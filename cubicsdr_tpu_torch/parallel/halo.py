"""Halo exchange: the one collective the streaming chain needs
(``cubicsdr_tpu/parallel/halo.py``).

Filter history between time shards moves as a cyclic permute: shard i
receives shard i-1's tail. The wrap makes block streaming seamless:
shard 0's "previous samples" are the last shard's tail, the end of the
previous block.
"""

from __future__ import annotations

from cubicsdr_tpu_torch.ops.planar import xcat
from cubicsdr_tpu_torch.utils.tree import tree_map


def halo_exchange(x, n_halo: int, axis):
    """Shard i-1's last ``n_halo`` samples (cyclically). x: [..., L_local]
    tensor, PC, or a nest of them; ``axis`` the time ``Axis``."""
    tail = tree_map(lambda p: p[..., p.shape[-1] - n_halo:], x)
    if n_halo == 0:                     # nothing to move
        return tail
    return axis.permute_prev(tail)


def with_halo(x, n_halo: int, axis):
    """The received (cyclic) halo in front of the local shard. Shard 0
    receives the CURRENT block's global tail: right for spatially cyclic
    data, wrong for a stream (use ``streaming_halo``)."""
    return tree_map(lambda h, p: xcat([h, p]),
                    halo_exchange(x, n_halo, axis), x)


def streaming_halo(x, n_halo: int, carry, axis):
    """Stream-correct halo: shard i > 0 uses shard i-1's current tail;
    shard 0 uses ``carry``, the previous block's global tail, which the
    cyclic permute delivered to it on the last step.

    Returns (z, new_carry): z = [halo, x] along the last axis, and
    ``new_carry`` what this shard received (shard 0's history exactly when
    the permute wraps). x and carry are tensors, PCs or matching nests."""
    received = halo_exchange(x, n_halo, axis)
    used = carry if axis.index == 0 else received
    z = tree_map(lambda u, p: xcat([u, p]), used, x)
    return z, received
