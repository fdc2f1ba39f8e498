"""The receiver's ('time', 'chan') mesh on ``torch.distributed``
(``cubicsdr_tpu/parallel/mesh.py``), and the collectives over one of its
axes.

One process per rank, one device per process. Rank r sits at
(time, chan) = (r // n_chan, r % n_chan), the JAX mesh's device order.
The JAX collectives map so: ``ppermute`` to a batched send/receive on the
time group (rank i receives rank i-1's tensors, cyclically), ``psum`` and
``pmax`` to ``all_reduce``, ``pmean`` to a sum over the group size (gloo
has no average), ``all_gather`` to ``all_gather_into_tensor`` in rank
order, ``axis_index`` to the rank's coordinate. On an axis of one rank
each is its own identity: the permute hands back the rank's own tail,
which is the math of a cyclic permute over one shard.

NCCL takes one rank per GPU. Ranks that share a card run their
collectives, where the caller asks for it (``host_collectives``), through
gloo on host copies of the card's tensors: the compute stays on the card,
and the copies are the stand-in for a link between hosts.

Under NCCL every collective here can be captured in a CUDA graph (the
compiled sharded step, ``sharded.py`` ``make_step``): the wire copies and
the receive buffers are allocated inside the step, so a capture takes
them from its own pool; ``all_reduce``, ``all_gather_into_tensor`` and the
batched send/receive run on NCCL's streams, and their waits are stream
waits, not host waits. The communicators, the lazily made point-to-point
ones included, come into being at the first eager call (a compiled step's
warm-ups). A host-collective axis copies to the host and blocks on gloo:
no capture can hold it, and ``make_step`` refuses it.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from cubicsdr_tpu_torch.utils.tree import (
    tree_leaves, tree_map, tree_unflatten)


class Axis:
    """One mesh axis as this rank sees it: its process group (None where
    the axis has one rank), its size, this rank's index on it and the
    global ranks along it in index order. ``host``: run the collectives on
    host copies (gloo with tensors on a card)."""

    def __init__(self, group=None, size: int = 1, index: int = 0,
                 ranks: tuple = (0,), host: bool = False):
        self.group, self.size, self.index = group, int(size), int(index)
        self.ranks, self.host = tuple(ranks), bool(host)

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy to send or reduce in place: on the host
        (``host``), else on ``t``'s device (inside a capture, from its
        pool)."""
        return (t.detach().to("cpu", copy=True) if self.host
                else t.detach().clone()).contiguous()

    def _reduce(self, t, op):
        if self.size == 1:
            return t
        buf = self._to_wire(t)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return self.psum(t) / self.size

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` in index order."""
        if self.size == 1:
            return t[None]
        buf = self._to_wire(t).reshape(-1)
        out = buf.new_empty((self.size * buf.numel(),))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, buf, group=self.group)
        return out.view(self.size, *t.shape).to(t.device)

    def permute_prev(self, tree):
        """Every leaf of ``tree`` as rank index-1 holds it (cyclically):
        one batched send/receive of all leaves, into new tensors (on one
        rank, copies: a caller may write over the tensors it sent)."""
        if self.size == 1:
            return tree_map(torch.clone, tree)
        leaves = tree_leaves(tree)
        dst = self.ranks[(self.index + 1) % self.size]
        src = self.ranks[(self.index - 1) % self.size]
        sends = [self._to_wire(t) for t in leaves]
        recvs = [torch.empty_like(s) for s in sends]
        ops = []
        for s, r in zip(sends, recvs):
            ops.append(dist.P2POp(dist.isend, s, dst, group=self.group))
            ops.append(dist.P2POp(dist.irecv, r, src, group=self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return tree_unflatten(tree, [r.to(t.device)
                                     for r, t in zip(recvs, leaves)])


class ReceiverMesh:
    """The ('time', 'chan') mesh as this rank sees it: ``time`` and
    ``chan`` Axes, the sizes ``nt``/``nc``, this rank's coordinate
    (``t``, ``c``) and the ``DeviceMesh`` (None for a one-rank mesh with
    no process group)."""

    def __init__(self, time: Axis, chan: Axis, device_mesh=None):
        self.time, self.chan, self.device_mesh = time, chan, device_mesh

    @property
    def nt(self) -> int:
        return self.time.size

    @property
    def nc(self) -> int:
        return self.chan.size

    @property
    def t(self) -> int:
        return self.time.index

    @property
    def c(self) -> int:
        return self.chan.index


def make_receiver_mesh(n_time: int | None = None, n_chan: int = 1,
                       device_type: str = "cuda",
                       host_collectives: bool = False) -> ReceiverMesh:
    """The mesh over the initialised process group's ranks: all of them on
    'time' by default, split ``n_chan`` ways on 'chan'. ``device_type`` is
    where each rank computes; ``host_collectives`` runs the collectives
    through gloo on host copies (several ranks on one card). Without an
    initialised process group only the one-rank mesh exists."""
    if not dist.is_initialized():
        if (n_time or 1) * n_chan != 1:
            raise RuntimeError(f"a {n_time}x{n_chan} mesh needs "
                               f"torch.distributed initialised")
        return ReceiverMesh(Axis(), Axis())
    world = dist.get_world_size()
    if n_time is None:
        n_time = world // n_chan
    if n_time * n_chan != world:
        raise ValueError(f"mesh {n_time}x{n_chan} does not cover the "
                         f"{world} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    host = host_collectives and device_type != "cpu"
    dm = init_device_mesh("cpu" if host else device_type, (n_time, n_chan),
                          mesh_dim_names=("time", "chan"))
    t, c = dm.get_coordinate()

    def axis(name, size, index):
        group = dm.get_group(name)
        return Axis(group, size, index,
                    dist.get_process_group_ranks(group), host)

    return ReceiverMesh(axis("time", n_time, t), axis("chan", n_chan, c),
                        dm)
