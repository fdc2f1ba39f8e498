"""StreamOp protocol: the universal stage contract, as ``nn.Module``s.

Every DSP stage is ``apply(state, x) -> (state, y)`` where ``state`` is a
nest of tuples/dicts of tensors — leaf for leaf the JAX package's state
pytree (``cubicsdr_tpu/stream/op.py``). Constants are registered buffers of
the module, so ``op.to(device)`` moves a whole chain; ``init_state()``
builds the state on the op's device.

``apply`` deliberately shadows ``nn.Module.apply(fn)`` (the recursive
initialiser): no stage of this package uses that.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from cubicsdr_tpu_torch.utils.tree import tree_leaves, tree_map

State = Any


class StreamOp(nn.Module):
    """Base class: subclasses define ``init_state()`` and ``apply(state, x)``.

    Output length is a function of input length and construction params
    only (the same static-shape contract as the JAX package)."""

    def __init__(self):
        super().__init__()
        # Empty anchor that follows .to(device): ops without constants of
        # their own still know where to build their state.
        self.register_buffer("_anchor", torch.empty(0), persistent=False)

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def init_state(self) -> State:
        return ()

    def apply(self, state: State, x):
        raise NotImplementedError

    def forward(self, state: State, x):
        return self.apply(state, x)


class Chain(StreamOp):
    """Sequential composition of StreamOps; state is a tuple of stage
    states."""

    def __init__(self, *ops: StreamOp):
        super().__init__()
        self.ops = nn.ModuleList(ops)

    def init_state(self):
        return tuple(op.init_state() for op in self.ops)

    def apply(self, state, x):
        new_states = []
        for op, s in zip(self.ops, state):
            s, x = op.apply(s, x)
            new_states.append(s)
        return tuple(new_states), x


def scan_blocks(op, state: State, blocks):
    """Run ``op`` over a leading blocks axis with carried state (the eager
    counterpart of the JAX package's ``lax.scan``).

    ``blocks``: nest whose leaves have shape [n_blocks, ...]. Returns
    (final_state, outputs stacked on a new leading axis)."""
    fn = op.apply if isinstance(op, StreamOp) else op
    outs = []
    for b in range(tree_leaves(blocks)[0].shape[0]):
        state, y = fn(state, tree_map(lambda t: t[b], blocks))
        outs.append(y)
    return state, tree_map(lambda *ys: torch.stack(ys), *outs)


def split_blocks(x: torch.Tensor, block_len: int) -> torch.Tensor:
    """Frame a [..., N] tensor into [..., n_blocks, block_len], dropping
    the ragged tail."""
    n = x.shape[-1] // block_len
    return x[..., : n * block_len].reshape(*x.shape[:-1], n, block_len)
