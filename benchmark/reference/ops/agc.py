"""Block-level automatic gain control (``cubicsdr_tpu/ops/agc.py``).

ModemAnalog's slow "autoGain": a double EMA (rate 0.025 per block) of the
per-block output ceiling, gain = 0.5 / smoothed ceiling
(ref: src/modules/modem/ModemAnalog.cpp:67-93). Block-granular in the
reference too, so it needs no scan.
"""

from __future__ import annotations

import torch

from benchmark.reference.stream.op import StreamOp


class AutoGain(StreamOp):
    """``time_axis``: the time ``Axis`` when the block's time axis is
    split over ranks (parallel/sharded.py); the block ceiling is then a
    max over it, so the EMA state stays the same on every time shard."""

    shard_kind = "replicated"

    def __init__(self, rate: float = 0.025, target: float = 0.5,
                 batch_shape: tuple = (), time_axis=None):
        super().__init__()
        self.rate = float(rate)
        self.target = float(target)
        self.batch_shape = tuple(batch_shape)
        self.time_axis = time_axis

    def init_state(self):
        # Three distinct tensors: the JAX package's leaves, and no leaf
        # aliases another when a caller updates state in place.
        return tuple(torch.ones(self.batch_shape, device=self.device)
                     for _ in range(3))          # prev ceil, ceil_ma, _maa

    def apply(self, state, x):
        ceil_prev, ceil_ma, ceil_maa = state
        # Reference order: smooth the PREVIOUS block's (pre-gain) ceiling
        # into the averages, measure this block's ceiling pre-gain, then
        # apply gain = target / MAA.
        ceil_ma = ceil_ma + (ceil_prev - ceil_ma) * self.rate
        ceil_maa = ceil_maa + (ceil_ma - ceil_maa) * self.rate
        ceil = x.amax(dim=-1)
        if self.time_axis is not None:
            ceil = self.time_axis.pmax(ceil)
        gain = self.target / ceil_maa.clamp_min(1e-9)
        return (ceil, ceil_ma, ceil_maa), x * gain[..., None]
