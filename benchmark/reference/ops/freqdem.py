"""FM quadrature discriminator (``cubicsdr_tpu/ops/freqdem.py``): the
per-sample phase increment scaled by 1/(2*pi*kf), liquid ``freqdem`` with
kf=0.5 (ref: src/modules/modem/analog/ModemFM.cpp:7,36). The only state is
the previous sample. Planar data takes the polynomial atan2, complex64
data a true one, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops.planar import (
    PC, PLANAR, dtype_ones, fast_atan2, pc_concat, pc_mul_conj)
from benchmark.reference.stream.op import StreamOp


def freqdem_block(prev, x, kf: float = 0.5):
    """prev: [...]; x: [..., L], both PC or both complex64. Returns
    (new_prev, audio [..., L]). PC data uses the polynomial atan2 (max
    error ~1e-7 rad, far below the chain's 60 dB floor)."""
    scale = float(np.float32(1.0 / (2.0 * np.pi * kf)))
    if not isinstance(x, PC):
        z = torch.cat([prev[..., None], x], dim=-1)
        d = z[..., 1:] * z[..., :-1].conj()
        return x[..., -1], torch.atan2(d.imag, d.real) * scale
    z = pc_concat([PC(prev.re[..., None], prev.im[..., None]), x])
    d = pc_mul_conj(z.slice_last(slice(1, None)), z.slice_last(slice(0, -1)))
    audio = fast_atan2(d.im, d.re) * scale
    return PC(x.re[..., -1], x.im[..., -1]), audio


class FreqDem(StreamOp):
    def __init__(self, kf: float = 0.5, batch_shape: tuple = (),
                 dtype=PLANAR):
        super().__init__()
        self.kf = float(kf)
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def init_state(self):
        # 1+0j: the first sample's phase difference is the true phase of
        # x[0] rather than an atan2(0, 0) artifact.
        return dtype_ones(self.batch_shape, self.dtype, self.device)

    def apply(self, prev, x):
        return freqdem_block(prev, x, self.kf)

    # Time-sharding: state = the previous input sample.
    shard_kind = "tail"

    def state_from_tail(self, tail):
        if not isinstance(tail, PC):
            return tail[..., 0]
        return PC(tail.re[..., 0], tail.im[..., 0])

