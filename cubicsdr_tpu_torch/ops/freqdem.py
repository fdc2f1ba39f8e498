"""FM quadrature discriminator (``cubicsdr_tpu/ops/freqdem.py``): the
per-sample phase increment scaled by 1/(2*pi*kf), liquid ``freqdem`` with
kf=0.5 (ref: src/modules/modem/analog/ModemFM.cpp:7,36). The only state is
the previous sample."""

from __future__ import annotations

import numpy as np

from cubicsdr_tpu_torch.ops.planar import (
    PC, PLANAR, dtype_ones, fast_atan2, pc_concat, pc_mul_conj)
from cubicsdr_tpu_torch.stream.op import StreamOp


def freqdem_block(prev: PC, x: PC, kf: float = 0.5):
    """prev: PC [...]; x: PC [..., L]. Returns (new_prev, audio [..., L]),
    with the polynomial atan2 (max error ~1e-7 rad, far below the chain's
    60 dB floor)."""
    scale = float(np.float32(1.0 / (2.0 * np.pi * kf)))
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
