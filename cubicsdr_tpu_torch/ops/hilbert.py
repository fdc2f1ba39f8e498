"""Analytic-signal FIR (``cubicsdr_tpu/ops/hilbert.py``), the firhilbf
equivalent the reference uses for real -> complex conversions in its
SSB/CW/FM-stereo chains (ref: src/modules/modem/analog/ModemUSB.cpp:13,
ModemFMStereo.cpp)."""

from __future__ import annotations

import numpy as np
import torch

from cubicsdr_tpu_torch.ops import design
from cubicsdr_tpu_torch.ops.fir import FirFilter
from cubicsdr_tpu_torch.ops.planar import to_complex
from cubicsdr_tpu_torch.stream.op import StreamOp


class AnalyticFilter(StreamOp):
    """real -> analytic signal x + j*H{x}, streaming: ONE FIR with complex
    taps delta[n - mid] + j*hilbert_fir[n] over real data, whose state is
    the real input tail. The output is complex64, as the JAX package's."""

    def __init__(self, num_taps: int = 63, batch_shape: tuple = ()):
        super().__init__()
        hh = design.hilbert_fir(num_taps)
        delay = np.zeros(num_taps)
        delay[(num_taps - 1) // 2] = 1.0
        self.fir = FirFilter(delay + 1j * hh, batch_shape,
                             dtype=torch.float32)

    def init_state(self):
        return self.fir.init_state()

    def apply(self, state, x):
        state, y = self.fir.apply(state, x)
        return state, to_complex(y)
