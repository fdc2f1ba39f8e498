"""Numerically-controlled oscillator (``cubicsdr_tpu/ops/nco.py``).

On the receive step's folded path the NCO is folded into the first
resampler stage (``receiver/frontend.py``), and this op only carries the
per-demod phase. ``apply`` mixes explicitly for chains that are not
folded (a unity-ratio frontend, the standalone WBFM chain).
"""

from __future__ import annotations

import math

import torch

from cubicsdr_tpu_torch.ops.planar import PC, pc_mul
from cubicsdr_tpu_torch.stream.op import StreamOp

TWO_PI = 2.0 * math.pi


class NCOMixer(StreamOp):
    """Stateful frequency shifter: ``apply(phase, (x, omega))`` multiplies
    x [..., L] by e^{+i(phase + omega*k)}; omega = 2*pi*f_shift/rate.
    ``batch_shape`` batches independent NCOs with independent phases."""

    def __init__(self, batch_shape: tuple = ()):
        super().__init__()
        self.batch_shape = tuple(batch_shape)

    def init_state(self):
        return torch.zeros(self.batch_shape, dtype=torch.float32,
                           device=self.device)

    def apply(self, phase, inputs):
        x, omega = inputs
        L = x.shape[-1]
        omega = torch.as_tensor(omega, dtype=torch.float32,
                                device=phase.device).expand(phase.shape)
        # The ramp argument is formed in float64: omega*k in float32 loses
        # ~0.03 rad at k ~ 1e6, which an FM discriminator turns into noise.
        k = torch.arange(L, dtype=torch.float64, device=phase.device)
        th = torch.remainder(phase.double()[..., None]
                             + omega.double()[..., None] * k, TWO_PI)
        rot = PC(torch.cos(th).float(), torch.sin(th).float())
        nxt = torch.remainder(phase + omega * L, TWO_PI)
        return nxt, pc_mul(x, rot)
