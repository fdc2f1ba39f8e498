"""Numerically-controlled oscillator (``cubicsdr_tpu/ops/nco.py``).

On the receive step's folded path the NCO is folded into the first
resampler stage (``receiver/frontend.py``), and this op only carries the
per-demod phase. ``apply`` mixes explicitly for chains that are not
folded (a unity-ratio frontend, the standalone WBFM chain, and every
complex64 chain): complex64 data takes the JAX package's full-length
float32 ramp e^{i mod(phase0 + omega*k, 2*pi)} (``phasor_ramp``).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ops.planar import PC, pc_mul
from benchmark.reference.stream.op import StreamOp

TWO_PI = 2.0 * math.pi


def phasor_ramp(phase0, omega, n: int) -> torch.Tensor:
    """e^{i(phase0 + omega*k)} for k in [0, n), complex64 [..., n]: the
    argument formed and wrapped mod 2*pi in float32, as the JAX package
    forms it. phase0, omega: float32 tensors broadcastable to [..., 1]."""
    k = torch.arange(n, dtype=torch.float32, device=phase0.device)
    theta = torch.remainder(phase0 + omega * k, TWO_PI)
    return torch.complex(torch.cos(theta), torch.sin(theta))


def mix(x: torch.Tensor, phase0, omega):
    """x complex64 [..., L] times the phasor ramp; returns (y,
    next_phase) with next_phase = mod(phase0 + omega*L, 2*pi)."""
    L = x.shape[-1]
    return (x * phasor_ramp(phase0, omega, L),
            torch.remainder(phase0 + omega * L, TWO_PI))


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
        if isinstance(omega, (int, float)):
            # A scalar (a kit's fixed offset) is filled on the device: no
            # host upload per block, so a CUDA graph can capture the step.
            omega = torch.full(phase.shape, omega, dtype=torch.float32,
                               device=phase.device)
        else:
            omega = torch.as_tensor(omega, dtype=torch.float32,
                                    device=phase.device).expand(phase.shape)
        if not isinstance(x, PC):
            y, _ = mix(x, phase[..., None], omega[..., None])
            return torch.remainder(phase + omega * L, TWO_PI), y
        # The ramp argument is formed in float64: omega*k in float32 loses
        # ~0.03 rad at k ~ 1e6, which an FM discriminator turns into noise.
        k = torch.arange(L, dtype=torch.float64, device=phase.device)
        th = torch.remainder(phase.double()[..., None]
                             + omega.double()[..., None] * k, TWO_PI)
        rot = PC(torch.cos(th).float(), torch.sin(th).float())
        nxt = torch.remainder(phase + omega * L, TWO_PI)
        return nxt, pc_mul(x, rot)
