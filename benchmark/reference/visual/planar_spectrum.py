"""Planar spectrum processor (``cubicsdr_tpu/visual/planar_spectrum.py``):
the display math of ``visual/spectrum.py`` on frames that arrive as
planar (re, im) planes.

The JAX package runs a four-step matmul FFT here because the TPU has no
complex type; the card has one, so the port joins the planes with
``torch.complex`` and takes ``torch.fft.fft`` of all frames in one batched
call, then runs the sequential EMA over the frames.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.fftops import fftshift_mag
from benchmark.reference.ops.planar import PC
from benchmark.reference.stream.op import StreamOp
from benchmark.reference.visual.spectrum import SpectrumProcessor


class PlanarSpectrumProcessor(StreamOp):
    """frames: PC of shape [n_frames, fftSizeInternal] -> display dict.
    State and EMA are SpectrumProcessor's (``self.core``)."""

    def __init__(self, fft_size: int = 2048, fft_average_rate: float = 0.65,
                 scale_factor: float = 1.0, peak_hold: bool = False):
        super().__init__()
        self.core = SpectrumProcessor(fft_size, fft_average_rate,
                                      scale_factor, peak_hold)
        self.fft_size = self.core.fft_size
        self.n = self.core.n

    def init_state(self):
        return self.core.init_state()

    def apply(self, state, frames: PC, dc_offset_bins=None, valid=None):
        X = torch.fft.fft(torch.complex(frames.re, frames.im), dim=-1)
        state = self.core.ema(state, fftshift_mag(X), valid)
        return state, self.core._points(state, dc_offset_bins)
