"""Synthetic FM captures made on the device, for smoke tests and
profiling: the JAX bench's demod layout and FM stations carrying one
tone each."""

from __future__ import annotations

import numpy as np
import torch


def demod_freqs(n: int, spread: int = 16) -> np.ndarray:
    """Offsets (Hz) of n demods at 500 kHz spacing plus 20 kHz, wrapping
    every ``spread`` demods. ``spread`` = 16 is the JAX bench's layout
    (``bench.py:75-77``: one demod per 8 MS/s channel); 15 keeps every
    station clear of the +-fs/2 wrap edge."""
    return np.asarray([((i % spread) - spread // 2) * 500e3 + 20e3
                       for i in range(n)], np.float32)


def synth_fm(freqs, n: int, fs: float, device, seed: int,
             noise: float = 0.02) -> torch.Tensor:
    """Planes [2, n] float32: FM stations at ``freqs`` (station k carries
    a 700 + 90k Hz tone at 75 kHz deviation, amplitude 0.5) plus complex
    Gaussian noise, built in float64 on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    re = noise * torch.randn(n, generator=g, device=device,
                             dtype=torch.float64)
    im = noise * torch.randn(n, generator=g, device=device,
                             dtype=torch.float64)
    for k, f0 in enumerate(freqs):
        msg = torch.sin(2 * np.pi * (700.0 + 90.0 * k) * t)
        ph = 2 * np.pi * float(f0) * t + 2 * np.pi * 75e3 * torch.cumsum(
            msg, 0) / fs
        re += 0.5 * torch.cos(ph)
        im += 0.5 * torch.sin(ph)
    return torch.stack([re, im]).float()
