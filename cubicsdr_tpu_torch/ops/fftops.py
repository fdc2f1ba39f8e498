"""Windowed batched FFT helpers for spectrum/waterfall processing
(``cubicsdr_tpu/ops/fftops.py``; ref: liquid fft_execute use at
src/process/SpectrumVisualProcessor.cpp:439). ``torch.fft`` runs the
batched complex FFT (cuFFT on the card); magnitude and fftshift stay
elementwise around it.
"""

from __future__ import annotations

import numpy as np
import torch


def fftshift_mag(X: torch.Tensor) -> torch.Tensor:
    """|FFT| with DC centered — the half-swap at
    ref: src/process/SpectrumVisualProcessor.cpp:441-452."""
    return torch.fft.fftshift(X.abs(), dim=-1)


def spectrum_frames(x: torch.Tensor, fft_size: int, window=None):
    """x: complex [..., n_frames, fft_size] -> magnitude spectra [...,
    n_frames, fft_size], DC-centered, optional window (numpy array or
    None)."""
    if window is not None:
        x = x * torch.as_tensor(np.asarray(window, np.float32),
                                device=x.device)
    return fftshift_mag(torch.fft.fft(x, dim=-1))


def hann(n: int) -> np.ndarray:
    return np.hanning(n).astype(np.float32)
