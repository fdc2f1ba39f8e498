"""Synthetic FM captures made on the device, for smoke tests and
profiling: the JAX bench's demod layout and FM stations carrying one
tone each; and the back-pressured cycling source of the live-loop
rows, with the live row built on it."""

from __future__ import annotations

import time

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


def noise_blocks(block_len: int, dtype=np.float32, n: int = 4,
                 seed: int = 1) -> list:
    """``n`` host blocks of Gaussian planes [2, block_len] in the ring's
    sample format (the JAX bench's live-row input, ``bench.py:192-200``):
    unit variance for float32, a quarter of half full scale for integer
    wire formats."""
    rng = np.random.default_rng(seed)
    shape = (2, block_len)
    if np.dtype(dtype) == np.float32:
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in range(n)]
    k = float(np.iinfo(dtype).max // 2)
    return [(rng.standard_normal(shape) * 0.25 * k).astype(dtype)
            for _ in range(n)]


class CycleSource:
    """Unthrottled host source that cycles ``blocks`` with back-pressure:
    it waits for ring space instead of shedding, so a live-loop rate is
    the loop's own and ring drops stay a real health signal
    (``bench.py:202-222``). Set ``ring`` to the receiver's ring."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.ring = None
        self.stop_flag = False

    def __iter__(self):
        i = 0
        n = self.blocks[0].shape[-1]
        while not self.stop_flag:
            while (self.ring is not None and not self.stop_flag
                   and self.ring.fill + n > self.ring.capacity):
                time.sleep(0.0002)
            yield self.blocks[i % len(self.blocks)]
            i += 1

    def stop(self):
        self.stop_flag = True


def live_row(rx, ingest_dtype, n_warm: int = 8):
    """The live16 row of the JAX package's ``bench.py:175-258`` on
    pipeline ``rx``: 16 demods at the bench layout, a cycling noise
    source in ring format ``ingest_dtype``, a 1024-point 64-line waterfall
    and a 1 s ring. Returns the running receiver after ``n_warm`` blocks;
    the caller stops it."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    controls = rx.control_template()
    controls[0]["frequency"] = demod_freqs(16)
    src = CycleSource(noise_blocks(rx.block_len, ingest_dtype))
    lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                      waterfall_lines=64, ring_seconds=1.0,
                      ingest_dtype=ingest_dtype)
    src.ring = lr.ring
    lr.start_producer()
    lr.run_blocks(max_blocks=n_warm)
    return lr
