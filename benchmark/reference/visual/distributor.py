"""FFTDataDistributor — re-blocker / waterfall line-rate governor
(``cubicsdr_tpu/visual/distributor.py``; ref: src/process/
FFTDataDistributor.cpp:28-142, buffer constant CubicSDRDefs.h:69).

Each input block of L samples yields a FIXED frame capacity
[max_lines, fft_size] plus a validity mask; frame start times follow the
reference's fractional line pacing. The pacer runs in float32 exactly as
the JAX package computes it, so frame indices and masks are identical,
not merely close. Data is planar (``dtype=PLANAR``, a PC) or complex64
(``dtype=torch.complex64``); the gather is the same per plane.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops.planar import (
    PC, PLANAR, dtype_zeros, xcat, xtail)
from benchmark.reference.stream.op import StreamOp


class FFTDataDistributor(StreamOp):
    def __init__(self, fft_size: int, sample_rate: float,
                 lines_per_second: float = 30.0, block_len: int = 0,
                 dtype=PLANAR):
        super().__init__()
        self.dtype = dtype
        self.fft_size = int(fft_size)
        self.sample_rate = float(sample_rate)
        self.lps = float(lines_per_second)
        self.block_len = int(block_len)
        # samples between line starts (can be < fft_size at high lps —
        # overlapping windows, like the reference's compacting ring).
        self.hop = self.sample_rate / self.lps
        # float32 hop: the reference multiplies in float32.
        self.register_buffer("hop32", torch.tensor(np.float32(self.hop)))
        if block_len:
            self.max_lines = int(np.ceil(block_len / self.hop)) + 1

    def init_state(self):
        return (dtype_zeros(self.fft_size - 1, self.dtype, self.device),
                torch.zeros((), dtype=torch.float32,
                            device=self.device))    # history, next line pos

    def apply(self, state, x):
        """x: [L] PC or complex64 -> (frames [max_lines, fft_size] of x's
        kind, valid [max_lines] bool). Frame k starts when the fractional
        accumulator crosses; positions are relative to the block with
        fft_size-1 samples of history, so a line may straddle the
        boundary."""
        hist, next_pos = state
        L = x.shape[-1]
        if not self.block_len:
            self.block_len = L
            self.max_lines = int(np.ceil(L / self.hop)) + 1
        z = xcat([hist, x])
        dev = z.device
        k = torch.arange(self.max_lines, dtype=torch.float32, device=dev)
        starts = next_pos + k * self.hop32          # block-sample units
        valid = starts <= (L - 1)
        # Window ENDS at start (newest sample), so begin fft_size-1
        # earlier; offset by history length.
        s_idx = starts.clamp(0, L - 1).to(torch.int64)
        idx = s_idx[:, None] + torch.arange(self.fft_size, device=dev)
        frames = PC(z.re[idx], z.im[idx]) if isinstance(z, PC) else z[idx]
        n_emitted = valid.to(torch.float32).sum()
        new_next = next_pos + n_emitted * self.hop32 - L
        new_hist = xtail(z, self.fft_size - 1)
        return (new_hist, new_next), (frames, valid)
