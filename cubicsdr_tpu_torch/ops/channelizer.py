"""Polyphase filter-bank channelizers, planar
(``cubicsdr_tpu/ops/channelizer.py``): the critically sampled analyzer
(PFBCH, liquid firpfbch) and the 2x-oversampled one (PFBCH2, firpfbch2).

Channel k's output is the input mixed down by w_k = 2*pi*k/M, lowpassed by
the prototype h and decimated by D (M critically, M/2 oversampled):

    y_k[s] = e^{-j w_k n_s} * sum_t h[t] e^{+j w_k t} x[n_s - t],
    n_s = s*D + D - 1,

computed as M polyphase branches over reversed stride-D frames, an M-point
IDFT, a constant phase c_k and, oversampled only, a (-1)^{k*s} parity
flip. Channel k is centred at +k/M * fs, wrapped
(ref: src/sdr/SDRPostThread.cpp:406,463,504-509).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cubicsdr_tpu_torch.ops import design
from cubicsdr_tpu_torch.ops.kernels.pfb import (
    pfbch2_planar, pfbch2_planar_plain)
from cubicsdr_tpu_torch.ops.planar import (
    PC, idft_mats_np, pc_concat, pc_idft_m, pc_mul)
from cubicsdr_tpu_torch.stream.op import StreamOp


def _polyphase(h: np.ndarray, M: int) -> np.ndarray:
    """h [M*J] -> h_poly [M, J] with h_poly[rho, j] = h[j*M + rho]."""
    K = len(h)
    J = int(np.ceil(K / M))
    hp = np.zeros((M, J), np.float32)
    for rho in range(M):
        t = h[rho::M]
        hp[rho, : len(t)] = t
    return hp


class ChannelizerPFB(StreamOp):
    """Critically sampled M-channel analyzer on planar data: L inputs ->
    PC [M, L//M]; L must be a multiple of M. Channel k is centred at
    +k*fs/M (wrapped) and sampled at fs/M. The reference's configuration:
    8 taps per branch, a 60 dB Kaiser prototype (ref: src/sdr/
    SDRPostThread.cpp:406).

    State: J-1 frames of history, already framed and reversed, PC
    [M, J-1] (the JAX package's layout). Plain PyTorch, as the JAX
    package computes this analyzer in XLA: a depthwise convolution over
    the branches, the M-point IDFT as two real matmuls, and c_k."""

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 as_db: float = 60.0):
        super().__init__()
        self.M = int(num_channels)
        h = design.pfb_prototype(self.M, taps_per_channel, as_db)
        self.register_buffer("h_poly",
                             torch.from_numpy(_polyphase(np.asarray(h),
                                                         self.M)))
        self.J = self.h_poly.shape[1]
        w_re, w_im = idft_mats_np(self.M)
        self.register_buffer("w_re", torch.from_numpy(w_re))
        self.register_buffer("w_im", torch.from_numpy(w_im))
        # c_k = e^{-j w_k (D-1)} with D = M.
        k = np.arange(self.M)
        c = np.exp(-2j * np.pi * k * (self.M - 1) / self.M)
        self.register_buffer("c_re",
                             torch.from_numpy(c.real.astype(np.float32)))
        self.register_buffer("c_im",
                             torch.from_numpy(c.imag.astype(np.float32)))

    def init_state(self):
        z = torch.zeros((self.M, self.J - 1), dtype=torch.float32,
                        device=self.device)
        return PC(z, z.clone())

    def apply(self, hist: PC, x: PC):
        if x.shape[-1] % self.M:
            raise ValueError(f"block length {x.shape[-1]} is not a multiple "
                             f"of M={self.M}")
        n_frames = x.shape[-1] // self.M

        def frames(p):
            # G[s, rho] = x[s*M + M-1 - rho] -> [M, s], branch axis first.
            return p.reshape(n_frames, self.M).flip(-1).transpose(0, 1)

        z = pc_concat([hist, PC(frames(x.re), frames(x.im))])   # [M, J-1+n]
        # Depthwise true convolution of branch rho with h_poly[rho]:
        # F.conv1d correlates, so the taps are flipped.
        w = self.h_poly.flip(-1)[:, None, :]
        u = PC(*(F.conv1d(p[None], w, groups=self.M)[0] for p in z))
        y = pc_mul(pc_idft_m(u, self.w_re, self.w_im),
                   PC(self.c_re[:, None], self.c_im[:, None]))
        return z.slice_last(slice(z.shape[-1] - (self.J - 1), None)), y


class ChannelizerPFB2(StreamOp):
    """2x-oversampled M-channel analyzer on planar data: L inputs ->
    PC [M, 2*L//M]; L must be a multiple of M/2.

    State: (raw sample history PC [(2J-1)*D], int32 global step parity).
    ``use_kernels``: run the CUDA analyzer (``csrc/pfb.cu``) on CUDA data;
    otherwise, and on CPU data, its plain PyTorch version."""

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 as_db: float = 60.0, use_kernels: bool = False):
        super().__init__()
        if num_channels % 2:
            raise ValueError(f"PFBCH2 needs an even channel count, got "
                             f"{num_channels}")
        self.M = int(num_channels)
        self.D = self.M // 2
        h = design.pfb_prototype(self.M, taps_per_channel, as_db)
        self.register_buffer("h_poly",
                             torch.from_numpy(_polyphase(np.asarray(h),
                                                         self.M)))
        self.J = self.h_poly.shape[1]
        self.use_kernels = bool(use_kernels)
        w_re, w_im = idft_mats_np(self.M)
        self.register_buffer("w_re", torch.from_numpy(w_re))
        self.register_buffer("w_im", torch.from_numpy(w_im))
        # c_k = e^{-j w_k (D-1)}, D = M/2.
        k = np.arange(self.M)
        c = np.exp(-2j * np.pi * k * (self.D - 1) / self.M)
        self.register_buffer("c_re",
                             torch.from_numpy(c.real.astype(np.float32)))
        self.register_buffer("c_im",
                             torch.from_numpy(c.imag.astype(np.float32)))
        # Oldest sample needed for step s=0: (2J-1)*D samples of history.
        self.hist_len = (2 * self.J - 1) * self.D

    def init_state(self):
        z = torch.zeros(self.hist_len, dtype=torch.float32,
                        device=self.device)
        return (PC(z, z.clone()),
                torch.zeros((), dtype=torch.int32, device=self.device))

    def apply(self, state, x: PC):
        samp_hist, parity = state
        if x.shape[-1] % self.D:
            raise ValueError(f"block length {x.shape[-1]} is not a multiple "
                             f"of D={self.D}")
        n_steps = x.shape[-1] // self.D
        new_parity = (parity + n_steps) % 2
        z = pc_concat([samp_hist, x])
        new_hist = z.slice_last(slice(z.shape[-1] - self.hist_len, None))
        fn = pfbch2_planar if self.use_kernels else pfbch2_planar_plain
        cr, ci = fn(z.re, z.im, self.h_poly, self.w_re, self.w_im,
                    self.c_re, self.c_im, parity)
        return (new_hist, new_parity), PC(cr, ci)


def channel_centers(num_channels: int, sample_rate: float,
                    frequency: float = 0.0) -> np.ndarray:
    """RF center of each channel in the analyzer's k -> +k*fs/M order,
    wrapped to (-fs/2, fs/2] (ref: src/sdr/SDRPostThread.cpp:100-126)."""
    M = num_channels
    k = np.arange(M)
    f = k * (sample_rate / M)
    f = np.where(f > sample_rate / 2, f - sample_rate, f)
    return frequency + f
