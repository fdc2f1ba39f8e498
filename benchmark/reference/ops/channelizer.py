"""Polyphase filter-bank channelizers (``cubicsdr_tpu/ops/channelizer.py``):
the critically sampled analyzer (PFBCH, liquid firpfbch) and the
2x-oversampled one (PFBCH2, firpfbch2).

Channel k's output is the input mixed down by w_k = 2*pi*k/M, lowpassed by
the prototype h and decimated by D (M critically, M/2 oversampled):

    y_k[s] = e^{-j w_k n_s} * sum_t h[t] e^{+j w_k t} x[n_s - t],
    n_s = s*D + D - 1,

computed as M polyphase branches over reversed stride-D frames, an M-point
IDFT, a constant phase c_k and, oversampled only, a (-1)^{k*s} parity
flip. Channel k is centred at +k/M * fs, wrapped
(ref: src/sdr/SDRPostThread.cpp:406,463,504-509).

Representations: ``dtype=PLANAR`` (two float32 planes; the IDFT as two
real matmuls, or PFBCH2's CUDA kernel) or ``dtype=torch.complex64``, the
JAX package's complex path: the depthwise polyphase convolution
(``conv1d_grouped``, dilation 2 for PFBCH2), then M * ``torch.fft.ifft``
over the branch axis and c_k as a complex constant. The kernel takes
planar data only, as the JAX package's Pallas kernel does.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops import design
from benchmark.reference.ops.kernels.pfb import (
    pfbch2_planar, pfbch2_planar_plain)
from benchmark.reference.ops.planar import (
    PC, PLANAR, dtype_zeros, idft_mats_np, pc_concat, pc_idft_m, pc_mul)
from benchmark.reference.stream.op import StreamOp
from benchmark.reference.utils.convolve import conv1d_grouped


def _polyphase(h: np.ndarray, M: int) -> np.ndarray:
    """h [M*J] -> h_poly [M, J] with h_poly[rho, j] = h[j*M + rho]."""
    K = len(h)
    J = int(np.ceil(K / M))
    hp = np.zeros((M, J), np.float32)
    for rho in range(M):
        t = h[rho::M]
        hp[rho, : len(t)] = t
    return hp


def _complex_c(c: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(c.astype(np.complex64))


class ChannelizerPFB(StreamOp):
    """Critically sampled M-channel analyzer: L inputs -> [M, L//M] in the
    representation ``dtype`` (PLANAR or torch.complex64); L must be a
    multiple of M. Channel k is centred at +k*fs/M (wrapped) and sampled
    at fs/M. The reference's configuration: 8 taps per branch, a 60 dB
    Kaiser prototype (ref: src/sdr/SDRPostThread.cpp:406).

    State: J-1 frames of history, already framed and reversed, [M, J-1]
    (the JAX package's layout). Plain PyTorch, as the JAX package
    computes this analyzer in XLA: a depthwise convolution over the
    branches, the M-point IDFT (two real matmuls on planes, an inverse FFT
    on complex64), and c_k."""

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 as_db: float = 60.0, dtype=PLANAR):
        super().__init__()
        self.dtype = dtype
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
        if dtype != PLANAR:
            self.register_buffer("c", _complex_c(c))

    def init_state(self):
        return dtype_zeros((self.M, self.J - 1), self.dtype, self.device)

    @property
    def hist_len(self) -> int:
        """Raw-sample history equivalent (for the halo exchange)."""
        return (self.J - 1) * self.M

    def hist_from_samples(self, tail):
        """The framed history state from the last (J-1)*M raw samples."""
        def f(t):
            return t.reshape(self.J - 1, self.M).flip(-1).transpose(0, 1)
        return PC(f(tail.re), f(tail.im)) if isinstance(tail, PC) \
            else f(tail)

    # Time-sharding: raw-sample tail -> framed history.
    shard_kind = "tail"

    def state_from_tail(self, tail):
        return self.hist_from_samples(tail)

    def apply(self, hist, x):
        if x.shape[-1] % self.M:
            raise ValueError(f"block length {x.shape[-1]} is not a multiple "
                             f"of M={self.M}")
        n_frames = x.shape[-1] // self.M

        def frames(p):
            # G[s, rho] = x[s*M + M-1 - rho] -> [M, s], branch axis first.
            return p.reshape(n_frames, self.M).flip(-1).transpose(0, 1)

        if not isinstance(x, PC):
            z = torch.cat([hist, frames(x)], dim=-1)        # [M, J-1+n]
            u = conv1d_grouped(z, self.h_poly)
            y = self.M * torch.fft.ifft(u, dim=-2) * self.c[:, None]
            return z[..., z.shape[-1] - (self.J - 1):], y
        z = pc_concat([hist, PC(frames(x.re), frames(x.im))])   # [M, J-1+n]
        # Depthwise true convolution of branch rho with h_poly[rho].
        u = conv1d_grouped(z, self.h_poly)
        y = pc_mul(pc_idft_m(u, self.w_re, self.w_im),
                   PC(self.c_re[:, None], self.c_im[:, None]))
        return z.slice_last(slice(z.shape[-1] - (self.J - 1), None)), y


class ChannelizerPFB2(StreamOp):
    """2x-oversampled M-channel analyzer: L inputs -> [M, 2*L//M] in the
    representation ``dtype`` (PLANAR or torch.complex64); L must be a
    multiple of M/2.

    State: (raw sample history [(2J-1)*D], int32 global step parity).
    ``use_kernels`` (planar only, as the JAX package's ``use_pallas``):
    run the CUDA analyzer (``csrc/pfb.cu``) on CUDA data; otherwise, and on
    CPU data, its plain PyTorch version."""

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 as_db: float = 60.0, use_kernels: bool = False,
                 dtype=PLANAR):
        super().__init__()
        if num_channels % 2:
            raise ValueError(f"PFBCH2 needs an even channel count, got "
                             f"{num_channels}")
        if use_kernels and dtype != PLANAR:
            raise ValueError("the PFB kernel takes planar data "
                             "(dtype=PLANAR) only")
        self.dtype = dtype
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
        if dtype != PLANAR:
            self.register_buffer("c", _complex_c(c))
            self.register_buffer("flip", torch.from_numpy(
                np.where(k % 2 == 1, -1.0, 1.0).astype(np.float32)))
        # Oldest sample needed for step s=0: (2J-1)*D samples of history.
        self.hist_len = (2 * self.J - 1) * self.D

    def init_state(self):
        return (dtype_zeros(self.hist_len, self.dtype, self.device),
                torch.zeros((), dtype=torch.int32, device=self.device))

    # Time-sharding: state = (raw sample tail, step parity); with an even
    # local step count the parity is shard-invariant (callers keep it so).
    shard_kind = "tail"

    def state_from_tail(self, tail):
        return (tail, torch.zeros((), dtype=torch.int32,
                                  device=tail.device))

    def _complex(self, z, parity, n_steps: int):
        """The JAX package's complex64 analyzer on the hist-prefixed
        stream z: reversed length-M windows at stride D (two adjacent
        D-rows each), the polyphase FIR at tap dilation 2, M * IFFT over
        the branches, c_k and the (-1)^{k*s} flip at the global step
        parity."""
        n_total = (z.shape[-1] - self.M) // self.D + 1
        A = z[: (n_total + 1) * self.D].reshape(n_total + 1, self.D)
        G = torch.cat([A[:-1], A[1:]], dim=-1).flip(-1).transpose(0, 1)
        u = conv1d_grouped(G, self.h_poly, dilation=2)   # [M, n_steps]
        y = self.M * torch.fft.ifft(u, dim=-2) * self.c[:, None]
        s = (torch.arange(n_steps, device=z.device) + parity) % 2
        sign = torch.where(s[None, :] == 1, self.flip[:, None],
                           torch.ones_like(self.flip)[:, None])
        return y * sign

    def apply(self, state, x):
        samp_hist, parity = state
        if x.shape[-1] % self.D:
            raise ValueError(f"block length {x.shape[-1]} is not a multiple "
                             f"of D={self.D}")
        n_steps = x.shape[-1] // self.D
        new_parity = (parity + n_steps) % 2
        if not isinstance(x, PC):
            z = torch.cat([samp_hist, x], dim=-1)
            return ((z[z.shape[-1] - self.hist_len:], new_parity),
                    self._complex(z, parity, n_steps))
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
