"""Fused route + NCO shift + rational resample: the CUDA kernel's wrapper
(``csrc/route.cu``) and its plain PyTorch version.

Counterpart of ``cubicsdr_tpu/ops/pallas/route.py:
routed_shifted_resample_pallas``. For demod n the kernel reads channel
``chan_idx[n]`` of the per-channel planes directly, modulates each output
tile's input window by e^{+iω i}, resamples it through the stage's banded
polyphase kernel, and rotates the tile by its base phase — no per-demod
full-rate stream is ever written to memory.
"""

from __future__ import annotations

import torch

from cubicsdr_tpu_torch.ops.kernels import build
from cubicsdr_tpu_torch.ops.resample import _windows

TWO_PI = 6.283185307179586


def choose_fused_tile(n_out: int, P: int, Q: int, lo: int = 64,
                      hi: int = 1024, target: int = 128):
    """Output tile O of the fused frontend: O % P == 0, n_out % O == 0, and
    O and S = (O//P)*Q both 128-aligned, or None.

    The alignment is the TPU kernel's rule (``cubicsdr_tpu/ops/pallas/
    route.py:choose_fused_tile``); the CUDA kernel takes any O, but the
    rule also decides which groups ``RoutedChannelFrontend.upgrade``
    fuses — and so the state layout — which must stay leaf for leaf the
    reference's. The tile also fixes the phase bookkeeping's rounding."""
    cands = [o for o in range(lo, hi + 1)
             if o % P == 0 and o % 128 == 0 and n_out % o == 0
             and ((o // P) * Q) % 128 == 0]
    return min(cands, key=lambda o: abs(o - target)) if cands else None


def _tables(omega, W: int, S: int):
    """Per-demod modulation E = e^{+i mod(ω i, 2π)} [N, W] and the split
    pre-wrapped tile increments a1 = mod(ωS, 2π), a64 = mod(64 a1, 2π)."""
    i_idx = torch.arange(W, dtype=torch.float32, device=omega.device)
    th = torch.remainder(omega[:, None] * i_idx, TWO_PI)
    a1 = torch.remainder(omega * S, TWO_PI)
    a64 = torch.remainder(64.0 * a1, TWO_PI)
    return torch.cos(th), torch.sin(th), a1, a64


def routed_shifted_resample_plain(z_re, z_im, chan_idx, e_re, e_im, pw0,
                                  a1, a64, toep, S: int, start: int):
    """Plain version: windows of the selected channels @ the banded
    Toeplitz tile matrix ``toep`` [W, O], then the tile rotation."""
    W, O = toep.shape
    total = z_re.shape[-1]
    n_rows = (total - start - W) // S + 1
    idx = chan_idx.long()

    def win(plane):
        return _windows(plane, start, n_rows, S, W)[idx]    # [N, rows, W]

    x_re, x_im = win(z_re), win(z_im)
    xm_re = x_re * e_re[:, None, :] - x_im * e_im[:, None, :]
    xm_im = x_im * e_re[:, None, :] + x_re * e_im[:, None, :]
    y_re, y_im = xm_re @ toep, xm_im @ toep                  # [N, rows, O]
    g = torch.arange(n_rows, device=z_re.device)
    hi = torch.div(g, 64, rounding_mode="floor").to(torch.float32)
    lo = (g % 64).to(torch.float32)
    phi = torch.remainder(pw0[:, None] + a64[:, None] * hi
                          + a1[:, None] * lo, TWO_PI)
    c, s = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
    out_re = y_re * c - y_im * s
    out_im = y_im * c + y_re * s
    N = chan_idx.shape[0]
    return out_re.reshape(N, n_rows * O), out_im.reshape(N, n_rows * O)


def routed_shifted_resample(z_re, z_im, chan_idx, omega, phase_w0, rs, toep):
    """z planes [M, hist + Lc] per-channel raw streams (rs.hist_len history
    prefix); chan_idx int32 [N], each in [0, M) (not checked: checking
    would synchronise with the device); omega, phase_w0 float32 [N] (phase_w0 =
    phase of the first window sample); rs the RationalResampler stage;
    toep its [W, O] tile matrix (O from ``choose_fused_tile``). Returns
    (y_re, y_im) [N, Lc//Q*P]. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/route.cu``."""
    W, O = toep.shape
    P, Q, KK = rs.P, rs.Q, rs.KK
    M, total = z_re.shape
    L = total - rs.hist_len
    n_out = L // Q * P
    if L % Q or O % P or n_out % O or W != (O // P - 1) * Q + KK:
        raise ValueError(f"tile O={O}, W={W} does not fit L={L}, P/Q="
                         f"{P}/{Q}, KK={KK}")
    S = (O // P) * Q
    start = rs.hist_len + Q - 1 - (KK - 1)
    e_re, e_im, a1, a64 = _tables(omega, W, S)
    if z_re.device.type == "cpu":
        return routed_shifted_resample_plain(
            z_re, z_im, chan_idx, e_re, e_im, phase_w0, a1, a64, toep, S,
            start)
    lib = build.load_library()
    dev = z_re.device
    f32 = torch.float32
    N = chan_idx.shape[0]
    build.require(z_re, "z_re", dev, f32)
    build.require(z_im, "z_im", dev, f32, z_re.shape)
    build.require(chan_idx, "chan_idx", dev, torch.int32, (N,))
    build.require(omega, "omega", dev, f32, (N,))
    build.require(phase_w0, "phase_w0", dev, f32, (N,))
    build.require(rs.ker, "ker", dev, f32, (P, KK))
    n_rows = n_out // O
    out_re = torch.empty((N, n_out), dtype=f32, device=dev)
    out_im = torch.empty((N, n_out), dtype=f32, device=dev)
    if N == 0 or n_rows == 0:
        return out_re, out_im
    code = lib.routed_shifted_resample_launch(
        z_re.data_ptr(), z_im.data_ptr(), total, chan_idx.data_ptr(),
        e_re.data_ptr(), e_im.data_ptr(), rs.ker.data_ptr(),
        phase_w0.data_ptr(), a1.data_ptr(), a64.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), N, n_rows, O, P, Q, KK, S, W,
        start, build.stream_ptr(z_re))
    build.check_launch(lib, code, "routed_shifted_resample_launch")
    routed_shifted_resample.launches += 1
    return out_re, out_im


routed_shifted_resample.launches = 0
