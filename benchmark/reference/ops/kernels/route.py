"""Fused route + NCO shift + rational resample, plain PyTorch (a frozen
copy of the port's ``ops/kernels/route.py`` plain version and tile rule;
``routed_shifted_resample`` runs the plain version on every device)."""

from __future__ import annotations

import torch

from benchmark.reference.ops.resample import _windows

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
    """z planes [M, hist + Lc] per-channel raw streams; chan_idx [N];
    omega, phase_w0 float32 [N]; rs the RationalResampler stage; toep its
    [W, O] tile matrix. Returns (y_re, y_im) [N, Lc//Q*P]."""
    W, O = toep.shape
    P, Q, KK = rs.P, rs.Q, rs.KK
    L = z_re.shape[-1] - rs.hist_len
    n_out = L // Q * P
    if L % Q or O % P or n_out % O or W != (O // P - 1) * Q + KK:
        raise ValueError(f"tile O={O}, W={W} does not fit L={L}, P/Q="
                         f"{P}/{Q}, KK={KK}")
    S = (O // P) * Q
    start = rs.hist_len + Q - 1 - (KK - 1)
    e_re, e_im, a1, a64 = _tables(omega, W, S)
    return routed_shifted_resample_plain(
        z_re, z_im, chan_idx, e_re, e_im, phase_w0, a1, a64, toep, S, start)
