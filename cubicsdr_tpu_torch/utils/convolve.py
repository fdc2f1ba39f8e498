"""Batched 1-D true convolution (``cubicsdr_tpu/utils/convolve.py``), the
workhorse under every FIR op, the resampler's conv form and the
channelizers' polyphase filters.

``torch.nn.functional.conv1d`` computes a correlation, so the taps are
flipped. Planar data, complex64 data and complex taps decompose into real
convolutions, as the JAX package decomposes them (rr - ii, ri + ir): a
complex tensor never reaches ``F.conv1d``, whose complex path multiplies
three times instead of four and rounds otherwise. cuDNN runs the real
convolutions in full float32 (the package turns TF32 off at import).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cubicsdr_tpu_torch.ops.planar import PC, as_pc, join_like


def conv_real(x: torch.Tensor, h: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """VALID true convolution of real x [..., L] with real taps, strided.
    h [K] returns [..., (L-K)//stride+1]; a bank h [F, K] returns
    [..., F, (L-K)//stride+1], each filter over the same x."""
    batch = x.shape[:-1]
    hk = h.flip(-1).to(x.dtype).reshape(-1, 1, h.shape[-1])
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), hk, stride=stride)
    if h.dim() == 1:
        return y.reshape(*batch, y.shape[-1])
    return y.reshape(*batch, h.shape[0], y.shape[-1])


def conv1d(x, h, stride: int = 1):
    """True convolution (VALID) along the last axis. x: real [..., L], PC
    or complex64; h: real taps [K] or complex taps as a PC of two [K]
    tensors. Complex taps on complex data take the four real convolutions
    (rr - ii, ri + ir), computed as one two-filter bank per plane; the
    result has x's representation (a PC for real x with complex taps)."""
    if torch.is_tensor(x) and x.is_complex():
        return join_like(*conv1d(as_pc(x), h, stride), x)
    if isinstance(h, PC):
        hb = torch.stack([h.re, h.im])                   # [2, K]
        if isinstance(x, PC):
            r = conv_real(x.re, hb, stride)              # (rr, ri)
            i = conv_real(x.im, hb, stride)              # (ir, ii)
            return PC(r[..., 0, :] - i[..., 1, :], r[..., 1, :] + i[..., 0, :])
        y = conv_real(x, hb, stride)
        return PC(y[..., 0, :], y[..., 1, :])
    if isinstance(x, PC):
        return PC(conv_real(x.re, h, stride), conv_real(x.im, h, stride))
    return conv_real(x, h, stride)


def conv1d_grouped(x, hs: torch.Tensor, stride: int = 1,
                   dilation: int = 1):
    """Depthwise true convolution: channel c of x [..., C, L] filtered by
    the real taps hs[c] [C, K], taps ``dilation`` samples apart. x is
    real, PC or complex64 (each plane filtered on its own). Returns
    [..., C, (L - (K-1)*dilation - 1)//stride + 1]."""
    if isinstance(x, PC):
        return PC(conv1d_grouped(x.re, hs, stride, dilation),
                  conv1d_grouped(x.im, hs, stride, dilation))
    if x.is_complex():
        return join_like(*conv1d_grouped(as_pc(x), hs, stride, dilation), x)
    batch = x.shape[:-2]
    C, L = x.shape[-2], x.shape[-1]
    w = hs.flip(-1).to(x.dtype)[:, None, :]            # [C, 1, K]
    y = F.conv1d(x.reshape(-1, C, L), w, stride=stride, dilation=dilation,
                 groups=C)
    return y.reshape(*batch, C, y.shape[-1])


def conv1d_multi(x: torch.Tensor, hs: torch.Tensor, stride: int = 1
                 ) -> torch.Tensor:
    """One real signal x [..., L] through P real filters hs [P, K] at once
    (a polyphase bank): [..., P, (L-K)//stride+1]."""
    if hs.dim() != 2:
        raise ValueError(f"hs must be [P, K], got {tuple(hs.shape)}")
    return conv_real(x, hs, stride)


def frame_signal(x: torch.Tensor, frame_len: int, hop: int
                 ) -> torch.Tensor:
    """[..., L] -> [..., n_frames, frame_len], frames ``hop`` apart (a
    view of x)."""
    return x.unfold(-1, frame_len, hop)
