"""Batched 1-D true convolution (``cubicsdr_tpu/utils/convolve.py``), the
workhorse under every FIR op and the resampler's conv form.

``torch.nn.functional.conv1d`` computes a correlation, so the taps are
flipped. Planar data and complex taps decompose into real convolutions;
cuDNN runs them in full float32 (the package turns TF32 off at import).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cubicsdr_tpu_torch.ops.planar import PC


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
    """True convolution (VALID) along the last axis. x: real [..., L] or
    PC; h: real taps [K] or complex taps as a PC of two [K] tensors.
    Complex taps on planar data take the four real convolutions
    (rr - ii, ri + ir), computed as one two-filter bank per plane."""
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
