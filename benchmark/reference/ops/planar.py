"""Planar complex arithmetic: IQ as two float32 tensors (re, im).

The JAX package carries IQ this way because the TPU has no complex64
(``cubicsdr_tpu/ops/planar.py``); the port keeps the same representation so
its state is leaf for leaf the reference's and the two compare directly.
Its other representation, ``torch.complex64`` tensors (the JAX package's
default), goes through the helpers here that take either kind:
``planes_of``/``join_like`` let one planes-first code path serve both.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch


class PC(NamedTuple):
    """Planar complex: two same-shape float32 tensors."""
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    def __getitem__(self, idx):
        if isinstance(idx, int):           # preserve NamedTuple field access
            return tuple.__getitem__(self, idx)
        return PC(self.re[idx], self.im[idx])

    @property
    def device(self):
        return self.re.device

    def slice_last(self, sl):
        return PC(self.re[..., sl], self.im[..., sl])


def as_pc(x) -> PC:
    """A complex tensor (or a PC) in planar form."""
    if isinstance(x, PC):
        return x
    return PC(x.real.to(torch.float32), x.imag.to(torch.float32))


def to_complex(x) -> torch.Tensor:
    """A PC (or a complex tensor) as one complex64 tensor."""
    if isinstance(x, PC):
        return torch.complex(x.re, x.im)
    return x.to(torch.complex64)


# Sentinel dtype value: ops constructed with dtype=PLANAR carry planar
# complex state/data (two float32 planes).
PLANAR = "pc"


def dtype_zeros(shape, dtype, device=None):
    """zeros() that understands the PLANAR sentinel."""
    if dtype == PLANAR:
        return PC(torch.zeros(shape, dtype=torch.float32, device=device),
                  torch.zeros(shape, dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def dtype_ones(shape, dtype, device=None):
    """ones() (1+0j for PLANAR) understanding the PLANAR sentinel."""
    if dtype == PLANAR:
        return PC(torch.ones(shape, dtype=torch.float32, device=device),
                  torch.zeros(shape, dtype=torch.float32, device=device))
    return torch.ones(shape, dtype=dtype, device=device)


def pc_concat(parts, dim=-1) -> PC:
    return PC(torch.cat([p.re for p in parts], dim=dim),
              torch.cat([p.im for p in parts], dim=dim))


def xcat(parts, dim=-1):
    """Concatenate tensors or PCs (all parts must be the same kind)."""
    if isinstance(parts[0], PC):
        return pc_concat(parts, dim=dim)
    return torch.cat(parts, dim=dim)


def xtail(z, n: int):
    """Last ``n`` samples along the last axis (tensor or PC)."""
    L = z.shape[-1]
    if isinstance(z, PC):
        return z.slice_last(slice(L - n, None))
    return z[..., L - n:]


def xslice(z, sl: slice):
    """``z[..., sl]`` for a tensor or a PC."""
    if isinstance(z, PC):
        return z.slice_last(sl)
    return z[..., sl]


def planes_of(x):
    """(re, im) float32 planes of a PC or a complex tensor — the
    planes-first idiom: kits compute on real planes, so one code path
    serves both representations."""
    if isinstance(x, PC):
        return x.re, x.im
    return x.real.to(torch.float32), x.imag.to(torch.float32)


def join_like(re, im, like):
    """Assemble planes (re, im) in the representation of ``like``."""
    if isinstance(like, PC):
        return PC(re, im)
    return torch.complex(re, im)


def pc_mul(a: PC, b: PC) -> PC:
    return PC(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def pc_mul_conj(a: PC, b: PC) -> PC:
    """a * conj(b)."""
    return PC(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def phasor_ramp_outer(theta0, omega, L: int, block: int = 512) -> PC:
    """e^{i(theta0 + omega*k)} for k in [0, L) by angle addition,
    k = a*B + b: phasor = P1[a] * P2[b], from about 2*sqrt(L) cos/sin
    evaluations, each argument wrapped mod 2*pi (the JAX package's
    ``phasor_ramp_outer``, in its float32 rounding). theta0, omega: [...]
    broadcastable; returns PC [..., L]."""
    B = block
    A = -(-L // B)
    dev = theta0.device
    a = torch.arange(A, dtype=torch.float32, device=dev) * B
    b = torch.arange(B, dtype=torch.float32, device=dev)
    two_pi = float(np.float32(2.0 * np.pi))
    th_a = torch.remainder(theta0[..., None] + omega[..., None] * a, two_pi)
    th_b = torch.remainder(omega[..., None] * b, two_pi)
    p1r, p1i = torch.cos(th_a), torch.sin(th_a)          # [..., A]
    p2r, p2i = torch.cos(th_b), torch.sin(th_b)          # [..., B]
    re = p1r[..., :, None] * p2r[..., None, :] - p1i[..., :, None] * p2i[
        ..., None, :]
    im = p1r[..., :, None] * p2i[..., None, :] + p1i[..., :, None] * p2r[
        ..., None, :]
    return PC(re.reshape(*re.shape[:-2], A * B)[..., :L],
              im.reshape(*im.shape[:-2], A * B)[..., :L])


@lru_cache(maxsize=None)
def idft_mats_np(M: int):
    """Planar M * inverse-DFT matrix (no 1/M), float32 (re, im)."""
    k = np.arange(M)
    W = np.exp(2j * np.pi * np.outer(k, k) / M)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def pc_idft_m(u: PC, w_re: torch.Tensor, w_im: torch.Tensor,
              axis_m: int = -2) -> PC:
    """M * inverse DFT along ``axis_m`` as two real matmuls against the
    planar matrix (w_re, w_im) = idft_mats_np(M), kept as buffers by the
    caller. u: [..., M, T] by default."""
    def mv(W, a):
        return torch.einsum("km,...mt->...kt", W, a.movedim(axis_m, -2))
    yr = mv(w_re, u.re) - mv(w_im, u.im)
    yi = mv(w_re, u.im) + mv(w_im, u.re)
    return PC(yr.movedim(-2, axis_m), yi.movedim(-2, axis_m))


# Minimax-ish odd polynomial for atan on [0, 1] (fit in s = r^2; float64
# fit, float32 eval; max abs error ~1e-7 rad) — the JAX package's fit,
# same degree and sample grid, so the coefficients are identical.
_ATAN_DEG = 9


@lru_cache(maxsize=None)
def _atan_coeffs():
    r = np.linspace(0, 1, 20001)[1:]
    s = r * r
    target = np.arctan(r) / r
    cheb = np.polynomial.chebyshev.Chebyshev.fit(s, target, _ATAN_DEG)
    poly = cheb.convert(kind=np.polynomial.Polynomial)
    return tuple(float(c) for c in poly.coef)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 with torch.atan2's sign/quadrant conventions for
    nonzero inputs (0,0 -> 0); max error ~1e-7 rad."""
    c = [float(np.float32(v)) for v in _atan_coeffs()]
    ax, ay = x.abs(), y.abs()
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    r = mn / mx.clamp_min(1e-37)
    s = r * r
    p = torch.full_like(s, c[-1])
    for k in range(len(c) - 2, -1, -1):
        p = p * s + c[k]
    a = p * r
    a = torch.where(ay > ax, float(np.float32(np.pi / 2)) - a, a)
    a = torch.where(x < 0, float(np.float32(np.pi)) - a, a)
    return torch.where(y < 0, -a, a)
