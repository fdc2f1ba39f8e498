"""IIR filtering without sequential loops (``cubicsdr_tpu/ops/iir.py``):
the DC blocker and first-order sections (FM de-emphasis).

y[n] = a*y[n-1] + d[n] runs in blocked form: within each tile of T
samples the zero-state response is ONE [T, T] lower-triangular product
(A[j, i] = a^(i-j)), the carry between tiles is a second, small
lower-triangular product over the n_tiles tile-end values
(C[u, t] = (a^T)^(t-u)), and the carry folds back into each tile as a
rank-1 update. Blocks shorter than two tiles are one tile of their own
length (the JAX package runs its associative scan there: the same
recurrence, rounded differently). The matrices are built in float64 and
cast, as the JAX package builds A, once per (a, shape, device).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.fir import fir_block
from cubicsdr_tpu_torch.ops.planar import PC, PLANAR, dtype_zeros
from cubicsdr_tpu_torch.stream.op import StreamOp


@lru_cache(maxsize=None)
def _lower_powers_np(a: float, n: int) -> np.ndarray:
    """[n, n] with M[j, i] = a^(i-j) for i >= j, else 0 (float64 build)."""
    i = np.arange(n)
    e = (i[None, :] - i[:, None]).astype(np.float64)
    return np.where(e >= 0, np.power(a, e, where=e >= 0), 0.0
                    ).astype(np.float32)


@lru_cache(maxsize=None)
def _scan_consts(a: float, T: int, n_tiles: int, device: str):
    """(A [T, T], pw [T] = a^(1..T), C [n, n], cp [n] = (a^T)^(1..n)) on
    ``device`` for the blocked recurrence."""
    a32 = np.float32(a)
    aT = float(a32 ** np.float32(T))
    consts = (_lower_powers_np(a, T),
              a32 ** np.arange(1, T + 1, dtype=np.float32),
              _lower_powers_np(aT, n_tiles),
              (np.float64(aT) ** np.arange(1, n_tiles + 1)).astype(
                  np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device)
                 for c in consts)


def affine_scan_1st_order(a: float, d, y_prev, tile: int = 256):
    """Solve y[n] = a*y[n-1] + d[n] (y[-1] = y_prev) along the last axis.
    d: [..., L]; y_prev: [...]."""
    L = d.shape[-1]
    T = tile if L >= 2 * tile else L
    n_tiles = -(-L // T)
    A, pw, C, cp = _scan_consts(float(a), T, n_tiles, str(d.device))
    pad = n_tiles * T - L
    dp = torch.nn.functional.pad(d, (0, pad)) if pad else d
    dt = dp.reshape(*d.shape[:-1], n_tiles, T)
    y0 = dt @ A                                       # zero-state per tile
    E = y0[..., -1]                                   # [..., n_tiles]
    s_end = E @ C + cp * y_prev[..., None]            # carry AFTER tile t
    s_in = torch.cat([y_prev[..., None], s_end[..., :-1]], dim=-1)
    y = y0 + s_in[..., None] * pw
    y = y.reshape(*d.shape[:-1], n_tiles * T)
    return y[..., :L] if pad else y


class DCBlocker(StreamOp):
    """H(z) = (1 - z^-1) / (1 - (1-alpha) z^-1) — removes the DC spike the
    hardware leaves at the tuner center (ref: src/sdr/SDRPostThread.cpp:29,
    284). Planar only."""

    def __init__(self, alpha: float = 0.0005, batch_shape: tuple = ()):
        super().__init__()
        self.alpha = float(alpha)
        self.batch_shape = tuple(batch_shape)

    def init_state(self):
        return (dtype_zeros(self.batch_shape, PLANAR, self.device),   # x[-1]
                dtype_zeros(self.batch_shape, PLANAR, self.device))   # y[-1]

    def _plane(self, x_prev, y_prev, x):
        xd = torch.cat([x_prev[..., None], x], dim=-1)
        d = xd[..., 1:] - xd[..., :-1]
        return affine_scan_1st_order(1.0 - self.alpha, d, y_prev)

    def apply(self, state, x: PC):
        x_prev, y_prev = state
        yr = self._plane(x_prev.re, y_prev.re, x.re)
        yi = self._plane(x_prev.im, y_prev.im, x.im)
        # Copies, not views: the caller may overwrite x in place (the
        # pipeline writes the blocked channel 0 back into its input).
        new = (PC(x.re[..., -1].clone(), x.im[..., -1].clone()),
               PC(yr[..., -1], yi[..., -1]))
        return new, PC(yr, yi)


class FirstOrderIIR(StreamOp):
    """y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1] on real data (FM de-emphasis,
    ref: src/modules/modem/analog/ModemFMStereo.cpp:271-288)."""

    def __init__(self, b, a, batch_shape: tuple = ()):
        super().__init__()
        b = np.asarray(b, np.float64)
        a = np.asarray(a, np.float64)
        assert b.shape == (2,) and a.shape == (2,) and a[0] == 1.0
        self.b, self.a = b, a
        self.register_buffer("b_taps", torch.from_numpy(
            b.astype(np.float32)))
        self.batch_shape = tuple(batch_shape)

    def init_state(self):
        return (torch.zeros((*self.batch_shape, 1), device=self.device),
                torch.zeros(self.batch_shape, device=self.device))

    def apply(self, state, x):
        xh, y_prev = state
        xh, f = fir_block(xh, x, self.b_taps)
        y = affine_scan_1st_order(-self.a[1], f, y_prev)
        return (xh, y[..., -1]), y
