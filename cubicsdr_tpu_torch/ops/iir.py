"""DC blocker as a blocked-exact first-order recurrence
(``cubicsdr_tpu/ops/iir.py``).

y[n] = a*y[n-1] + d[n] runs without a sequential loop: within each tile of
T samples the zero-state response is ONE [T, T] lower-triangular product
(A[j, i] = a^(i-j)), the carry between tiles is a second, small
lower-triangular product over the n_tiles tile-end values
(C[u, t] = (a^T)^(t-u)), and the carry folds back into each tile as a
rank-1 update. Both matrices are built in float64 and cast, as the JAX
package builds A.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.planar import PC, PLANAR, dtype_zeros
from cubicsdr_tpu_torch.stream.op import StreamOp


@lru_cache(maxsize=None)
def _lower_powers_np(a: float, n: int) -> np.ndarray:
    """[n, n] with M[j, i] = a^(i-j) for i >= j, else 0 (float64 build)."""
    i = np.arange(n)
    e = (i[None, :] - i[:, None]).astype(np.float64)
    return np.where(e >= 0, np.power(a, e, where=e >= 0), 0.0
                    ).astype(np.float32)


def affine_scan_1st_order(d, y_prev, A, pw, C, cp):
    """Solve y[n] = a*y[n-1] + d[n] (y[-1] = y_prev) in blocked form.

    d: [..., L]; y_prev: [...]. A: [T, T] tile response; pw: [T] =
    a^(1..T); C: [n_tiles, n_tiles] with C[u, t] = (a^T)^(t-u); cp:
    [n_tiles] = (a^T)^(1..n_tiles), n_tiles = ceil(L/T)."""
    L = d.shape[-1]
    T = A.shape[0]
    n_tiles = C.shape[0]
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

    def __init__(self, alpha: float = 0.0005, batch_shape: tuple = (),
                 tile: int = 256):
        super().__init__()
        self.alpha = float(alpha)
        self.batch_shape = tuple(batch_shape)
        a = 1.0 - self.alpha
        self.register_buffer("tile_resp",
                             torch.from_numpy(_lower_powers_np(a, tile)))
        a32 = np.float32(a)
        self.register_buffer("tile_pow", torch.from_numpy(
            a32 ** np.arange(1, tile + 1, dtype=np.float32)))
        self._a_tile = float(a32 ** np.float32(tile))

    def _carry_mats(self, n_tiles: int):
        """(C, cp) for n_tiles tiles, registered as buffers on first use."""
        name = f"carry_{n_tiles}"
        if not hasattr(self, name):
            aT = self._a_tile
            self.register_buffer(name, torch.from_numpy(
                _lower_powers_np(aT, n_tiles)).to(self.device))
            self.register_buffer(name + "_pow", torch.from_numpy(
                (np.float64(aT) ** np.arange(1, n_tiles + 1)
                 ).astype(np.float32)).to(self.device))
        return getattr(self, name), getattr(self, name + "_pow")

    def init_state(self):
        return (dtype_zeros(self.batch_shape, PLANAR, self.device),   # x[-1]
                dtype_zeros(self.batch_shape, PLANAR, self.device))   # y[-1]

    def _plane(self, x_prev, y_prev, x):
        xd = torch.cat([x_prev[..., None], x], dim=-1)
        d = xd[..., 1:] - xd[..., :-1]
        T = self.tile_resp.shape[0]
        C, cp = self._carry_mats(-(-x.shape[-1] // T))
        return affine_scan_1st_order(d, y_prev, self.tile_resp,
                                     self.tile_pow, C, cp)

    def apply(self, state, x: PC):
        x_prev, y_prev = state
        yr = self._plane(x_prev.re, y_prev.re, x.re)
        yi = self._plane(x_prev.im, y_prev.im, x.im)
        # Copies, not views: the caller may overwrite x in place (the
        # pipeline writes the blocked channel 0 back into its input).
        new = (PC(x.re[..., -1].clone(), x.im[..., -1].clone()),
               PC(yr[..., -1], yi[..., -1]))
        return new, PC(yr, yi)
