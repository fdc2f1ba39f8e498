"""IIR filtering without sequential loops (``cubicsdr_tpu/ops/iir.py``):
the DC blocker, first-order sections (FM de-emphasis) and cascaded biquads
(``SOSFilter``, on ``affine_scan_2nd_order``).

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
    d: [..., L] real or complex64; y_prev: [...] of d's kind. The
    coefficient is real, so complex data runs the real recurrence on each
    plane (real products only, in full float32)."""
    if d.is_complex():
        return torch.complex(
            affine_scan_1st_order(a, d.real, y_prev.real, tile),
            affine_scan_1st_order(a, d.imag, y_prev.imag, tile))
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


def affine_scan_2nd_order(m, f, s_prev):
    """Solve s[n] = M s[n-1] + [f[n], 0] with a constant 2x2 ``m`` along
    the last axis (a biquad's recurrence). f: [..., L] real or complex64;
    s_prev: [..., 2] = [y[-1], y[-2]]. Returns (y [..., L], s_last
    [..., 2]).

    A doubling scan in log2(L) passes: after the pass at distance d each
    sample holds sum over the last 2d inputs of M^(n-j) v[j], the pass
    adding M^d times the partial sum d samples back (the powers squared in
    float64, cast once each); s_prev enters as M s_prev added to v[0]. The
    JAX package runs an associative scan: the same sums, rounded in
    another order. Complex data runs the real recurrence on each plane."""
    if f.is_complex():
        yr, sr = affine_scan_2nd_order(m, f.real, s_prev.real)
        yi, si = affine_scan_2nd_order(m, f.imag, s_prev.imag)
        return torch.complex(yr, yi), torch.complex(sr, si)
    p = np.asarray(m, np.float64)
    L = f.shape[-1]
    mt = torch.as_tensor(p.T, dtype=f.dtype, device=f.device)
    v = torch.stack([f, torch.zeros_like(f)], dim=-1)          # [..., L, 2]
    v = torch.cat([v[..., :1, :] + (s_prev @ mt)[..., None, :],
                   v[..., 1:, :]], dim=-2)
    d = 1
    while d < L:
        pt = torch.as_tensor(p.T, dtype=f.dtype, device=f.device)
        v = torch.cat([v[..., :d, :], v[..., d:, :] + v[..., :-d, :] @ pt],
                      dim=-2)
        p = p @ p
        d *= 2
    return v[..., 0], v[..., -1, :]


class DCBlocker(StreamOp):
    """H(z) = (1 - z^-1) / (1 - (1-alpha) z^-1) — removes the DC spike the
    hardware leaves at the tuner center (ref: src/sdr/SDRPostThread.cpp:29,
    284). Planar or complex64 (``dtype``) data; the coefficient is real,
    so each plane runs the real recurrence (``affine_scan_1st_order``)."""

    def __init__(self, alpha: float = 0.0005, batch_shape: tuple = (),
                 dtype=PLANAR):
        super().__init__()
        self.alpha = float(alpha)
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def init_state(self):
        return (dtype_zeros(self.batch_shape, self.dtype, self.device),
                dtype_zeros(self.batch_shape, self.dtype, self.device))

    def _plane(self, x_prev, y_prev, x):
        xd = torch.cat([x_prev[..., None], x], dim=-1)
        d = xd[..., 1:] - xd[..., :-1]
        return affine_scan_1st_order(1.0 - self.alpha, d, y_prev)

    def apply(self, state, x):
        x_prev, y_prev = state
        if not isinstance(x, PC):
            y = self._plane(x_prev, y_prev, x)
            # A copy, not a view: the caller may overwrite x in place.
            return (x[..., -1].clone(), y[..., -1]), y
        yr = self._plane(x_prev.re, y_prev.re, x.re)
        yi = self._plane(x_prev.im, y_prev.im, x.im)
        # Copies, not views: the caller may overwrite x in place (the
        # pipeline writes the blocked channel 0 back into its input).
        new = (PC(x.re[..., -1].clone(), x.im[..., -1].clone()),
               PC(yr[..., -1], yi[..., -1]))
        return new, PC(yr, yi)

    # --- time-sharding: the EXACT cross-shard composition of the
    # recurrence (``compose_first_order``) on the differenced halo'd
    # input. ---
    def shard_carries(self):
        return (dtype_zeros((*self.batch_shape, 1), PLANAR, self.device),
                dtype_zeros(self.batch_shape, PLANAR, self.device))

    def shard_apply(self, carries, x: PC, axis):
        from cubicsdr_tpu_torch.parallel.halo import streaming_halo
        c_x, y_end = carries
        z, new_cx = streaming_halo(x, 1, c_x, axis)
        a = 1.0 - self.alpha
        yr, er = compose_first_order(a, z.re[..., 1:] - z.re[..., :-1],
                                     y_end.re, axis)
        yi, ei = compose_first_order(a, z.im[..., 1:] - z.im[..., :-1],
                                     y_end.im, axis)
        return (new_cx, PC(er, ei)), PC(yr, yi)


def compose_first_order(a: float, f, y_end, axis):
    """y[n] = a*y[n-1] + f[n] on one time shard of a stream split over
    ``axis``, exactly: the local scan from a zero state is affine in the
    true initial state, y[n] = y0[n] + a^{n+1} s0. Each shard publishes its
    zero-state end value E with one small all_gather; shard t builds its
    s0 from the previous block's end ``y_end`` and the E of shards before
    it. f: [..., L]; y_end: [...]. Returns (y, the block's new end value,
    the same on every shard)."""
    L = f.shape[-1]
    t, n_t = float(axis.index), float(axis.size)
    # A fill, not an upload from the host: a CUDA graph can capture it.
    a32 = torch.full((), a, dtype=torch.float32, device=f.device)
    y0 = affine_scan_1st_order(a, f, torch.zeros_like(y_end))
    F = a32 ** L                                  # decay across one shard
    Es = axis.all_gather(y0[..., -1])             # [n_t, ...]
    j = torch.arange(Es.shape[0], dtype=torch.float32, device=f.device)
    w = torch.where(j < t, F ** (t - 1.0 - j), torch.zeros_like(j))
    s0 = (F ** t) * y_end + torch.tensordot(w, Es, dims=([0], [0]))
    pw = a32 ** torch.arange(1, L + 1, dtype=torch.float32, device=f.device)
    y = y0 + pw * s0[..., None]
    w_all = F ** (n_t - 1.0 - j)
    y_end_new = (F ** n_t) * y_end + torch.tensordot(w_all, Es,
                                                      dims=([0], [0]))
    return y, y_end_new


class SOSFilter(StreamOp):
    """Cascaded biquads in scipy's sos layout [n_sections, 6] with
    streaming state; matches ``scipy.signal.sosfilt`` on the concatenated
    stream. The sections run one after another, each a numerator FIR and
    ``affine_scan_2nd_order``. Real float32 (``dtype=torch.float32``) or
    complex64 data; the coefficients are real."""

    def __init__(self, sos, batch_shape: tuple = (), dtype=torch.float32):
        super().__init__()
        sos = np.asarray(sos, np.float64)
        if sos.ndim != 2 or sos.shape[1] != 6:
            raise ValueError(f"sos must be [n_sections, 6], got "
                             f"{sos.shape}")
        self.sos = sos
        self.register_buffer("b_taps", torch.from_numpy(
            sos[:, :3].astype(np.float32)))
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def init_state(self):
        """Per section: (the last two inputs, [y[-1], y[-2]])."""
        z = (*self.batch_shape, 2)
        return tuple((torch.zeros(z, dtype=self.dtype, device=self.device),
                      torch.zeros(z, dtype=self.dtype, device=self.device))
                     for _ in range(self.sos.shape[0]))

    def apply(self, state, x):
        new_state = []
        for i, (xh, yh) in enumerate(state):
            _, _, _, _, a1, a2 = self.sos[i]
            xh, f = fir_block(xh, x, self.b_taps[i])
            x, yh = affine_scan_2nd_order([[-a1, -a2], [1.0, 0.0]], f, yh)
            new_state.append((xh, yh))
        return tuple(new_state), x


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

    # Time-sharding: the numerator's one-sample halo, then the exact
    # cross-shard composition of the recurrence.
    def shard_carries(self):
        return self.init_state()

    def shard_apply(self, carries, x, axis):
        from cubicsdr_tpu_torch.parallel.halo import streaming_halo
        c_x, y_end = carries
        z, new_cx = streaming_halo(x, 1, c_x, axis)
        _, f = fir_block(z[..., :1], z[..., 1:], self.b_taps)
        y, e = compose_first_order(-self.a[1], f, y_end, axis)
        return (new_cx, e), y
