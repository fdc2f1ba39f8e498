"""Rational polyphase resampler (``cubicsdr_tpu/ops/resample.py``).

The ratio is snapped to a rational P/Q and each block of L inputs
(L % Q == 0) produces exactly L*P/Q outputs. Planar and real data run the
Toeplitz form: overlapping stride-S windows of the stream against a banded
[W, O] tap matrix, one batched matmul per stage. complex64 data runs the
JAX package's conv form: the [P, KK] polyphase kernel as one strided-Q
multi-filter convolution per plane, its P output phases interleaved.
Taps, kernels and Toeplitz matrices are built exactly as the JAX package
builds them.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from cubicsdr_tpu_torch.ops import design
from cubicsdr_tpu_torch.ops.planar import (
    PC, PLANAR, as_pc, dtype_zeros, join_like, xcat, xtail)
from cubicsdr_tpu_torch.stream.op import StreamOp
from cubicsdr_tpu_torch.utils.convolve import conv_real

MAX_DENOMINATOR = 1_000_000
TWO_PI = 6.283185307179586


def design_ratio(ratio: float, max_denominator: int = 256,
                 tol: float = 1e-3) -> tuple[int, int]:
    """Snap an arbitrary resample ratio to P/Q within relative error
    ``tol``; the denominator bound grows until the snap is within tol.
    Raises if no acceptable rational exists below MAX_DENOMINATOR."""
    if not (ratio > 0):
        raise ValueError(f"resample ratio must be positive, got {ratio}")
    md = max_denominator
    while True:
        fr = Fraction(ratio).limit_denominator(md)
        if fr.numerator > 0 and abs(float(fr) / ratio - 1.0) <= tol:
            return fr.numerator, fr.denominator
        if md >= MAX_DENOMINATOR:
            raise ValueError(
                f"cannot approximate resample ratio {ratio} to within "
                f"{tol:g} with denominator <= {MAX_DENOMINATOR}")
        md *= 10


def resampler_taps(P: int, Q: int, taps_per_phase: int = 24,
                   as_db: float = 60.0) -> np.ndarray:
    """Anti-alias/anti-image lowpass at the upsampled rate P*fs, cutoff
    min(0.5/P, 0.5/Q), gain P; length max(P, Q)*taps_per_phase."""
    L = max(P, Q) * taps_per_phase
    fc = min(0.5 / P, 0.5 / Q)
    return design.kaiser_lowpass(L, fc, as_db, gain=float(P))


def _choose_tile(n_out: int, P: int, lo: int = 64, hi: int = 512,
                 target: int = 128):
    cands = [o for o in range(lo, hi + 1) if o % P == 0 and n_out % o == 0]
    return min(cands, key=lambda o: abs(o - target)) if cands else None


@lru_cache(maxsize=None)
def _toeplitz_np(ker_key, P: int, Q: int, KK: int, O: int):
    """Banded output-tile matrix T [W, O]: y_tile[m] = sum_i w_s[i]*T[i, m]
    where m = lb*P + r and t = lb*Q + KK-1 - i indexes ker[r, t]."""
    ker = np.asarray(ker_key, np.float32).reshape(P, KK)
    S = (O // P) * Q
    W = (O // P - 1) * Q + KK
    T = np.zeros((W, O), np.float32)
    for m in range(O):
        lb, r = divmod(m, P)
        for t in range(KK):
            i = lb * Q + KK - 1 - t
            if 0 <= i < W:
                T[i, m] = ker[r, t]
    return T, S, W


class RationalResampler(StreamOp):
    """P/Q resampler over the last axis; block length must divide by Q.

    y[m] = sum_k h[k] u[m*Q - k] with u the P-upsampled (zero-stuffed)
    input — scipy.signal.upfirdn semantics with streaming state. ``dtype``
    is PLANAR, torch.complex64 or torch.float32 (real data)."""

    def __init__(self, P: int, Q: int, taps=None, batch_shape: tuple = (),
                 dtype=PLANAR, taps_per_phase: int = 24,
                 as_db: float = 60.0):
        super().__init__()
        self.P, self.Q = int(P), int(Q)
        h = resampler_taps(P, Q, taps_per_phase, as_db) if taps is None \
            else np.asarray(taps, np.float32)
        K = len(h)
        # Polyphase branches h_poly[p, j] = h[j*P + p], folded with each
        # output phase's input offset d_r into one common [P, KK] kernel
        # (see the JAX package for the derivation).
        J = int(np.ceil(K / P))
        h_poly = np.zeros((P, J), np.float32)
        for p in range(P):
            t = h[p::P]
            h_poly[p, : len(t)] = t
        KK = J + self.Q - 1
        ker = np.zeros((P, KK), np.float32)
        for r in range(P):
            phi = (r * Q) % P
            d = (r * Q) // P
            lag0 = (Q - 1) - d
            ker[r, lag0: lag0 + J] = h_poly[phi]
        self.ker_np = ker
        self.register_buffer("ker", torch.from_numpy(ker))     # [P, KK]
        self.KK = KK
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype
        # history long enough to cover max lag (KK - 1), rounded up to Q.
        self.hist_len = int(np.ceil((KK - 1) / self.Q)) * self.Q

    def toeplitz(self, O: int):
        """(T [W, O], S, W) for output tile O. T is registered as a buffer
        on first use, so it follows the op's device."""
        name = f"toep_{O}"
        if not hasattr(self, name):
            T_np, _, _ = _toeplitz_np(tuple(self.ker_np.reshape(-1).tolist()),
                                      self.P, self.Q, self.KK, O)
            self.register_buffer(name, torch.from_numpy(T_np).to(self.device))
        T = getattr(self, name)
        return T, (O // self.P) * self.Q, T.shape[0]

    def init_state(self):
        return dtype_zeros((*self.batch_shape, self.hist_len), self.dtype,
                           self.device)

    def apply(self, hist, x):
        assert x.shape[-1] % self.Q == 0, (x.shape, self.Q)
        z = xcat([hist, x])
        if isinstance(z, PC) or not z.is_complex():
            y = planar_resample_matmul(z, self)
        else:
            y = join_like(*planar_rational_resample(as_pc(z), self), z)
        return xtail(z, self.hist_len), y

    # Time-sharding: the carried state IS the input tail.
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return self.hist_len

    def shard_carry_init(self):
        return self.init_state()


# ------------------------------------------------------- multi-stage ----

def _prime_factors(n: int) -> list[int]:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def stage_plan(P: int, Q: int, max_stage: int = 64) -> list[tuple[int, int]]:
    """Decompose a P/Q resample into cascaded rational stages: Q's prime
    factors greedily packed into stages <= max_stage, P riding the first
    stage; pure upsampling stays single-stage."""
    if Q <= max_stage or P >= Q:
        return [(P, Q)]
    packs: list[int] = []
    for f in sorted(_prime_factors(Q), reverse=True):
        for i in range(len(packs)):
            if packs[i] * f <= max_stage:
                packs[i] *= f
                break
        else:
            packs.append(f)
    packs.sort(reverse=True)          # decimate hardest at the highest rate
    return [(P, packs[0])] + [(1, q) for q in packs[1:]]


class ResamplerChain(StreamOp):
    """Multi-stage P/Q resampler with the RationalResampler interface."""

    def __init__(self, P: int, Q: int, batch_shape: tuple = (),
                 dtype=PLANAR, taps_per_phase: int = 24,
                 as_db: float = 60.0, max_stage: int = 64):
        super().__init__()
        self.P, self.Q = int(P), int(Q)
        self.stages = nn.ModuleList([
            RationalResampler(p, q, batch_shape=batch_shape, dtype=dtype,
                              taps_per_phase=taps_per_phase, as_db=as_db)
            for p, q in stage_plan(self.P, self.Q, max_stage)])
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def init_state(self):
        return tuple(rs.init_state() for rs in self.stages)

    def apply(self, state, x):
        new = []
        for rs, s in zip(self.stages, state):
            s, x = rs.apply(s, x)
            new.append(s)
        return tuple(new), x

    # Time-sharding: each stage exchanges its own (intermediate) input
    # tail; every stage's local length divides its Q.
    def shard_carries(self):
        return tuple(rs.shard_carry_init() for rs in self.stages)

    def shard_apply(self, carries, x, axis):
        from cubicsdr_tpu_torch.parallel.shardable import shard_stage
        new = []
        for rs, c in zip(self.stages, carries):
            c, x = shard_stage(rs, c, x, axis)
            new.append(c)
        return tuple(new), x


class IdentityResampler(StreamOp):
    """Unity-ratio passthrough, interface-identical to RationalResampler."""

    P = Q = 1
    hist_len = 0
    shard_kind = "tail"

    def __init__(self, batch_shape: tuple = (), dtype=PLANAR):
        super().__init__()
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def init_state(self):
        return dtype_zeros((*self.batch_shape, 0), self.dtype, self.device)

    def shard_halo_len(self) -> int:
        return 0

    def shard_carry_init(self):
        return self.init_state()

    def apply(self, state, x):
        return state, x


class PlanarResampler(ResamplerChain):
    """Stateful multi-stage P/Q resampler on planar-complex (PC) or real
    float32 data, each stage in the Toeplitz form; the state is each
    stage's input history, as the JAX package's ``PlanarResampler``.
    Runs on the card unless ``device`` says otherwise.

    ``apply(state, x)`` with x: PC or real [..., L], L % Q == 0; returns
    (state, y) with y of length L*P/Q."""

    def __init__(self, P: int, Q: int, batch_shape: tuple = (),
                 complex_data: bool = True, taps_per_phase: int = 24,
                 as_db: float = 60.0, max_stage: int = 64, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PlanarResampler runs on the card by default and this host "
                "has no CUDA device; pass device='cpu' to run on the host")
        super().__init__(P, Q, batch_shape=batch_shape,
                         dtype=PLANAR if complex_data else torch.float32,
                         taps_per_phase=taps_per_phase, as_db=as_db,
                         max_stage=max_stage)
        self.complex_data = complex_data
        self.to(device)

    def out_len(self, in_len: int) -> int:
        assert in_len % self.Q == 0, (in_len, self.Q)
        return in_len // self.Q * self.P


def make_resampler(P: int, Q: int, batch_shape: tuple = (), dtype=PLANAR,
                   taps_per_phase: int = 24, as_db: float = 60.0,
                   max_stage: int = 64):
    """Single-stage RationalResampler when the ratio is mild,
    ResamplerChain when Q needs splitting, identity when unity."""
    if P == Q:
        return IdentityResampler(batch_shape=batch_shape, dtype=dtype)
    if len(stage_plan(P, Q, max_stage)) == 1:
        return RationalResampler(P, Q, batch_shape=batch_shape, dtype=dtype,
                                 taps_per_phase=taps_per_phase, as_db=as_db)
    return ResamplerChain(P, Q, batch_shape=batch_shape, dtype=dtype,
                          taps_per_phase=taps_per_phase, as_db=as_db,
                          max_stage=max_stage)


# ------------------------------------------------ Toeplitz (planar) form ----

def _windows(plane, start: int, n_rows: int, S: int, W: int):
    """Overlapping stride-S windows [..., n_rows, W] of plane[..., start:],
    zero-padded past the end (the Toeplitz rows there are zero)."""
    w = plane[..., start:]
    pad = (n_rows - 1) * S + W - w.shape[-1]
    if pad > 0:
        w = torch.nn.functional.pad(w, (0, pad))
    return w.unfold(-1, W, S)[..., :n_rows, :]


def planar_rational_resample(x, rs: RationalResampler):
    """Conv form: rs's polyphase kernel [P, KK] as a bank of P stride-Q
    true convolutions over [..., L] data (planar PC or real) prefixed with
    rs.hist_len history — complex64 data's form, and planar data's for
    output lengths no Toeplitz tile divides. Output phase r of block b
    lands at b*P + r."""
    start = rs.hist_len + rs.Q - 1 - (rs.KK - 1)

    def one_plane(z):
        y = conv_real(z[..., start:], rs.ker, stride=rs.Q)   # [..., P, T]
        return y.transpose(-1, -2).reshape(*y.shape[:-2], -1)

    if isinstance(x, PC):
        return PC(one_plane(x.re), one_plane(x.im))
    return one_plane(x)


def planar_resample_matmul(x, rs: RationalResampler):
    """Toeplitz form of the rational resampler on hist-prefixed [..., L]
    data (PC or real): one [rows, W] @ [W, O] product per plane. Falls back
    to the conv form when no tile divides the output length."""
    is_pc = isinstance(x, PC)
    L = x.shape[-1] - rs.hist_len
    n_out = L // rs.Q * rs.P
    O = _choose_tile(n_out, rs.P)
    if O is None:
        return planar_rational_resample(x, rs)
    T, S, W = rs.toeplitz(O)
    start = rs.hist_len + rs.Q - 1 - (rs.KK - 1)
    n_rows = n_out // O

    def one_plane(plane):
        y = _windows(plane, start, n_rows, S, W) @ T     # [..., rows, O]
        return y.reshape(*y.shape[:-2], n_out)

    if is_pc:
        return PC(one_plane(x.re), one_plane(x.im))
    return one_plane(x)


def planar_shifted_resample_matmul(z: PC, rs: RationalResampler, omega,
                                   phase_w0):
    """Fused NCO-shift + rational resample: the NCO's e^{+iω i} folded
    into a per-demod modulated Toeplitz matrix, then one tile rotation
    e^{+i(phase_w0 + ω r S)} per output tile — mathematically
    ``resample(nco_mix(z))``.

    z: PC [..., N, hist+L] raw stream; omega, phase_w0: [..., N].
    Returns PC [..., N, L//Q*P], or None if no tile divides the output."""
    L = z.shape[-1] - rs.hist_len
    n_out = L // rs.Q * rs.P
    O = _choose_tile(n_out, rs.P)
    if O is None:
        return None
    T, S, W = rs.toeplitz(O)
    start = rs.hist_len + rs.Q - 1 - (rs.KK - 1)
    n_rows = n_out // O
    fr_re = _windows(z.re, start, n_rows, S, W)     # [..., N, rows, W]
    fr_im = _windows(z.im, start, n_rows, S, W)
    dev = z.re.device
    omega = torch.as_tensor(omega, dtype=torch.float32, device=dev)
    phase_w0 = torch.as_tensor(phase_w0, dtype=torch.float32, device=dev)
    i_idx = torch.arange(W, dtype=torch.float32, device=dev)
    th = torch.remainder(omega[..., None] * i_idx, TWO_PI)   # [..., N, W]
    Tm_re = T * torch.cos(th)[..., :, None]                  # [..., N, W, O]
    Tm_im = T * torch.sin(th)[..., :, None]
    y_re = fr_re @ Tm_re - fr_im @ Tm_im
    y_im = fr_re @ Tm_im + fr_im @ Tm_re
    r_idx = torch.arange(n_rows, dtype=torch.float32, device=dev)
    a = torch.remainder(omega * S, TWO_PI)
    phi = torch.remainder(phase_w0[..., None] + torch.remainder(
        a[..., None] * r_idx, TWO_PI), TWO_PI)
    c, s = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
    out_re = y_re * c - y_im * s
    out_im = y_im * c + y_re * s
    shp = (*out_re.shape[:-2], n_out)
    return PC(out_re.reshape(shp), out_im.reshape(shp))
