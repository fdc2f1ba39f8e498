"""Fused route + NCO shift + rational resample: the CUDA kernel's wrapper
(``csrc/route.cu``), the host layout of its taps, and its plain PyTorch
version.

Counterpart of ``cubicsdr_tpu/ops/pallas/route.py:
routed_shifted_resample_pallas``. For demod n the kernel reads channel
``chan_idx[n]`` of the per-channel planes directly, modulates each output
tile's input window by e^{+iω i}, resamples it through the stage's
polyphase kernel, and rotates the tile by its base phase — no per-demod
full-rate stream is ever written to memory. On CUDA the wrapper launches
that one kernel and nothing else: the modulation table and the tile
increments are built inside it.
"""

from __future__ import annotations

import numpy as np
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


# Unrolls the CUDA kernel is compiled for (csrc/route.cu, template U).
_UNROLLS = (8, 6, 5, 4)
# csrc/route.cu: outputs per thread, threads per block (nominal, and at
# most), and the dynamic shared memory an sm_90 block may opt into.
_R, _THREADS, _MAX_THREADS, SMEM_MAX = 8, 128, 256, 232448


def route_taps(ker: np.ndarray, Q: int):
    """The CUDA kernel's polyphase tap layout: (kp [P, Q, A] float32, U).

    With t = KK-1 - (a*Q + c), output phase r of block lb is
    y[lb] = sum_c sum_a kp[r, c, a] * xm[(lb + a)*Q + c], where
    kp[r, c, a] = ker[r, KK-1 - a*Q - c], and 0 where a*Q + c > KK-1 or
    a reaches past ceil(KK/Q) into the padding. A is ceil(KK/Q) rounded up
    to the kernel's unroll U, picked from the compiled unrolls to pad
    least (the larger on ties)."""
    P, KK = ker.shape
    a_min = -(-KK // Q)
    U = min(_UNROLLS, key=lambda u: (-(-a_min // u) * u, -u))
    A = -(-a_min // U) * U
    kp = np.zeros((P, Q, A), np.float32)
    for c in range(Q):
        for a in range(A):
            s = a * Q + c
            if s <= KK - 1:
                kp[:, c, a] = ker[:, KK - 1 - s]
    return kp, U


def route_plan(P: int, Q: int, O: int, KK: int, A: int):
    """The CUDA kernel's shared-memory plan: (TB, RS, CQ, keep_e, bytes,
    stream).

    TB tiles per batch, RS residue groups (thread groups that split a
    tile's residues and add their partial sums), CQ residue rows per pass,
    whether the E table stays resident, and whether the window streams.
    A resident window first (stream False): a resident E first; then the
    most threads (TB * RS * P * ceil(O/P / 8), counted up to 128; residue
    groups may take a block to 256 when its batch is cut short), the
    fewest passes and the most tiles per batch. The FM path (Q = 5) keeps
    8 tiles, every residue and E; NBFM (Q = 40, 64) fits one tile, split
    over 16 groups. Only where no tile's window fits (Q in the hundreds
    to thousands: RTL-SDR rates, 30.72 MS/s digital groups) does the
    window stream (stream True, TB = 1): each pass reads its CQ residue
    rows of the window from global memory and stages only those CQ rows
    of taps, so the window and the taps never reside whole. The byte
    count is the kernel's own layout (raw span of both planes, taps,
    rows or the reduction over them, E)."""
    Ob = O // P
    G = -(-Ob // _R)
    Lrow = G * _R + A
    row_stride = (Lrow + Lrow // _R + 2) // 2 * 2
    A4 = -(-A // 4) * 4
    S, W = Ob * Q, (Ob - 1) * Q + KK
    tpt = P * G
    tb0 = 1 if tpt >= _THREADS else _THREADS // tpt
    nbytes = (4 * (2 * ((3 + (tb0 - 1) * S + W + 3) // 4 * 4) + P * Q * A4)
              + 8 * ((Q * Lrow + 1) // 2 * 2 + tb0 * Q * row_stride))
    if nbytes <= SMEM_MAX:             # the whole batch fits: no search
        return tb0, 1, Q, True, nbytes, False
    for keep_e in (True, False):
        e_len = (Q * Lrow + 1) // 2 * 2 if keep_e else 0
        best = None
        for tb in range(tb0, 0, -1):
            raw_len = (3 + (tb - 1) * S + W + 3) // 4 * 4
            fixed = 4 * (2 * raw_len + P * Q * A4) + 8 * e_len
            cq = min(Q, (SMEM_MAX - fixed) // (8 * tb * row_stride))
            # Residue groups fill the block back to 128 threads, or to 256
            # where one tile's 16 or so threads are all a batch holds.
            cap = _MAX_THREADS if tb < tb0 else _THREADS
            for rs in range(min(cap // (tb * tpt), cq), 0, -1):
                rows = max(tb * cq * row_stride, (rs - 1) * _R * tb * tpt)
                nbytes = fixed + 8 * rows
                if nbytes <= SMEM_MAX:
                    key = (min(tb * rs * tpt, _THREADS), -(-Q // cq), tb)
                    if best is None or key[0] > best[0][0] or (
                            key[0] == best[0][0] and key[1] < best[0][1]):
                        best = (key, (tb, rs, cq, keep_e, nbytes, False))
                    break
        if best is not None:
            return best[1]
    # Streaming: one tile per batch, the most residue groups (up to 256
    # threads), then the most residues per pass.
    for keep_e in (True, False):
        e_len = (Q * Lrow + 1) // 2 * 2 if keep_e else 0
        room = SMEM_MAX - 8 * e_len
        for rs in range(min(_MAX_THREADS // tpt, Q), 0, -1):
            red = (rs - 1) * _R * tpt
            cq = min(Q, room // (4 * P * A4 + 8 * row_stride))
            while cq >= rs and (4 * P * cq * A4
                                + 8 * max(cq * row_stride, red)) > room:
                cq -= 1
            if cq >= rs:
                nbytes = (4 * P * cq * A4
                          + 8 * (max(cq * row_stride, red) + e_len))
                return 1, rs, cq, keep_e, nbytes, True
    raise ValueError(f"route {P}/{Q} with O={O}, KK={KK}: one tile's "
                     f"residue rows do not fit the kernel's shared memory")


def _taps_buffer(rs):
    """The stage's ``route_taps`` layout as a buffer on ``rs`` (built once
    per resampler, follows its device) and its unroll U."""
    if not hasattr(rs, "route_taps"):
        kp, U = route_taps(rs.ker_np, rs.Q)
        rs.register_buffer("route_taps", torch.from_numpy(kp).to(rs.device))
        rs.route_unroll = U
    return rs.route_taps, rs.route_unroll


def routed_shifted_resample(z_re, z_im, chan_idx, omega, phase_w0, rs, toep):
    """z planes [M, hist + Lc] per-channel raw streams (rs.hist_len history
    prefix); chan_idx int32 [N], each in [0, M) (not checked: checking
    would synchronise with the device); omega, phase_w0 float32 [N] (phase_w0 =
    phase of the first window sample); rs the RationalResampler stage;
    toep its [W, O] tile matrix (O from ``choose_fused_tile``). Returns
    (y_re, y_im) [N, Lc//Q*P]. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/route.cu`` (one launch, no other device work)."""
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
    if z_re.device.type == "cpu":
        e_re, e_im, a1, a64 = _tables(omega, W, S)
        return routed_shifted_resample_plain(
            z_re, z_im, chan_idx, e_re, e_im, phase_w0, a1, a64, toep, S,
            start)
    lib = build.load_library()
    dev = z_re.device
    f32 = torch.float32
    N = chan_idx.shape[0]
    build.require(z_re, "z_re", dev, f32, align=16)
    build.require(z_im, "z_im", dev, f32, z_re.shape, align=16)
    build.require(chan_idx, "chan_idx", dev, torch.int32, (N,))
    build.require(omega, "omega", dev, f32, (N,))
    build.require(phase_w0, "phase_w0", dev, f32, (N,))
    taps, U = _taps_buffer(rs)
    build.require(taps, "route_taps", dev, f32)
    n_rows = n_out // O
    tb, rs_groups, cq, keep_e, _, stream = route_plan(P, Q, O, KK,
                                                      taps.shape[-1])
    out_re = torch.empty((N, n_out), dtype=f32, device=dev)
    out_im = torch.empty((N, n_out), dtype=f32, device=dev)
    if N == 0 or n_rows == 0:
        return out_re, out_im
    code = lib.routed_shifted_resample_launch(
        z_re.data_ptr(), z_im.data_ptr(), total, chan_idx.data_ptr(),
        omega.data_ptr(), phase_w0.data_ptr(), taps.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), N, n_rows, O, P, Q,
        taps.shape[-1], U, S, W, start, tb, rs_groups, cq, int(keep_e),
        int(stream), build.stream_ptr(z_re))
    build.check_launch(lib, code, "routed_shifted_resample_launch")
    routed_shifted_resample.launches += 1
    return out_re, out_im


routed_shifted_resample.launches = 0
