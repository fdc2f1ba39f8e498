"""Fused route + NCO + resample: the CUDA kernel's plain version (the
wrapper on CPU tensors) vs the JAX package's Pallas kernel in interpret
mode, atol 5e-5 as tests/test_fused_route.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.ops.pallas.route import (  # noqa: E402
    routed_shifted_resample_pallas)
from cubicsdr_tpu.ops.planar import PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.ops.resample import (  # noqa: E402
    RationalResampler as JRationalResampler)

from cubicsdr_tpu_torch.ops.kernels.route import (  # noqa: E402
    choose_fused_tile, routed_shifted_resample)
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.ops.resample import (  # noqa: E402
    RationalResampler, planar_shifted_resample_matmul)


def _case(rng, M, N, chan_idx=None, Lc=5 * 128 * 8 * 5):
    rs = RationalResampler(1, 5, batch_shape=(N,))
    z = rng.standard_normal((2, M, rs.hist_len + Lc)).astype(np.float32)
    if chan_idx is None:
        chan_idx = rng.integers(0, M, N)
    chan_idx = np.asarray(chan_idx, np.int32)
    omega = rng.uniform(-0.5, 0.5, N).astype(np.float32)
    phase0 = rng.uniform(0, 6.28, N).astype(np.float32)
    phase_w0 = np.mod(phase0 + omega * (rs.Q - rs.KK),
                      2 * np.pi).astype(np.float32)
    return rs, z, chan_idx, omega, phase_w0


def _port(rs, z, chan_idx, omega, phase_w0):
    n_out = (z.shape[-1] - rs.hist_len) // rs.Q * rs.P
    O = choose_fused_tile(n_out, rs.P, rs.Q)
    yr, yi = routed_shifted_resample(
        torch.from_numpy(z[0]), torch.from_numpy(z[1]),
        torch.from_numpy(chan_idx), torch.from_numpy(omega),
        torch.from_numpy(phase_w0), rs, rs.toeplitz(O)[0])
    return yr.numpy(), yi.numpy()


def _pallas(z, chan_idx, omega, phase_w0, N):
    rsj = JRationalResampler(1, 5, batch_shape=(N,), dtype=JPLANAR)
    yr, yi = routed_shifted_resample_pallas(
        jnp.asarray(z[0]), jnp.asarray(z[1]), jnp.asarray(chan_idx),
        jnp.asarray(omega), jnp.asarray(phase_w0), rsj, interpret=True)
    return np.asarray(yr), np.asarray(yi)


@pytest.mark.parametrize("N,chan_idx", [
    (24, None),
    # N not a multiple of 8, every channel repeated or skipped.
    (13, [3, 3, 0, 15, 3, 7, 7, 0, 15, 15, 1, 3, 0]),
])
def test_plain_matches_pallas(rng, N, chan_idx):
    M = 16
    rs, z, ci, omega, pw0 = _case(rng, M, N, chan_idx)
    yr, yi = _port(rs, z, ci, omega, pw0)
    assert yr.shape == (N, (z.shape[-1] - rs.hist_len) // 5)
    pr, pi = _pallas(z, ci, omega, pw0, N)
    np.testing.assert_allclose(yr, pr, atol=5e-5)
    np.testing.assert_allclose(yi, pi, atol=5e-5)


def test_plain_matches_gathered_folded_matmul(rng):
    """Routing inside the kernel == gather, then the port's folded
    NCO+resample matmul on the per-demod streams."""
    M, N = 16, 9
    rs, z, ci, omega, pw0 = _case(rng, M, N, Lc=5 * 128 * 6)
    yr, yi = _port(rs, z, ci, omega, pw0)
    zg = z[:, ci, :]
    ref = planar_shifted_resample_matmul(
        PC(torch.from_numpy(zg[0]), torch.from_numpy(zg[1])), rs,
        torch.from_numpy(omega), torch.from_numpy(pw0))
    np.testing.assert_allclose(yr, ref.re.numpy(), atol=5e-5)
    np.testing.assert_allclose(yi, ref.im.numpy(), atol=5e-5)


def test_fused_tile_rule_is_the_reference_rule():
    from cubicsdr_tpu.ops.pallas.route import choose_fused_tile as j_choose
    for n_out in (25600, 6400, 88000, 1000, 12800):
        for P, Q in ((1, 5), (1, 4), (2, 3), (6, 25)):
            assert choose_fused_tile(n_out, P, Q) == j_choose(n_out, P, Q)


def _kernel_order(rs, z, chan_idx, omega, phase_w0):
    """The CUDA kernel's arithmetic, in its order, from the host layouts it
    reads (``route_taps``, ``route_plan``): modulate each tile window by E,
    split it into Q stride-Q sub-streams; residue group k accumulates
    kp[r, c, a] * x_c[lb + a] over its residues (every RS-th row of each
    pass of CQ rows), then a; the groups' sums are added in group order,
    and each tile is rotated by its phase."""
    from cubicsdr_tpu_torch.ops.kernels.route import (
        _tables, route_plan, route_taps)
    from cubicsdr_tpu_torch.ops.resample import _windows
    P, Q, KK = rs.P, rs.Q, rs.KK
    Lc = z.shape[-1] - rs.hist_len
    O = choose_fused_tile(Lc // Q * P, P, Q)
    Ob, S = O // P, (O // P) * Q
    W = (Ob - 1) * Q + KK
    start = rs.hist_len + Q - 1 - (KK - 1)
    n_rows = Lc // Q * P // O
    om = torch.from_numpy(omega)
    e_re, e_im, a1, a64 = _tables(om, W, S)
    idx = torch.from_numpy(chan_idx).long()
    w_re = _windows(torch.from_numpy(z[0]), start, n_rows, S, W)[idx]
    w_im = _windows(torch.from_numpy(z[1]), start, n_rows, S, W)[idx]
    xm_re = w_re * e_re[:, None] - w_im * e_im[:, None]     # [N, rows, W]
    xm_im = w_im * e_re[:, None] + w_re * e_im[:, None]
    kp, U = route_taps(rs.ker_np, Q)
    A = kp.shape[-1]
    assert A % U == 0 and A >= -(-KK // Q)
    kp = torch.from_numpy(kp)
    Lrow = Ob + A
    pad = Lrow * Q - W
    xm_re = torch.nn.functional.pad(xm_re, (0, pad))
    xm_im = torch.nn.functional.pad(xm_im, (0, pad))
    N = len(chan_idx)
    _, RS, CQ, _, _, _ = route_plan(P, Q, O, KK, A)
    groups = []
    for k in range(RS):
        acc_re = torch.zeros((N, n_rows, P, Ob))
        acc_im = torch.zeros((N, n_rows, P, Ob))
        for c0 in range(0, Q, CQ):
            for c in range(c0 + k, min(Q, c0 + CQ), RS):
                xc_re = xm_re[..., c::Q]                      # [N, rows, Lrow]
                xc_im = xm_im[..., c::Q]
                for a in range(A):
                    t = kp[:, c, a][:, None]                  # [P, 1]
                    acc_re = acc_re + t * xc_re[..., None, a:a + Ob]
                    acc_im = acc_im + t * xc_im[..., None, a:a + Ob]
        groups.append((acc_re, acc_im))
    acc_re, acc_im = groups[0]
    for g_re, g_im in groups[1:]:
        acc_re, acc_im = acc_re + g_re, acc_im + g_im
    g = torch.arange(n_rows)
    phi = torch.remainder(
        torch.from_numpy(phase_w0)[:, None]
        + a64[:, None] * torch.div(g, 64, rounding_mode="floor").float()
        + a1[:, None] * (g % 64).float(), 6.283185307179586)
    c_, s_ = torch.cos(phi)[..., None, None], torch.sin(phi)[..., None, None]
    y_re = acc_re * c_ - acc_im * s_
    y_im = acc_im * c_ + acc_re * s_
    # [N, rows, P, Ob] -> output index lb*P + r within each tile.
    return (y_re.transpose(-1, -2).reshape(N, -1).numpy(),
            y_im.transpose(-1, -2).reshape(N, -1).numpy())


@pytest.mark.parametrize("P,Q,Lc", [(1, 5, 5 * 128 * 8), (2, 5, 640 * 8),
                                    (1, 4, 4 * 128 * 10), (3, 5, 640 * 8),
                                    (1, 40, 40 * 128 * 2),
                                    (3, 50, 50 * 128 * 2),
                                    (1, 50, 50 * 128 * 2),
                                    (1, 2, 2 * 128 * 8),
                                    (1, 25, 25 * 128 * 2),
                                    (1, 20, 20 * 128 * 2),
                                    (1, 32, 32 * 128 * 2),
                                    (5, 8, 8 * 128 * 2)])
def test_kernel_layout_matches_plain(rng, P, Q, Lc):
    """The CUDA kernel's polyphase tap layout, evaluated in its summation
    order, equals the plain version (route 1/5 on the main path, 2/5 with
    two output phases, 1/4 with even Q, 3/5 with a tap count the kernel
    walks in a runtime loop, 1/40 at NBFM's shape, whose residues the
    kernel splits over 16 thread groups; scan58's AM stage 3/50 at O=384,
    through the runtime loop with 5 residue groups, and its CW/BPSK stage
    1/50 with 1,249 taps; the stages only the critically sampled 'pfbch'
    mode fuses: 1/2 with 8 tiles per batch, 1/25 with its 219 KB plan,
    1/20 and 1/32 with 4 and 8 residue groups, and 5/8 at O=640 through
    the runtime loop), atol 5e-5."""
    N, M = 16, 16
    rs = RationalResampler(P, Q, batch_shape=(N,))
    z = rng.standard_normal((2, M, rs.hist_len + Lc)).astype(np.float32)
    ci = (np.arange(N) * 7 % M).astype(np.int32)
    omega = rng.uniform(-1.5, 1.5, N).astype(np.float32)
    pw0 = rng.uniform(0, 6.28, N).astype(np.float32)
    kr, ki = _kernel_order(rs, z, ci, omega, pw0)
    yr, yi = _port(rs, z, ci, omega, pw0)
    assert kr.shape == yr.shape == (N, Lc // Q * P)
    np.testing.assert_allclose(kr, yr, atol=5e-5)
    np.testing.assert_allclose(ki, yi, atol=5e-5)


def test_route_taps_hold_every_tap_once():
    """Each kernel tap appears exactly once in the layout, at
    kp[r, c, a] with a*Q + c = KK-1-t; the padding is zero."""
    from cubicsdr_tpu_torch.ops.kernels.route import route_taps
    for P, Q in ((1, 5), (2, 5), (1, 4), (6, 25), (3, 2)):
        rs = RationalResampler(P, Q)
        kp, U = route_taps(rs.ker_np, Q)
        KK = rs.KK
        assert kp.shape[:2] == (P, Q) and kp.shape[2] % U == 0
        back = np.zeros_like(rs.ker_np)
        for c in range(Q):
            for a in range(kp.shape[2]):
                s = a * Q + c
                if s <= KK - 1:
                    back[:, KK - 1 - s] = kp[:, c, a]
                else:
                    assert not kp[:, c, a].any()
        np.testing.assert_array_equal(back, rs.ker_np)


def _default_bandwidths():
    from cubicsdr_tpu_torch.modems import make_modem, modem_names
    # Each modem at its default bandwidth, and BPSK at scan58's 20 kHz.
    return [(n, make_modem(n).default_sample_rate) for n in modem_names()
            ] + [("BPSK", 20000)]


# The exact plan (tb, groups, cq, threads) of every fused first stage
# (P, Q, O) with Q > 5 that a registered modem reaches at 2.4-20 MS/s, in
# either channelizer mode (tests/test_torch_channel_modes.py checks
# 'pfbch').
_WIDE_Q_PLANS = {
    (1, 40, 128): (1, 16, 40, 256),   # NBFM at 8 MS/s, BPSK 20 kHz at 2.4
    (1, 64, 128): (1, 16, 49, 256),   # NBFM at 2.4 MS/s
    (1, 50, 128): (1, 16, 50, 256),   # CW, BPSK 20 kHz (scan58)
    (3, 50, 384): (1, 5, 50, 240),    # AM (scan58), I/Q at 2.4 MS/s
    (6, 25, 768): (1, 1, 25, 96),     # I/Q
    (5, 16, 640): (1, 1, 16, 80),     # FMS at 2.4 MS/s
    (3, 25, 384): (2, 1, 25, 96),     # FSK, GMSK at 2.4 MS/s
    # Only the critically sampled 'pfbch' mode fuses these.
    (1, 25, 128): (3, 5, 25, 240),    # BPSK 20 kHz at 8 MS/s
    (1, 20, 128): (4, 4, 20, 256),    # BPSK 20 kHz at 2.4 MS/s
    (1, 32, 128): (2, 8, 32, 256),    # NBFM at 2.4 MS/s
    (5, 8, 640): (1, 1, 8, 80),       # FMS 250 kHz at 2.4 MS/s
}


@pytest.mark.parametrize("modem,bandwidth", _default_bandwidths())
def test_route_plan_fits_every_fused_group(modem, bandwidth):
    """Every group the pipeline fuses, for every registered modem at its
    default bandwidth and at common SDR rates, gets a shared-memory plan
    within the 227 KB an sm_90 block may hold; the FM path keeps its whole
    batch of 8 tiles, every residue and the E table; NBFM (first stage
    1/40 or 1/64) is fused, fits, and fills 256 threads with residue
    groups; every other stage with Q > 5 (AM's 3/50 at O=384, CW/BPSK's
    1/50, ...) gets its own exact plan."""
    from cubicsdr_tpu_torch.ops.kernels.route import (
        SMEM_MAX, route_plan, route_taps)
    from cubicsdr_tpu_torch.receiver import (
        DemodGroupSpec, ReceiverPipeline)
    fused = set()
    for fs in (2_400_000, 8_000_000, 10_000_000, 20_000_000):
        rx = ReceiverPipeline(fs, [DemodGroupSpec(modem, bandwidth, 2)],
                              device="cpu")
        for fe, f in zip(rx.frontends, rx.fused_route):
            if not f:
                continue
            rs = fe._stage1
            kp, _ = route_taps(rs.ker_np, rs.Q)
            tb, groups, cq, keep_e, nbytes, stream = route_plan(
                rs.P, rs.Q, fe.tile, rs.KK, kp.shape[-1])
            assert nbytes <= SMEM_MAX and 1 <= groups <= cq <= rs.Q
            assert not stream
            threads = tb * groups * rs.P * -(-fe.tile // rs.P // 8)
            assert keep_e
            if rs.Q <= 5:
                assert (groups, cq, threads) == (1, rs.Q, 128)
            else:
                if modem in ("FM", "NBFM"):
                    assert tb == 1 and threads == 256
                key = (rs.P, rs.Q, fe.tile)
                assert (tb, groups, cq, threads) == _WIDE_Q_PLANS[key], key
            fused.add((rs.P, rs.Q, fe.tile))
    expect = {("FM", 200000): {(1, 5, 128)},
              ("NBFM", 12500): {(1, 40, 128), (1, 64, 128)},
              ("AM", 6000): {(3, 50, 384)},
              ("CW", 500): {(1, 50, 128)},
              ("BPSK", 20000): {(1, 50, 128)},
              ("DSB", 5400): set()}
    if (modem, bandwidth) in expect:
        want = expect[(modem, bandwidth)]
        assert want <= fused if want else not fused, fused


# Every plan ``route_plan`` gave before the streaming mode existed, as it
# gave it: (TB, RS, CQ, keep_e, bytes) for each stage (P, Q, O) of the
# tests above and of chip_smoke.py.
_RESIDENT_PLANS = {
    (1, 5, 128): (8, 1, 5, True, 104320), (2, 5, 256): (4, 1, 5, True, 53280),
    (1, 4, 128): (8, 1, 4, True, 83456), (3, 5, 384): (2, 1, 5, True, 29312),
    (6, 25, 768): (1, 1, 25, True, 87840),
    (1, 40, 128): (1, 16, 40, True, 157792),
    (1, 64, 128): (1, 16, 49, True, 231568),
    (1, 50, 128): (1, 16, 50, True, 197232),
    (3, 50, 384): (1, 5, 50, True, 179232),
    (5, 16, 640): (1, 1, 16, True, 56192),
    (3, 25, 384): (2, 1, 25, True, 146432),
    (1, 25, 128): (3, 5, 25, True, 219440),
    (1, 20, 128): (4, 4, 20, True, 223872),
    (1, 32, 128): (2, 8, 32, True, 203552),
    (5, 8, 640): (1, 1, 8, True, 28128), (1, 2, 128): (8, 1, 2, True, 41744),
    (1, 128, 128): (1, 16, 44, False, 231264),
    (2, 3, 384): (2, 1, 3, True, 26128)}


def _plan_of(P, Q, O):
    from cubicsdr_tpu_torch.ops.kernels.route import route_plan, route_taps
    rs = RationalResampler(P, Q)
    kp, _ = route_taps(rs.ker_np, Q)
    return rs, route_plan(P, Q, O, rs.KK, kp.shape[-1])


def test_resident_plans_are_unchanged():
    """Every plan that fitted before the streaming mode is still the plan,
    field for field, with the window resident."""
    for (P, Q, O), want in _RESIDENT_PLANS.items():
        assert _plan_of(P, Q, O)[1] == (*want, False), (P, Q, O)


# The stages that no resident plan fits (the RTL-SDR's 1.024, 1.4 and
# 2.56 MS/s, and the digital modems at 30.72 MS/s), with the channel
# length the pipeline gives them and their exact streaming plan
# (TB, RS, CQ, keep_e, bytes, stream).
_STREAMING = {
    (3, 307, 384): (196480, (1, 5, 166, False, 231072, True)),
    (1, 467, 128): (59776, (1, 16, 154, False, 231616, True)),
    (2, 467, 256): (59776, (1, 8, 163, False, 232112, True)),
    (2, 3413, 256): (436864, (1, 8, 163, False, 232112, True)),
    (4, 317, 512): (40576, (1, 4, 170, False, 231200, True)),
}


@pytest.mark.parametrize("P,Q,O", list(_STREAMING))
def test_streaming_plan_for_wide_windows(P, Q, O):
    """Where one tile's window (41,751-477,819 floats per plane) cannot be
    resident, the plan streams it: one tile per batch, E computed per
    pass, CQ residue rows and their taps per pass, within the 227 KB an
    sm_90 block may hold; the tile is still the reference's."""
    from cubicsdr_tpu_torch.ops.kernels.route import SMEM_MAX
    chan_len, want = _STREAMING[(P, Q, O)]
    assert choose_fused_tile(chan_len // Q * P, P, Q) == O
    rs, plan = _plan_of(P, Q, O)
    assert (O // P - 1) * Q + rs.KK > SMEM_MAX // 8
    assert plan == want
    tb, groups, cq, _, nbytes, stream = plan
    assert stream and tb == 1 and nbytes <= SMEM_MAX
    assert 1 <= groups <= cq <= Q


def _direct(rs, z, chan_idx, omega, phase_w0, O):
    """The routed resample straight from its definition, without the tile
    matrix: y[lb*P + r] = sum_t ker[r, t] * xm[lb*Q + KK-1-t] over each
    modulated window, then the tile rotation (for the stage whose tile
    matrix would take 489 MB)."""
    from cubicsdr_tpu_torch.ops.kernels.route import _tables
    from cubicsdr_tpu_torch.ops.resample import _windows
    P, Q, KK = rs.P, rs.Q, rs.KK
    Lc = z.shape[-1] - rs.hist_len
    Ob, S = O // P, (O // P) * Q
    W = (Ob - 1) * Q + KK
    start = rs.hist_len + Q - 1 - (KK - 1)
    n_rows = Lc // Q * P // O
    e_re, e_im, a1, a64 = _tables(torch.from_numpy(omega), W, S)
    idx = torch.from_numpy(chan_idx).long()
    w_re = _windows(torch.from_numpy(z[0]), start, n_rows, S, W)[idx]
    w_im = _windows(torch.from_numpy(z[1]), start, n_rows, S, W)[idx]
    xm_re = w_re * e_re[:, None] - w_im * e_im[:, None]
    xm_im = w_im * e_re[:, None] + w_re * e_im[:, None]
    k = torch.from_numpy(rs.ker_np[:, ::-1].copy())            # [P, KK]
    y_re = torch.einsum("nglk,pk->nglp", xm_re.unfold(-1, KK, Q), k)
    y_im = torch.einsum("nglk,pk->nglp", xm_im.unfold(-1, KK, Q), k)
    g = torch.arange(n_rows)
    phi = torch.remainder(
        torch.from_numpy(phase_w0)[:, None]
        + a64[:, None] * torch.div(g, 64, rounding_mode="floor").float()
        + a1[:, None] * (g % 64).float(), 6.283185307179586)
    c_, s_ = torch.cos(phi)[..., None, None], torch.sin(phi)[..., None, None]
    N = len(chan_idx)
    return ((y_re * c_ - y_im * s_).reshape(N, -1).numpy(),
            (y_im * c_ + y_re * s_).reshape(N, -1).numpy())


@pytest.mark.parametrize("P,Q,O", list(_STREAMING))
def test_streaming_layout_matches_plain(rng, P, Q, O):
    """The streaming plan's arithmetic in the kernel's order (residue
    group k sums its residues of each pass of CQ rows, tap by tap; the
    groups' sums added in group order) equals the plain version over two
    tiles of 2 demods on 3 channels (the 2/3413 stage against the direct
    definition: its tile matrix would take 489 MB), atol 5e-5."""
    M, N = 3, 2
    rs = RationalResampler(P, Q, batch_shape=(N,))
    Lc = 2 * O // P * Q
    z = rng.standard_normal((2, M, rs.hist_len + Lc)).astype(np.float32)
    ci = np.array([2, 0], np.int32)
    omega = rng.uniform(-1.5, 1.5, N).astype(np.float32)
    pw0 = rng.uniform(0, 6.28, N).astype(np.float32)
    assert choose_fused_tile(Lc // Q * P, P, Q) == O
    kr, ki = _kernel_order(rs, z, ci, omega, pw0)
    if Q == 3413:
        yr, yi = _direct(rs, z, ci, omega, pw0, O)
    else:
        yr, yi = _port(rs, z, ci, omega, pw0)
        dr, di = _direct(rs, z, ci, omega, pw0, O)
        np.testing.assert_allclose(dr, yr, atol=5e-5)
        np.testing.assert_allclose(di, yi, atol=5e-5)
    assert kr.shape == yr.shape == (N, 2 * O)
    np.testing.assert_allclose(kr, yr, atol=5e-5)
    np.testing.assert_allclose(ki, yi, atol=5e-5)
