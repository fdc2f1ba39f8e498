"""PFBCH2 analyzer: the CUDA kernel's plain version and the port's
ChannelizerPFB2 vs the JAX package's Pallas kernel (interpret mode) and its
XLA channelizer. atol 2e-4, as tests/test_pallas_pfb.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import cubicsdr_tpu.ops.pallas.pfb as j_pfb  # noqa: E402
from cubicsdr_tpu.ops.channelizer import (  # noqa: E402
    ChannelizerPFB2 as JChannelizerPFB2)
from cubicsdr_tpu.ops.planar import PC as JPC, PLANAR as JPLANAR  # noqa: E402

from cubicsdr_tpu_torch.ops.channelizer import ChannelizerPFB2  # noqa: E402
from cubicsdr_tpu_torch.ops.kernels.pfb import (  # noqa: E402
    pfbch2_planar, pfbch2_planar_plain)
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402

ATOL = 2e-4


@pytest.fixture
def interp():
    j_pfb.INTERPRET = True
    yield
    j_pfb.INTERPRET = False


def _iq(rng, n):
    return rng.standard_normal((2, n)).astype(np.float32)


def _plain(ch, z, parity=0):
    return pfbch2_planar_plain(
        torch.from_numpy(z[0]), torch.from_numpy(z[1]), ch.h_poly, ch.w_re,
        ch.w_im, ch.c_re, ch.c_im, torch.tensor(parity, dtype=torch.int32))


def _xla_stream(M, blocks):
    chj = JChannelizerPFB2(M, dtype=JPLANAR)
    st, outs = chj.init_state(), []
    for b in blocks:
        st, y = chj.apply(st, JPC(jnp.asarray(b[0]), jnp.asarray(b[1])))
        outs.append(np.asarray(y.re) + 1j * np.asarray(y.im))
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("M,n_steps", [(2, 256), (6, 256), (10, 256),
                                       (16, 256), (16, 1000)])
def test_plain_matches_pallas_and_xla(rng, M, n_steps):
    """Every even M that optimal_channel_count produces, and a step count
    with no 128-multiple divisor (the Pallas kernel's padded ragged tail)."""
    ch = ChannelizerPFB2(M)
    x = _iq(rng, n_steps * ch.D)
    z = np.concatenate([np.zeros((2, ch.hist_len), np.float32), x], -1)
    yr, yi = _plain(ch, z)
    got = yr.numpy() + 1j * yi.numpy()
    assert got.shape == (M, n_steps)
    pr, pi = j_pfb.pfbch2_planar_pallas(
        jnp.asarray(z[0]), jnp.asarray(z[1]), ch.h_poly.numpy(), M,
        tile=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pr) + 1j * np.asarray(pi),
                               atol=ATOL)
    np.testing.assert_allclose(got, _xla_stream(M, [x]), atol=ATOL)


def test_odd_step_counts_carry_parity(rng):
    """Blocks of an odd step count: the carried parity keeps the
    (-1)^{k*s} flip global, as the XLA channelizer does (the Pallas path
    asserts even counts instead)."""
    M, n_steps = 6, 101
    ch = ChannelizerPFB2(M, use_kernels=True)
    blocks = [_iq(rng, n_steps * ch.D) for _ in range(3)]
    st, outs = ch.init_state(), []
    for b in blocks:
        st, y = ch.apply(st, PC(torch.from_numpy(b[0]),
                                torch.from_numpy(b[1])))
        outs.append(y.re.numpy() + 1j * y.im.numpy())
    assert int(st[1]) == 1
    np.testing.assert_allclose(np.concatenate(outs, -1),
                               _xla_stream(M, blocks), atol=ATOL)


def test_channelizer_streams_like_pallas(interp, rng):
    """3 streamed blocks through the port's ChannelizerPFB2(use_kernels)
    (the plain version on CPU) == the JAX Pallas channelizer, and ==
    one-shot."""
    M, n_steps = 16, 256
    ch = ChannelizerPFB2(M, use_kernels=True)
    chj = JChannelizerPFB2(M, dtype=JPLANAR, use_pallas=True)
    x = _iq(rng, 3 * n_steps * ch.D)
    st, stj, outs = ch.init_state(), chj.init_state(), []
    for b in range(3):
        blk = x[:, b * n_steps * ch.D:(b + 1) * n_steps * ch.D]
        st, y = ch.apply(st, PC(torch.from_numpy(blk[0]),
                                torch.from_numpy(blk[1])))
        stj, yj = chj.apply(stj, JPC(jnp.asarray(blk[0]),
                                     jnp.asarray(blk[1])))
        np.testing.assert_allclose(y.re.numpy(), np.asarray(yj.re), atol=ATOL)
        np.testing.assert_allclose(y.im.numpy(), np.asarray(yj.im), atol=ATOL)
        np.testing.assert_array_equal(st[0].re.numpy(), np.asarray(stj[0].re))
        outs.append(y.re.numpy())
    _, one = ch.apply(ch.init_state(), PC(torch.from_numpy(x[0]),
                                          torch.from_numpy(x[1])))
    np.testing.assert_allclose(np.concatenate(outs, -1), one.re.numpy(),
                               atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu(rng):
    """On CPU tensors the kernel wrapper IS the plain version (and counts
    no launch)."""
    ch = ChannelizerPFB2(10)
    z = _iq(rng, ch.hist_len + 64 * ch.D)
    before = pfbch2_planar.launches
    args = (torch.from_numpy(z[0]), torch.from_numpy(z[1]), ch.h_poly,
            ch.w_re, ch.w_im, ch.c_re, ch.c_im,
            torch.tensor(1, dtype=torch.int32))
    for a, b in zip(pfbch2_planar(*args), pfbch2_planar_plain(*args)):
        assert torch.equal(a, b)
    assert pfbch2_planar.launches == before


def _kernel_order(ch, z, parity):
    """The CUDA kernel's arithmetic, in its order, from the host layouts it
    reads: the J-tap FIR per branch, then the form ``pfb_form`` picks: a
    radix-2 DIT FFT on bit-reversed branch sums with the folded twiddles
    and c_k, or the DFT with F = c_k W (both from
    ``pfb_transform_consts``), or the product with F folded in float32 from
    the channelizer's (w, c), summed over branches in order; then the
    flip."""
    from cubicsdr_tpu_torch.ops.kernels.pfb import (
        pfb_form, pfb_transform_consts)
    M, J, D = ch.M, ch.J, ch.D
    zr, zi = torch.from_numpy(z[0]), torch.from_numpy(z[1])
    n_steps = (zr.shape[-1] - ch.hist_len) // D
    s = torch.arange(n_steps)
    rho = torch.arange(M)
    u_re = torch.zeros((M, n_steps))
    u_im = torch.zeros((M, n_steps))
    for j in range(J):
        p = (s[None, :] + 2 * (J - 1 - j)) * D + M - 1 - rho[:, None]
        u_re = u_re + ch.h_poly[:, j:j + 1] * zr[p]
        u_im = u_im + ch.h_poly[:, j:j + 1] * zi[p]
    form = pfb_form(M, J)
    if form == "fft":
        v = torch.from_numpy(pfb_transform_consts(M)).reshape(-1, 2)
        assert v.shape == (3 * M // 2, 2)
        bits = M.bit_length() - 1
        rev = [int(format(i, f"0{bits}b")[::-1], 2) for i in range(M)]
        ar, ai = list(u_re[rev]), list(u_im[rev])
        span = 2
        while span <= M:
            half = span // 2
            for i in range(0, M, span):
                for j in range(half):
                    a, b, w = i + j, i + j + half, j * (M // span)
                    wr, wi = v[w]
                    tr = wr * ar[b] - wi * ai[b]
                    ti = wr * ai[b] + wi * ar[b]
                    ar[b], ai[b] = ar[a] - tr, ai[a] - ti
                    ar[a], ai[a] = ar[a] + tr, ai[a] + ti
            span *= 2
        c = v[M // 2:]
        y_re = torch.stack([ar[k] * c[k, 0] - ai[k] * c[k, 1]
                            for k in range(M)])
        y_im = torch.stack([ar[k] * c[k, 1] + ai[k] * c[k, 0]
                            for k in range(M)])
    elif form == "dft":
        F = torch.from_numpy(pfb_transform_consts(M)).reshape(M, M, 2)
        y_re = F[..., 0] @ u_re - F[..., 1] @ u_im
        y_im = F[..., 0] @ u_im + F[..., 1] @ u_re
    else:
        # F folded in blocks of KB output channels, as the plan holds it.
        from cubicsdr_tpu_torch.ops.kernels.pfb import pfb_plan
        kb = pfb_plan(M, J)[3]
        f_re, f_im = [], []
        for k0 in range(0, M, kb):
            cr, ci = ch.c_re[k0:k0 + kb, None], ch.c_im[k0:k0 + kb, None]
            w_re, w_im = ch.w_re[k0:k0 + kb], ch.w_im[k0:k0 + kb]
            f_re.append(cr * w_re - ci * w_im)
            f_im.append(cr * w_im + ci * w_re)
        f_re, f_im = torch.cat(f_re), torch.cat(f_im)
        assert f_re.shape == (M, M)
        y_re = torch.zeros((M, n_steps))
        y_im = torch.zeros((M, n_steps))
        for r in range(M):
            y_re = y_re + f_re[:, r:r + 1] * u_re[r] - f_im[:, r:r + 1] * u_im[r]
            y_im = y_im + f_re[:, r:r + 1] * u_im[r] + f_im[:, r:r + 1] * u_re[r]
    odd = ((s + parity) % 2)[None, :] * (rho % 2)[:, None]
    sign = (1 - 2 * odd).float()
    return (y_re * sign).numpy(), (y_im * sign).numpy()


@pytest.mark.parametrize("M,n_steps,parity,J", [
    (16, 640, 0, 8), (6, 256, 0, 8), (10, 253, 1, 8), (16, 127, 1, 8),
    (8, 300, 1, 8), (20, 300, 1, 8), (40, 129, 0, 8), (64, 200, 1, 8),
    (6, 101, 1, 12), (136, 97, 1, 8), (200, 64, 0, 8), (246, 75, 1, 8)])
def test_kernel_layout_matches_plain(rng, M, n_steps, parity, J):
    """The CUDA kernel's host layouts, evaluated in its order (FFT for
    M = 8, 16, 64; DFT for M = 6, 10; the product with F = c_k W for
    M = 20, 40 and for a channelizer with 12 taps per branch; at M = 136,
    200 and 246 with F folded in blocks of the plan's KB channels), equal
    the plain version, odd step counts and parity included, atol 2e-4."""
    from cubicsdr_tpu_torch.ops.kernels.pfb import pfb_form
    ch = ChannelizerPFB2(M, taps_per_channel=J)
    assert ch.J == J
    assert pfb_form(M, J) == ("product" if M > 16 and M & (M - 1)
                              or J != 8 else "fft" if M & (M - 1) == 0
                              else "dft")
    z = _iq(rng, ch.hist_len + n_steps * ch.D)
    kr, ki = _kernel_order(ch, z, parity)
    pr, pi = _plain(ch, z, parity)
    assert kr.shape == (M, n_steps)
    np.testing.assert_allclose(kr, pr.numpy(), atol=ATOL)
    np.testing.assert_allclose(ki, pi.numpy(), atol=ATOL)


def test_plan_fits_every_source_rate():
    """The kernel's tile and shared memory fit an sm_90 block for the
    channel count of every source rate up to 64 MS/s (M = 2 .. 128); the
    main path's M = 16 keeps 128-step tiles with two or more blocks per
    SM."""
    from cubicsdr_tpu_torch.io.sources import optimal_channel_count
    from cubicsdr_tpu_torch.ops.kernels.pfb import SMEM_MAX, pfb_plan
    for fs in range(500_000, 64_000_001, 500_000):
        M = optimal_channel_count(fs)
        T, nbytes, stages, kb = pfb_plan(M, 8)
        assert T in (32, 64, 128) and nbytes <= SMEM_MAX
        assert (stages, kb) == (2, M)
    assert pfb_plan(16, 8) == (128, 36224, 2, 16)


def _plan_before(M: int, J: int):
    """``pfb_plan`` as it was before the large-M mode: (T, bytes), or None
    where nothing fitted."""
    from cubicsdr_tpu_torch.ops.kernels.pfb import (
        _SMEM_TWO_PER_SM, SMEM_MAX, pfb_form)
    D = M // 2
    fits = []
    for T in (128, 64, 32):
        win = ((T + 2 * J - 1) * D + 3) // 4 * 4
        f = 2 * M * M if pfb_form(M, J) == "product" else 0
        nbytes = 4 * (4 * win + 2 * T * (M + 1) + f + M * J)
        if nbytes <= _SMEM_TWO_PER_SM:
            return T, nbytes
        if nbytes <= SMEM_MAX:
            fits.append((T, nbytes))
    return fits[0] if fits else None


def test_plans_that_fitted_are_unchanged():
    """Every (M, J) that had a plan keeps it, with two staged windows and
    F whole; from M = 134 (J = 8) on, nothing fitted before."""
    from cubicsdr_tpu_torch.ops.kernels.pfb import pfb_plan
    for J in (8, 12):
        for M in range(2, 402, 2):
            before = _plan_before(M, J)
            if before is not None:
                assert pfb_plan(M, J) == (*before, 2, M), (M, J)
            elif J == 8:
                assert M >= 134, M
    assert _plan_before(132, 8) is not None
    assert _plan_before(134, 8) is None


def test_plan_fits_every_source_rate_up_to_200_msps():
    """Every even M up to 400, so the channel count of every source rate up
    to 200 MS/s, gets a plan within the 227 KB an sm_90 block may hold:
    from M = 134 on, one staged window and F tiled in blocks of KB output
    channels (a multiple of 4, or F whole at 134-140)."""
    from cubicsdr_tpu_torch.io.sources import optimal_channel_count
    from cubicsdr_tpu_torch.ops.kernels.pfb import SMEM_MAX, pfb_plan
    ms = {optimal_channel_count(fs)
          for fs in range(500_000, 200_000_001, 500_000)}
    assert max(ms) <= 400 and {140, 246} <= ms
    for M in sorted(ms | set(range(134, 401, 2))):
        T, nbytes, stages, kb = pfb_plan(M, 8)
        assert T in (32, 64, 128) and nbytes <= SMEM_MAX
        if M >= 134:
            assert stages == 1 and (kb == M or kb % 4 == 0) and kb >= 4
    assert pfb_plan(134, 8) == (32, 207712, 1, 134)
    assert pfb_plan(140, 8) == (32, 223712, 1, 140)
    assert pfb_plan(246, 8) == (32, 227584, 1, 56)
    assert pfb_plan(400, 8) == (32, 229056, 1, 12)
