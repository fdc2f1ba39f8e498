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
