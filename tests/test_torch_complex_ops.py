"""The port's complex64 ops vs the JAX package's complex64 ops, on the
same numpy-seeded inputs streamed over 3 blocks: the NCO mix, FIR
(real and complex taps), the DC blocker and its affine scan, the FM
discriminator, the rational resampler's conv form (single stage, chain,
identity), both channelizers (PFBCH2 with an odd step count so the
parity carries), the analytic filter and the unfolded channel frontend
(state leaf for leaf). Tolerances are tests/test_torch_ops.py's for the
linear ops (1e-6 to 1e-5, scaled to each output's magnitude)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.ops import channelizer as j_ch  # noqa: E402
from cubicsdr_tpu.ops import fir as j_fir  # noqa: E402
from cubicsdr_tpu.ops import freqdem as j_fd  # noqa: E402
from cubicsdr_tpu.ops import hilbert as j_hb  # noqa: E402
from cubicsdr_tpu.ops import iir as j_iir  # noqa: E402
from cubicsdr_tpu.ops import nco as j_nco  # noqa: E402
from cubicsdr_tpu.ops import resample as j_rs  # noqa: E402
from cubicsdr_tpu.receiver import frontend as j_fe  # noqa: E402

from cubicsdr_tpu_torch.ops import planar as pl  # noqa: E402
from cubicsdr_tpu_torch.ops.channelizer import (  # noqa: E402
    ChannelizerPFB, ChannelizerPFB2)
from cubicsdr_tpu_torch.ops.fir import FirFilter  # noqa: E402
from cubicsdr_tpu_torch.ops.freqdem import FreqDem  # noqa: E402
from cubicsdr_tpu_torch.ops.hilbert import AnalyticFilter  # noqa: E402
from cubicsdr_tpu_torch.ops.iir import (  # noqa: E402
    DCBlocker, affine_scan_1st_order)
from cubicsdr_tpu_torch.ops.nco import NCOMixer, mix  # noqa: E402
from cubicsdr_tpu_torch.ops.resample import (  # noqa: E402
    IdentityResampler, RationalResampler, ResamplerChain, make_resampler)
from cubicsdr_tpu_torch.receiver.frontend import ChannelFrontend  # noqa
from cubicsdr_tpu_torch.utils.interop import state_to_numpy  # noqa: E402
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402

C64 = torch.complex64


def cplx(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def run_both(op, op_j, blocks, extra=None):
    """Stream ``blocks`` (numpy) through the port op and the JAX op;
    returns (port outputs, JAX outputs, port state, JAX state) with numpy
    leaves. ``extra`` is a second input paired with each block."""
    st, stj, ys, yjs = op.init_state(), op_j.init_state(), [], []
    for b in blocks:
        x, xj = torch.from_numpy(b), jnp.asarray(b)
        if extra is not None:
            x, xj = (x, torch.as_tensor(extra)), (xj, jnp.asarray(extra))
        st, y = op.apply(st, x)
        stj, yj = op_j.apply(stj, xj)
        ys.append(y.numpy())
        yjs.append(np.asarray(yj))
    return ys, yjs, state_to_numpy(st), jax.tree.map(np.asarray, stj)


def assert_close(ys, yjs, tol):
    for y, yj in zip(ys, yjs):
        assert y.shape == yj.shape and y.dtype == yj.dtype
        scale = max(1.0, float(np.abs(yj).max()))
        np.testing.assert_allclose(y, yj, atol=tol * scale, rtol=0)


def assert_state_like(st, stj):
    """Leaf for leaf: the same structure order, shapes and dtypes."""
    a, b = tree_leaves(st), jax.tree.leaves(stj)
    assert [(x.shape, x.dtype) for x in a] == [(x.shape, x.dtype) for x in b]


def test_representation_helpers(rng):
    x = cplx(rng, 3, 5)
    p = pl.as_pc(torch.from_numpy(x))
    assert isinstance(p, pl.PC) and p.re.dtype == torch.float32
    z = pl.to_complex(p)
    assert z.dtype == C64 and np.array_equal(z.numpy(), x)
    assert pl.as_pc(z).re.numpy().tolist() == x.real.tolist()
    re, im = pl.planes_of(z)
    assert isinstance(pl.join_like(re, im, p), pl.PC)
    assert np.array_equal(pl.join_like(re, im, z).numpy(), x)
    assert pl.dtype_ones((2,), C64).numpy().tolist() == [1, 1]
    assert pl.dtype_zeros((2,), C64).dtype == C64


@pytest.mark.parametrize("batch", [(), (3,)])
def test_nco_mixer_complex(rng, batch):
    L = 20000                           # long enough for f32 phase growth
    blocks = [cplx(rng, *batch, L) for _ in range(3)]
    omega = np.float32(0.7123) if not batch else np.asarray(
        [0.1, -2.3, 3.0], np.float32)
    ys, yjs, st, stj = run_both(NCOMixer(batch), j_nco.NCOMixer(batch),
                                blocks, extra=omega)
    assert_close(ys, yjs, 1e-5)
    np.testing.assert_allclose(st, stj, atol=1e-6)
    y, nxt = mix(torch.from_numpy(blocks[0]), torch.tensor(np.float32(0.3)),
                 torch.tensor(np.float32(0.01)))
    yj, nj = j_nco.mix(jnp.asarray(blocks[0]), jnp.float32(0.3),
                       jnp.float32(0.01))
    assert_close([y.numpy()], [np.asarray(yj)], 1e-5)
    assert abs(float(nxt) - float(nj)) < 1e-6


@pytest.mark.parametrize("taps", ["real", "complex"])
def test_fir_complex_data(rng, taps):
    h = rng.standard_normal(63)
    if taps == "complex":
        h = h + 1j * rng.standard_normal(63)
    h = h.astype(np.complex64 if taps == "complex" else np.float32)
    blocks = [cplx(rng, 2, 1000) for _ in range(3)]
    ys, yjs, st, stj = run_both(FirFilter(h, (2,), dtype=C64),
                                j_fir.FirFilter(h, (2,)), blocks)
    assert_close(ys, yjs, 1e-6)
    assert_state_like(st, stj)


def test_dc_blocker_and_affine_scan_complex(rng):
    L = 2048                             # the blocked form in both
    blocks = [cplx(rng, L) + 0.3 for _ in range(3)]
    ys, yjs, st, stj = run_both(DCBlocker(0.0005, dtype=C64),
                                j_iir.DCBlocker(0.0005), blocks)
    assert_close(ys, yjs, 1e-5)
    assert_state_like(st, stj)
    for n in (300, 2048):                # JAX: associative scan, blocked
        d, y0 = cplx(rng, 2, n), cplx(rng, 2)
        got = affine_scan_1st_order(0.99, torch.from_numpy(d),
                                    torch.from_numpy(y0)).numpy()
        ref = np.asarray(j_iir.affine_scan_1st_order(
            0.99, jnp.asarray(d), jnp.asarray(y0)))
        assert_close([got], [ref], 1e-5)


def test_freqdem_complex(rng):
    blocks = [cplx(rng, 4, 1000) for _ in range(3)]
    ys, yjs, st, stj = run_both(FreqDem(batch_shape=(4,), dtype=C64),
                                j_fd.FreqDem(batch_shape=(4,)), blocks)
    assert_close(ys, yjs, 1e-6)
    assert_state_like(st, stj)


@pytest.mark.parametrize("P,Q", [(6, 25), (2, 5), (1, 100), (1, 1)])
def test_resamplers_complex_conv_form(rng, P, Q):
    L = Q * 40 if Q > 1 else 500
    blocks = [cplx(rng, 3, L) for _ in range(3)]
    op = make_resampler(P, Q, batch_shape=(3,), dtype=C64)
    op_j = j_rs.make_resampler(P, Q, batch_shape=(3,))
    kind = {(1, 100): ResamplerChain, (1, 1): IdentityResampler}.get(
        (P, Q), RationalResampler)
    assert isinstance(op, kind)
    ys, yjs, st, stj = run_both(op, op_j, blocks)
    assert ys[0].shape == (3, L // Q * P)
    assert_close(ys, yjs, 1e-5)
    assert_state_like(st, stj)


@pytest.mark.parametrize("M", [8, 16])
def test_channelizer_pfb_complex(rng, M):
    blocks = [cplx(rng, M * 125) for _ in range(3)]
    ys, yjs, st, stj = run_both(ChannelizerPFB(M, dtype=C64),
                                j_ch.ChannelizerPFB(M), blocks)
    assert ys[0].shape == (M, 125)
    assert_close(ys, yjs, 1e-5)
    assert_state_like(st, stj)


@pytest.mark.parametrize("M,steps", [(8, 250), (16, 125), (6, 333)])
def test_channelizer_pfb2_complex(rng, M, steps):
    """An odd step count flips the carried parity every block."""
    blocks = [cplx(rng, M // 2 * steps) for _ in range(3)]
    ys, yjs, st, stj = run_both(ChannelizerPFB2(M, dtype=C64),
                                j_ch.ChannelizerPFB2(M), blocks)
    assert ys[0].shape == (M, steps)
    assert_close(ys, yjs, 1e-5)
    assert_state_like(st, stj)
    assert int(st[1]) == int(stj[1]) == (3 * steps) % 2
    with pytest.raises(ValueError, match="planar"):
        ChannelizerPFB2(M, use_kernels=True, dtype=C64)


def test_analytic_filter(rng):
    blocks = [rng.standard_normal((2, 800)).astype(np.float32)
              for _ in range(3)]
    op = AnalyticFilter(63, (2,))
    ys, yjs, st, stj = run_both(op, j_hb.AnalyticFilter(63, (2,)), blocks)
    assert ys[0].dtype == np.complex64
    assert_close(ys, yjs, 1e-6)
    assert_state_like(st, stj)


@pytest.mark.parametrize("bw", [200000, 12500, 500000])
def test_channel_frontend_unfolded(rng, bw):
    """The mix-then-resample form; 500 kHz on a 500 kHz channel is the
    unity-ratio identity resampler."""
    rate, n, L = 500_000.0, 3, 5000
    fe = ChannelFrontend(rate, bw, n, dtype=C64)
    fe_j = j_fe.ChannelFrontend(rate, bw, n)
    assert not fe.folded and not fe_j.folded
    omega = np.asarray([0.31, -1.2, 2.9], np.float32)
    blocks = [cplx(rng, n, L) for _ in range(3)]
    ys, yjs, st, stj = run_both(fe, fe_j, blocks, extra=omega)
    assert_close(ys, yjs, 1e-5)
    assert_state_like(st, stj)
    mask = tree_leaves(fe.state_row_mask())
    assert len(mask) == len(jax.tree.leaves(fe_j.state_row_mask()))
    assert all(mask)
