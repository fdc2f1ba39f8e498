"""The JAX package's library ops that no receive path calls, ported with
their exports: ``FirDecimator``, ``SOSFilter`` on
``affine_scan_2nd_order``, ``design.halfband_sos``, ``conv1d_multi`` and
``frame_signal``, and the ``cubicsdr_tpu.ops`` namespace. Each streams
the same numpy input through the JAX op and the port's, block by block.
Tolerances are the reference's own tests': tests/test_ops_core.py:74
(decimator vs strided lfilter, atol 1e-4) and :93 (SOS vs sosfilt, atol
1e-3), tests/test_planar_ops.py:61 (planar vs complex64 decimator, atol
2e-5)."""

import inspect

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cubicsdr_tpu.ops as j_ops  # noqa: E402
from cubicsdr_tpu.ops import design as j_design  # noqa: E402
from cubicsdr_tpu.ops.fir import FirDecimator as JFirDecimator  # noqa: E402
from cubicsdr_tpu.ops.iir import (  # noqa: E402
    SOSFilter as JSOSFilter, affine_scan_2nd_order as j_scan2)
from cubicsdr_tpu.utils import convolve as j_conv  # noqa: E402

import cubicsdr_tpu_torch.ops as ops  # noqa: E402
from cubicsdr_tpu_torch.ops import design  # noqa: E402
from cubicsdr_tpu_torch.ops.fir import FirDecimator  # noqa: E402
from cubicsdr_tpu_torch.ops.iir import (  # noqa: E402
    SOSFilter, affine_scan_2nd_order)
from cubicsdr_tpu_torch.ops.planar import PC, PLANAR  # noqa: E402
from cubicsdr_tpu_torch.utils.convolve import (  # noqa: E402
    conv1d_multi, frame_signal)


def _stream(op, x, block_len, to_port, apply=None):
    """Outputs of ``op`` over ``x`` cut into blocks and the final state;
    ``to_port`` maps a numpy block to the op's input, ``apply`` replaces
    ``op.apply`` (a jitted JAX step)."""
    st, ys = op.init_state(), []
    for b in range(x.shape[-1] // block_len):
        st, y = (apply or op.apply)(st, to_port(
            x[..., b * block_len:(b + 1) * block_len]))
        ys.append(y)
    return ys, st


def _np(y):
    if isinstance(y, PC):
        return y.re.numpy() + 1j * y.im.numpy()
    return np.asarray(y.numpy() if torch.is_tensor(y) else y)


@pytest.mark.parametrize("decim", [2, 4, 8])
def test_decimator_matches_jax_and_strided_lfilter(rng, decim):
    """complex64 and planar, against the JAX FirDecimator block by block
    and against one-shot lfilter[::decim], as tests/test_ops_core.py:74."""
    h = design.kaiser_lowpass(64, 0.4 / decim)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    want, _ = _stream(JFirDecimator(h, decim), x, 512, jnp.asarray)
    want = np.concatenate([np.asarray(w) for w in want])
    np.testing.assert_allclose(want, sps.lfilter(h, 1.0, x)[::decim],
                               atol=1e-4)
    for dtype, to_port in ((torch.complex64, torch.from_numpy),
                           (PLANAR, lambda b: PC(
                               torch.from_numpy(b.real.copy()),
                               torch.from_numpy(b.imag.copy())))):
        op = FirDecimator(h, decim, dtype=dtype)
        got, st = _stream(op, x, 512, to_port)
        got = np.concatenate([_np(g) for g in got])
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert _np(st).shape == (-(-63 // decim) * decim,)


def test_decimator_batched_planar_vs_complex64():
    """tests/test_planar_ops.py:61's case: batch (2,), Hann taps, decim 4,
    three 32-sample blocks; planar against complex64 at atol 2e-5, and
    both against the JAX decimator."""
    rng = np.random.default_rng(1234)
    x = (rng.standard_normal((2, 96)) + 1j * rng.standard_normal((2, 96))
         ).astype(np.complex64)
    taps = np.hanning(17).astype(np.float32)
    want, _ = _stream(JFirDecimator(taps, 4, (2,)), x, 32, jnp.asarray)
    got_c, _ = _stream(FirDecimator(taps, 4, (2,), dtype=torch.complex64),
                       x, 32, torch.from_numpy)
    got_p, _ = _stream(FirDecimator(taps, 4, (2,), dtype=PLANAR), x, 32,
                       lambda b: PC(torch.from_numpy(b.real.copy()),
                                    torch.from_numpy(b.imag.copy())))
    for w, c, p in zip(want, got_c, got_p):
        np.testing.assert_allclose(_np(p), _np(c), atol=2e-5)
        np.testing.assert_allclose(_np(c), np.asarray(w), atol=2e-5)


def test_decimator_refuses_a_ragged_block():
    op = FirDecimator(np.ones(5, np.float32), 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of decim"):
        op.apply(op.init_state(), torch.zeros(10))


@pytest.mark.parametrize("complex_data", [False, True])
def test_sos_matches_jax_and_sosfilt(rng, complex_data):
    """Butterworth order 6 at 0.3 (tests/test_ops_core.py:93), streamed in
    512-sample blocks: the JAX SOSFilter and scipy's sosfilt at atol
    1e-3, state leaf for leaf the JAX layout."""
    sos = sps.butter(6, 0.3, output="sos")
    x = rng.standard_normal(4096).astype(np.float32)
    if complex_data:
        x = (x + 1j * rng.standard_normal(4096)).astype(np.complex64)
    dt_j = jnp.complex64 if complex_data else jnp.float32
    dt_p = torch.complex64 if complex_data else torch.float32
    jop = JSOSFilter(sos, dtype=dt_j)
    want, st_j = _stream(jop, x, 512, jnp.asarray, jax.jit(jop.apply))
    got, st_p = _stream(SOSFilter(sos, dtype=dt_p), x, 512,
                        torch.from_numpy)
    got = np.concatenate([_np(g) for g in got])
    want = np.concatenate([np.asarray(w) for w in want])
    np.testing.assert_allclose(want, sps.sosfilt(sos, x), atol=1e-3)
    np.testing.assert_allclose(got, sps.sosfilt(sos, x), atol=1e-3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert len(st_p) == len(st_j) == 3
    for (xh, yh), (xj, yj) in zip(st_p, st_j):
        np.testing.assert_allclose(_np(xh), np.asarray(xj), atol=1e-6)
        np.testing.assert_allclose(_np(yh), np.asarray(yj), atol=1e-3)


@pytest.mark.parametrize("L", [1, 7, 256, 1000])
def test_affine_scan_2nd_order_matches_jax(rng, L):
    """A stable resonator's recurrence from a nonzero state, batch (3,),
    against the JAX associative scan and a float64 loop: y and the last
    state within 1e-4 of the loop (float32 sums of decaying terms)."""
    r, th = 0.97, 0.4
    m = np.array([[2 * r * np.cos(th), -r * r], [1.0, 0.0]])
    f = rng.standard_normal((3, L)).astype(np.float32)
    s0 = rng.standard_normal((3, 2)).astype(np.float32)
    y, s = affine_scan_2nd_order(m, torch.from_numpy(f),
                                 torch.from_numpy(s0))
    yj, sj = jax.jit(lambda a, b: j_scan2(m, a, b))(jnp.asarray(f),
                                                    jnp.asarray(s0))
    want = np.zeros((3, L))
    prev = s0.astype(np.float64)
    for n in range(L):
        cur = prev @ m.T
        cur[:, 0] += f[:, n]
        want[:, n] = cur[:, 0]
        prev = cur
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), prev, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-4)


@pytest.mark.parametrize("order,fc", [(6, 0.25), (4, 0.1)])
def test_halfband_sos_equals_jax(order, fc):
    np.testing.assert_array_equal(design.halfband_sos(order, fc),
                                  j_design.halfband_sos(order, fc))
    assert design.halfband_sos(order, fc).dtype == np.float32


@pytest.mark.parametrize("stride", [1, 3])
def test_conv1d_multi_matches_jax(rng, stride):
    x = rng.standard_normal((2, 3, 200)).astype(np.float32)
    hs = rng.standard_normal((4, 9)).astype(np.float32)
    got = conv1d_multi(torch.from_numpy(x), torch.from_numpy(hs), stride)
    want = np.asarray(j_conv.conv1d_multi(jnp.asarray(x), jnp.asarray(hs),
                                          stride))
    assert got.shape == want.shape == (2, 3, 4, (200 - 9) // stride + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("frame_len,hop", [(64, 16), (50, 50), (33, 7)])
def test_frame_signal_equals_jax(rng, frame_len, hop):
    x = rng.standard_normal((2, 500)).astype(np.float32)
    got = frame_signal(torch.from_numpy(x), frame_len, hop)
    want = np.asarray(j_conv.frame_signal(jnp.asarray(x), frame_len, hop))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_namespace_has_the_jax_exports():
    """``cubicsdr_tpu_torch.ops`` offers every public name of
    ``cubicsdr_tpu.ops`` (its classes, functions and ``design``), each the
    port's own object of that name."""
    names = {n for n, v in vars(j_ops).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    assert names == set(ops.__all__) - {"design"}
    for n in names:
        obj = getattr(ops, n)
        assert obj.__name__ == n
        assert obj.__module__.startswith("cubicsdr_tpu_torch.ops.")
    assert ops.design is design
    with pytest.raises(AttributeError):
        ops.no_such_op
