"""The port's ``PlanarResampler`` against the JAX package's
(``cubicsdr_tpu/ops/resample.py``) on the CPU, at the two cases of
tests/test_resample_chain.py:118-142 (complex 1/1600 on one stream, real
6/25 over 3 rows) and at that test's tolerance, atol 2e-4: the same
seeded numpy input streamed block by block through both, outputs and the
carried state leaf for leaf. Then the port's class against the port's
own ``ResamplerChain`` and ``make_resampler``, as that test holds the
JAX class against the JAX ones."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.ops.planar import PC as JPC  # noqa: E402
from cubicsdr_tpu.ops.resample import (  # noqa: E402
    PlanarResampler as JPlanarResampler)

from cubicsdr_tpu_torch.ops.planar import PC, PLANAR  # noqa: E402
from cubicsdr_tpu_torch.ops.resample import (  # noqa: E402
    PlanarResampler, ResamplerChain, make_resampler)
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402

ATOL = 2e-4     # tests/test_resample_chain.py:130,142

# (P, Q, batch shape, complex data, blocks, samples per block, seed)
CASES = {"complex_1_1600": (1, 1600, (), True, 2, 1600 * 48, 7),
         "real_6_25_batched": (6, 25, (3,), False, 2, 25 * 64, 11)}


def _input(batch, complex_data, n, seed):
    rng = np.random.default_rng(seed)
    if complex_data:
        return (rng.standard_normal((*batch, n))
                + 1j * rng.standard_normal((*batch, n))).astype(np.complex64)
    return rng.standard_normal((*batch, n)).astype(np.float32)


def _port_in(x):
    if np.iscomplexobj(x):
        return PC(torch.from_numpy(x.real.copy()),
                  torch.from_numpy(x.imag.copy()))
    return torch.from_numpy(x)


def _jax_in(x):
    if np.iscomplexobj(x):
        return JPC(jnp.asarray(x.real), jnp.asarray(x.imag))
    return jnp.asarray(x)


def _np(y):
    if isinstance(y, (PC, JPC)):
        return np.asarray(y.re) + 1j * np.asarray(y.im)
    return np.asarray(y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_planar_resampler_matches_jax(case):
    P, Q, batch, cplx, n_blocks, L, seed = CASES[case]
    ours = PlanarResampler(P, Q, batch_shape=batch, complex_data=cplx,
                           device="cpu")
    ref = JPlanarResampler(P, Q, batch_shape=batch, complex_data=cplx)
    assert [(s.P, s.Q) for s in ours.stages] == [(s.P, s.Q)
                                                 for s in ref.stages]
    x = _input(batch, cplx, n_blocks * L, seed)
    st, st_j = ours.init_state(), ref.init_state()
    for b in range(n_blocks):
        blk = x[..., b * L:(b + 1) * L]
        st, y = ours.apply(st, _port_in(blk))
        st_j, y_j = ref.apply(st_j, _jax_in(blk))
        assert y.shape == tuple(y_j.shape) == (*batch, ours.out_len(L))
        np.testing.assert_allclose(_np(y), _np(y_j), rtol=0, atol=ATOL)
    leaves, leaves_j = tree_leaves(st), jax.tree_util.tree_leaves(st_j)
    assert len(leaves) == len(leaves_j) == len(ours.stages) * (2 if cplx
                                                                else 1)
    for a, b in zip(leaves, leaves_j):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


def test_planar_resampler_matches_complex_chain():
    """tests/test_resample_chain.py:118-130 on the port: planar 1/1600
    against the complex64 chain."""
    P, Q = 1, 1600
    rc = ResamplerChain(P, Q, dtype=torch.complex64)
    pr = PlanarResampler(P, Q, device="cpu")
    x = _input((), True, Q * 96, 7)
    _, yc = rc.apply(rc.init_state(), torch.from_numpy(x))
    _, yp = pr.apply(pr.init_state(), _port_in(x))
    np.testing.assert_allclose(_np(yp), yc.numpy(), rtol=0, atol=ATOL)


def test_planar_resampler_batched_real():
    """tests/test_resample_chain.py:133-142 on the port: real 6/25 over 3
    rows against ``make_resampler``'s float32 resampler."""
    pr = PlanarResampler(6, 25, batch_shape=(3,), complex_data=False,
                         device="cpu")
    rs = make_resampler(6, 25, batch_shape=(3,), dtype=torch.float32)
    x = _input((3,), False, 25 * 128, 11)
    _, yp = pr.apply(pr.init_state(), torch.from_numpy(x))
    _, yc = rs.apply(rs.init_state(), torch.from_numpy(x))
    np.testing.assert_allclose(yp.numpy(), yc.numpy(), rtol=0, atol=ATOL)


def test_planar_resampler_runs_on_the_card_by_default():
    """The default device is the card; a host without one refuses."""
    if torch.cuda.is_available():
        pr = PlanarResampler(1, 4)
        assert pr.device.type == "cuda"
        assert isinstance(pr.init_state()[0], PC)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PlanarResampler(1, 4)
    pr = PlanarResampler(1, 4, complex_data=False, device="cpu")
    assert pr.stages[0].dtype is torch.float32
    assert PlanarResampler(1, 4, device="cpu").stages[0].dtype is PLANAR
