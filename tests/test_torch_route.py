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
    O = choose_fused_tile(z.shape[-1] - rs.hist_len, rs.P, rs.Q)
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
