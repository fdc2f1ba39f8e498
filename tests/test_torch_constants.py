"""The port's host-built constants equal the JAX package's exactly: filter
designs, polyphase layouts, resampler kernels, Toeplitz tiles, rational
plans, channel centres and the fast_atan2 polynomial."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cubicsdr_tpu.io.sources import optimal_channel_count as j_occ  # noqa: E402
from cubicsdr_tpu.ops import design as j_design  # noqa: E402
from cubicsdr_tpu.ops import resample as j_rs  # noqa: E402
from cubicsdr_tpu.ops.channelizer import (  # noqa: E402
    _polyphase as j_polyphase, channel_centers as j_centers)
from cubicsdr_tpu.ops.planar import _atan_coeffs as j_atan  # noqa: E402

from cubicsdr_tpu_torch.io.sources import optimal_channel_count  # noqa: E402
from cubicsdr_tpu_torch.ops import design  # noqa: E402
from cubicsdr_tpu_torch.ops import resample as rs_mod  # noqa: E402
from cubicsdr_tpu_torch.ops.channelizer import (  # noqa: E402
    _polyphase, channel_centers)
from cubicsdr_tpu_torch.ops.planar import _atan_coeffs  # noqa: E402


@pytest.mark.parametrize("M", [2, 6, 10, 16])
def test_pfb_prototype_and_polyphase(M):
    h = design.pfb_prototype(M)
    np.testing.assert_array_equal(h, j_design.pfb_prototype(M))
    np.testing.assert_array_equal(_polyphase(h, M), j_polyphase(h, M))


@pytest.mark.parametrize("P,Q", [(1, 5), (6, 25), (2, 3), (1, 12)])
def test_resampler_constants(P, Q):
    np.testing.assert_array_equal(rs_mod.resampler_taps(P, Q),
                                  j_rs.resampler_taps(P, Q))
    r = rs_mod.RationalResampler(P, Q)
    rj = j_rs.RationalResampler(P, Q)
    np.testing.assert_array_equal(r.ker.numpy(), np.asarray(rj.ker))
    assert (r.KK, r.hist_len) == (rj.KK, rj.hist_len)
    O = 128 if P == 1 else 96
    key = tuple(r.ker_np.reshape(-1).tolist())
    T, S, W = rs_mod._toeplitz_np(key, P, Q, r.KK, O)
    Tj, Sj, Wj = j_rs._toeplitz_np(key, P, Q, rj.KK, O)
    assert (S, W) == (Sj, Wj)
    np.testing.assert_array_equal(T, Tj)


@pytest.mark.parametrize("ratio", [200e3 / 1e6, 48e3 / 200e3, 500 / 800e3,
                                   12.5e3 / 1e6, 1.0])
def test_design_ratio_and_stage_plan(ratio):
    pq = rs_mod.design_ratio(ratio, max_denominator=500)
    assert pq == j_rs.design_ratio(ratio, max_denominator=500)
    assert rs_mod.stage_plan(*pq) == j_rs.stage_plan(*pq)


def test_channel_centers_and_count():
    for fs in (2.4e6, 4.8e6, 8e6, 10e6, 20e6, 0.25e6):
        assert optimal_channel_count(fs) == j_occ(fs)
        M = optimal_channel_count(fs)
        np.testing.assert_array_equal(channel_centers(M, fs, 100e6),
                                      j_centers(M, fs, 100e6))


def test_fast_atan2_coefficients():
    assert _atan_coeffs() == j_atan()


@pytest.mark.parametrize("case", [
    ("kaiser_filter_len", (0.004, 60.0)), ("kaiser_filter_len", (0.5, 30.0)),
    ("lowpass_for_transition", (0.1, 0.02)),
    ("lowpass_for_transition", (0.25, 0.05, 40.0, 2.0)),
    ("deemphasis_coeffs", (75, 48000)), ("deemphasis_coeffs", (50, 44100)),
    ("ssb_bandpass", (257, 5400, 5400, True)),
    ("ssb_bandpass", (101, 5400, 5400, False))],
    ids=lambda c: f"{c[0]}{c[1]}")
def test_modem_designs_equal_jax(case):
    """The designs the modem bank builds from (AM/FMS/SSB filter lengths,
    lowpasses, de-emphasis and one-sided SSB bandpasses) equal the JAX
    package's exactly."""
    name, args = case
    got, want = getattr(design, name)(*args), getattr(j_design, name)(*args)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    else:
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
