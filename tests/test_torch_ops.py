"""Port ops vs the JAX package's, on the same numpy inputs: fast_atan2,
FreqDem, DCBlocker, the real 6/25 RationalResampler, the folded
NCO+resample matmul, SquelchGate and mix_audio — plus streaming ==
one-shot for each stateful op."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.ops import freqdem as j_fd  # noqa: E402
from cubicsdr_tpu.ops import iir as j_iir  # noqa: E402
from cubicsdr_tpu.ops import planar as j_pl  # noqa: E402
from cubicsdr_tpu.ops import resample as j_rs  # noqa: E402
from cubicsdr_tpu.receiver import mixer as j_mix  # noqa: E402
from cubicsdr_tpu.receiver import squelch as j_sq  # noqa: E402

from cubicsdr_tpu_torch.ops import planar as pl  # noqa: E402
from cubicsdr_tpu_torch.ops.freqdem import FreqDem  # noqa: E402
from cubicsdr_tpu_torch.ops.iir import DCBlocker  # noqa: E402
from cubicsdr_tpu_torch.ops.resample import (  # noqa: E402
    RationalResampler, planar_shifted_resample_matmul)
from cubicsdr_tpu_torch.receiver.mixer import mix_audio  # noqa: E402
from cubicsdr_tpu_torch.receiver.squelch import SquelchGate  # noqa: E402


def t_pc(a):
    """numpy [2, ...] -> port PC."""
    return pl.PC(torch.from_numpy(np.ascontiguousarray(a[0])),
                 torch.from_numpy(np.ascontiguousarray(a[1])))


def j_pc(a):
    return j_pl.PC(jnp.asarray(a[0]), jnp.asarray(a[1]))


def stream(op, blocks):
    st, ys = op.init_state(), []
    for b in blocks:
        st, y = op.apply(st, b)
        ys.append(y)
    return st, ys


def test_fast_atan2(rng):
    y = rng.standard_normal(4096).astype(np.float32)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:4], y[:4] = [0, 1, -1, 0], [0, 0, 0, -1]
    got = pl.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref = np.asarray(j_pl.fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[4:], np.arctan2(y, x)[4:], atol=1e-6)


def test_freqdem_streamed(rng):
    n, L = 4, 1000
    z = rng.standard_normal((2, n, 3 * L)).astype(np.float32)
    fd, fdj = FreqDem(batch_shape=(n,)), j_fd.FreqDem(
        batch_shape=(n,), dtype=j_pl.PLANAR)
    st, ys = stream(fd, [t_pc(z[..., b * L:(b + 1) * L]) for b in range(3)])
    stj = fdj.init_state()
    for b in range(3):
        stj, yj = fdj.apply(stj, j_pc(z[..., b * L:(b + 1) * L]))
        np.testing.assert_allclose(ys[b].numpy(), np.asarray(yj), atol=1e-5)
    _, one = fd.apply(fd.init_state(), t_pc(z))
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), one.numpy(),
                               atol=1e-6)


def test_dc_blocker_blocked_form(rng):
    L = 2048
    x = (rng.standard_normal((2, 3 * L)) + 0.3).astype(np.float32)
    dc, dcj = DCBlocker(0.0005), j_iir.DCBlocker(0.0005, dtype=j_pl.PLANAR)
    st, ys = stream(dc, [t_pc(x[:, b * L:(b + 1) * L]) for b in range(3)])
    stj = dcj.init_state()
    for b in range(3):
        stj, yj = dcj.apply(stj, j_pc(x[:, b * L:(b + 1) * L]))
        np.testing.assert_allclose(ys[b].re.numpy(), np.asarray(yj.re),
                                   atol=1e-5)
        np.testing.assert_allclose(ys[b].im.numpy(), np.asarray(yj.im),
                                   atol=1e-5)
    _, one = dc.apply(dc.init_state(), t_pc(x))
    np.testing.assert_allclose(torch.cat([y.re for y in ys], -1).numpy(),
                               one.re.numpy(), atol=1e-5)


def test_real_resampler_6_25_streamed(rng):
    n, L = 3, 25 * 96
    x = rng.standard_normal((n, 3 * L)).astype(np.float32)
    rs = RationalResampler(6, 25, batch_shape=(n,), dtype=torch.float32)
    rsj = j_rs.RationalResampler(6, 25, batch_shape=(n,), dtype=jnp.float32)
    st, ys = stream(rs, [torch.from_numpy(x[:, b * L:(b + 1) * L])
                         for b in range(3)])
    stj = rsj.init_state()
    for b in range(3):
        stj, yj = rsj.apply(stj, jnp.asarray(x[:, b * L:(b + 1) * L]))
        np.testing.assert_allclose(ys[b].numpy(), np.asarray(yj), atol=1e-5)
    _, one = rs.apply(rs.init_state(), torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), one.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("L", [5 * 7, 5 * 61])
def test_real_resampler_conv_fallback_matches(rng, L):
    """Lengths with no Toeplitz tile take the conv form in both packages."""
    x = rng.standard_normal((2, L)).astype(np.float32)
    rs = RationalResampler(1, 5, batch_shape=(2,), dtype=torch.float32)
    rsj = j_rs.RationalResampler(1, 5, batch_shape=(2,), dtype=jnp.float32)
    _, y = rs.apply(rs.init_state(), torch.from_numpy(x))
    _, yj = rsj.apply(rsj.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)


def test_planar_shifted_resample_matmul(rng):
    N, Lc = 5, 5 * 128 * 3
    rs = RationalResampler(1, 5, batch_shape=(N,))
    rsj = j_rs.RationalResampler(1, 5, batch_shape=(N,), dtype=j_pl.PLANAR)
    z = rng.standard_normal((2, N, rs.hist_len + Lc)).astype(np.float32)
    omega = rng.uniform(-0.5, 0.5, N).astype(np.float32)
    pw0 = rng.uniform(0, 6.28, N).astype(np.float32)
    y = planar_shifted_resample_matmul(t_pc(z), rs, torch.from_numpy(omega),
                                       torch.from_numpy(pw0))
    yj = j_rs.planar_shifted_resample_matmul(j_pc(z), rsj, jnp.asarray(omega),
                                             jnp.asarray(pw0))
    np.testing.assert_allclose(y.re.numpy(), np.asarray(yj.re), atol=5e-5)
    np.testing.assert_allclose(y.im.numpy(), np.asarray(yj.im), atol=5e-5)


def test_squelch_gate_streamed(rng):
    N, L = 6, 512
    g = SquelchGate(48000, N, use_signal_out=[i % 2 == 0 for i in range(N)])
    gj = j_sq.SquelchGate(48000, N,
                          use_signal_out=[i % 2 == 0 for i in range(N)])
    sl = np.linspace(-80, 0, N).astype(np.float32)
    en = np.asarray([True, False] * (N // 2))
    st, stj = g.init_state(), gj.init_state()
    for b in range(3):
        amp = 10.0 ** (-b)
        audio = (amp * rng.standard_normal((N, 1, L))).astype(np.float32)
        iq = (amp * rng.standard_normal((2, N, 4 * L))).astype(np.float32)
        st, out = g.apply(st, (torch.from_numpy(audio), t_pc(iq), sl, en))
        stj, outj = gj.apply(stj, (jnp.asarray(audio), j_pc(iq), sl, en))
        for k in ("level", "floor", "ceil", "peak"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(outj[k]),
                                       atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(out["squelched"].numpy(),
                                      np.asarray(outj["squelched"]))
        np.testing.assert_allclose(out["audio"].numpy(),
                                   np.asarray(outj["audio"]), atol=1e-6)


def test_mix_audio(rng):
    audio = rng.standard_normal((5, 2, 300)).astype(np.float32)
    gains = rng.uniform(0, 2, 5).astype(np.float32)
    active = np.asarray([True, False, True, True, False])
    m, p = mix_audio(torch.from_numpy(audio), gains, active)
    mj, pj = j_mix.mix_audio(jnp.asarray(audio), gains, active)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-6)
