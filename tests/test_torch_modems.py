"""Every modem kit of the port against the JAX package's, and the ops
the kits are built from (FIR, delay line, first-order IIR, AGC,
convolution) against the JAX package and scipy, with streaming
equal to one-shot. Inputs are numpy-seeded planar IQ; the JAX side runs
with ``dtype=PLANAR`` as tests/test_planar_modems.py runs it, and the
tolerances are that file's: audio atol 1e-4 * max(|y|, 1), dict outputs
atol 1e-5, symbols equal except where the slicer's margin between its two
best scores is under 1e-5."""

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cubicsdr_tpu.modems as j_modems  # noqa: E402
from cubicsdr_tpu.ops import agc as j_agc  # noqa: E402
from cubicsdr_tpu.ops import fir as j_fir  # noqa: E402
from cubicsdr_tpu.ops import iir as j_iir  # noqa: E402
from cubicsdr_tpu.ops.planar import PC as JPC, PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.utils import convolve as j_conv  # noqa: E402

from cubicsdr_tpu_torch.modems import make_modem, modem_names  # noqa: E402
from cubicsdr_tpu_torch.modems.digital import symbols_to_bits  # noqa: E402
from cubicsdr_tpu_torch.ops import design  # noqa: E402
from cubicsdr_tpu_torch.ops.agc import AutoGain  # noqa: E402
from cubicsdr_tpu_torch.ops.fir import DelayLine, FirFilter  # noqa: E402
from cubicsdr_tpu_torch.ops.iir import (  # noqa: E402
    FirstOrderIIR, affine_scan_1st_order)
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.utils.convolve import conv1d  # noqa: E402
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402

MARGIN = 1e-5


def bandlimited_iq(rng, shape):
    """Smooth random IQ planes [2, *shape] (keeps the discriminators in a
    sane regime), tests/test_planar_modems.py's signal."""
    n = shape[-1]
    x = (rng.standard_normal((*shape[:-1], n + 32))
         + 1j * rng.standard_normal((*shape[:-1], n + 32)))
    y = sps.lfilter(np.hanning(33), [1.0], x, axis=-1)[..., 32:]
    y = (y / np.max(np.abs(y))).astype(np.complex64)
    return np.stack([y.real, y.imag]).astype(np.float32)


def t_pc(a):
    return PC(torch.from_numpy(np.ascontiguousarray(a[0])),
              torch.from_numpy(np.ascontiguousarray(a[1])))


def j_pc(a):
    return JPC(jnp.asarray(a[0]), jnp.asarray(a[1]))


def assert_symbols_close(got, ref, margin, what):
    """Hard decisions agree wherever the margin is at least MARGIN; returns
    the rows where every symbol agrees."""
    got, ref = np.asarray(got), np.asarray(ref)
    bad = (got != ref) & (np.asarray(margin) >= MARGIN)
    assert not bad.any(), f"{what}: {bad.sum()} symbols differ"
    return (got == ref).all(axis=-1)


@pytest.mark.parametrize("name", modem_names())
def test_kit_matches_jax(rng, name):
    """Each registered modem's kit, port vs JAX, planar input, batch 2,
    three streamed blocks."""
    modem, modem_j = make_modem(name), j_modems.make_modem(name)
    assert modem.modem_type == modem_j.modem_type
    assert modem.settings == modem_j.settings
    rate = modem.check_sample_rate(modem.default_sample_rate, 48000)
    assert rate == modem_j.check_sample_rate(modem_j.default_sample_rate,
                                             48000)
    bm = modem.block_multiple(rate, 48000)
    assert bm == modem_j.block_multiple(rate, 48000)
    kit = modem.build_kit(rate, 48000, batch_shape=(2,))
    kit_j = modem_j.build_kit(rate, 48000, batch_shape=(2,), dtype=JPLANAR)
    L = int(np.lcm(bm, 16)) * 4
    x = bandlimited_iq(rng, (2, 3 * L))
    st, st_j = kit.init_state(), kit_j.init_state()
    assert ([tuple(t.shape) for t in tree_leaves(st)]
            == [tuple(a.shape) for a in jax.tree.leaves(st_j)])
    for b in range(3):
        blk = x[..., b * L:(b + 1) * L]
        margin = (kit.decision_margin(st, t_pc(blk))
                  if modem.modem_type == "digital" else None)
        st, y = kit.apply(st, t_pc(blk))
        st_j, y_j = kit_j.apply(st_j, j_pc(blk))
        if isinstance(y, dict):
            assert set(y) == set(y_j) == {"symbols", "evm", "locked"}
            assert y["symbols"].dtype == torch.int32
            same = assert_symbols_close(y["symbols"], y_j["symbols"],
                                        margin, name)
            for k in ("evm", "locked"):
                np.testing.assert_allclose(
                    y[k].numpy()[same], np.asarray(y_j[k])[same], atol=1e-5,
                    rtol=0, err_msg=f"{name}:{k}")
        else:
            ref = np.asarray(y_j)
            scale = max(float(np.max(np.abs(ref))), 1.0)
            assert y.shape == ref.shape
            np.testing.assert_allclose(y.numpy(), ref, atol=1e-4 * scale,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("name", modem_names())
def test_settings_defaults_and_schema(name):
    """Settings default from get_settings(), with the JAX package's typed
    schema, and round-trip through write/read."""
    m, mj = make_modem(name), j_modems.make_modem(name)
    sch = [(a.key, a.name, a.value, a.arg_type, a.units, a.low, a.high,
            a.options) for a in m.get_settings()]
    sch_j = [(a.key, a.name, a.value, a.arg_type, a.units, a.low, a.high,
              a.options) for a in mj.get_settings()]
    assert sch == sch_j
    for a in m.get_settings():
        assert m.read_setting(a.key) == a.value
        m.write_setting(a.key, a.options[-1] if a.options else a.value)
        assert m.read_setting(a.key) == (a.options[-1] if a.options
                                          else a.value)


def stream(op, blocks):
    st, ys = op.init_state(), []
    for b in blocks:
        st, y = op.apply(st, b)
        ys.append(y)
    return st, ys


def cat(ys):
    if isinstance(ys[0], PC):
        return np.stack([torch.cat([y.re for y in ys], -1).numpy(),
                         torch.cat([y.im for y in ys], -1).numpy()])
    return torch.cat(ys, -1).numpy()


@pytest.mark.parametrize("taps_kind", ["real", "complex"])
@pytest.mark.parametrize("data_kind", ["real", "planar"])
def test_fir_filter_streams_and_matches(rng, taps_kind, data_kind):
    """FirFilter == JAX FirFilter == scipy lfilter, streaming == one-shot."""
    h = rng.standard_normal(17).astype(np.float32)
    if taps_kind == "complex":
        h = (h + 1j * rng.standard_normal(17)).astype(np.complex64)
    n, L = 3, 96
    if data_kind == "real":
        x = rng.standard_normal((n, 3 * L)).astype(np.float32)
        xs = [torch.from_numpy(x[:, b * L:(b + 1) * L]) for b in range(3)]
        xj = [jnp.asarray(x[:, b * L:(b + 1) * L]) for b in range(3)]
        xc = x
        fir = FirFilter(h, (n,), dtype=torch.float32)
        fir_j = j_fir.FirFilter(h, (n,), dtype=jnp.float32)
    else:
        x = rng.standard_normal((2, n, 3 * L)).astype(np.float32)
        xs = [t_pc(x[..., b * L:(b + 1) * L]) for b in range(3)]
        xj = [j_pc(x[..., b * L:(b + 1) * L]) for b in range(3)]
        xc = x[0] + 1j * x[1]
        fir = FirFilter(h, (n,))
        fir_j = j_fir.FirFilter(h, (n,), dtype=JPLANAR)
    _, ys = stream(fir, xs)
    _, ys_j = stream(fir_j, xj)
    got = cat(ys)
    ref = sps.lfilter(h, [1.0], xc, axis=-1)
    if got.ndim == 3:
        got = got[0] + 1j * got[1]
    np.testing.assert_allclose(got, ref, atol=2e-5)
    for y, yj in zip(ys, ys_j):
        if isinstance(y, PC):
            yj = (np.asarray(yj.re) + 1j * np.asarray(yj.im)
                  if isinstance(yj, JPC) else np.asarray(yj))
            y = y.re.numpy() + 1j * y.im.numpy()
        else:
            y, yj = y.numpy(), np.asarray(yj)
        np.testing.assert_allclose(y, yj, atol=1e-5)
    _, one = fir.apply(fir.init_state(), torch.from_numpy(x)
                       if data_kind == "real" else t_pc(x))
    np.testing.assert_allclose(cat([one]), cat(ys), atol=1e-5)


def test_conv1d_strided_matches_jax(rng):
    """conv1d on planar data with complex taps (the four real
    convolutions), strided, == the JAX package's."""
    x = rng.standard_normal((2, 3, 200)).astype(np.float32)
    h = (rng.standard_normal(9) + 1j * rng.standard_normal(9)).astype(
        np.complex64)
    for stride in (1, 3):
        y = conv1d(t_pc(x), PC(torch.from_numpy(h.real.copy()),
                               torch.from_numpy(h.imag.copy())), stride)
        yj = j_conv.conv1d(j_pc(x), h, stride)
        np.testing.assert_allclose(y.re.numpy(), np.asarray(yj.re),
                                   atol=1e-5)
        np.testing.assert_allclose(y.im.numpy(), np.asarray(yj.im),
                                   atol=1e-5)


@pytest.mark.parametrize("delay", [0, 7, 60])
def test_delay_line(rng, delay):
    """DelayLine == the JAX package's: y[t] = x[t - d] with zeros before
    the stream, streamed over blocks no longer than the delay too."""
    x = rng.standard_normal((4, 3 * 60)).astype(np.float32)
    blocks = [x[:, b * 60:(b + 1) * 60] for b in range(3)]
    _, ys = stream(DelayLine(delay, (4,)), [torch.from_numpy(b)
                                           for b in blocks])
    _, ys_j = stream(j_fir.DelayLine(delay, (4,)),
                     [jnp.asarray(b) for b in blocks])
    got = cat(ys)
    np.testing.assert_array_equal(
        got, np.concatenate([np.asarray(y) for y in ys_j], -1))
    np.testing.assert_array_equal(got[:, delay:], x[:, :x.shape[1] - delay])
    assert not got[:, :delay].any()


@pytest.mark.parametrize("L", [100, 3000])
def test_first_order_iir_both_branches(rng, L):
    """FirstOrderIIR (FM de-emphasis) on blocks shorter than two tiles
    (one tile of the block's length) and longer (blocked with carries):
    == the JAX package, == scipy lfilter, streaming == one-shot."""
    b, a = design.deemphasis_coeffs(75, 48000)
    x = rng.standard_normal((3, 2, 3 * L)).astype(np.float32)
    iir = FirstOrderIIR(b, a, (3, 2))
    iir_j = j_iir.FirstOrderIIR(b, a, (3, 2))
    xs = [x[..., k * L:(k + 1) * L] for k in range(3)]
    _, ys = stream(iir, [torch.from_numpy(v) for v in xs])
    _, ys_j = stream(iir_j, [jnp.asarray(v) for v in xs])
    for y, yj in zip(ys, ys_j):
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)
    ref = sps.lfilter(b.astype(np.float64), a.astype(np.float64), x, axis=-1)
    np.testing.assert_allclose(cat(ys), ref, atol=1e-4)
    _, one = iir.apply(iir.init_state(), torch.from_numpy(x))
    np.testing.assert_allclose(one.numpy(), cat(ys), atol=1e-4)


@pytest.mark.parametrize("L", [300, 5000])
def test_affine_scan_1st_order_branches(rng, L):
    d = rng.standard_normal((2, L)).astype(np.float32)
    y0 = rng.standard_normal(2).astype(np.float32)
    y = affine_scan_1st_order(0.97, torch.from_numpy(d), torch.from_numpy(y0))
    ref = sps.lfilter([1.0], [1.0, -0.97], d, axis=-1,
                      zi=0.97 * y0[:, None])[0]
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-4)
    yj = j_iir.affine_scan_1st_order(0.97, jnp.asarray(d), jnp.asarray(y0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-4)


def test_auto_gain_matches_jax(rng):
    g, gj = AutoGain(batch_shape=(3,)), j_agc.AutoGain(batch_shape=(3,))
    st = g.init_state()
    assert len({id(t) for t in st}) == 3          # three distinct tensors
    stj = gj.init_state()
    for b in range(4):
        x = ((b + 1) * rng.standard_normal((3, 128))).astype(np.float32)
        st, y = g.apply(st, torch.from_numpy(x))
        stj, yj = gj.apply(stj, jnp.asarray(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-6,
                                   atol=1e-6)


def test_symbols_to_bits():
    assert symbols_to_bits(np.asarray([1, 0, 3, 2]), 2) == "01001110"


# --- behaviour, ported from tests/test_modems.py and tests/test_parity.py --

def tone_snr(audio, f0, fs, guard=30.0, fmax=None):
    a = audio - audio.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    freqs = np.fft.rfftfreq(len(a), 1 / fs)
    sig = (freqs > f0 - guard) & (freqs < f0 + guard)
    noise = ~sig & (freqs > 50) & (freqs < (fmax or fs / 2 - 100))
    return 10 * np.log10(spec[sig].sum() / max(spec[noise].sum(), 1e-30))


def run_kit(kit, x, n_blocks):
    """Stream complex x through the kit in n_blocks blocks; audio
    [C, n]."""
    st, outs = kit.init_state(), []
    for blk in np.asarray(x, np.complex64).reshape(n_blocks, -1):
        st, y = kit.apply(st, PC(torch.from_numpy(blk.real.copy()),
                                 torch.from_numpy(blk.imag.copy())))
        outs.append(y.numpy())
    return np.concatenate(outs, axis=-1)


def test_fm_stereo_separation():
    m = make_modem("FMS")
    fs = m.check_sample_rate(200000, 48000)
    n = m.block_multiple(fs) * 8192
    t = np.arange(n) / fs
    left = np.sin(2 * np.pi * 1000.0 * t)
    msg = (0.45 * left + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * left * np.sin(2 * np.pi * 38000.0 * t))
    x = np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(msg) / fs)
    audio = run_kit(m.build_kit(fs), x, 8)
    assert audio.shape[0] == 2
    aL, aR = audio[0, 19200:], audio[1, 19200:]
    sep = 10 * np.log10(np.mean(aL ** 2) / np.mean(aR ** 2))
    assert sep > 40, sep
    assert tone_snr(aL, 1000.0, 48000, fmax=15000) > 25


def test_am_snr_parity_with_scipy_chain():
    """The AM half of tests/test_parity.py: envelope detection against a
    scipy chain (|x|, DC removal, resample_poly), within 1 dB."""
    import scipy.signal as sig
    fs, f_aud, n = 6000.0, 600.0, 8 * 65536
    rng = np.random.default_rng(3)
    t = np.arange(n) / fs
    iq = (1 + 0.8 * np.sin(2 * np.pi * f_aud * t)) * np.exp(1j * 0.2)
    iq = iq + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ours = run_kit(make_modem("AM").build_kit(int(fs)), iq, 8)[0][48000:]
    env = np.abs(iq.astype(np.complex64))
    env = env - sig.lfilter(*sig.butter(2, 0.002), env)
    golden = sig.resample_poly(env, 8, 1)[48000:]
    snr_ours = tone_snr(ours, f_aud, 48e3, guard=40, fmax=15000)
    snr_gold = tone_snr(golden, f_aud, 48e3, guard=40, fmax=15000)
    assert snr_ours > 30
    assert abs(snr_ours - snr_gold) < 1.0, (snr_ours, snr_gold)


@pytest.mark.parametrize("name,sign", [("USB", +1), ("LSB", -1)])
def test_ssb_rejects_opposite_sideband(name, sign):
    m = make_modem(name)
    fs = m.check_sample_rate(5400, 48000)
    n = m.block_multiple(fs) * 2048
    t = np.arange(n) / fs
    audio_w = run_kit(m.build_kit(fs), np.exp(sign * 2j * np.pi * 900 * t),
                      4)[0][9600:]
    audio_u = run_kit(m.build_kit(fs), np.exp(-sign * 2j * np.pi * 1700 * t),
                      4)[0][9600:]
    assert tone_snr(audio_w, 900.0, 48000) > 30
    assert 10 * np.log10(np.mean(audio_u ** 2) / np.mean(audio_w ** 2)) < -30


def test_cw_beep_dsb_and_iq():
    """CW turns a carrier at DC into its 650 Hz beep; DSB product-detects
    a suppressed-carrier tone; I/Q passes (imag, real) through."""
    m = make_modem("CW")
    fs = m.check_sample_rate(m.default_sample_rate, 48000)
    audio = run_kit(m.build_kit(fs), np.ones(m.block_multiple(fs) * 512), 4)
    assert tone_snr(audio[0][4800:], 650.0, 48000) > 30
    m = make_modem("DSB")
    fs = m.check_sample_rate(5400, 48000)
    t = np.arange(m.block_multiple(fs) * 2048) / fs
    audio = run_kit(m.build_kit(fs),
                    np.sin(2 * np.pi * 700.0 * t) * np.exp(1j * 0.4), 4)
    assert tone_snr(audio[0][9600:], 700.0, 48000) > 30
    m = make_modem("I/Q")
    assert m.check_sample_rate(123456, 48000) == 48000
    x = np.arange(256) + 1j * np.arange(256, 512)
    audio = run_kit(m.build_kit(48000), x, 1)
    np.testing.assert_array_equal(audio[0], x.imag.astype(np.float32))
    np.testing.assert_array_equal(audio[1], x.real.astype(np.float32))
