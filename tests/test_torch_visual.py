"""The port's visual chain (``cubicsdr_tpu_torch/visual``, ``ops/fftops``)
vs the JAX package's, on the same numpy inputs.

Tolerances:
- the distributor's frames, valid masks and pacer phase: exactly equal
  (the pacer runs in float32 in both packages);
- spectrum points atol 2e-3 and the ceiling rtol 1e-3, the JAX package's
  own bound between two FFT forms (tests/test_planar_spectrum.py:22-26):
  the port takes a complex FFT where the JAX planar path takes a
  four-step matmul FFT;
- display-state shifts and rescales: exactly equal (pure data movement).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.ops import planar as jpl  # noqa: E402
from cubicsdr_tpu.visual import (  # noqa: E402
    FFTDataDistributor as JDistributor, ScopeProcessor as JScope,
    SpectrumProcessor as JSpectrum)
from cubicsdr_tpu.visual.planar_spectrum import (  # noqa: E402
    PlanarSpectrumProcessor as JPlanarSpectrum)
from cubicsdr_tpu.visual import spectrum as jspec  # noqa: E402
from cubicsdr_tpu.ops import fftops as jfft  # noqa: E402

from cubicsdr_tpu_torch.ops import fftops  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.visual import (  # noqa: E402
    FFTDataDistributor, Gradient, PlanarSpectrumProcessor, ScopeProcessor,
    SpectrumProcessor, THEMES, Waterfall)
from cubicsdr_tpu_torch.visual.scope import scope_trace  # noqa: E402
from cubicsdr_tpu_torch.visual.spectrum import (  # noqa: E402
    SpectrumView, ZoomSpectrumView, _hide_dc, mags_to_display,
    rescale_display_state, shift_display_state)
from tests.conftest import make_tone  # noqa: E402

PTS_ATOL = 2e-3
CEIL_RTOL = 1e-3


def pc_of(x):
    return PC(torch.from_numpy(np.ascontiguousarray(x.real, np.float32)),
              torch.from_numpy(np.ascontiguousarray(x.imag, np.float32)))


def noisy_tone(n, f0, fs, rng):
    x = make_tone(n, f0, fs) + 0.05 * (rng.standard_normal(n)
                                       + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


@pytest.mark.parametrize("fs,fft,L,lps", [
    (480e3, 512, 48000, 37.0),       # ragged hop, partial last line
    (100e3, 2048, 10000, 113.0),     # lines overlap (hop < fft)
    (1e6, 512, 16750, 30.0),         # the live loop's test shape
])
def test_distributor_frames_and_masks_equal(fs, fft, L, lps):
    rng = np.random.default_rng(1)
    jd = JDistributor(fft, fs, lines_per_second=lps, block_len=L,
                      dtype=jpl.PLANAR)
    td = FFTDataDistributor(fft, fs, lines_per_second=lps, block_len=L)
    assert td.max_lines == jd.max_lines
    sj, st = jd.init_state(), td.init_state()
    n_valid = 0
    for _ in range(5):
        x = noisy_tone(L, 10e3, fs, rng)
        sj, (fj, vj) = jd.apply(sj, jpl.from_complex(x))
        st, (ft, vt) = td.apply(st, pc_of(x))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(ft.re.numpy(), np.asarray(fj.re))
        np.testing.assert_array_equal(ft.im.numpy(), np.asarray(fj.im))
        assert float(st[1]) == float(sj[1])          # pacer phase
        n_valid += int(vt.sum())
    assert abs(n_valid - 5 * L / fs * lps) <= 2


def test_distributor_latches_block_len():
    td = FFTDataDistributor(256, 200e3, lines_per_second=30)
    st = td.init_state()
    z = torch.zeros(6400)
    st, (fr, v) = td.apply(st, PC(z, z))
    assert td.block_len == 6400 and fr.shape == (td.max_lines, 256)


@pytest.mark.parametrize("peak_hold", [False, True])
def test_planar_spectrum_matches_jax(peak_hold):
    """Points within atol 2e-3 and the ceiling within rtol 1e-3 of the JAX
    planar processor (four-step FFT), masked frames skipped alike."""
    rng = np.random.default_rng(2)
    fft = 512
    jp = JPlanarSpectrum(fft, peak_hold=peak_hold)
    tp = PlanarSpectrumProcessor(fft, peak_hold=peak_hold)
    sj, st = jp.init_state(), tp.init_state()
    valid = np.array([True] * 5 + [False] * 3)
    for b, amp in enumerate((2.0, 0.05, 1.0)):      # burst, quiet, steady
        x = (amp * noisy_tone(tp.n * 8, 125e3, 1e6, rng)).reshape(8, tp.n)
        sj, oj = jp.apply(sj, jpl.from_complex(x), valid=jnp.asarray(valid))
        st, ot = tp.apply(st, pc_of(x), valid=torch.from_numpy(valid))
        np.testing.assert_allclose(ot["spectrum_points"].numpy(),
                                   np.asarray(oj["spectrum_points"]),
                                   atol=PTS_ATOL)
        np.testing.assert_allclose(float(ot["fft_ceiling"]),
                                   float(oj["fft_ceiling"]), rtol=CEIL_RTOL)
        if peak_hold:
            np.testing.assert_allclose(
                ot["spectrum_hold_points"].numpy(),
                np.asarray(oj["spectrum_hold_points"]), atol=PTS_ATOL)
    assert bool(st["primed"]) and st["primed"].dtype == torch.bool
    if peak_hold:       # the burst stays held over the quieter blocks
        hold = ot["spectrum_hold_points"].numpy()
        assert hold.max() >= ot["spectrum_points"].numpy().max() - 1e-3


def test_complex_spectrum_and_helpers_match_jax():
    """SpectrumProcessor (complex frames), the DC hide, mags_to_display and
    the fftops helpers against the JAX package's."""
    fft, fs, f0 = 256, 1e6, 125e3
    jsp = JSpectrum(fft, hide_dc=True)
    tsp = SpectrumProcessor(fft, hide_dc=True)
    x = make_tone(tsp.n * 6, f0, fs).reshape(6, tsp.n)
    sj, oj = jsp.apply(jsp.init_state(), jnp.asarray(x), dc_offset_bins=128)
    st, ot = tsp.apply(tsp.init_state(), torch.from_numpy(x),
                       dc_offset_bins=128)
    np.testing.assert_allclose(ot["spectrum_points"].numpy(),
                               np.asarray(oj["spectrum_points"]),
                               atol=PTS_ATOL)
    assert abs(int(ot["spectrum_points"].argmax())
               - (fft // 2 + int(f0 / fs * fft))) <= 1
    pts = np.linspace(0, 1, fft).astype(np.float32)
    np.testing.assert_array_equal(
        _hide_dc(torch.from_numpy(pts), 100, fft).numpy(),
        np.asarray(jspec._hide_dc(jnp.asarray(pts), 100, fft)))
    mags = np.abs(np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1))
    _, dj = jspec.mags_to_display(jsp, jsp.init_state(), mags)
    _, dt = mags_to_display(tsp, tsp.init_state(), mags)
    np.testing.assert_allclose(dt, dj, atol=PTS_ATOL)
    win = fftops.hann(tsp.n)
    np.testing.assert_array_equal(win, jfft.hann(tsp.n))
    np.testing.assert_allclose(
        fftops.spectrum_frames(torch.from_numpy(x), tsp.n, win).numpy(),
        np.asarray(jfft.spectrum_frames(jnp.asarray(x), tsp.n, win)),
        rtol=1e-4, atol=1e-3)


def test_scope_matches_jax():
    t = np.arange(256 * 4) / 48000
    a = np.stack([np.sin(2 * np.pi * 3000 * t),
                  np.cos(2 * np.pi * 500 * t)]).astype(np.float32)
    ta = torch.from_numpy(a)
    assert scope_trace(ta, "Y").shape == (1, a.shape[1])
    assert scope_trace(ta[:1], "2Y").shape == (2, a.shape[1])
    assert scope_trace(ta, "XY").shape == (2, a.shape[1])
    js, ts = JScope(fft_size=128), ScopeProcessor(fft_size=128)
    _, oj = js.apply(js.init_state(), jnp.asarray(a))
    _, ot = ts.apply(ts.init_state(), ta)
    np.testing.assert_allclose(ot["spectrum_points"].numpy(),
                               np.asarray(oj["spectrum_points"]),
                               atol=PTS_ATOL)


def test_spectrum_view_zoom():
    """SpectrumView (planar frames) + the planar core: a tone 10 kHz above
    the view center lands right of center, as in the JAX package's
    test_visual.py."""
    fs, fft_size, view_off = 1e6, 256, 200e3
    sv = SpectrumView(fs, view_off, 125e3, fft_size)
    sp = PlanarSpectrumProcessor(fft_size)
    x = make_tone(1 << 17, view_off + 10e3, fs)
    _, frames = sv.apply(sv.init_state(), pc_of(x))
    assert frames.shape[0] >= 1
    _, out = sp.apply(sp.init_state(), frames)
    expect = fft_size // 2 + int(10e3 / sv.resample_bw * fft_size)
    assert abs(int(out["spectrum_points"].argmax()) - expect) <= 2


def test_shift_display_state_semantics():
    n = 16
    st = {"ma": torch.arange(n, dtype=torch.float32),
          "maa": torch.arange(n, dtype=torch.float32) + 100}
    ma = shift_display_state(st, 3)["ma"].numpy()
    # left shift; vacated tail keeps stale values (memmove, no memset).
    np.testing.assert_array_equal(ma[: n - 3], np.arange(3, n))
    np.testing.assert_array_equal(ma[n - 3:], [13, 14, 15])
    ma = shift_display_state(st, -2)["ma"].numpy()
    np.testing.assert_array_equal(ma[2:], np.arange(n - 2))
    np.testing.assert_array_equal(ma[:2], [0, 1])
    np.testing.assert_array_equal(st["ma"].numpy(), np.arange(n))
    for k in (5, -7):
        ref = jspec.shift_display_state(
            {key: jnp.asarray(v.numpy()) for key, v in st.items()}, k)
        got = shift_display_state(st, k)
        for key in st:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]))


def test_rescale_display_state_semantics():
    n = 16
    st = {"ma": torch.arange(n, dtype=torch.float32),
          "maa": torch.zeros(n)}
    zin = rescale_display_state(st, zoom_in=True)["ma"].numpy()
    np.testing.assert_array_equal(zin, [n // 4 + i // 2 for i in range(n)])
    zout = rescale_display_state(st, zoom_in=False)["ma"].numpy()
    assert (zout[: n // 4] == 0).all() and (zout[-n // 4:] == 0).all()
    np.testing.assert_array_equal(
        zout[n // 4: n - n // 4],
        [(i - n // 4) * 2 for i in range(n // 4, n - n // 4)])
    for zoom_in in (True, False):
        ref = jspec.rescale_display_state(
            {key: jnp.asarray(v.numpy()) for key, v in st.items()}, zoom_in)
        got = rescale_display_state(st, zoom_in)
        np.testing.assert_array_equal(got["ma"].numpy(),
                                      np.asarray(ref["ma"]))


def _tone_planes(fs, f, n, amp=1.0):
    t = np.arange(n) / fs
    return np.stack([amp * np.cos(2 * np.pi * f * t),
                     amp * np.sin(2 * np.pi * f * t)]).astype(np.float32)


def test_retune_pans_not_resets():
    fs, L = 1_000_000, 1 << 16
    zv = ZoomSpectrumView(fs, L, fft_size=256, device="cpu")
    zv.set_view(0.0, 250_000)               # resample_bw = 250 kHz
    assert zv.resample_bw == 250_000
    planes = _tone_planes(fs, 50_000, 8 * L)
    for b in range(8):
        pts = zv.feed(planes[:, b * L: (b + 1) * L])
    assert pts is not None
    peak_before = int(np.argmax(pts))
    ma_before = zv.st_core["ma"].numpy().copy()
    assert ma_before.max() > 0
    # Retune up by 1/4 of the span: the tone appears shifted LEFT by n/4
    # bins at once, with the smoothed history carried over.
    zv.set_view(62_500, 250_000)
    k = int(np.floor(62_500 / (zv.resample_bw / zv.n)))
    np.testing.assert_allclose(zv.st_core["ma"].numpy()[: zv.n - k],
                               ma_before[k:], rtol=1e-6)
    for b in range(2):
        pts2 = zv.feed(planes[:, b * L: (b + 1) * L])
    expected = peak_before - (zv.core.fft_size // 4)
    assert abs(int(np.argmax(pts2)) - expected) <= 2


def test_zoom_rescales_history():
    fs, L = 1_000_000, 1 << 16
    zv = ZoomSpectrumView(fs, L, fft_size=256, device="cpu")
    zv.set_view(0.0, 250_000)
    planes = _tone_planes(fs, 31_250, 8 * L)   # +1/8 of the 250k span
    for b in range(8):
        pts = zv.feed(planes[:, b * L: (b + 1) * L])
    off_before = int(np.argmax(pts)) - 128
    ma_before = zv.st_core["ma"].numpy().copy()
    zv.set_view(0.0, 125_000)                  # zoom IN 2x
    assert zv.resample_bw == 125_000
    n = zv.n
    np.testing.assert_allclose(zv.st_core["ma"].numpy(),
                               ma_before[n // 4 + np.arange(n) // 2],
                               rtol=1e-6)
    for b in range(8):
        pts2 = zv.feed(planes[:, b * L: (b + 1) * L])
    assert abs(int(np.argmax(pts2)) - 128 - 2 * off_before) <= 2


def test_zoom_program_cache_reuse():
    """Zooming in then back out reuses the cached front of each revisited
    (P, Q, chunk)."""
    fs, L = 1_000_000, 20000
    v = ZoomSpectrumView(fs, L, fft_size=128, device="cpu")
    step_full = v._step
    v.set_view(0.0, fs / 2)          # zoom in one step
    step_half = v._step
    assert step_half is not step_full
    v.set_view(0.0, fs)              # back out: a cache hit
    assert v._step is step_full
    v.set_view(0.0, fs / 2)          # in again: a cache hit too
    assert v._step is step_half
    assert v.front_cache_hits >= 2
    planes = np.random.default_rng(0).standard_normal((2, L)).astype(
        np.float32)
    for _ in range(3):
        v.feed(planes)
    assert v.points is not None


def test_prewarm_populates_cache_and_surfaces_failures(monkeypatch):
    fs, L = 1_000_000, 20000
    v = ZoomSpectrumView(fs, L, fft_size=128, device="cpu")
    assert len(v._front_cache) == 1
    t = v.prewarm_adjacent()              # on a background thread
    t.join(timeout=60)
    assert not t.is_alive()
    # Full-band view has one neighbor below (fs/2); nothing above.
    assert len(v._front_cache) == 2 and v.level_builds == 1
    v.set_view(0.0, fs / 2)          # pre-warmed: no new front
    assert v.front_cache_hits >= 1

    def boom(bw):
        raise RuntimeError("no front")

    # A level that fails to build is not swallowed.
    monkeypatch.setattr(v, "_make_front", boom)
    with pytest.raises(RuntimeError, match="no front"):
        v.prewarm_level(fs / 8)
    with pytest.raises(RuntimeError, match="no front"):
        v.prewarm_adjacent(background=False)


def test_waterfall_roll_and_render(tmp_path):
    wf = Waterfall(64, lines=16, theme="jet")
    wf.add_lines(np.linspace(0, 1, 64))
    wf.add_lines(np.tile(np.linspace(0, 1, 64), (3, 1)))
    np.testing.assert_array_equal(
        wf.buffer[-4:], np.tile(np.linspace(0, 1, 64, dtype=np.float32),
                                (4, 1)))
    rgb = wf.render_rgb()
    assert rgb.shape == (16, 64, 3)
    assert rgb.min() >= 0 and rgb.max() <= 1
    p = str(tmp_path / "wf.png")
    wf.render_png(p)
    assert os.path.getsize(p) > 100
    for name in ["default", "jet", "bw", "sharp", "rad", "touch", "hd",
                 "radar"]:
        assert name in THEMES


def test_gradient_interpolation():
    g = Gradient([(0.0, (0, 0, 0)), (1.0, (1, 0.5, 0))])
    np.testing.assert_allclose(g.generate(11)[5], [0.5, 0.25, 0], atol=1e-6)


def test_zoom_view_default_device_is_the_card():
    """Built without ``device``, the zoom view is on the card; a host with
    no CUDA device raises instead of falling back to the CPU. Decided here,
    at run time, not at collection."""
    if torch.cuda.is_available():
        assert ZoomSpectrumView(2.4e6, 2400).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ZoomSpectrumView(2.4e6, 2400)
