"""The port's app shell against the JAX package's: frequency parsing,
config/session/bookmark files written by one package and read by the
other, the digital console, and the CLI end to end with ``--device cpu``
(``demod``, ``rx``, ``waterfall``, ``modems``, and ``demod`` through the
'pfbch' and 'single' channelizers) on the same capture files as the JAX
CLI, which runs its XLA path on the CPU.

The JAX CLI runs its Pallas kernels in interpret mode (its default on
the CPU is the XLA path), so both CLIs pick the same kernel-aligned block
size: the mix's per-block peak handling makes the mix depend on it.
Tolerances are the main path's: audio rms < 2e-3 and 99.5% quantile
< 5e-3 (the WAVs are 16-bit PCM on both sides), waterfall points 2e-3.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cubicsdr_tpu.ops.pallas.pfb as j_pfb  # noqa: E402
import cubicsdr_tpu.ops.pallas.route as j_route  # noqa: E402
from cubicsdr_tpu.app import (  # noqa: E402
    AppConfig as JAppConfig, BookmarkMgr as JBookmarkMgr,
    SessionMgr as JSessionMgr)
from cubicsdr_tpu.app import cli as jcli  # noqa: E402
from cubicsdr_tpu.app.bookmarks import (  # noqa: E402
    BookmarkEntry as JEntry, BookmarkRange as JRange)
from cubicsdr_tpu.app.digital_console import (  # noqa: E402
    DigitalConsole as JDigitalConsole)
from cubicsdr_tpu.io.wav import read_wav  # noqa: E402
from cubicsdr_tpu.receiver import DemodulatorMgr as JDemodulatorMgr  # noqa: E402
from cubicsdr_tpu.visual.waterfall import Waterfall as JWaterfall  # noqa: E402

from cubicsdr_tpu_torch.app import (  # noqa: E402
    AppConfig, BookmarkMgr, SessionMgr)
from cubicsdr_tpu_torch.app import cli  # noqa: E402
from cubicsdr_tpu_torch.app.bookmarks import (  # noqa: E402
    BookmarkEntry, BookmarkRange)
from cubicsdr_tpu_torch.app.digital_console import DigitalConsole  # noqa: E402
from cubicsdr_tpu_torch.io.sources import Station, SyntheticSource  # noqa: E402
from cubicsdr_tpu_torch.receiver import DemodulatorMgr  # noqa: E402
from cubicsdr_tpu_torch.visual.waterfall import Waterfall  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("s,expect", [
    ("100.1", 100.1e6), ("100.1M", 100.1e6), ("98700k", 98.7e6),
    ("2.4G", 2.4e9), ("146520000", 146520000.0), ("455k", 455000.0),
    (88.5, 88.5), ("162.55 MHz", 162.55e6),
])
def test_parse_frequency(s, expect):
    assert cli.parse_frequency(s) == pytest.approx(expect)
    assert cli.parse_frequency(s) == jcli.parse_frequency(s)


@pytest.mark.parametrize("f", [2.4e9, 100.1e6, 455e3, 999.0])
def test_format_frequency(f):
    assert cli.format_frequency(f) == jcli.format_frequency(f)
    assert cli.format_frequency(100.1e6) == "100.100000 MHz"


def test_config_files_load_in_both_packages(tmp_path):
    for make, load in ((AppConfig, JAppConfig.load),
                       (JAppConfig, AppConfig.load)):
        cfg = make(theme="jet", center_freq=98_500_000, waterfall_lps=60,
                   snap=12500, recording_path="rec")
        dev = cfg.get_device("rtl=0")
        dev.ppm, dev.gains, dev.settings = -2, {"TUNER": 30.5}, {"a": "1"}
        p = str(tmp_path / f"{make.__module__}.json")
        cfg.save(p)
        got = load(p)
        assert (got.theme, got.center_freq, got.waterfall_lps, got.snap,
                got.recording_path) == ("jet", 98_500_000, 60, 12500, "rec")
        d = got.get_device("rtl=0")
        assert (d.ppm, d.gains, d.settings) == (-2, {"TUNER": 30.5},
                                                {"a": "1"})


def _demods(mgr):
    a = mgr.new_demodulator(100e6, "NBFM", 12500)
    a.squelch_enabled, a.squelch_level = True, -40.0
    b = mgr.new_demodulator(100.2e6, "FSK", 19200)
    b.write_modem_settings({"bps": 2})
    b.muted = True


def test_session_files_load_in_both_packages(tmp_path):
    for (sess_w, mgr_w), (sess_r, mgr_r) in (
            ((SessionMgr, DemodulatorMgr), (JSessionMgr, JDemodulatorMgr)),
            ((JSessionMgr, JDemodulatorMgr), (SessionMgr, DemodulatorMgr))):
        mgr = mgr_w()
        _demods(mgr)
        sess = sess_w(mgr)
        sess.center_freq, sess.sample_rate, sess.solo_mode = (
            100_000_000, 2_400_000, True)
        p = str(tmp_path / f"{sess_w.__module__}.json")
        sess.save_session(p)
        mgr2 = mgr_r()
        sess2 = sess_r(mgr2)
        assert sess2.load_session(p, supported_rates=[2_000_000, 2_500_000])
        assert (sess2.center_freq, sess2.sample_rate, sess2.solo_mode) == (
            100_000_000, 2_500_000, True)
        got = [(d.demod_type, d.frequency, d.bandwidth, d.squelch_enabled,
                d.squelch_level, d.muted, d.read_modem_settings())
               for d in mgr2.get_demodulators()]
        want = [(d.demod_type, d.frequency, d.bandwidth, d.squelch_enabled,
                 d.squelch_level, d.muted, d.read_modem_settings())
                for d in mgr.get_demodulators()]
        assert got == want and got[1][-1]["bps"] == 2


def test_bookmark_files_load_in_both_packages(tmp_path):
    for (bm_w, entry, rng_), bm_r in (
            ((BookmarkMgr, BookmarkEntry, BookmarkRange), JBookmarkMgr),
            ((JBookmarkMgr, JEntry, JRange), BookmarkMgr)):
        bm = bm_w()
        bm.add_bookmark("weather", entry(label="WX", frequency=162.55e6,
                                         demod_type="NBFM"))
        bm.add_range(rng_("FM band", 98e6, 88e6, 108e6))
        for i in range(30):
            bm.add_recent(entry(label=f"r{i}", frequency=1e6 * i))
        p = str(tmp_path / f"{bm_w.__module__}.json")
        bm.save_to_file(p)
        bm.save_to_file(p)                      # second save -> .backup
        assert os.path.exists(p + ".backup")
        got = bm_r()
        assert got.load_from_file(p)
        assert got.get_bookmarks("weather")[0].frequency == 162.55e6
        assert [e.label for e in got.recents] == [e.label for e in bm.recents]
        assert len(got.recents) == 25 and got.ranges[0].end_freq == 108e6
        with open(p, "w") as f:                 # corrupt -> .lastloaded
            f.write("{corrupt")
        again = bm_r()
        assert again.load_from_file(p)
        assert again.get_bookmarks("weather")[0].label == "WX"


@pytest.mark.parametrize("bps", [1, 2, 3])
def test_digital_console_matches_jax(rng, bps):
    a = DigitalConsole(bits_per_symbol=bps, max_chars=200)
    b = JDigitalConsole(bits_per_symbol=bps, max_chars=200)
    for n in (40, 17, 64, 90):
        syms = rng.integers(0, 1 << bps, n).astype(np.int32)
        a.write_symbols(syms)
        b.write_symbols(syms)
        assert a.text == b.text
    assert a.hex_view() == b.hex_view() and a.ascii_view() == b.ascii_view()
    a.clear()
    assert a.text == ""


def test_plan_sessions_rebuild_the_plans(tmp_path):
    """A saved session of each synthetic plan (``Plan.manager``, what the
    chip smoke test's CLI and serve phases load) plans the same groups,
    in order, through either package's session loader."""
    from cubicsdr_tpu.receiver import plan_from_manager as j_plan
    from cubicsdr_tpu_torch.receiver import plan_from_manager
    from cubicsdr_tpu_torch.utils.synth import coverage_plans, scan58
    for plan in [scan58(), *coverage_plans()]:
        sess = SessionMgr(plan.manager(100e6))
        sess.center_freq, sess.sample_rate = 100_000_000, int(plan.fs)
        p = str(tmp_path / f"{plan.name}.json")
        sess.save_session(p)
        for load, mgr_cls, planner in ((SessionMgr, DemodulatorMgr,
                                        plan_from_manager),
                                       (JSessionMgr, JDemodulatorMgr,
                                        j_plan)):
            mgr = mgr_cls()
            assert load(mgr).load_session(p)
            specs, _ = planner(mgr)
            assert [(s.modem_name, s.bandwidth, s.count) for s in specs] \
                == [(s.modem_name, s.bandwidth, s.count) for s in plan.specs]
            offsets = [[d.frequency - 100e6 for d in ds]
                       for ds in planner(mgr)[1].values()]
            for got, want in zip(offsets, plan.freqs):
                np.testing.assert_allclose(got, want)


# --- the CLI end to end --------------------------------------------------

FS = 1_000_000


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX CLI on its Pallas path, the kernels interpreted."""
    monkeypatch.setattr(jcli, "_pallas_default", lambda: True)
    monkeypatch.setattr(j_pfb, "INTERPRET", True)
    monkeypatch.setattr(j_route, "INTERPRET", True)


def _write_cf32(path, stations, fs, n_blocks, block=1 << 17, seed=0):
    src = SyntheticSource(fs, block, stations, noise=0.01, seed=seed)
    cap = np.concatenate([next(src) for _ in range(n_blocks)])
    inter = np.empty(2 * len(cap), np.float32)
    inter[0::2], inter[1::2] = cap.real, cap.imag
    inter.tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """1 MS/s, 0.52 s: an FM station at +200 kHz (1 kHz tone) and an NBFM
    one at -250 kHz (700 Hz, 2.5 kHz deviation)."""
    d = tmp_path_factory.mktemp("cli")
    return _write_cf32(d / "cap.cf32",
                       [Station(200e3, "fm", audio_freq=1000.0),
                        Station(-250e3, "fm", audio_freq=700.0,
                                deviation=2.5e3)], FS, 4)


def _wavs_close(a, b, capture, fs):
    """The two WAVs, equal in shape, over the audio the capture's samples
    produce (the last block is zero-padded)."""
    da, ra = read_wav(a)
    db, rb = read_wav(b)
    assert ra == rb == 48000 and da.shape == db.shape
    n = os.path.getsize(capture) // 8 * 48000 // int(fs)
    assert da.shape[1] >= n, (da.shape, n)
    d = np.abs(da[:, :n] - db[:, :n])
    assert np.sqrt(np.mean(d * d)) < 2e-3, np.sqrt(np.mean(d * d))
    assert np.quantile(d, 0.995) < 5e-3
    return da


def _tone(x, f0):
    x = x[len(x) // 4:]
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return abs(np.fft.rfftfreq(len(x), 1 / 48000)[spec.argmax()] - f0)


@pytest.mark.parametrize("args,tone", [
    (["-f", "200k", "-m", "FM", "-b", "200000"], 1000.0),
    (["-f=-250k", "-m", "NBFM", "-b", "12500"], 700.0),
    (["-f", "200k", "-m", "FM", "--channelizer", "pfbch"], 1000.0),
    (["-f", "200k", "-m", "FM", "--channelizer", "single"], 1000.0),
    (["-f=-250k", "-m", "NBFM", "-b", "12500", "--squelch", "-120",
      "--channelizer", "pfbch"], 700.0),
])
def test_cli_demod_matches_jax(capture, tmp_path, jax_kernels, args,
                              tone):
    port, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    assert cli.main(["demod", capture, "-r", str(FS), *args, "-o", port,
                     "--device", "cpu"]) == 0
    assert jcli.main(["demod", capture, "-r", str(FS), *args,
                      "-o", ref]) == 0
    d = _wavs_close(port, ref, capture, FS)
    assert _tone(d[0], tone) < 10


def test_cli_rx_session_matches_jax(tmp_path, jax_kernels):
    """A session of FM, NBFM, AM, CW and BPSK demods saved by the JAX
    package, run by both CLIs on one 2 MS/s capture: the mixes agree."""
    fs = 2_000_000
    cap = _write_cf32(tmp_path / "cap.cf32",
                      [Station(300e3, "fm", audio_freq=1000.0),
                       Station(-200e3, "fm", audio_freq=700.0,
                               deviation=2.5e3),
                       Station(500e3, "am", audio_freq=500.0),
                       Station(-600e3, "tone", amplitude=0.2),
                       Station(100e3, "noise", amplitude=0.05)], fs, 3)
    mgr = JDemodulatorMgr()
    for f, t, bw in ((300e3, "FM", 200000), (-200e3, "NBFM", 12500),
                     (500e3, "AM", 6000), (-600e3, "CW", 500),
                     (100e3, "BPSK", 20000), (-200e3, "NBFM", 12500)):
        mgr.new_demodulator(100e6 + f, t, bw)
    sess = JSessionMgr(mgr)
    sess.center_freq, sess.sample_rate = 100_000_000, fs
    sp = str(tmp_path / "sess.json")
    sess.save_session(sp)
    port, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    assert cli.main(["rx", sp, cap, "-o", port, "--device", "cpu"]) == 0
    assert jcli.main(["rx", sp, cap, "-o", ref]) == 0
    d = _wavs_close(port, ref, cap, fs)
    assert d.shape[0] == 2 and np.abs(d).max() > 0.05


def test_cli_waterfall_lines_match_jax(capture, tmp_path, monkeypatch):
    """The waterfall subcommand's lines (the buffer it renders) agree with
    the JAX CLI's at 2e-3, NaN at the same points. The capture is short,
    so the stream's first lines, which hold NaN points, stay in the
    buffer: the port renders them as the floor and writes its PNG, where
    the JAX package's render raises IndexError (a NaN cast to an index)."""
    bufs = {}

    def keep(name, orig):
        def render_png(self, path):
            bufs[name] = self.buffer.copy()
            orig(self, path)
        return render_png

    monkeypatch.setattr(Waterfall, "render_png",
                        keep("port", Waterfall.render_png))
    monkeypatch.setattr(JWaterfall, "render_png",
                        keep("jax", JWaterfall.render_png))
    args = ["-r", str(FS), "--fft-size", "256", "--lines", "24"]
    port, ref = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert cli.main(["waterfall", capture, *args, "-o", port,
                     "--device", "cpu"]) == 0
    with pytest.raises(IndexError):
        jcli.main(["waterfall", capture, *args, "-o", ref])
    a, b = bufs["port"], bufs["jax"]
    assert a.shape == b.shape == (24, 256)
    assert np.isnan(a).any()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, atol=2e-3)
    assert Path(port).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_modems_listing_equals_jax(capsys):
    assert cli.main(["modems"]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["modems"]) == 0
    assert port == capsys.readouterr().out and "BPSK" in port


def test_cli_parser_has_the_jax_subcommands_and_device():
    """Every subcommand of the JAX CLI; --device defaults to the card,
    and so does multihost's device kind (--devices); rx takes --mesh with
    the options only that mode reads; bench takes the bench's own
    arguments (tests/test_torch_bench.py)."""
    import argparse
    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == {"demod", "waterfall", "rx", "serve",
                                "multihost", "modems", "bench"}
    argv = {"demod": ["x", "-r", "1", "-f", "1"], "waterfall": ["x", "-r",
            "1"], "rx": ["s", "x"], "serve": []}
    for name, args in argv.items():
        assert sub.choices[name].parse_args(args).device == "cuda"
    assert sub.choices["multihost"].parse_args([]).devices == "cuda"
    a = sub.choices["rx"].parse_args(
        ["s", "x", "--mesh", "time=2", "--fft-size", "256", "--checkpoint",
         "c.npz", "--record", "rec"])
    assert (a.mesh, a.fft_size, a.checkpoint, a.record) == (
        "time=2", 256, "c.npz", "rec")


def test_cli_on_the_card_without_cuda_fails_and_writes_nothing(capture,
                                                               tmp_path):
    """``--device`` defaults to the card: on a host without CUDA the
    command exits non-zero with the pipeline's error and writes no WAV."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = tmp_path / "never.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "cubicsdr_tpu_torch", "demod", capture,
         "-r", str(FS), "-f", "200k", "-o", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["waterfall", capture, "-r", str(FS), "-o",
                  str(tmp_path / "never.png")])
    assert not (tmp_path / "never.png").exists()
