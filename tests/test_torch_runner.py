"""The port's live loop (``cubicsdr_tpu_torch/app/runner.py``) vs the JAX
package's ``LiveReceiver`` on the same finite sources, on the CPU, plus
regression tests for faults of the reference loop (two from ADVICE.md,
and the deferred finish's double read of the zoom view).

Tolerances:
- recorded WAVs, mix and sink audio: the pipeline tolerances (rms of the
  difference < 2e-3, 99.5% quantile < 5e-3, tests/test_fused_route.py);
- waterfall lines, zoom and demod-view points: atol 2e-3 (the spectrum
  bound of tests/test_planar_spectrum.py). The first two lines of any
  stream are left out: the first frame is fft_size-1 zeros of history
  and one sample, whose flat |FFT| makes ceiling == floor, and the double
  EMA carries that frame into the second line, so both lines are 0/0 in
  exact arithmetic and rounding decides them (in either package);
- metrics block, sample and drop counts: exactly equal.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cubicsdr_tpu.app.runner import LiveReceiver as JLive  # noqa: E402
from cubicsdr_tpu.io.sources import Station, SyntheticSource  # noqa: E402
from cubicsdr_tpu.io.wav import read_wav  # noqa: E402
from cubicsdr_tpu.ops.planar import PLANAR as JPLANAR  # noqa: E402
import cubicsdr_tpu.receiver as J  # noqa: E402

import cubicsdr_tpu_torch.receiver as T  # noqa: E402
from cubicsdr_tpu_torch.app.runner import LiveReceiver  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.utils.interop import live_state_from_jax  # noqa: E402

FS = 1_000_000
L = 16750                 # the JAX package's choose_block_len at 1 MS/s
N_BLOCKS = 12
LINES = 4                 # holds lines 4-7 of the 7 a 12-block run draws
PTS_ATOL = 2e-3


def synth_blocks(n=N_BLOCKS, stations=None):
    src = SyntheticSource(FS, L, stations or [
        Station(200e3, "fm", audio_freq=1000.0)], noise=0.05, seed=3)
    return [next(src) for _ in range(n)]


def build(pkg, freqs=(200e3,), complex64=False):
    """A pipeline of ``freqs`` FM demods and its controls: planar (the
    port's plain path), or with ``complex64`` each package's complex64
    pipeline (the JAX package's default)."""
    mgr = pkg.DemodulatorMgr()
    for f in freqs:
        mgr.new_demodulator(100e6 + f, "FM", 200000)
    specs, keyed = pkg.plan_from_manager(mgr)
    if pkg is J:
        kw = {} if complex64 else {"dtype": JPLANAR}
    else:
        kw = ({"device": "cpu", "dtype": torch.complex64} if complex64
              else {"device": "cpu", "use_kernels": False})
    rx = pkg.ReceiverPipeline(FS, specs, block_len=L, **kw)
    return rx, pkg.controls_from_manager(mgr, rx, keyed, 100e6)


def run_live(Live, pkg, blocks, freqs=(200e3,), setup=None,
             complex64=False, **kw):
    """Run ``blocks`` through a fresh receiver; returns (receiver, the
    on_block outputs)."""
    rx, ctl = build(pkg, freqs, complex64)
    got = []
    kw.setdefault("waterfall_fft", 256)
    kw.setdefault("waterfall_lines", LINES)
    lr = Live(rx, ctl, iter(blocks), on_block=got.append, **kw)
    if setup is not None:
        setup(lr)
    lr.start_producer()
    assert lr.run_blocks() == len(blocks)
    lr.stop()
    return lr, got


def assert_audio_close(a, b):
    assert a.shape == b.shape
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert np.sqrt(np.mean(d * d)) < 2e-3
    assert np.quantile(d, 0.995) < 5e-3


def counts(snap):
    """The stream counters of a snapshot (the port's also holds its
    event counters and span summary, which the JAX package has not)."""
    return {k: (v["samples"], v["blocks"], v["dropped"])
            for k, v in snap.items()
            if k not in ("notes", "counters", "spans")}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The same 12-block source through both packages, recording on."""
    d = tmp_path_factory.mktemp("rec")
    blocks = synth_blocks()
    out = {"blocks": blocks}
    for name, Live, pkg in (("jax", JLive, J), ("port", LiveReceiver, T)):
        lr, got = run_live(Live, pkg, blocks,
                           record_path=str(d / f"{name}"))
        out[name] = dict(lr=lr, got=got,
                         wav=read_wav(str(d / f"{name}_demod0.wav")))
    return out


def test_live_receiver_matches_jax(recorded):
    j, p = recorded["jax"], recorded["port"]
    (wj, rj), (wp, rp) = j["wav"], p["wav"]
    assert rp == rj == 48000 and wp.shape == (1, N_BLOCKS * 804)
    assert_audio_close(wp, wj)
    for a, b in zip(p["got"], j["got"]):
        assert_audio_close(a["mix"], b["mix"])
        np.testing.assert_allclose(a["groups"][0]["level"],
                                   b["groups"][0]["level"], atol=0.05)
    np.testing.assert_allclose(p["lr"].waterfall.buffer,
                               j["lr"].waterfall.buffer, atol=PTS_ATOL)
    assert p["lr"].waterfall.buffer.max() > 0
    assert counts(p["lr"].metrics.snapshot()) == counts(
        j["lr"].metrics.snapshot())
    assert counts(p["lr"].metrics.snapshot())["pipeline"] == (
        N_BLOCKS * L, N_BLOCKS, 0)


def test_jax_stream_continues_in_port(recorded):
    """Six blocks in a JAX receiver; its pipeline and waterfall states
    move to a port receiver (``live_state_from_jax``), which runs blocks
    7-12 like the uninterrupted JAX run."""
    blocks = recorded["blocks"]
    lj, _ = run_live(JLive, J, blocks[:6])
    rx, ctl = build(T)
    got = []
    lr = LiveReceiver(rx, ctl, iter(blocks[6:]), on_block=got.append,
                      waterfall_fft=256, waterfall_lines=LINES)
    live_state_from_jax(lj, lr)
    lr.start_producer()
    assert lr.run_blocks() == 6
    lr.stop()
    for a, b in zip(got, recorded["jax"]["got"][6:]):
        assert_audio_close(a["mix"], b["mix"])
    drawn = int((np.abs(lr.waterfall.buffer).sum(axis=1) > 0).sum())
    assert drawn == 3
    np.testing.assert_allclose(
        lr.waterfall.buffer[-drawn:],
        recorded["jax"]["lr"].waterfall.buffer[-drawn:], atol=PTS_ATOL)


@pytest.mark.parametrize("dt,full", [(np.int16, 32768), (np.int8, 128)])
def test_raw_ingest_matches_jax(dt, full):
    """cs16/cs8 wire planes through the ring, converted on the device."""
    raw = [np.stack([np.clip(b.real * full, -full, full - 1),
                     np.clip(b.imag * full, -full, full - 1)]).astype(dt)
           for b in synth_blocks()]
    lj, gj = run_live(JLive, J, raw, ingest_dtype=dt)
    lp, gp = run_live(LiveReceiver, T, raw, ingest_dtype=dt)
    assert lp.ring.dtype == dt
    for a, b in zip(gp, gj):
        assert_audio_close(a["mix"], b["mix"])
    np.testing.assert_allclose(lp.waterfall.buffer, lj.waterfall.buffer,
                               atol=PTS_ATOL)


def test_views_and_sinks_match_jax(tmp_path):
    """Zoom view, demod view, one recorded row, a subset sink and a solo
    default sink, with two demods, in both packages."""
    freqs = (200e3, -300e3)
    blocks = synth_blocks(stations=[
        Station(200e3, "fm", audio_freq=1000.0),
        Station(-300e3, "fm", audio_freq=700.0)])
    res = {}
    for name, Live, pkg in (("jax", JLive, J), ("port", LiveReceiver, T)):
        d = tmp_path / name

        def setup(lr, d=d):
            lr.set_recording(1, True, path=str(d) + "rec")
            lr.set_audio_sink("sub", f"wav:{d}sub", demods=[0, 1])
            lr.set_audio_output(f"wav:{d}solo")
            lr.set_audio_solo(1)
            lr.set_demod_view(1)
            lr.set_zoom(200e3, 500_000)   # Q=2 divides L: device feed

        lr, _ = run_live(Live, pkg, blocks, freqs, setup=setup)
        res[name] = (lr, [read_wav(f"{d}{f}.wav")[0]
                          for f in ("rec_demod1", "sub", "solo")])
    (lj, wj), (lp, wp) = res["jax"], res["port"]
    for a, b in zip(wp, wj):
        assert_audio_close(a, b)
    assert lp.zoom.chunk == L and lp.zoom.points.shape == (256,)
    np.testing.assert_allclose(lp.zoom.points, lj.zoom.points,
                               atol=PTS_ATOL)
    np.testing.assert_allclose(lp.demod_spectrum, lj.demod_spectrum,
                               atol=PTS_ATOL)
    assert not [k for k in lp.metrics.notes if "error" in k]


def test_complex64_live_receiver_matches_jax(tmp_path):
    """The live loop around each package's complex64 pipeline: the float32
    ring assembled as complex64 in the step, the complex distributor,
    spectrum, demod and zoom views; recordings, mix, waterfall and view
    points at the tolerances above. The JAX loop runs its step eagerly:
    jitted, its complex64 NCO ramp departs from the eager one (ROADMAP
    queue 3), which the port matches."""
    freqs = (200e3, -300e3)
    blocks = synth_blocks(stations=[
        Station(200e3, "fm", audio_freq=1000.0),
        Station(-300e3, "fm", audio_freq=700.0)])
    res = {}
    for name, Live, pkg in (("jax", JLive, J), ("port", LiveReceiver, T)):
        d = tmp_path / name

        def setup(lr, d=d):
            lr.set_recording(0, True, path=str(d) + "rec")
            lr.set_demod_view(1)
            lr.set_zoom(200e3, 500_000)

        with jax.disable_jit(name == "jax"):
            lr, got = run_live(Live, pkg, blocks, freqs, setup=setup,
                               complex64=True)
        res[name] = (lr, got, read_wav(f"{d}rec_demod0.wav")[0])
    (lj, gj, wj), (lp, gp, wp) = res["jax"], res["port"]
    assert not lp.planar and lp.pipeline.dtype == torch.complex64
    assert_audio_close(wp, wj)
    for a, b in zip(gp, gj):
        assert_audio_close(a["mix"], b["mix"])
    for a, b in ((lp.waterfall.buffer, lj.waterfall.buffer),
                 (lp.zoom.points, lj.zoom.points),
                 (lp.demod_spectrum, lj.demod_spectrum)):
        np.testing.assert_allclose(a[-LINES + 2:] if a.ndim == 2 else a,
                                   b[-LINES + 2:] if b.ndim == 2 else b,
                                   atol=PTS_ATOL)
    assert lp.zoom.chunk == L and not lp.zoom.planar
    assert counts(lp.metrics.snapshot()) == counts(lj.metrics.snapshot())


def after_next_stage(lr, act):
    """Make ``lr``'s next stage that takes a block call ``act`` between
    that stage and the block's dispatch, on the consumer, once."""
    stage = lr._stage_block

    def stage_then_act():
        blk = stage()
        if blk is not None:
            lr._stage_block = stage
            act()
        return blk
    lr._stage_block = stage_then_act


def test_planar_complex_swap_mid_stream():
    """A planar receiver swapped to a complex64 plan (two demods) and back
    while its producer runs: each step sees blocks only in its own
    representation (a block staged before a swap, which lands between
    the block's stage and its dispatch, included), the ring
    drops nothing, ``on_block`` sees each plan's shapes, the zoom view
    follows; raw cs16 ingest into a complex64 plan is refused."""
    rx_p, ctl_p = build(T)
    rx_c, ctl_c = build(T, (200e3, -300e3), complex64=True)
    seen = []
    for rx in (rx_p, rx_c):
        def apply(st, inputs, rx=rx, orig=rx.apply):
            seen.append((rx is rx_c, isinstance(inputs[0], PC),
                         inputs[0].dtype if rx is rx_c else None))
            return orig(st, inputs)
        rx.apply = apply
    got = []
    lr = LiveReceiver(rx_p, ctl_p, iter(synth_blocks()), waterfall_fft=256,
                      on_block=lambda o: got.append(
                          o["groups"][0]["level"].shape))
    lr.set_zoom(200e3, 500_000)
    lr.start_producer()
    assert lr.run_blocks(max_blocks=4) == 4
    # Block 5 is staged under the planar plan; the swap lands before its
    # dispatch, so it reaches the complex64 step.
    after_next_stage(lr, lambda: lr.swap_pipeline(rx_c, ctl_c))
    assert lr.run_blocks(max_blocks=4) == 4
    assert not lr.planar and not lr.zoom.planar
    lr.swap_pipeline(rx_p, ctl_p)
    assert lr.planar and lr.zoom.planar
    assert lr.run_blocks() == 4
    lr.stop()
    assert seen == ([(False, True, None)] * 4
                    + [(True, False, torch.complex64)] * 4
                    + [(False, True, None)] * 4)
    assert got == [(1,)] * 4 + [(2,)] * 4 + [(1,)] * 4
    assert lr.ring.dropped_samples == 0
    assert counts(lr.metrics.snapshot())["pipeline"] == (N_BLOCKS * L,
                                                         N_BLOCKS, 0)
    assert np.isfinite(lr.zoom.points).all()
    with pytest.raises(ValueError, match="planar"):
        LiveReceiver(rx_c, ctl_c, iter(()), ingest_dtype=np.int16)
    lr16 = LiveReceiver(rx_p, ctl_p, iter(()), ingest_dtype=np.int16)
    with pytest.raises(ValueError, match="planar"):
        lr16.swap_pipeline(rx_c, ctl_c)
    assert lr16.pipeline is rx_p
    lr16.stop()


def test_set_display_carries_the_smoothed_display():
    """A runtime display change rebuilds the visual stages it touches and
    keeps the smoothed state, so the waterfall goes on drawing."""
    blocks = synth_blocks(8)
    rx, ctl = build(T, (200e3, -300e3))
    lr = LiveReceiver(rx, ctl, iter(blocks), waterfall_fft=256,
                      waterfall_lines=LINES)
    lr.set_demod_view(1)
    lr.start_producer()
    assert lr.run_blocks(max_blocks=4) == 4
    assert lr.demod_spectrum.shape == (256,)
    spec, st_spec = lr.spec, lr._st_spec
    lr.set_display(lps=45.0, fft_average_rate=0.5, peak_hold=True,
                   demod_view_fft=128)
    assert lr.display_params() == {
        "lps": 45.0, "fft_average_rate": 0.5, "peak_hold": True,
        "fft_size": 256, "demod_view_fft": 128}
    assert lr.spec is not spec and lr._st_spec is st_spec
    assert lr.demod_spectrum is None
    before = lr.waterfall.buffer.copy()
    assert lr.run_blocks() == 4
    lr.stop()
    assert lr.demod_spectrum.shape == (128,)
    assert np.isfinite(lr.demod_spectrum).all()
    assert not np.array_equal(lr.waterfall.buffer, before)
    assert np.isfinite(lr.waterfall.buffer[-2:]).all()
    assert "pipeline" in lr.status()


def test_set_source_swaps_the_producer():
    blocks = synth_blocks(5)
    rx, ctl = build(T)
    lr = LiveReceiver(rx, ctl, iter(blocks[:3]), waterfall_fft=256)
    lr.start_producer()
    assert lr.run_blocks() == 3
    lr.set_source(iter(blocks[3:]))
    assert lr.run_blocks() == 2
    lr.stop()
    assert counts(lr.metrics.snapshot())["pipeline"] == (5 * L, 5, 0)


def test_profile_trace_writes_a_trace(tmp_path):
    """The webview's ``profile`` action's trace: the profiler's ops, and
    the live loop's spans (producer, staging, consumer) on rows of their
    own."""
    import json

    from cubicsdr_tpu_torch.app.runner import BLOCK_SPANS
    from cubicsdr_tpu_torch.utils.metrics import profile_trace
    rx, ctl = build(T)
    lr = LiveReceiver(rx, ctl, iter(synth_blocks(3)), waterfall_fft=256,
                      on_block=lambda r: None)
    with profile_trace(str(tmp_path / "prof")) as prof:
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
        lr.start_producer()
        assert lr.run_blocks() == 3
        lr.stop()
    assert any("fft" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    names = {e["name"] for e in spans}
    assert set(BLOCK_SPANS) | {
        "ingest.write", "ingest.ready", "compiled.build"} <= names
    assert {e["args"]["seq"] for e in spans if e["name"] == "fanout"} \
        == {0, 1, 2}
    # The consumer ran on this thread: the profiler's own ranges too.
    ops = {e["name"] for e in trace["traceEvents"]
           if e.get("cat") == "cpu_op"}
    assert {"step.dispatch", "post.dispatch", "pull.wait", "fanout"} <= ops
    # On the profiler's clock: each span lies where its range lies (ts in
    # microseconds).
    rows = sorted(e["ts"] for e in spans if e["name"] == "fanout")
    ranges = sorted(e["ts"] for e in trace["traceEvents"]
                    if e.get("cat") == "cpu_op" and e["name"] == "fanout")
    assert len(rows) == len(ranges) == 3
    assert max(abs(a - b) for a, b in zip(rows, ranges)) < 50


def _fill(lr, n):
    for b in synth_blocks(n):
        assert lr.ring.write(np.ascontiguousarray(b.real, np.float32),
                             np.ascontiguousarray(b.imag, np.float32))


def test_run_blocks_after_stop_does_not_block():
    """A ``stop()`` from another thread lands during a bounded run,
    between a block's stage and its dispatch; a later run_blocks on the
    same receiver runs its next block and waits on nothing the stopped
    run left (run under its own timeout so a regression fails)."""
    rx, ctl = build(T)
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    _fill(lr, 2)

    def stop_elsewhere():
        t = threading.Thread(target=lr.stop, daemon=True)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    after_next_stage(lr, stop_elsewhere)
    assert lr.run_blocks(max_blocks=2, wait=False) == 1
    assert lr.ring.readable == L                # block 2 left in the ring
    lr._stop.clear()                    # a later run on the same receiver
    res = {}
    t = threading.Thread(target=lambda: res.setdefault(
        "n", lr.run_blocks(max_blocks=1, wait=False)), daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "run_blocks blocked after a stop"
    assert res["n"] == 1 and lr.ring.readable == 0
    lr.stop()


def test_rate_only_swap_drops_stale_staged_block():
    """A swap that changes the sample rate but keeps block_len rebuilds
    the ring; a block staged from the old ring, the swap landing between
    its stage and its dispatch, must be dropped, not run through the new
    plan."""
    rx1, ctl1 = build(T)
    rx2 = T.ReceiverPipeline(1_200_000, rx1.groups, block_len=15000,
                             use_kernels=False, device="cpu")
    rx1 = T.ReceiverPipeline(FS, rx1.groups, block_len=15000,
                             use_kernels=False, device="cpu")
    assert rx1.block_len == rx2.block_len
    lr = LiveReceiver(rx1, ctl1, iter(()), waterfall_fft=256)
    z = np.zeros(15000, np.float32)
    for _ in range(2):
        lr.ring.write(z, z)
    assert lr.run_blocks(max_blocks=1, wait=False) == 1

    def swap():                         # block 2 is staged
        lr.swap_pipeline(rx2, ctl1)
        lr.ring.write(z, z)                     # one block in the new ring
    after_next_stage(lr, swap)
    assert lr.run_blocks(max_blocks=1, wait=False) == 1
    snap = lr.metrics.snapshot()["pipeline"]
    assert snap["dropped"] == 15000 and snap["blocks"] == 3
    assert lr.pipeline is rx2 and lr.ring.fill == 0     # the new block ran
    lr.stop()


def test_zoom_view_error_propagates():
    """A failure of the device-fed zoom view is raised from run_blocks,
    not turned into a metrics note (a CUDA fault there would otherwise
    leave the loop running without its zoom view)."""
    rx, ctl = build(T)
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    lr.set_zoom(200e3, 500_000)

    def broken(iq):
        raise RuntimeError("zoom view failed")

    lr.zoom.feed_device = broken
    _fill(lr, 1)
    with pytest.raises(RuntimeError, match="zoom view failed"):
        lr.run_blocks(max_blocks=1, wait=False)
    lr.stop()
    assert not lr.metrics.notes


def test_zoom_off_during_the_deferred_finish():
    """The deferred finish runs outside the step lock, so a zoom-off may
    set ``zoom`` to None between its check and its use of the view; it
    reads the view once (the JAX package's finish reads it twice and
    raises AttributeError in the consumer now and then, as
    tests/test_churn.py shows)."""
    from cubicsdr_tpu_torch.ops.planar import PC
    rx, ctl = build(T)
    reads, fed = [], []

    class View:
        def feed(self, p):
            fed.append(p.shape)

    class Racy(LiveReceiver):
        # Each read of ``zoom`` takes the next value: the view, then None.
        zoom = property(lambda self: reads.pop(0) if reads else None,
                        lambda self, v: None)

    lr = Racy(rx, ctl, iter(()), waterfall_fft=256)
    blk = synth_blocks(1)[0]
    planes = (blk.real.copy(), blk.imag.copy())
    snap, ctl_dev = lr._device_controls()
    lr.state, out = lr.step(lr.state, ((torch.from_numpy(planes[0]),
                                        torch.from_numpy(planes[1])),
                                       ctl_dev))
    disp = lr._fanout_dispatch(out, snap)
    reads[:] = [View(), None]
    lr._fanout_finish(disp, PC(*out["iq"]), out, planes)
    assert fed == [(2, L)]
    lr.stop()


def test_audio_tap_keeps_only_the_mixes():
    """The audio tap's 64 blocks hold each block's mix and nothing of the
    block's packed pull, of which the mix is a view (a tap of views kept
    64 whole pulls, several times the mixes' bytes)."""
    lr, got = run_live(LiveReceiver, T, synth_blocks(70))
    tap = list(lr.audio_tap)
    assert len(tap) == lr.audio_tap.maxlen == 64
    held = {id(m if m.base is None else m.base):
            (m if m.base is None else m.base).nbytes for m in tap}
    assert sum(held.values()) <= 64 * got[-1]["mix"].nbytes
    for m, g in zip(tap, got[-64:]):
        np.testing.assert_array_equal(m, g["mix"])
