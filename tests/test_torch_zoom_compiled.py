"""The port's compiled zoom view (``cubicsdr_tpu_torch/visual/spectrum.py``
``ZoomSpectrumView``: one ``CompiledStep`` per zoom level, built by the
prewarm, a background thread building the adjacent levels) on the CPU.

Tolerances:
- compiled against the plain eager front, and ``LiveReceiver(compiled=
  True)`` against ``compiled=False``: bit for bit (the CPU
  ``CompiledStep`` runs the same ops on copies of the same values);
- against the JAX package's jitted ``ZoomSpectrumView``: points atol 2e-3,
  ``PTS_ATOL`` of tests/test_torch_visual.py (the port's complex FFT
  against the JAX planar path's four-step matmul FFT). The points are
  magnitudes, so the NCO phase hazard of ROADMAP queue 3 does not bite.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cubicsdr_tpu.ops import planar as jpl  # noqa: E402
from cubicsdr_tpu.visual import spectrum as jspec  # noqa: E402

import cubicsdr_tpu_torch.receiver as T  # noqa: E402
from cubicsdr_tpu_torch.app.runner import LiveReceiver  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.utils.compiled import CompiledStep  # noqa: E402
from cubicsdr_tpu_torch.visual import spectrum as spectrum_mod  # noqa: E402
from cubicsdr_tpu_torch.visual.spectrum import ZoomSpectrumView  # noqa: E402
from tests.test_torch_runner import build, synth_blocks  # noqa: E402

PTS_ATOL = 2e-3
FS = 1_000_000
FFT = 128
# (offset, bandwidth) per stage of the walk: zoom in twice, retune at the
# same level, zoom back out, and revisit two levels.
WALK = [(100e3, 250e3), (100e3, 125e3), (100e3, 62_500.0),
        (130e3, 62_500.0), (130e3, 125e3), (130e3, 250e3),
        (130e3, 125e3)]
BLOCKS_PER_STAGE = 2


def planes_of(n, seed):
    """A tone at +110 kHz in noise, float32 planes [2, n]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = (np.exp(2j * np.pi * 110e3 * t)
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return np.stack([x.real, x.imag]).astype(np.float32)


def walk(view, L, feed, seed=5, after=None):
    """Feed the view ``BLOCKS_PER_STAGE`` blocks of L per stage of WALK
    (``after(view)`` after each stage); returns per block (points,
    lines) as host copies."""
    p = planes_of(len(WALK) * BLOCKS_PER_STAGE * L, seed)
    out, b = [], 0
    for off, bw in WALK:
        view.prewarm_level(bw)
        view.set_view(off, bw)
        for _ in range(BLOCKS_PER_STAGE):
            blk = p[:, b * L:(b + 1) * L]
            b += 1
            if feed == "device":
                x = torch.from_numpy(blk)
                x = (PC(x[0], x[1]) if view.planar
                     else torch.complex(x[0], x[1]))
                pts, nv = view.feed_device(x)
                out.append((pts.clone(), int(nv)))
            else:
                pts = view.feed(blk)
                out.append((None if pts is None else pts.copy(),
                            getattr(view, "lines", None)))
        if after is not None:
            after(view)
    return out


def same_blocks(a, b):
    for (x, nx), (y, ny) in zip(a, b):
        assert nx == ny
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y),
                                  equal_nan=True)


@pytest.mark.parametrize("feed,L,dtype", [
    ("device", 32768, "planar"), ("device", 32768, "complex64"),
    ("host", 20001, "planar")])
def test_compiled_view_equals_eager_front(feed, L, dtype):
    """(a) Every block of the walk: the compiled view's points and line
    count equal the plain eager front's bit for bit, on the
    device-resident feed (chunk == block) in both representations and
    the host-fed one (a misaligned block); the display state after the
    walk too. Each level is built once: the revisits reuse theirs."""
    kw = {} if dtype == "planar" else {"dtype": torch.complex64}
    views = {c: ZoomSpectrumView(FS, L, fft_size=FFT, device="cpu",
                                 compiled=c, **kw) for c in (True, False)}
    got = {c: walk(v, L, feed) for c, v in views.items()}
    assert isinstance(views[True]._step, CompiledStep)
    assert not isinstance(views[False]._step, CompiledStep)
    same_blocks(got[True], got[False])
    assert sum(n for _, n in got[True]) > 0
    for k, v in views[True].st_core.items():
        assert np.array_equal(v.numpy(), views[False].st_core[k].numpy(),
                              equal_nan=True), k
    levels = {bw for _, bw in WALK}
    for v in views.values():
        assert v.level_builds == len(levels)
        assert v.front_cache_hits >= 2
    if feed == "host":
        assert views[True].chunk != L       # the walk ends misaligned


def test_compiled_view_matches_jax_view():
    """(b) The port's compiled view against the JAX package's jitted
    ``ZoomSpectrumView`` (planar) over the same walk from the same
    input, host-fed at an explicit block length: points at PTS_ATOL
    from the fifth block (about one line per block) on. A fresh display
    is ill-conditioned at first: its first two lines are 0/0 in exact
    arithmetic (tests/test_torch_runner.py), and the ceiling and floor
    EMAs (rate 0.05) start from them, so the next lines' points, up to
    20 here, differ by up to 6e-3 (0.3%) before they settle."""
    L = 32768
    port = ZoomSpectrumView(FS, L, fft_size=FFT, device="cpu")
    ref = jspec.ZoomSpectrumView(FS, L, fft_size=FFT, dtype=jpl.PLANAR)
    got_p, got_j = walk(port, L, "host"), walk(ref, L, "host")
    compared = 0
    for i, ((a, _), (b, _)) in enumerate(zip(got_p, got_j)):
        assert (a is None) == (b is None)
        if a is not None and i >= 4:
            np.testing.assert_allclose(a, np.asarray(b), atol=PTS_ATOL)
            compared += 1
    assert compared == len(got_p) - 4
    assert port.view_offset == ref.view_offset
    assert port.resample_bw == ref.resample_bw


class _SlowBuild:
    """CompiledStep.build replaced by a slow counting one: the CPU build
    is a no-op, so the race needs a build that takes time."""

    def __init__(self, delay=0.2, fail_on_thread=None):
        self.calls = {}
        self.started = threading.Event()
        self.delay = delay
        self.fail_on_thread = fail_on_thread
        self.lock = threading.Lock()

    def __call__(self, step):
        with self.lock:
            self.calls[id(step)] = self.calls.get(id(step), 0) + 1
        self.started.set()
        threading.Event().wait(self.delay)
        if threading.current_thread().name == self.fail_on_thread:
            raise RuntimeError("planted build failure")


def join_prewarms():
    for th in threading.enumerate():
        if th.name == "cs-zoom-prewarm":
            th.join(timeout=30)
            assert not th.is_alive()


def test_prewarm_race_builds_each_level_once(monkeypatch):
    """(c) A background ``prewarm_adjacent`` racing ``prewarm_level`` of the
    same levels (and eight more threads doing the same) builds each
    level once: the waiters wait for the build in progress."""
    slow = _SlowBuild()
    monkeypatch.setattr(CompiledStep, "build",
                        lambda st, background=False: slow(st))
    v = ZoomSpectrumView(FS, 20000, fft_size=FFT, device="cpu")
    v.set_view(0.0, 250e3)
    t = v.prewarm_adjacent()
    assert slow.started.wait(10)
    others = [threading.Thread(target=v.prewarm_level, args=(bw,))
              for _ in range(4) for bw in (125e3, 500e3)]
    for o in others:
        o.start()
    v.prewarm_level(125e3)                 # waits for the background build
    v.prewarm_level(500e3)
    for th in [t, *others]:
        th.join(timeout=30)
        assert not th.is_alive()
    assert len(slow.calls) == 2 and set(slow.calls.values()) == {1}
    assert v.level_builds == 2
    steps = {lv.bw: lv.step for lv in v._front_cache.values()}
    assert {id(steps[125e3]), id(steps[500e3])} == set(slow.calls)
    assert all(lv.built for lv in v._front_cache.values()
               if lv.bw != FS and lv.bw != 250e3)


def test_background_failure_is_kept_and_raised(monkeypatch):
    """(d) A build that fails on the background thread is kept for its
    level: the next ``prewarm_level`` of that level raises it (once; the
    one after builds again), and ``on_error`` hears of it as it
    happens."""
    slow = _SlowBuild(delay=0.0, fail_on_thread="cs-zoom-prewarm")
    monkeypatch.setattr(CompiledStep, "build",
                        lambda st, background=False: slow(st))
    v = ZoomSpectrumView(FS, 20000, fft_size=FFT, device="cpu")
    heard = []
    v.on_error = lambda bw, e: heard.append((bw, str(e)))
    v.prewarm_level(250e3)
    v.set_view(0.0, 250e3)
    v.prewarm_adjacent().join(timeout=30)
    assert sorted(heard) == [(125e3, "planted build failure"),
                             (500e3, "planted build failure")]
    with pytest.raises(RuntimeError, match="planted"):
        v.prewarm_level(125e3)
    v.prewarm_level(125e3)                 # built here, on this thread
    assert v.level_builds == 2 and v._make_front(500e3).error is not None


def test_background_failure_noted_by_live_receiver(monkeypatch):
    """(d) Under ``LiveReceiver``: a failed background build of an
    adjacent level is noted in ``metrics``; a zoom to that level raises
    the kept failure and leaves the view where it was; the next zoom
    there builds it."""
    slow = _SlowBuild(delay=0.0, fail_on_thread="cs-zoom-prewarm")
    monkeypatch.setattr(CompiledStep, "build",
                        lambda st, background=False: slow(st))
    rx, ctl = build(T)
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    lr.set_zoom(200e3, 250e3)
    z = lr.zoom
    join_prewarms()
    assert set(lr.metrics.notes) >= {"zoom_error_build_125000",
                                     "zoom_error_build_500000"}
    with pytest.raises(RuntimeError, match="planted"):
        lr.set_zoom(200e3, 125e3)
    assert lr.zoom is z and z.resample_bw == 250e3
    lr.set_zoom(200e3, 125e3)
    assert z.resample_bw == 125e3
    join_prewarms()
    lr.stop()


def test_live_receiver_compiled_zoom_equals_eager():
    """(e) ``LiveReceiver(compiled=True)`` against ``compiled=False``: a
    mid-stream zoom walk (the device-fed 500 kHz level, the host-fed
    250 kHz one, a retune, a zoom-off and a zoom-on that reattaches the
    stashed view with its built levels), every block's zoom points,
    their view and the lines drawn bit for bit."""
    blocks = synth_blocks()
    steps = [(2, (200e3, 500e3)), (2, (200e3, 250e3)), (2, (180e3, 250e3)),
             (2, None), (2, (180e3, 500e3)), (2, (180e3, 250e3))]
    seen = {}
    for compiled in (True, False):
        rx, ctl = build(T)
        per = []
        lr = LiveReceiver(rx, ctl, iter(blocks), waterfall_fft=256,
                          compiled=compiled)
        lr.on_block = lambda o, lr=lr, per=per: per.append(
            None if lr.zoom is None or lr.zoom.points is None else
            (lr.zoom.points.copy(), lr.zoom.points_view, lr.zoom.lines))
        lr.start_producer()
        stashed = None
        for n, view in steps:
            if view is None:
                stashed = lr.zoom
                lr.set_zoom(None)
            else:
                lr.set_zoom(*view)
                join_prewarms()
                if stashed is not None:
                    assert lr.zoom is stashed
                    builds = stashed.level_builds
            assert lr.run_blocks(max_blocks=n) == n
        assert lr.zoom.level_builds == builds      # revisits build nothing
        assert lr.zoom.chunk != rx.block_len       # host-fed at the end
        lr.stop()
        assert isinstance(lr.zoom._step, CompiledStep) == compiled
        assert not lr.metrics.notes
        seen[compiled] = per
    assert len(seen[True]) == len(blocks)
    for a, b in zip(seen[True], seen[False]):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a[0], b[0], equal_nan=True)
            assert a[1:] == b[1:]
    assert sum(a is not None for a in seen[True]) >= 8


def test_level_bound_keeps_the_current_level(monkeypatch):
    """(f) With the bound at two built levels the walk's three levels
    cannot all stay: after every stage the current level is kept and at
    most two built ones are; evicted levels are rebuilt at their next
    use (more builds than levels), and the points still equal the eager
    front's bit for bit."""
    monkeypatch.setattr(spectrum_mod, "ZOOM_LEVELS", 2)
    kept = []

    def after(v):
        assert v._level in v._front_cache.values()
        assert sum(lv.built for lv in v._front_cache.values()) <= 2
        kept.append(v._level.bw)

    views = {c: ZoomSpectrumView(FS, 32768, fft_size=FFT, device="cpu",
                                 compiled=c) for c in (True, False)}
    got = {c: walk(v, 32768, "device", after=after)
           for c, v in views.items()}
    same_blocks(got[True], got[False])
    v = views[True]
    levels = {bw for _, bw in WALK}
    assert kept[:len(WALK)] == [bw for _, bw in WALK]
    assert v.level_evictions >= 2 and v.level_builds > len(levels)
    assert v.level_builds - v.level_evictions == sum(
        lv.built for lv in v._front_cache.values())


def test_background_build_cannot_evict_a_level_about_to_build(
        monkeypatch):
    """(f) A new level is not built yet when ``_make_front`` hands it to
    ``prewarm_level``; a build (the background prewarm's) that ends in
    that window and evicts past the bound must not drop it, or its build
    would land on a level the cache no longer holds. With the bound at
    one built level: the new level stays and is built, the other one is
    evicted, and making it current builds nothing more."""
    monkeypatch.setattr(spectrum_mod, "ZOOM_LEVELS", 1)
    v = ZoomSpectrumView(FS, 20000, fft_size=FFT, device="cpu")
    make = v._make_front

    def racing(bw):
        level = make(bw)
        if bw == 62_500.0:
            v._warm_one(500e3, background=True)
        return level

    v._make_front = racing
    v.prewarm_level(62_500.0)
    del v._make_front
    built = [lv.bw for lv in v._front_cache.values() if lv.built]
    assert built == [62_500.0]
    assert (v.level_builds, v.level_evictions) == (2, 1)
    v.set_view(0.0, 62_500.0)
    v.feed(planes_of(2 * v.chunk, 9))
    assert v.level_builds == 2 and v.lines > 0


def test_background_build_yields_to_a_waiting_build(monkeypatch):
    """A build in the background passes the process's build gate once
    per part (each warm-up, each capture): a build asked for meanwhile
    on another thread (the consumer's, or a zoom to show) runs whole
    right after the part in progress, before the background build's
    next part."""
    order, started = [], threading.Event()

    def parts(step):
        for i in range(3):
            order.append((step.name, i))
            if step.name == "background":
                started.set()
            threading.Event().wait(0.2 if i == 0 else 0.01)
            yield

    monkeypatch.setattr(CompiledStep, "_build", parts)
    steps = {}
    for name in ("background", "foreground"):
        steps[name] = CompiledStep(lambda s, x: (s, x), "cpu")
        steps[name].name = name
    t = threading.Thread(target=steps["background"]._gated_build,
                         kwargs={"background": True})
    t.start()
    assert started.wait(10)
    steps["foreground"]._gated_build()
    t.join(timeout=30)
    assert not t.is_alive()
    assert order == [("background", 0), ("foreground", 0),
                     ("foreground", 1), ("foreground", 2),
                     ("background", 1), ("background", 2)]


@pytest.mark.parametrize("swap", ["format", "representation"])
def test_swap_between_dispatch_and_finish_of_a_host_fed_view(swap):
    """A block's finish runs outside the step lock: a swap may close the
    zoom view the finish read (a format change drops it, a
    representation swap replaces it by one built in the other
    representation) before the finish feeds that view from the host
    planes (a chunk-misaligned level). The closed view still steps on
    its current level, and the loop goes on with the view the swap
    left."""
    rx, ctl = build(T)
    if swap == "format":
        rx2 = T.ReceiverPipeline(FS, rx.groups, block_len=15000,
                                 use_kernels=False, device="cpu")
        ctl2 = ctl
    else:
        rx2, ctl2 = build(T, complex64=True)
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    lr.set_zoom(200e3, 250e3)
    join_prewarms()
    z = lr.zoom
    assert z.chunk != rx.block_len              # fed from the host
    blk = synth_blocks(1)[0]
    planes = (blk.real.copy(), blk.imag.copy())
    z.feed(np.stack(planes))                    # the next feed steps
    feed, fed = z.feed, []

    def swap_then_feed(p):
        lr.swap_pipeline(rx2, ctl2)
        fed.append(feed(p))
        return fed[-1]

    z.feed = swap_then_feed
    snap, ctl_dev = lr._device_controls()
    lr.state, out = lr.step(lr.state, ((torch.from_numpy(planes[0]),
                                        torch.from_numpy(planes[1])),
                                       ctl_dev))
    disp = lr._fanout_dispatch(out, snap)
    lr._fanout_finish(disp, PC(*out["iq"]), out, planes)
    assert len(fed) == 1 and fed[0] is z.points and z.lines > 0
    assert not z._front_cache
    if swap == "format":
        assert lr.zoom is None
        lr.set_zoom(200e3, 250e3)
    else:
        assert lr.zoom is not z and not lr.zoom.planar
        assert lr.zoom._level.built
    z2 = lr.zoom
    L2 = rx2.block_len
    x = planes_of(3 * L2, 4)
    for b in range(3):
        assert lr.ring.write(x[0, b * L2:(b + 1) * L2].copy(),
                             x[1, b * L2:(b + 1) * L2].copy())
    assert lr.run_blocks(max_blocks=3, wait=False) == 3
    join_prewarms()
    lr.stop()
    assert z2.lines > 0 and z2.points.shape == z.points.shape
    assert not lr.metrics.notes
