"""The live loop's spans and counters (``cubicsdr_tpu_torch/utils/
metrics.py`` ``SPANS``, stamped by ``app/runner.py`` ``LiveReceiver``)
on the CPU: one span of each kind per block in chain order, numbered as
``on_block`` sees them; the store's fixed capacity; the profiler ranges
they open only while a profiler runs; ``CompiledStep``'s build spans; a
ring write that was shed, and the ready times that skip it."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_runner import T, L, build, synth_blocks  # noqa: E402

from cubicsdr_tpu_torch.app import runner as R  # noqa: E402
from cubicsdr_tpu_torch.app.runner import (  # noqa: E402
    LiveReceiver, block_spans)
from cubicsdr_tpu_torch.utils import metrics as M  # noqa: E402
from cubicsdr_tpu_torch.utils.compiled import CompiledStep  # noqa: E402
from cubicsdr_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

N = 6
CHAIN = ("stage", "step.dispatch", "post.dispatch", "pull.wait", "fanout")
CONSUMER = ("step.dispatch", "post.dispatch", "pull.wait", "fanout",
            "on_block")


def run_loop(source, n, **kw):
    """A fresh receiver on the small FM plan run over ``source`` until
    ``n`` blocks; returns (receiver, the on_block results)."""
    rx, ctl = build(T)
    got = []
    lr = LiveReceiver(rx, ctl, source, waterfall_fft=256,
                      on_block=got.append, **kw)
    lr.start_producer()
    assert lr.run_blocks(max_blocks=n) == n
    lr.stop()
    return lr, got


def wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.002)


def test_each_block_has_its_spans_in_chain_order():
    lr, got = run_loop(iter(synth_blocks(N)), N)
    assert [r["seq"] for r in got] == list(range(N))
    b = block_spans(lr.metrics.spans)
    np.testing.assert_array_equal(b["seq"], np.arange(N))
    ends = []
    for name in CHAIN:
        a, e = b[name]
        assert (a > 0).all() and (e >= a).all(), name
        ends.append((a, e))
    for (_, e0), (a1, _) in zip(ends, ends[1:]):
        assert (e0 <= a1).all()
    on_a, on_e = b["on_block"]
    fa, fe = b["fanout"]
    assert ((fa <= on_a) & (on_e <= fe)).all()
    # Each source block is one write of one block: block i is ready at
    # the end of write i, before its on_block.
    w = lr.metrics.spans.rows(("ingest.write",))
    np.testing.assert_array_equal(w["value"], np.full(N, L))
    np.testing.assert_array_equal(b["ready"], w["end"])
    assert (on_a > b["ready"]).all()
    # No device on the CPU: no device times; each block is read out of
    # the ring, and no ring span is held for a copy.
    assert np.isnan(b["device.step"]).all()
    assert np.isnan(b["device.post"]).all()
    assert "stage.slot_wait" not in b
    snap = lr.metrics.snapshot()
    for name in CHAIN + ("on_block", "ingest.write", "ingest.ready"):
        assert snap["spans"][name]["count"] == N, name
        assert snap["spans"][name]["median_ms"] >= 0
    assert "slot_waits" not in snap.get("counters", {})


def test_the_step_layers_have_no_device_spans_on_the_cpu():
    """The step's layers are timed by events inside its graph on the
    card; on the CPU no layer span is recorded and ``block_spans``
    carries each as NaN, and the step's marks read nothing."""
    lr, _ = run_loop(iter(synth_blocks(N)), N)
    b = block_spans(lr.metrics.spans)
    assert R.DEVICE_LAYERS == ("device.chan", "device.route",
                               "device.kits")
    for name in R.DEVICE_LAYERS:
        assert b[name].shape == (N,) and np.isnan(b[name]).all(), name
        assert name not in lr.metrics.snapshot()["spans"]
        assert M.SPANS.parent(name) == "device.step"
    step = lr._step_cache[lr.pipeline]
    assert step.marks
    assert step.mark_ms(0) == {} and step.mark_ms(1) == {}


def test_the_pipeline_marks_each_layer_the_runner_names(monkeypatch):
    """One step marks the runner's layers once each, in their order."""
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.receiver import pipeline as P
    got = []
    monkeypatch.setattr(P, "device_mark", got.append)
    rx, ctl = build(T)
    z = torch.zeros(L)
    rx.apply(rx.init_state(), (PC(z, z), ctl))
    assert got == list(R._LAYER_MARKS)
    assert [R._LAYER_MARKS[m] for m in got] == list(R.DEVICE_LAYERS)


def test_block_spans_reads_the_step_layers():
    log = M.SPANS.log()
    for seq in range(3):
        log.add(R._DEV_STEP, seq, 0, 1_000_000)
        for i, span in enumerate(R._DEV_LAYER.values(), 1):
            if (seq, i) != (2, 3):
                log.add(span, seq, 0, 100_000 * i)
    b = block_spans(log)
    np.testing.assert_array_equal(b["device.step"], [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(b["device.chan"], [0.1, 0.1, 0.1])
    np.testing.assert_array_equal(b["device.route"], [0.2, 0.2, 0.2])
    np.testing.assert_array_equal(b["device.kits"][:2], [0.3, 0.3])
    assert np.isnan(b["device.kits"][2])
    assert log.summary()["device.kits"] == {"count": 2,
                                            "median_ms": 0.3}


def test_a_device_mark_outside_a_capture_does_nothing():
    """A step that marks its layers runs as before where nothing is
    captured (the CPU, the warm-ups, the eager loop)."""
    from cubicsdr_tpu_torch.utils.compiled import device_mark

    def fn(state, x):
        device_mark("chan")
        y = state + x
        device_mark("kits")
        return y, y * 2
    assert not CompiledStep(fn, "cpu").marks
    step = CompiledStep(fn, "cpu", marks=True)
    for k in range(3):
        st, out = step(torch.zeros(4) if k == 0 else step.state,
                       torch.ones(4))
    np.testing.assert_array_equal(out.numpy(), np.full(4, 6.0))
    assert step.mark_ms(0) == {}


@pytest.mark.parametrize("channels,kernels,form", [
    (None, False, None), (2, True, 0), (6, True, 1), (20, True, 2)])
def test_the_plan_s_pfb_form_and_the_demods_fanned_out(channels, kernels,
                                                       form):
    """``pfb.form`` is the index of the plan's PFB kernel form in
    ``PFB_FORMS`` (absent where no PFB kernel runs), set at each plan;
    ``fanout.demods`` the demods of the last block fanned out."""
    from cubicsdr_tpu_torch.ops.kernels.pfb import PFB_FORMS
    from cubicsdr_tpu_torch.receiver import (
        DemodGroupSpec, ReceiverPipeline)
    assert PFB_FORMS == ("fft", "dft", "product")
    base, ctl = build(T)
    lr = LiveReceiver(base, ctl, iter(synth_blocks(2)), waterfall_fft=256)
    assert "pfb.form" not in lr.metrics.counters
    freqs = np.asarray([-100e3, 0.0, 200e3], np.float32)
    rx = ReceiverPipeline(1e6, [DemodGroupSpec("FM", 200000, 3)],
                          num_channels=channels, use_kernels=kernels,
                          block_len=base.block_len if channels is None
                          else None, device="cpu")
    c = rx.control_template()
    c[0]["frequency"] = freqs
    lr.swap_pipeline(rx, c)
    counters = lr.metrics.snapshot().get("counters", {})
    if form is None:
        assert rx.pfb_form is None and "pfb.form" not in counters
    else:
        assert PFB_FORMS[counters["pfb.form"]] == rx.pfb_form
        assert counters["pfb.form"] == form
    L = rx.block_len
    lr.set_source(iter([(0.01 * np.ones((2, L), np.float32))] * 2))
    lr.start_producer()
    assert lr.run_blocks(max_blocks=2) == 2
    lr.stop()
    assert lr.metrics.snapshot()["counters"]["fanout.demods"] == 3


def test_starved_polls_count_the_consumer_waits():
    """Each block written 30 ms after the block before it reached
    ``on_block``: the loop waits on the ring once per gap (not once per
    millisecond), and a write ends each wait."""
    delivered = threading.Semaphore(0)

    def slow():
        for i, b in enumerate(synth_blocks(3)):
            if i and not delivered.acquire(timeout=30):
                return
            time.sleep(0.03)
            yield b
    rx, ctl = build(T)
    lr = LiveReceiver(rx, ctl, slow(), waterfall_fft=256,
                      on_block=lambda r: delivered.release())
    lr.start_producer()
    assert lr.run_blocks(max_blocks=3) == 3
    lr.stop()
    c = lr.metrics.snapshot()["counters"]
    assert c == dict(lr.metrics.counters)
    assert 2 <= c["starved_polls"] <= 2 * 3
    assert 2 <= c["ring_wakes"] <= c["starved_polls"]


def test_the_store_keeps_its_capacity_and_drops_the_oldest():
    """Each thread's ring holds its last spans: the live loop's rings
    hold its last SPAN_BLOCKS blocks (up to four ring writes each), the
    build ring its last 1,024 spans."""
    log, extra = M.SPANS.log(), 20
    nb = M.SPAN_BLOCKS + extra
    for k in range(nb):
        t = 100 * k
        for w in range(4):
            log.add(R._WRITE, -1, t + w, t + w + 1, 5)
        log.add(R._READY, -1, t + 3, t + 4, k + 1)
        log.add(R._STAGE, k, t + 5, t + 7, k + 1)
        for i, name in enumerate((R._STEP, R._POST, R._PULL, R._FANOUT)):
            log.add(name, k, t + 7 + i, t + 8 + i)
        log.add(R._ON_BLOCK, k, t + 10, t + 11)
    for k in range(1024 + extra):
        M.SPANS.process.add(M.SPANS.name("compiled.build", "build"), k,
                            10 * k + 1, 10 * k + 2)
    b = block_spans(log)
    np.testing.assert_array_equal(b["seq"], np.arange(extra, nb))
    np.testing.assert_array_equal(b["stage"][0], 100 * b["seq"] + 5)
    np.testing.assert_array_equal(b["ready"], 100 * b["seq"] + 4)
    w = log.rows(("ingest.write",))
    assert len(w["start"]) == 4 * M.SPAN_BLOCKS
    assert w["start"][0] == 100 * extra and w["end"][-1] == 100 * nb - 96
    builds = M.SPANS.process.rows(("compiled.build",))
    assert len(builds["start"]) == 1024
    np.testing.assert_array_equal(builds["seq"][-3:],
                                  np.arange(1024 + extra - 3, 1024 + extra))
    # A block whose ready write is gone has no ready time (never a later
    # write's); a finished block reads its fan-out and device times.
    log.add(R._STAGE, nb, 1, 2, 1)
    log.add(R._FANOUT, nb, 6, 9)
    log.add(R._DEV_STEP, nb, 0, 1_500_000)
    log.add(R._DEV_POST, nb, 0, 250_000)
    last = block_spans(log, nb)
    assert last["ready"][0] == 0
    np.testing.assert_array_equal(last["fanout"], ([6], [9]))
    assert (last["device.step"][0], last["device.post"][0]) == (1.5, 0.25)
    assert M.SPANS.latest() is log
    # The span summary reads each name's spans held.
    snap = log.summary()
    assert snap["stage"]["count"] == M.SPAN_BLOCKS
    assert snap["device.post"] == {"count": 1, "median_ms": 0.25}


def test_threads_logging_at_once_keep_their_own_blocks():
    """More writers than cores, switching often: each log reads back
    exactly the blocks and writes it recorded (a row claimed twice would
    mix them)."""
    logs = [M.SPANS.log() for _ in range(16)]
    n = 200
    go = threading.Barrier(len(logs))

    def work(i, log):
        go.wait(10)
        for k in range(n):
            t = 1_000_000 * i + 10 * k
            log.add(R._WRITE, -1, t + 1, t + 2, 1)
            log.add(R._READY, -1, t + 1, t + 2, k + 1)
            log.add(R._STAGE, k, t + 3, t + 4, k + 1)
            log.add(R._STEP, k, t + 5, t + 6)
            log.add(R._FANOUT, k, t + 8, t + 9)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i, lg))
                   for i, lg in enumerate(logs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for i, log in enumerate(logs):
        b = block_spans(log)
        t = 1_000_000 * i + 10 * np.arange(n)
        np.testing.assert_array_equal(b["seq"], np.arange(n))
        np.testing.assert_array_equal(b["stage"][0], t + 3)
        np.testing.assert_array_equal(b["fanout"][1], t + 9)
        np.testing.assert_array_equal(b["ready"], t + 2)


def test_profiler_ranges_match_the_stored_spans(monkeypatch):
    opened = []
    real = M._Range

    class Counting:
        def __init__(self, name):
            opened.append(name)
            self.r = real(name)

        def __enter__(self):
            return self.r.__enter__()

        def __exit__(self, *exc):
            return self.r.__exit__(*exc)

    monkeypatch.setattr(M, "_Range", Counting)
    run_loop(iter(synth_blocks(3)), 3)
    assert opened == []                      # no profiler: none opened
    # The system may stop the thread between a span's stamp and its
    # range's open for a scheduler slice (some ms on a loaded machine):
    # a span stamped in the wrong place misses in every run, such a
    # stop in one; so a run with misses is made again, twice at most.
    for _ in range(3):
        misses = profiled_misses()
        if not misses:
            break
    assert set(CONSUMER) <= set(opened) - {"warm"}
    assert misses == []


def profiled_misses() -> list:
    """Run the loop under the profiler; the consumer's spans whose start
    or end lies 50 us or more from its range's."""
    # A span's stamp and its range's open back to back; a forced switch
    # of the interpreter lock between them (every 5 ms by default) would
    # put another thread's time between the two clocks' readings. With a
    # long interval the consumer yields the lock only where it blocks.
    acts = [torch.profiler.ProfilerActivity.CPU]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            # The thread's first range sets the profiler up for it.
            M.close_range(M.open_range("warm"))
            p0 = time.time_ns()
            lr, _ = run_loop(iter(synth_blocks(N)), N)
    finally:
        sys.setswitchinterval(old)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    b = block_spans(lr.metrics.spans)
    # The profiler's clock is an approximate one, mapped onto wall time
    # from the profiler's start: the two part by some tens of ppm of the
    # time since (the first block's step holds its build, about a second
    # under the profiler), so 100 ppm of it is allowed on top. Block 0's
    # dispatch is the first use of each range and op under the profiler,
    # whose own set-up can stamp its start later: it is only matched.
    misses = []
    for name in CONSUMER:
        got = np.array(sorted(events[name]))
        assert len(got) == N, name
        for seq, a, e in zip(b["seq"], *b[name]):
            k = np.argmin(np.abs(got[:, 0] - a))
            tol = 1_000_000 if seq == 0 else 50_000
            if (abs(got[k, 0] - a) >= tol + 1e-4 * (a - p0)
                    or abs(got[k, 1] - e) >= tol + 1e-4 * (e - p0)):
                misses.append((name, int(seq), int(got[k, 0] - a),
                               int(got[k, 1] - e)))
    return misses


def test_compiled_step_spans_each_build_once():
    def fn(state, x):
        return state + x, state * 2
    builds = ("compiled.build", "compiled.warmup", "compiled.capture")
    t0 = time.time_ns()
    step = CompiledStep(fn, "cpu")
    for _ in range(3):
        step(torch.zeros(4), torch.ones(4))
    assert step.last == 0 and step.device_ms(0) is None
    assert step.build_split_ms["captures"] == []
    assert step.build_ms == pytest.approx(
        sum(step.build_split_ms["warmups"])) and step.build_ms > 0
    b = M.SPANS.process.rows(builds)
    new = b["start"] >= t0
    assert list(b["name"][new]) == ["compiled.build", "compiled.warmup"]
    (seq,) = set(b["seq"][new])
    (top, kid) = np.nonzero(new)[0]
    assert b["start"][top] <= b["start"][kid]
    assert b["end"][kid] <= b["end"][top]
    assert M.SPANS.parent("compiled.warmup") == "compiled.build"
    # The live loop's step and its post-step: each built once, and one
    # block through each per block.
    t0 = time.time_ns()
    lr, _ = run_loop(iter(synth_blocks(N)), N)
    b = M.SPANS.process.rows(("compiled.build",))
    assert (b["start"] >= t0).sum() == 2
    stats = lr.cache_stats()
    assert (stats["step_builds"], stats["post_builds"]) == (1, 1)
    assert lr.metrics.stats["pipeline"].blocks_in == N
    assert lr.metrics.spans.summary()["post.dispatch"]["count"] == N


def test_a_shed_write_is_marked_and_ready_times_skip_it():
    rx, ctl = build(T)
    blocks = synth_blocks(7)
    more = threading.Event()

    def source():
        yield from blocks[:5]        # a ring of 4 blocks sheds the 5th
        more.wait(30)
        yield from blocks[5:]

    got = []
    lr = LiveReceiver(rx, ctl, source(), waterfall_fft=256,
                      ring_seconds=0.0, on_block=got.append)
    assert lr.ring.capacity == 4 * L
    ingest = lr.metrics.stats["ingest"]
    lr.start_producer()
    wait_for(lambda: ingest.blocks_in == 5)
    assert lr.run_blocks(max_blocks=2) == 2
    more.set()
    wait_for(lambda: ingest.blocks_in == 7)
    assert lr.run_blocks(max_blocks=4) == 4
    lr.stop()
    assert ingest.samples_dropped == L
    w = lr.metrics.spans.rows(("ingest.write",))
    np.testing.assert_array_equal(w["value"] // L, [1, 1, 1, 1, -1, 1, 1])
    b = block_spans(lr.metrics.spans)
    assert [r["seq"] for r in got] == list(b["seq"]) == list(range(6))
    np.testing.assert_array_equal(b["ready"], w["end"][[0, 1, 2, 3, 5, 6]])


def test_post_state_is_the_post_steps_state():
    rx, ctl = build(T)
    lr = LiveReceiver(rx, ctl, iter(synth_blocks(3)), waterfall_fft=256)
    lr.set_demod_view(0)
    lr.start_producer()
    assert lr.run_blocks() == 3
    lr.stop()
    got = lr.post_state()
    want = tree_map(lambda t: t.detach().cpu().numpy(),
                    (lr._st_dist, lr._st_spec, lr._st_dv))
    assert len(got) == 3 and len(got[2]) == 2    # the demod view's, on
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
