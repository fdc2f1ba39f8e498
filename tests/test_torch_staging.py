"""The live loop's staging (``cubicsdr_tpu_torch/app/runner.py``): the
ring in frames of one block, the held spans' release, every block staged
on the consumer, the starved loop's wait on the ring when it lacks a
block (woken by the write, by ``stop()`` and by a format swap), and on
the card
(marked ``card``; run with ``python -m pytest tests/test_torch_staging.py
-m card`` on a machine with a GPU) each block copied to the device
straight out of its pinned ring frame. No JAX here."""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cubicsdr_tpu_torch.receiver as T
from cubicsdr_tpu_torch.app import runner as R
from cubicsdr_tpu_torch.app.runner import LiveReceiver
from cubicsdr_tpu_torch.utils.soak import join_prewarms

FS = 1_000_000
L = 16750


def build(device="cpu", block_len=L):
    mgr = T.DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = T.plan_from_manager(mgr)
    rx = T.ReceiverPipeline(FS, specs, block_len=block_len,
                            use_kernels=False, device=device)
    return rx, T.controls_from_manager(mgr, rx, keyed, 100e6)


def blocks(n, seed=0, block_len=L):
    """Planes [2, block_len] of float32 noise, one per block."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, block_len)).astype(np.float32)
            for _ in range(n)]


def in_thread(fn):
    """Run ``fn`` on a daemon thread; its result lands in the dict."""
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("n", fn()),
                         daemon=True)
    t.start()
    return t, res


def until(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.002)


def starved(lr):
    """The loop has begun to wait on the ring for a block."""
    return lr.metrics.counters.get("starved_polls", 0) > 0


@pytest.fixture
def long_slice(monkeypatch):
    """Waits on the ring that only a wake or a write can end within a
    test's time: what ends them early is the wake, not the slice."""
    monkeypatch.setattr(R, "WAIT_SLICE_S", 5.0)


@pytest.mark.parametrize("seconds", [0.0, 0.0671, 0.37, 2.0])
def test_the_ring_is_whole_blocks_in_frames_of_one(seconds):
    """At least ``ring_seconds`` and four blocks, rounded up to whole
    blocks, in frames of one block; host memory of its own on the CPU."""
    rx, ctl = build()
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256,
                      ring_seconds=seconds)
    want = max(int(FS * seconds), 4 * L)
    cap = lr.ring.capacity
    assert cap % L == 0 and want <= cap < want + L
    assert lr.ring.frame == L and lr.ring.storage is None


class _Event:
    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def test_held_spans_are_released_oldest_first_once_their_copies_end():
    """A release never passes a copy in flight, unless asked to wait for
    it."""
    rx, ctl = build()
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    ring = lr.ring
    for b in blocks(3):
        assert ring.write(b[0], b[1])
    evs = [_Event(True), _Event(False), _Event(True)]
    for ev in evs:
        assert ring.acquire(L) is not None
        lr._held.append((ring, ev))
    lr._release_spans()
    assert (ring.fill, len(lr._held)) == (2 * L, 2)
    assert not evs[1].waited
    lr._release_spans(wait=True)
    assert (ring.fill, len(lr._held)) == (0, 0)
    assert evs[1].waited and not evs[2].waited


@pytest.mark.card
def test_card_stages_each_block_straight_from_its_pinned_frame():
    """On the card: the staged device block is the block written, over
    the ring's wrap, with no host copy while the zoom view is off or its
    chunk is the block (fed on the device); held spans are all released
    once ``run_blocks`` drains; an open chunk-misaligned zoom view still
    gets each block's host planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    rx, ctl = build("cuda")
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256,
                      ring_seconds=0.0)
    ring = lr.ring
    assert ring.capacity == 4 * L and ring.storage.is_pinned()
    assert tuple(ring.storage.shape) == (4, 2, L)
    aligned = SimpleNamespace(chunk=L)              # all staging reads
    for i, b in enumerate(blocks(10)):              # wraps twice
        assert ring.write(b[0], b[1])
        lr.zoom = aligned if i % 2 else None
        blk = lr._stage_block()
        assert blk.planes is None and blk.slot >= 0
        blk.ready.synchronize()
        np.testing.assert_array_equal(torch.stack(blk.iq).cpu().numpy(), b)
        assert ring.fill == L and ring.readable == 0
        lr._release_spans()
        assert ring.fill == 0 and not lr._held, i
    lr.zoom = None

    for b in blocks(3, seed=1):
        assert ring.write(b[0], b[1])
    assert lr.run_blocks(wait=False) == 3
    assert not lr._held and ring.fill == 0

    lr.set_zoom(200e3, 250e3)
    join_prewarms()
    z = lr.zoom
    assert z.chunk != L                             # fed from the host
    fed, feed = [], z.feed
    z.feed = lambda p: (fed.append(p.copy()), feed(p))[1]
    src = blocks(3, seed=2)
    for b in src:
        assert ring.write(b[0], b[1])
    assert lr.run_blocks(wait=False) == 3
    lr.stop()
    assert not lr._held and ring.fill == 0
    assert len(fed) == 3
    for p, b in zip(fed, src):
        np.testing.assert_array_equal(p, b)


def test_stop_during_a_starved_wait_returns_at_once(long_slice):
    """The loop sleeps on an empty ring; ``stop()`` wakes it within a
    second and ends the loop, which leaves no thread of its own."""
    rx, ctl = build()
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    before = set(threading.enumerate())
    t, res = in_thread(lr.run_blocks)
    until(lambda: starved(lr))
    time.sleep(0.05)                    # into the ring's wait
    t0 = time.monotonic()
    lr.stop()
    t.join(1.0)
    assert time.monotonic() - t0 < 1.0
    assert not t.is_alive() and res["n"] == 0
    assert set(threading.enumerate()) <= before
    assert lr.metrics.counters["starved_polls"] == 1
    assert "ring_wakes" not in lr.metrics.counters


def test_a_format_swap_during_a_starved_wait_stages_from_the_new_ring(
        long_slice):
    """A swap to another block length retires the ring the loop waits
    on; the loop moves to the new ring at once, and the block written
    there is staged and run through the new plan, none dropped."""
    rx, ctl = build()
    L2 = 15000
    rx2, ctl2 = build(block_len=L2)
    got = []
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256,
                      on_block=got.append)
    t, res = in_thread(lambda: lr.run_blocks(max_blocks=1))
    until(lambda: starved(lr))
    time.sleep(0.05)                    # into the ring's wait
    old = lr.ring
    lr.swap_pipeline(rx2, ctl2)
    assert lr.ring is not old and lr.ring.frame == L2
    (b,) = blocks(1, block_len=L2)
    assert lr.ring.write(b[0], b[1])
    t.join(4)
    assert not t.is_alive() and res["n"] == 1 and len(got) == 1
    st = lr.metrics.stats["pipeline"]
    assert (st.samples_in, st.samples_dropped) == (L2, 0)
    assert lr.metrics.counters["starved_polls"] == 1
    assert lr.metrics.counters["ring_wakes"] == 1
    assert lr.ring.readable == 0
    lr.stop()


def test_run_blocks_without_wait_returns_on_an_empty_ring(long_slice):
    """``wait=False`` returns as soon as the ring lacks a block, waiting on
    nothing; a bounded waiting call leaves unread the block it did not
    run and no thread of its own, so nothing waits on after it either."""
    rx, ctl = build()
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    t0 = time.monotonic()
    assert lr.run_blocks(wait=False) == 0
    assert time.monotonic() - t0 < 1.0
    assert "starved_polls" not in lr.metrics.counters
    for b in blocks(2):
        assert lr.ring.write(b[0], b[1])
    before = set(threading.enumerate())
    assert lr.run_blocks(max_blocks=1) == 1
    assert lr.ring.readable == L
    assert set(threading.enumerate()) <= before
    assert lr.run_blocks(wait=False) == 1       # the block it left
    t0 = time.monotonic()
    assert lr.run_blocks(wait=False) == 0
    assert time.monotonic() - t0 < 1.0
    assert "starved_polls" not in lr.metrics.counters
    lr.stop()


def collect(into):
    """An ``on_block`` that keeps a host copy of each block's outputs (a
    block's pull is reused by later blocks)."""
    def on_block(r):
        into.append((r["seq"], r["mix"].copy(),
                     [(g["level"].copy(), g["iq"].re.numpy().copy(),
                       g["iq"].im.numpy().copy()) for g in r["groups"]]))
    return on_block


def test_a_closed_loop_stages_every_block_on_the_consumer(monkeypatch):
    """With six blocks already in the ring (a closed loop: the next block
    is always there), every block is staged on the thread that calls
    ``run_blocks``, which starts no thread; the outputs are those of six
    one-block calls on a fresh receiver fed the same blocks."""
    src = blocks(6)
    runs = []
    for calls in ((None,), (1,) * 6):
        rx, ctl = build()
        got = []
        lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256,
                          on_block=collect(got))
        for b in src:
            assert lr.ring.write(b[0], b[1])
        stagers, started = [], []
        stage = lr._stage_block
        lr._stage_block = lambda: (stagers.append(threading.get_ident()),
                                   stage())[1]
        start = threading.Thread.start
        monkeypatch.setattr(threading.Thread, "start", lambda t: (
            started.append(t.name), start(t))[1])
        assert sum(lr.run_blocks(max_blocks=k, wait=False)
                   for k in calls) == 6
        monkeypatch.setattr(threading.Thread, "start", start)
        assert stagers and set(stagers) == {threading.get_ident()}
        assert started == []
        assert lr.ring.readable == 0
        runs.append((got, lr.waterfall.buffer.copy()))
        lr.stop()
    (a, wa), (b, wb) = runs
    assert [r[0] for r in a] == [r[0] for r in b] == list(range(6))
    for (_, mix_a, ga), (_, mix_b, gb) in zip(a, b):
        np.testing.assert_array_equal(mix_a, mix_b)
        for x, y in zip(ga, gb):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(wa, wb)


def test_a_bounded_call_takes_only_the_blocks_it_runs():
    """Nothing is staged ahead or carried across calls: a call bounded to
    one block leaves the other two in the ring."""
    rx, ctl = build()
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    for b in blocks(3):
        assert lr.ring.write(b[0], b[1])
    assert lr.run_blocks(max_blocks=1) == 1
    assert lr.ring.readable == 2 * L
    lr.stop()


def test_a_paced_source_waits_once_per_gap():
    """Each block written 30 ms after the block before it reached
    ``on_block``, as a radio delivers them to a loop that keeps up: at
    most two starved waits per block, and a write ends the wait in every
    gap. The loop finishes the block in hand before it waits: else no
    block would follow it."""
    n = 5
    delivered = threading.Semaphore(0)

    def paced():
        for i, b in enumerate(blocks(n)):
            if i and not delivered.acquire(timeout=30):
                return                  # block i - 1 never reached on_block
            time.sleep(0.03)
            yield b
    rx, ctl = build()
    lr = LiveReceiver(rx, ctl, paced(), waterfall_fft=256,
                      on_block=lambda r: delivered.release())
    lr.start_producer()
    assert lr.run_blocks() == n
    lr.stop()
    c = lr.metrics.counters
    assert c["starved_polls"] <= 2 * n
    assert c["ring_wakes"] >= n - 1
