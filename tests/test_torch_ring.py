"""The port's framed sample ring (``cubicsdr_tpu_torch/native``) on both
backends, the native library and the numpy fallback: frames in the
storage, reads and writes across frame and wrap boundaries, blocks handed
out in place (``acquire``/``release``) and the room they hold, and the
wait for a readable block (``wait_readable``/``wake``)."""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import pytest

from cubicsdr_tpu_torch import native
from cubicsdr_tpu_torch.native import SampleRing

DTYPES = (np.float32, np.int16, np.int8)
F, CAP = 8, 48                  # six frames


@pytest.fixture(params=("native", "numpy"))
def backend(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif native.get_lib() is None:
        pytest.skip("no C++ compiler for the native ring")
    return request.param


def _ring(dtype, frame=F, cap=CAP):
    store = np.zeros(2 * cap, dtype)
    return SampleRing(cap, dtype, frame=frame, storage=store), \
        store.reshape(-1, 2, frame)


def _block(n, dtype, start):
    """Planes whose samples count up from ``start`` (re) and down (im)."""
    k = np.arange(start, start + n)
    return (k % 101).astype(dtype), (-(k % 97)).astype(dtype)


class _Model:
    """What the ring should hold: the readable samples, and what the held
    spans and the reads behind them keep from the room."""

    def __init__(self):
        self.readable = collections.deque()
        self.busy = collections.deque()     # ("span" | "read", n)
        self.consumed = 0

    @property
    def fill(self):
        return len(self.readable) + sum(n for _, n in self.busy)

    def take(self, n, kind):
        out = [self.readable.popleft() for _ in range(n)]
        self.consumed += n
        if kind == "span" or self.busy:
            self.busy.append((kind, n))
        return out

    def release(self):
        assert self.busy[0][0] == "span"
        self.busy.popleft()
        while self.busy and self.busy[0][0] == "read":
            self.busy.popleft()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_matches_its_model_over_random_operations(backend, dtype):
    """Writes of odd sizes straddle frame and wrap boundaries; reads,
    acquires and releases in any order give the samples written, in
    order, with the fill, the readable count and the shed writes the
    model gives; an acquired frame's storage is the block itself."""
    rng = np.random.default_rng(11)
    ring, frames = _ring(dtype)
    m, written, dropped = _Model(), 0, 0
    for _ in range(600):
        op = rng.integers(4)
        if op == 0:
            n = int(rng.integers(1, 20))
            re, im = _block(n, dtype, written)
            ok = ring.write(re, im)
            assert ok == (m.fill + n <= CAP)
            if ok:
                m.readable.extend(zip(re.tolist(), im.tolist()))
                written += n
            else:
                dropped += n
        elif op == 1:
            n = F if rng.random() < 0.3 else int(rng.integers(1, 20))
            got = ring.read(n)
            assert (got is None) == (len(m.readable) < n)
            if got is not None:
                exp = np.array(m.take(n, "read"), dtype).T
                np.testing.assert_array_equal(np.stack(got), exp)
        elif op == 2:
            n = F if rng.random() < 0.9 else F - 1
            k = ring.acquire(n)
            ok = (n == F and m.consumed % F == 0
                  and len(m.readable) >= F)
            assert (k is not None) == ok
            if ok:
                exp = np.array(m.take(F, "span"), dtype).T
                np.testing.assert_array_equal(frames[k], exp)
        else:
            assert ring.release() == any(k == "span" for k, _ in m.busy)
            if m.busy:
                m.release()
        assert ring.fill == m.fill
        assert ring.readable == len(m.readable)
        assert ring.dropped_samples == dropped


@pytest.mark.parametrize("dtype", DTYPES)
def test_held_spans_fill_the_ring_until_released(backend, dtype):
    """``fill`` counts held spans, so a write sheds while they fill the
    ring; each release gives its frame's room back, oldest first."""
    ring, frames = _ring(dtype)
    blocks = [_block(F, dtype, i * F) for i in range(CAP // F + 2)]
    for b in blocks[:CAP // F]:
        assert ring.write(*b)
    held = [ring.acquire(F) for _ in range(CAP // F)]
    assert held == list(range(CAP // F))
    assert (ring.fill, ring.readable) == (CAP, 0)
    assert ring.acquire(F) is None
    assert not ring.write(*blocks[-2])              # shed: no room
    assert ring.dropped_samples == F
    assert ring.release()
    assert (ring.fill, ring.readable) == (CAP - F, 0)
    # Frame 0 is free again; frame 1 still holds block 1.
    np.testing.assert_array_equal(frames[1], np.stack(blocks[1]))
    assert ring.write(*blocks[-1])
    np.testing.assert_array_equal(frames[0], np.stack(blocks[-1]))
    for _ in range(CAP // F - 1):
        assert ring.release()
    assert not ring.release()
    assert (ring.fill, ring.readable) == (F, F)
    assert ring.acquire(F) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_read_behind_a_held_span_is_freed_with_it(backend, dtype):
    """Room comes back in ring order: a read between two held spans is
    freed when the span before it is released, not before."""
    ring, frames = _ring(dtype)
    blocks = [_block(F, dtype, i * F) for i in range(4)]
    for b in blocks:
        assert ring.write(*b)
    assert ring.acquire(F) == 0
    np.testing.assert_array_equal(np.stack(ring.read(F)),
                                  np.stack(blocks[1]))
    assert ring.acquire(F) == 2
    assert (ring.fill, ring.readable) == (4 * F, F)
    assert ring.release()                       # frame 0 and the read
    assert (ring.fill, ring.readable) == (2 * F, F)
    np.testing.assert_array_equal(frames[2], np.stack(blocks[2]))
    assert ring.release()
    assert (ring.fill, ring.readable) == (F, F)
    np.testing.assert_array_equal(np.stack(ring.read(F)),
                                  np.stack(blocks[3]))
    assert ring.fill == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_acquire_refuses_what_is_not_one_aligned_frame(backend, dtype):
    """No block of another length, none from a read position inside a
    frame, none before a whole frame is readable."""
    ring, _ = _ring(dtype)
    assert ring.write(*_block(F - 1, dtype, 0))
    assert ring.acquire(F) is None                 # not readable yet
    assert ring.write(*_block(2 * F, dtype, F - 1))
    assert ring.acquire(F - 1) is None and ring.acquire(2 * F) is None
    assert ring.read(3) is not None
    assert ring.acquire(F) is None                 # inside frame 0
    assert ring.read(F - 3) is not None
    assert ring.acquire(F) == 1
    assert (ring.fill, ring.readable) == (2 * F - 1, F - 1)
    assert ring.release()
    assert (ring.fill, ring.readable) == (F - 1, F - 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_framed_ring_reads_as_an_unframed_one(backend, dtype):
    """Arbitrary writes and reads through a ring in frames and through
    one of two whole planes give the same samples, fills and sheds."""
    rng = np.random.default_rng(4)
    a, _ = _ring(dtype)
    b = SampleRing(CAP, dtype)
    assert b.frame == CAP
    written = 0
    for _ in range(300):
        n = int(rng.integers(1, 30))
        if rng.random() < 0.5:
            blk = _block(n, dtype, written)
            written += n
            assert a.write(*blk) == b.write(*blk)
        else:
            got, exp = a.read(n), b.read(n)
            assert (got is None) == (exp is None)
            if got is not None:
                np.testing.assert_array_equal(np.stack(got),
                                              np.stack(exp))
        assert (a.fill, a.readable, a.dropped_samples) == (
            b.fill, b.readable, b.dropped_samples)


def test_storage_and_frame_are_checked(backend):
    with pytest.raises(ValueError, match="divide"):
        SampleRing(50, np.int16, frame=8)
    with pytest.raises(ValueError, match="storage"):
        SampleRing(48, np.int16, frame=8,
                   storage=np.zeros(2 * 48, np.float32))
    with pytest.raises(ValueError, match="storage"):
        SampleRing(48, np.int16, frame=8, storage=np.zeros(48, np.int16))
    store = np.zeros((6, 2, 8), np.int16)
    ring = SampleRing(48, np.int16, frame=8, storage=store)
    assert ring.storage is store


def _waiter(ring, n, timeout):
    """A thread waiting on ``ring``; its result and the time it returned
    go into the returned list."""
    out, started = [], threading.Event()

    def run():
        started.set()
        ok = ring.wait_readable(n, timeout)
        out.extend((ok, time.monotonic()))
    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(10)
    return t, out


def test_wait_readable_returns_at_once_when_the_block_is_there(backend):
    ring, _ = _ring(np.int16)
    assert ring.write(*_block(F + 3, np.int16, 0))
    t0 = time.monotonic()
    assert ring.wait_readable(F, 5.0)
    assert ring.wait_readable(F + 3, 5.0)
    assert time.monotonic() - t0 < 1.0
    assert not ring.wait_readable(F + 4, 0.0)


def test_a_write_from_another_thread_ends_the_wait(backend):
    """A wait on an empty ring returns True within 50 ms of the write
    that makes the block readable; a write of part of it does not end
    the wait."""
    ring, _ = _ring(np.int8)
    t, out = _waiter(ring, F, 10.0)
    time.sleep(0.02)
    assert ring.write(*_block(F - 1, np.int8, 0))
    time.sleep(0.02)
    assert t.is_alive() and not out
    assert ring.write(*_block(1, np.int8, F - 1))
    wrote = time.monotonic()
    t.join(10)
    assert not t.is_alive()
    assert out[0] is True and out[1] - wrote < 0.05


def test_wait_readable_times_out_on_an_empty_ring(backend):
    ring, _ = _ring(np.float32)
    t0 = time.monotonic()
    assert not ring.wait_readable(F, 0.05)
    assert 0.04 <= time.monotonic() - t0 < 1.0


def test_wake_releases_a_waiter_early(backend):
    """``wake()`` ends a wait long before its timeout; the ring still
    lacks the block, so the wait returns False."""
    ring, _ = _ring(np.int16)
    t, out = _waiter(ring, F, 10.0)
    time.sleep(0.02)
    ring.wake()
    woke = time.monotonic()
    t.join(10)
    assert not t.is_alive()
    assert out[0] is False and out[1] - woke < 1.0


def test_a_waiter_leaves_other_threads_running(backend):
    """While one thread waits on the ring, this one runs Python code: the
    wait does not hold the interpreter lock."""
    ring, _ = _ring(np.int16)
    t, out = _waiter(ring, F, 2.0)
    spins, t0 = 0, time.monotonic()
    while time.monotonic() - t0 < 0.2:
        spins += 1
    assert t.is_alive() and not out, "the wait held the interpreter lock"
    assert spins > 1000
    assert ring.write(*_block(F, np.int16, 0))
    t.join(10)
    assert out[0] is True
