"""The live loop's staging (``cubicsdr_tpu_torch/app/runner.py``): the
ring in frames of one block, the held spans' release, and on the card
(marked ``card``; run with ``python -m pytest tests/test_torch_staging.py
-m card`` on a machine with a GPU) each block copied to the device
straight out of its pinned ring frame. No JAX here."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cubicsdr_tpu_torch.receiver as T
from cubicsdr_tpu_torch.app.runner import LiveReceiver
from cubicsdr_tpu_torch.utils.soak import join_prewarms

FS = 1_000_000
L = 16750


def build(device="cpu"):
    mgr = T.DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = T.plan_from_manager(mgr)
    rx = T.ReceiverPipeline(FS, specs, block_len=L, use_kernels=False,
                            device=device)
    return rx, T.controls_from_manager(mgr, rx, keyed, 100e6)


def blocks(n, seed=0):
    """Planes [2, L] of float32 noise, one per block."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, L)).astype(np.float32)
            for _ in range(n)]


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
