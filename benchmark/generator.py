"""The one traffic generator: a source object for ``LiveReceiver`` that
cycles a configuration's wire-format loop in whole blocks, driven by a
traffic mix's parameters (``traffic/<mix>.json``):

- ``"loop": "closed"`` — a copy of the port's ``utils/synth.py``
  ``CycleSource``: the producer waits for ring space and never sheds, so
  the rate is the live loop's own (a recording replayed faster than real
  time).
- ``"loop": "open"`` — a copy of ``utils/soak.py`` ``PacedSource``: block
  i of the window is written at its deadline, ``t0 + (i + 1) L / rate``
  with ``rate = rate_factor x`` the configuration's sample rate, whether
  or not the loop keeps up (a radio streaming to a listener).

Set-up runs ``allow(n)`` blocks closed-loop; ``start_window`` then
starts the mix's own schedule. Accounting: every block offered (its
stream index, its due time, whether the ring dropped it). A block's drop
is read from the ring's drop counter before the next block is handed
over, so each is paired exactly.
"""

from __future__ import annotations

import threading
import time

from benchmark.synth import stream_block


class TrafficSource:
    def __init__(self, mix: dict, loop, block_len: int, sample_rate: float):
        if mix.get("loop") not in ("closed", "open"):
            raise ValueError(f"a traffic mix's loop is closed or open, not "
                             f"{mix.get('loop')!r}")
        self.mix = mix
        self.closed = mix["loop"] == "closed"
        self.loop = loop
        self.L = int(block_len)
        self.rate = float(sample_rate) * float(mix.get("rate_factor", 1.0))
        self.ring = None                 # set to the receiver's ring
        self.drops = lambda: 0           # the ring's dropped samples
        self.offered: list = []          # [stream index, due, dropped]
        self.late_s = 0.0
        self._cv = threading.Condition()
        self._budget = 0                 # closed-loop blocks allowed
        self._window = None              # (t0, first index, count|None)
        self._stop = threading.Event()

    # --- control, from the harness's thread ---
    def allow(self, n: int):
        """Let ``n`` more blocks through, closed-loop (set-up)."""
        with self._cv:
            self._budget += int(n)
            self._cv.notify_all()

    def start_window(self, t0: float, count: int | None = None):
        """Start the mix's schedule at ``t0`` (perf_counter seconds): an
        open loop offers ``count`` blocks due from ``t0``, a closed loop
        offers blocks until stopped."""
        with self._cv:
            self._window = (float(t0), len(self.offered), count)
            self._cv.notify_all()

    def stop(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()

    def settle(self):
        """Read the last block's drop (after the producer has stopped)."""
        self._mark_drop()

    # --- the producer's side ---
    def _mark_drop(self):
        d = self.drops()
        if self.offered and d > self._seen_drops:
            self.offered[-1][2] = True
        self._seen_drops = d

    def _wait_turn(self) -> bool:
        """Block until the next block may go; False once stopped."""
        with self._cv:
            while not self._stop.is_set():
                w = self._window
                if w is None:
                    if self._budget > 0:
                        self._budget -= 1
                        return True
                elif w[2] is None or len(self.offered) - w[1] < w[2]:
                    return True
                self._cv.wait(0.05)
        return False

    def __iter__(self):
        # Two buffers, filled in turn: the live loop's producer copies a
        # block into the ring before it asks for the next.
        bufs = [None, None]
        self._seen_drops = self.drops()
        k = 0
        while self._wait_turn():
            w = self._window
            due = None
            if w is None or self.closed:
                while (self.ring is not None and not self._stop.is_set()
                       and self.ring.fill + self.L > self.ring.capacity):
                    time.sleep(0.0002)
            else:
                due = w[0] + (len(self.offered) - w[1] + 1) * self.L \
                    / self.rate
                ahead = due - time.perf_counter()
                if ahead > 0:
                    self._stop.wait(ahead)
                else:
                    self.late_s = max(self.late_s, -ahead)
            if self._stop.is_set():
                break
            self._mark_drop()
            self.offered.append([k, due, False])
            bufs[k % 2] = stream_block(self.loop, self.L, k, bufs[k % 2])
            yield bufs[k % 2]
            k += 1
