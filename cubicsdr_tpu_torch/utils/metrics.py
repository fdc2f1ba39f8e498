"""Observability: per-stage throughput/drop counters and a torch.profiler
context (``cubicsdr_tpu/utils/metrics.py``, re-homed because that module's
package pulls in jax).

A registry of counters any stage can tick, a snapshot API for status
lines, and ``profile_trace`` around ``torch.profiler`` for kernel-level
traces of the card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StreamStats:
    samples_in: int = 0
    blocks_in: int = 0
    samples_dropped: int = 0
    t_start: float = field(default_factory=time.monotonic)
    t_last: float = field(default_factory=time.monotonic)

    def tick(self, n_samples: int, dropped: int = 0):
        self.samples_in += n_samples
        self.blocks_in += 1
        self.samples_dropped += dropped
        self.t_last = time.monotonic()

    @property
    def elapsed(self) -> float:
        return max(self.t_last - self.t_start, 1e-9)

    @property
    def msps(self) -> float:
        return self.samples_in / self.elapsed / 1e6

    def snapshot(self) -> dict:
        return {
            "samples": self.samples_in,
            "blocks": self.blocks_in,
            "dropped": self.samples_dropped,
            "msps": round(self.msps, 3),
        }


class Metrics:
    """Process-wide named stats registry."""

    def __init__(self):
        self.stats: dict[str, StreamStats] = defaultdict(StreamStats)
        self.notes: dict[str, object] = {}

    def tick(self, name: str, n_samples: int, dropped: int = 0):
        self.stats[name].tick(n_samples, dropped)

    def note(self, key: str, value):
        """Latest-value observability (device counters, last errors)."""
        self.notes[key] = value

    def snapshot(self) -> dict:
        out = {k: v.snapshot() for k, v in self.stats.items()}
        if self.notes:
            out["notes"] = dict(self.notes)
        return out

    def status_line(self) -> str:
        parts = [f"{k}: {v.msps:.2f} MS/s"
                 + (f" (dropped {v.samples_dropped})"
                    if v.samples_dropped else "")
                 for k, v in self.stats.items()]
        return " | ".join(parts)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the CPU and (when present) the CUDA device with
    ``torch.profiler``; the Chrome trace lands in ``log_dir``. Yields the
    profiler, whose ``key_averages()`` sums device time by kernel."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
