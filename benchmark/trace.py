"""Reduction of a traced window to what the per-layer metrics read.

The traced run keeps ``torch.profiler``'s events in memory (no trace file
is written): the device's kernels and copies, and the harness's own host
spans (``bench.step_dispatch``, ``bench.post_dispatch``,
``bench.fanout_finish``, recorded around its calls into the live loop).
A block is the device work from one PFB launch (one per block) to the
next; per block: the union of device intervals (busy), the device
operations, and each kernel's time. Idle gaps on the device are labelled
with the host span that was open at their middle.
"""

from __future__ import annotations

import collections

HOST_SPANS = ("bench.step_dispatch", "bench.post_dispatch",
              "bench.fanout_finish")
BLOCK_MARK = "pfbch2_kernel"


def profiler_events(prof):
    """(device events, host spans): [(name, start_ns, end_ns)] from a
    stopped ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    try:
        events = prof.profiler.kineto_results.events()
        rows = ((e.name(), e.device_type(), e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in events)
    except AttributeError:                   # an older profiler
        rows = ((e.name, e.device_type, int(e.time_range.start * 1000),
                 int(e.time_range.end * 1000)) for e in prof.events())
    for name, dtype, a, b in rows:
        if name in HOST_SPANS:
            # A span also shows on the device's timeline as an
            # annotation: it is host time, never device work.
            if dtype != cuda:
                host.append((name, a, b))
        elif dtype == cuda:
            dev.append((name, a, b))
    dev.sort(key=lambda e: e[1])
    host.sort(key=lambda e: e[1])
    return dev, host


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def blocks(dev) -> list:
    """Per complete block of the trace (device work from one PFB launch to
    the next): {"busy_ns", "kernels", "ns_by_name"}."""
    marks = [a for name, a, _ in dev if BLOCK_MARK in name]
    out = []
    j = 0
    for lo, hi in zip(marks, marks[1:]):
        while j < len(dev) and dev[j][1] < lo:
            j += 1
        seg, k = [], j
        while k < len(dev) and dev[k][1] < hi:
            seg.append(dev[k])
            k += 1
        by_name = collections.Counter()
        for name, a, b in seg:
            by_name[name] += b - a
        busy = sum(min(b, hi) - a for a, b in _union(
            [(a, b) for _, a, b in seg]))
        out.append({"busy_ns": busy, "kernels": len(seg),
                    "ns_by_name": by_name})
    return out


def breakdown(dev, host, top: int = 10) -> dict:
    """The device operations that took most time over the trace, and the
    longest device-idle gaps labelled by the host span open at their
    middle (``staging_wait_or_other`` where none was)."""
    tot = collections.Counter()
    for name, a, b in dev:
        tot[name[:120]] += b - a
    busy = _union([(a, b) for _, a, b in dev])
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    labelled = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        label = "staging_wait_or_other"
        for name, ha, hb in host:
            if ha <= mid <= hb:
                label = name.split(".", 1)[1]
                break
        labelled.append([f"idle during {label}", (b - a) / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in tot.most_common(top)],
            "idle_gaps": labelled}


def busy_seconds(dev) -> float:
    return sum(b - a for a, b in _union([(a, b) for _, a, b in dev])) / 1e9
