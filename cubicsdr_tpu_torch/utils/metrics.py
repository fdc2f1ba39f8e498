"""Observability: per-stage throughput/drop counters, spans, and a
torch.profiler context (``cubicsdr_tpu/utils/metrics.py``, re-homed
because that module's package pulls in jax).

A registry of counters any stage can tick, a snapshot API for status
lines, the process-wide span store ``SPANS``, and ``profile_trace``
around ``torch.profiler`` for kernel-level traces of the card.

Spans. A span is one row of int64: its owner (a ``SpanLog``), its name,
a sequence number (a block's, say; -1 for none), its start and end
(``time.time_ns()``, the clock of ``torch.profiler``'s events) and a
value it carries. A name is declared once, with the thread whose work it
covers and its parent (a span of the same number); its rows live in the
ring of that thread, which holds that thread's last spans in
preallocated rows and drops the oldest first. Recording a span reuses a
row and keeps no new object. A span timed on the card starts at 0 and
ends at its device ns. The modules that record spans declare them
(``app/runner.py``: the live loop; ``utils/compiled.py``: builds).
Spans are always recorded.

Each ``Metrics`` holds a ``SpanLog``, its share of the store: a reader
takes one receiver's spans through it (``SPANS.latest()`` is the newest
log that holds a span); spans of no receiver (builds) go to
``SPANS.process``. While this thread's profiler runs, a span also opens
a profiler range of the same name (function scope, as an operator's: a
user-scope ``record_function`` would also annotate the device's
timeline); ``profile_trace`` adds every thread's spans to its trace
file, since the profiler records only its own thread's ranges.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import struct
import time
import weakref
from array import array
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

SPAN_BLOCKS = 4096      # a ring holds this many blocks of its spans
_COLS = 6               # owner, name, seq, start, end, value

now = time.time_ns
_profiling = torch.autograd._profiler_enabled
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def open_range(name: str):
    """A profiler range ``name`` while this thread's profiler runs (else
    None); ``close_range`` ends it."""
    if _Range is None or not _profiling():
        return None
    r = _Range(name)
    r.__enter__()
    return r


def close_range(r) -> None:
    if r is not None:
        r.__exit__(None, None, None)


_ROW = struct.Struct(f"{_COLS}q")


class _Ring:
    """The last ``rows`` spans of one thread: an int64 array (``a``, what
    recording writes a whole row into at once) and a numpy view of it
    (``t``, what reading reads); ``names``, the ids of its spans."""

    def __init__(self, rows: int):
        self.rows = rows
        self.a = array("q", bytes(8 * _COLS * rows))
        self.t = np.frombuffer(self.a, np.int64).reshape(rows, _COLS)
        self.t[:, 0] = -1
        self.next = itertools.count()
        self.names: list[int] = []


class SpanStore:
    """Spans shared by the process (module docstring)."""

    def __init__(self):
        self._rings: dict[str, _Ring] = {}
        self._ids: dict[str, int] = {}
        self._names: list[str] = []
        self._threads: list[str] = []
        self._parents: list = []
        self._ring_of: list[_Ring] = []
        self._keys = itertools.count(1)
        self._logs: list = []
        self.process = SpanLog(self, 0)

    def ring(self, thread: str, rows: int) -> None:
        """Hold the last ``rows`` spans of ``thread``; declare it once,
        before its names."""
        if thread not in self._rings:
            self._rings[thread] = _Ring(rows)

    def name(self, name: str, thread: str, parent: str | None = None
             ) -> int:
        """The id of span ``name``, on ``thread``'s ring, a child of
        ``parent``; the same name again gives the same id."""
        if name in self._ids:
            i = self._ids[name]
            if (self._threads[i], self._parents[i]) != (thread, parent):
                raise ValueError(f"span {name!r} declared otherwise")
            return i
        if parent is not None and parent not in self._ids:
            raise ValueError(f"declare {parent!r} before {name!r}")
        self._ids[name] = i = len(self._names)
        self._names.append(name)
        self._threads.append(thread)
        self._parents.append(parent)
        self._ring_of.append(self._rings[thread])
        self._rings[thread].names.append(i)
        return i

    def parent(self, name: str):
        return self._parents[self._ids[name]]

    def log(self) -> "SpanLog":
        """A new log, the share of one ``Metrics``."""
        lg = SpanLog(self, next(self._keys))
        self._logs = [r for r in self._logs if r() is not None]
        self._logs.append(weakref.ref(lg))
        return lg

    def latest(self):
        """The newest live log that holds a span, or None."""
        for r in reversed(self._logs):
            lg = r()
            if lg is not None and any((g.t[:, 0] == lg.key).any()
                                      for g in self._rings.values()):
                return lg
        return None

    def events(self, start: int, end: int) -> list:
        """[(name, thread, seq, start, end)] of every span held on the
        host clock that overlaps [start, end] ns, any log's."""
        out = []
        for thread, g in self._rings.items():
            t = g.t[(g.t[:, 0] >= 0) & (g.t[:, 3] > 0) & (g.t[:, 4] >= start)
                    & (g.t[:, 3] <= end)]
            for _, i, seq, a, b, _ in t.tolist():
                out.append((self._names[i], thread, seq, a, b))
        return out


class SpanLog:
    """One owner's spans in a ``SpanStore``. ``add`` runs on the
    recording threads and writes into a reused row."""

    def __init__(self, store: SpanStore, key: int):
        self.store = store
        self.key = key
        self.opened_ns = now()

    def add(self, name: int, seq: int, start: int, end: int,
            value: int = 0) -> None:
        """Record span ``name`` (an id of ``SpanStore.name``): one C call
        writes the whole row, so no thread sees it half written."""
        g = self.store._ring_of[name]
        _ROW.pack_into(g.a, next(g.next) % g.rows * _ROW.size, self.key,
                       name, seq, start, end, value)

    def rows(self, names, first: int | None = None,
             stop: int | None = None) -> dict:
        """This log's spans of ``names`` held (numbered ``first`` to
        ``stop`` - 1 when given), by number then start: arrays ``name``
        (the names), ``seq``, ``start``, ``end``, ``value``."""
        st = self.store
        ids = [st._ids[n] for n in names if n in st._ids]
        cols = [[] for _ in range(1, _COLS)]
        for g in {id(st._ring_of[i]): st._ring_of[i] for i in ids}.values():
            t = g.t
            m = (t[:, 0] == self.key) & np.isin(t[:, 1], ids)
            if first is not None:
                m &= t[:, 2] >= first
            if stop is not None:
                m &= t[:, 2] < stop
            j = np.flatnonzero(m)
            for c, col in enumerate(cols, 1):
                col.append(t[j, c])
        name, seq, start, end, value = (
            np.concatenate(c) if c else np.zeros(0, np.int64)
            for c in cols)
        o = np.lexsort((start, seq))
        return {"name": np.array(st._names, dtype=object)[name[o]],
                "seq": seq[o], "start": start[o], "end": end[o],
                "value": value[o]}

    def by_seq(self, names, first: int = 0,
               stop: int | None = None) -> dict:
        """This log's spans of ``names`` numbered ``first`` to ``stop`` -
        1, aligned by number: ``seq`` (each number held), and per name
        arrays (start, end, value), 0 where it has none."""
        r = self.rows(names, first, stop)
        seqs = np.unique(r["seq"])
        out = {"seq": seqs}
        for n in names:
            m = r["name"] == n
            cols = tuple(np.zeros(len(seqs), np.int64) for _ in range(3))
            j = np.searchsorted(seqs, r["seq"][m])
            for c, k in zip(cols, ("start", "end", "value")):
                c[j] = r[k][m]
            out[n] = cols
        return out

    def summary(self) -> dict:
        """Per span name, the count and the median ms (end - start) over
        this log's spans held."""
        st = self.store
        out = {}
        for g in st._rings.values():
            t = g.t
            own = t[:, 0] == self.key
            if not own.any():
                continue
            ns = t[:, 4] - t[:, 3]
            for i in g.names:
                d = ns[own & (t[:, 1] == i)]
                if len(d):
                    out[st._names[i]] = {
                        "count": int(len(d)),
                        "median_ms": float(np.median(d)) / 1e6}
        return out


SPANS = SpanStore()


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
    """Named stats, counters and notes, and this registry's spans
    (``spans``, a ``SpanLog`` of ``SPANS``)."""

    def __init__(self):
        self.stats: dict[str, StreamStats] = defaultdict(StreamStats)
        self.notes: dict[str, object] = {}
        self.counters: dict[str, int] = defaultdict(int)
        self.spans = SPANS.log()

    def tick(self, name: str, n_samples: int, dropped: int = 0):
        self.stats[name].tick(n_samples, dropped)

    def count(self, name: str, n: int = 1):
        """Add ``n`` to the event counter ``name``."""
        self.counters[name] += n

    def set(self, name: str, value: int):
        """Set the counter ``name`` to ``value``: a level (a plan's
        setting, the last block's size) rather than a count."""
        self.counters[name] = value

    def note(self, key: str, value):
        """Latest-value observability (device counters, last errors)."""
        self.notes[key] = value

    def snapshot(self) -> dict:
        out = {k: v.snapshot() for k, v in list(self.stats.items())}
        if self.counters:
            out["counters"] = dict(self.counters)
        spans = self.spans.summary()
        if spans:
            out["spans"] = spans
        if self.notes:
            out["notes"] = dict(self.notes)
        return out

    def status_line(self) -> str:
        parts = [f"{k}: {v.msps:.2f} MS/s"
                 + (f" (dropped {v.samples_dropped})"
                    if v.samples_dropped else "")
                 for k, v in self.stats.items()]
        return " | ".join(parts)


def _add_spans(path: str, events: list) -> None:
    """Append the program's spans to a Chrome trace file, one row per
    thread of the loop."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    tids = {}
    evs = trace.setdefault("traceEvents", [])
    for name, thread, seq, a, b in events:
        if thread not in tids:
            tids[thread] = tid = 2_000_000_000 + len(tids)
            evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": f"spans: {thread}"}})
        parent = SPANS.parent(name)
        args = {} if parent is None else {"parent": parent}
        if seq >= 0:
            args["seq"] = seq
        evs.append({"ph": "X", "cat": "program_span", "name": name,
                    "pid": pid, "tid": tids[thread], "ts": (a - base) / 1e3,
                    "dur": (b - a) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the CPU and (when present) the CUDA device with
    ``torch.profiler``; the Chrome trace lands in ``log_dir``, with the
    program's spans of the traced interval on rows of their own. Yields
    the profiler, whose ``key_averages()`` sums device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = now()
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, SPANS.events(t0, now()))
