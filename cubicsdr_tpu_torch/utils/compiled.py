"""CompiledStep — the port's counterpart of the JAX package's
``jax.jit(fn, donate_argnums=(0,))`` around a per-block step.

``fn(state, inputs) -> (state, outputs)`` is a pure step over nests of
tensors (dicts, tuples, lists and ``PC``; None holds no leaf). A
``CompiledStep`` owns static buffers for the state, the inputs and the
outputs:

- a call copies each given state or input leaf into its buffer unless it
  IS that buffer (the caller hands back the state the last call
  returned, and may write inputs straight into ``inputs``); a leaf of
  another shape, or another number of leaves, raises ValueError;
- it returns ``(state, outputs)``. ``state`` is the state buffers, which
  now hold the new state: the counterpart of donation;
- outputs alternate between ``slots`` sets of buffers (default 2), so
  the outputs of call i stay valid through call i+1 and are overwritten
  by call i+2. An output that is an input or state buffer (a
  passthrough) gets its own copy in the slot too. With ``slots=2`` a
  loop may finish block i-1 after it dispatched block i, as the JAX
  package's loop does with the fresh buffers each jitted call returns.

On a CUDA device the first call builds the step: ``WARMUPS`` calls on a
side stream, each on a throwaway copy of the state (they build what the
step builds at its first call: IIR constants, route taps, cuFFT plans,
the kernels' shared-memory attribute), then one CUDA graph per slot,
each with its own memory pool, all reading the shared state and input
buffers and copying the final state back into the state buffers inside
the graph. A call then copies its inputs and replays the next slot's
graph. A capture fault raises; there is no eager fallback. The capture
runs with ``capture_error_mode="thread_local"``: other threads may use
the card meanwhile (a control-plane thread builds a plan while the live
loop's consumer stages and replays blocks; the consumer replays while a
zoom level builds on the zoom view's prewarm thread), but none may
synchronise the whole device: a device-wide synchronisation, which
``torch.cuda.graph``'s entry makes (it also empties the caching
allocators, whose frees synchronise) and so do the build's own laps,
invalidates a capture in progress on another thread. So builds run one
at a time in the process, through ``BUILD_GATE``. A build asked for in
the background (``build(background=True)``: the zoom view's prewarm)
passes the gate once per part, each warm-up and each capture, and only
while no other build waits; so a build on the consumer's path (a new
plan's step, a new post-step, a zoom level to show) waits at most one
part of it. The kernel wrappers
count the warm-ups' launches as any launch; what a capture records they
count as ``captured``, and each replay adds its graph's launches to
their ``launches``.

A step with NCCL collectives (the compiled sharded step, one process
per rank) builds on every rank at its first call, which every rank
makes for the same block: the warm-ups run the collectives eagerly, in
the step's order on every rank, and so make the communicators (the
point-to-point ones too) before any capture; a capture records the
collectives without running them, so the ranks need not capture in
lockstep, and each replay then runs them in the same order on every
rank. ``BUILD_GATE`` orders builds within one process only. A
collective that NCCL refuses to capture raises, as any capture fault.

On the CPU the same object keeps the same buffer rules: a call runs
``fn`` eagerly on the buffers and copies its results into the slot's
output buffers and into the state buffers, so tests on the CPU see the
aliasing that the card would. Nothing is captured there: the first
call is the build, its eager run the warm-up (it builds what the step
builds at its first call).

A build is the span ``compiled.build`` of ``utils/metrics.py``
``SPANS.process``, numbered by build, with a child ``compiled.warmup``
or ``compiled.capture`` per part; each part ends synchronised. On the
card each graph records a pair of timing events at its start and its
end (event nodes inside the graph, so a replay costs the host nothing
more): ``device_ms(k)`` reads slot k's last replay, and ``last`` is the
slot of the last call. The step may mark points of its own work with
``device_mark(name)``: inside the capture of a step built with
``marks=True`` each mark is one more timing event of the graph, and
``mark_ms(k)`` gives, per mark, the device ms from the mark before it
(or the graph's start) to it. Elsewhere (a step built without marks,
the warm-ups, an eager step, the CPU) a mark does nothing, so a graph
of several steps (``bench.GraphedScan``) holds none.
"""

from __future__ import annotations

import contextlib
import itertools
import threading

import torch

from cubicsdr_tpu_torch.utils.metrics import SPANS, close_range, now, \
    open_range
from cubicsdr_tpu_torch.utils.tree import tree_leaves, tree_map

WARMUPS = 2             # eager calls before the captures (bench.py's)
_MARKS = threading.local()       # .events: the capture's marks, or None


def device_mark(name: str) -> None:
    """Inside the capture, on this thread, of a ``CompiledStep`` built
    with ``marks=True``, a timing event at this point of the graph,
    ending the part of the step named ``name`` (module docstring);
    elsewhere nothing."""
    marks = getattr(_MARKS, "events", None)
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        marks.append((name, ev))


class _BuildGate:
    """One CUDA build (part) at a time in the process: its device-wide
    synchronisations must not meet another thread's capture (module
    docstring). ``with BUILD_GATE():`` holds it for a whole build; with
    ``background=True`` it is entered only while no other build waits."""

    def __init__(self):
        self._cv = threading.Condition()
        self._held = False
        self._waiting = 0        # builds waiting that are not background

    @contextlib.contextmanager
    def __call__(self, background: bool = False):
        with self._cv:
            self._waiting += not background
            try:
                self._cv.wait_for(lambda: not self._held and (
                    not background or not self._waiting))
            finally:
                self._waiting -= not background
            self._held = True
        try:
            yield
        finally:
            with self._cv:
                self._held = False
                self._cv.notify_all()


BUILD_GATE = _BuildGate()


def counted_kernels() -> tuple:
    """The CUDA kernels' wrappers, each with ``launches`` and
    ``captured`` counters."""
    from cubicsdr_tpu_torch.ops.kernels.pfb import pfbch2_planar
    from cubicsdr_tpu_torch.ops.kernels.route import routed_shifted_resample
    return pfbch2_planar, routed_shifted_resample


def launch_counts() -> dict:
    """Each kernel wrapper's launches so far, by name."""
    return {k.__name__: k.launches for k in counted_kernels()}


def _captured_counts() -> dict:
    return {k.__name__: k.captured for k in counted_kernels()}


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _leaves(tree, what: str) -> list:
    leaves = tree_leaves(tree)
    for t in leaves:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} leaf {type(t).__name__} is not a "
                            f"tensor")
    return leaves


def _copy_into(bufs, given, what: str) -> None:
    """Copy the leaves of ``given`` (tensors or numpy arrays) into the
    buffers ``bufs``, skipping a leaf that is its buffer."""
    dst, src = tree_leaves(bufs), tree_leaves(given)
    if len(dst) != len(src):
        raise ValueError(f"{what}: {len(src)} leaves, the compiled step "
                         f"holds {len(dst)}")
    for d, s in zip(dst, src):
        if s is d:
            continue
        s = torch.as_tensor(s)
        if tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"{what}: a leaf of shape {tuple(s.shape)} "
                             f"for a buffer of {tuple(d.shape)}")
        d.copy_(s)


SPANS.ring("build", 1024)
_BUILD = SPANS.name("compiled.build", "build")
_PART = {"warmups": SPANS.name("compiled.warmup", "build", "compiled.build"),
         "captures": SPANS.name("compiled.capture", "build",
                                "compiled.build")}
_BUILDS = itertools.count()


class _BuildSpans:
    """The spans of one build: ``compiled.build`` from this object's
    creation to ``end``, with a child per part."""

    def __init__(self):
        self.range = open_range("compiled.build")
        self.seq = next(_BUILDS)
        self.start = now()
        self.split = {"warmups": [], "captures": []}

    def part(self, kind: str, start: int) -> None:
        """End a part ("warmups" or "captures") begun at ``start`` ns."""
        t = now()
        SPANS.process.add(_PART[kind], self.seq, start, t)
        self.split[kind].append((t - start) / 1e6)

    def end(self, step: "CompiledStep") -> None:
        close_range(self.range)
        SPANS.process.add(_BUILD, self.seq, self.start, now())
        step.build_ms = sum(map(sum, self.split.values()))
        step.build_split_ms = self.split


class CompiledStep:
    """A compiled per-block step over static buffers (module docstring).

    ``state`` and ``inputs`` are the buffers (None until the first call
    or ``prepare``); ``outputs[k]`` slot k's outputs; ``launches[k]`` the
    kernel launches slot k's graph holds (CUDA only); ``build_ms`` the
    wall ms of the build (CUDA: warm-ups and captures; CPU: the first
    call) and ``build_split_ms`` its parts (each warm-up, each capture,
    synchronised), both read from its spans; ``last`` the slot of the
    last call; ``marks`` whether its captures record ``fn``'s
    ``device_mark``s."""

    def __init__(self, fn, device, slots: int = 2, marks: bool = False):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.fn = fn
        self.device = torch.device(device)
        self.slots = int(slots)
        self.marks = bool(marks)
        self.state = None
        self.inputs = None
        self.outputs = [None] * self.slots
        self.launches = [None] * self.slots
        self.build_ms = None
        self.build_split_ms = None
        self.last = None
        self._graphs = None
        self._timing = None
        self._next = 0

    def _own(self, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        buf = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        buf.copy_(t)
        return buf

    def prepare(self, state, inputs) -> None:
        """Allocate the state and input buffers as copies of ``state``
        and ``inputs`` (tensors or numpy leaves). Nothing is built."""
        if self.state is not None:
            raise RuntimeError("the compiled step's buffers exist already")
        self.state = tree_map(self._own, state)
        self.inputs = tree_map(self._own, inputs)

    def build(self, background: bool = False) -> None:
        """(CUDA) Warm up and capture now rather than at the first call;
        needs the buffers (``prepare``). ``background``: a build off the
        consumer's path, which yields to other builds between its parts
        (module docstring)."""
        if self.state is None:
            raise RuntimeError("prepare the buffers before the build")
        if self.device.type == "cuda" and self._graphs is None:
            self._gated_build(background)

    def _gated_build(self, background: bool = False) -> None:
        parts = self._build()
        if not background:
            with BUILD_GATE():
                for _ in parts:
                    pass
            return
        done = False
        while not done:
            with BUILD_GATE(background=True):
                done = next(parts, True) is True

    def load_state(self, state) -> None:
        """Copy ``state`` (tensors or numpy leaves) into the state
        buffers, in stream order behind the calls already made."""
        _copy_into(self.state, state, "state")

    def __call__(self, state, inputs):
        if self.state is None:
            self.prepare(state, inputs)
        else:
            _copy_into(self.state, state, "state")
            _copy_into(self.inputs, inputs, "inputs")
        k = self.last = self._next
        self._next = (k + 1) % self.slots
        if self.device.type == "cuda":
            if self._graphs is None:
                self._gated_build()
            self._graphs[k].replay()
            for kern in counted_kernels():
                kern.launches += self.launches[k][kern.__name__]
            return self.state, self.outputs[k]
        spans = _BuildSpans() if self.build_ms is None else None
        t0 = now()
        rng = open_range("compiled.warmup") if spans is not None else None
        new_state, out = self.fn(self.state, self.inputs)
        out = self._keep(k, out)
        self._write_state(new_state)
        if spans is not None:
            close_range(rng)
            spans.part("warmups", t0)
            spans.end(self)
        return self.state, out

    def device_ms(self, k: int):
        """(CUDA) Device ms of slot k's last replay, from its graph's
        start to its end; call it once the replay is done. None on the
        CPU."""
        if self._timing is None:
            return None
        start, end, _ = self._timing[k]
        return start.elapsed_time(end)

    def mark_ms(self, k: int) -> dict:
        """(CUDA) Per ``device_mark`` of slot k's graph, in its order,
        the device ms of its last replay from the mark before (or the
        graph's start) to this mark; call it once the replay is done.
        Empty on the CPU and for a step without marks. Raises where a
        name marks more than one point of the graph."""
        if self._timing is None:
            return {}
        prev, _, marks = self._timing[k]
        out = {}
        for name, ev in marks:
            if name in out:
                raise ValueError(f"the step's graph marks {name!r} more "
                                 f"than once")
            out[name] = prev.elapsed_time(ev)
            prev = ev
        return out

    def _keep(self, k: int, out):
        """(CPU) ``out`` copied into slot k's output buffers."""
        _leaves(out, "output")
        if self.outputs[k] is None:
            self.outputs[k] = tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      device=t.device), out)
        _copy_into(self.outputs[k], out, "outputs")
        return self.outputs[k]

    def _write_state(self, new_state) -> None:
        """Copy ``new_state`` into the state buffers. A leaf that reads a
        state buffer other than its own is copied first, so that no copy
        reads a buffer an earlier copy wrote."""
        dst = tree_leaves(self.state)
        src = _leaves(new_state, "state")
        if len(src) != len(dst):
            raise ValueError(f"the step returned {len(src)} state leaves "
                             f"for {len(dst)} buffers")
        own = {_ptr(t) for t in dst}
        src = [s.clone() if s is not d and _ptr(s) in own else s
               for d, s in zip(dst, src)]
        _copy_into(self.state, src, "new state")

    def _build(self):
        """(CUDA) The warm-ups, then one capture per slot: a generator
        that yields after each part, never inside a stream's or a
        capture's context."""
        dev = self.device
        spans = _BuildSpans()

        def lap(part, t0, rng):
            torch.cuda.synchronize(dev)
            close_range(rng)
            spans.part(part, t0)

        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        for _ in range(WARMUPS):
            t0, rng = now(), open_range("compiled.warmup")
            with torch.cuda.stream(side):
                self.fn(tree_map(torch.clone, self.state), self.inputs)
            lap("warmups", t0, rng)
            yield
        cur.wait_stream(side)
        owned = {_ptr(t) for t in (tree_leaves(self.state)
                                   + tree_leaves(self.inputs))}
        graphs, outs, counts, timing = [], [], [], []
        for k in range(self.slots):
            t0, rng = now(), open_range("compiled.capture")
            g = torch.cuda.CUDAGraph()
            ev = tuple(torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(2))
            before = _captured_counts()
            marks = []
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                ev[0].record()
                _MARKS.events = marks if self.marks else None
                try:
                    new_state, out = self.fn(self.state, self.inputs)
                finally:
                    _MARKS.events = None
                _leaves(out, "output")
                out = tree_map(
                    lambda t: t.clone() if _ptr(t) in owned else t, out)
                self._write_state(new_state)
                ev[1].record()
            lap("captures", t0, rng)
            after = _captured_counts()
            timing.append((*ev, tuple(marks)))
            graphs.append(g)
            outs.append(out)
            counts.append({n: after[n] - before[n] for n in after})
            if k + 1 < self.slots:
                yield
        self._graphs, self.outputs, self.launches = graphs, outs, counts
        self._timing = timing
        spans.end(self)
