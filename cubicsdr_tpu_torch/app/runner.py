"""LiveReceiver — the running application core (``cubicsdr_tpu/app/
runner.py``) on torch tensors.

The analog of CubicSDR::OnInit's thread/queue wiring (ref: src/CubicSDR.cpp:
342-397): ONE producer thread fills the native sample ring from a source,
and the consumer loop pops fixed blocks, runs the receive step, and fans
results out to audio sinks (per-demod recorders + mix), the
spectrum/waterfall processors and the metrics registry. Back-pressure is
the bounded ring's try-push shedding, the reference's queue-full policy
(ref: src/sdr/SoapySDRThread.cpp:384-399).

Per block, on the pipeline's device:

    ring --(staging worker: pinned slot, own CUDA stream)--> device planes
         --> step --> packed post-step (waterfall re-block + spectrum EMA,
             levels, squelch flags, audio, demod view, zoom view)
         --> ONE device->host copy into pinned memory --> host fan-out

Threads and CUDA:

- the producer touches only numpy and the ring;
- the staging worker copies each block into one of ``N_SLOTS`` persistent
  pinned host slots and issues the host->device copy on its own CUDA
  stream, recording an event; a slot is refilled only after its previous
  copy's event has completed;
- the consumer makes its stream wait on that event before the step and
  ``record_stream``s the planes, so the caching allocator cannot recycle
  them while the step reads them. It dispatches block i, then finishes
  block i-1, whose packed pull synchronises on its own event first.

The loop runs a pipeline of either representation: planar
(``dtype=PLANAR``) or complex64. The ring carries float32 planes for
both; the step assembles them in the pipeline's representation, so a
block staged before a planar<->complex swap reaches the new step in the
new representation, and the visual chain (distributor, spectrum, zoom and
demod views) follows the pipeline's. Raw cs16/cs8 ingest takes a planar
pipeline. There is no CPU fallback: a CUDA pipeline runs every stage on
the card; a CPU pipeline (the tests) runs the same code with plain host
tensors.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cubicsdr_tpu_torch.io.recorder import RecordingSink, SquelchOption
from cubicsdr_tpu_torch.native import SampleRing
from cubicsdr_tpu_torch.ops.planar import PC, PLANAR, as_pc, to_complex
from cubicsdr_tpu_torch.utils.metrics import Metrics
from cubicsdr_tpu_torch.utils.tree import tree_map
from cubicsdr_tpu_torch.visual import (
    FFTDataDistributor, PlanarSpectrumProcessor, SpectrumProcessor,
    Waterfall)

# Pinned staging slots: one block computing, one staged, one being
# filled, and one spare so a refill never waits on a copy in flight.
N_SLOTS = 4


class _Stager:
    """Single DAEMON worker running staged host->device copies (a
    non-daemon worker hung on a dead transport would hang process exit,
    ref: src/CubicSDR.cpp:448-490).

    Every box names the pool that made it. After ``shutdown`` a submit
    queues nothing and returns a box already resolved to None, so a
    lookahead submit racing ``stop()`` can never leave a box that no
    worker will complete."""

    class _Box:
        def __init__(self, pool):
            self.pool = pool
            self._ev = threading.Event()
            self._val = None
            self._exc = None

        def result(self):
            self._ev.wait()
            if self._exc is not None:
                raise self._exc
            return self._val

    def __init__(self, name: str = "cs-stage"):
        self._q: queue.Queue = queue.Queue()
        self._mu = threading.Lock()
        self._closed = False
        self._t = threading.Thread(target=self._run, name=name,
                                   daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, box = item
            try:
                box._val = fn(*args)
            except BaseException as e:       # noqa: BLE001 — re-raised
                box._exc = e
            finally:
                box._ev.set()

    def submit(self, fn, *args) -> "_Stager._Box":
        box = self._Box(self)
        with self._mu:
            if not self._closed:
                self._q.put((fn, args, box))
                return box
        box._ev.set()                        # closed: resolves empty
        return box

    def shutdown(self, timeout: float = 2.0):
        """Stop the worker after its current item; waits at most
        ``timeout`` seconds for it (a copy hung on a dead device must not
        hang the caller)."""
        with self._mu:
            self._closed = True
            self._q.put(None)
        self._t.join(timeout=timeout)


class _Staged(NamedTuple):
    """One ring block on its way to the device."""
    iq: tuple          # (re, im) on the device, ring dtype
    planes: tuple      # (re, im) host numpy copies from the ring
    n: int             # samples
    gen: int           # ring/format generation it was read from
    ready: object      # CUDA event of its host->device copy, or None


class LiveReceiver:
    def __init__(self, pipeline, controls, source,
                 center_freq: float = 0.0,
                 ring_seconds: float = 2.0,
                 record_path: Optional[str] = None,
                 record_squelch: SquelchOption = SquelchOption.RECORD_SILENCE,
                 record_time_limit: float = 0.0,
                 waterfall_fft: int = 1024,
                 waterfall_lines: int = 256,
                 waterfall_lps: float = 30.0,
                 on_block: Optional[Callable] = None,
                 ingest_dtype=None, ingest_scale: Optional[float] = None):
        self.pipeline = pipeline
        self.device = pipeline.device
        self._cuda = self.device.type == "cuda"
        self.controls = controls
        self._ctl_cache = None               # (snapshot, device controls)
        self.source = source
        self.center_freq = center_freq
        # Native-format ingest: the ring and the host->device copy carry
        # the WIRE sample format (cs16/cs8 planes) and the step converts
        # on the device (ref: src/sdr/SoapySDRThread.cpp:253-343 converts
        # on the host).
        self.ingest_dtype = np.dtype(ingest_dtype or np.float32)
        self.planar = pipeline.dtype == PLANAR
        self._check_ingest(pipeline)
        if ingest_scale is None:
            ingest_scale = {2: 1.0 / 32768.0, 1: 1.0 / 128.0}.get(
                self.ingest_dtype.itemsize, 1.0)
        self.ingest_scale = float(ingest_scale)
        self.step = self._make_step(pipeline)
        self.state = pipeline.init_state()
        self.metrics = Metrics()
        self._ring_seconds = float(ring_seconds)
        # (generation, ring, block_len), replaced as one object by a format
        # swap: the staging worker reads all three at once, and a staged
        # block carries the generation it was read under.
        self._ingest = (0, self._new_ring(pipeline), pipeline.block_len)
        self.record_path = record_path
        self._recorders: dict[int, RecordingSink] = {}
        self._rec_opts = (record_squelch, record_time_limit)
        # Per-demod runtime recording control (ref: DemodulatorInstance::
        # startRecording/stopRecording, src/demod/DemodulatorInstance.cpp:
        # 600-655): launching with record_path records every demod
        # (record_all); per-row overrides key on stable row keys.
        self.record_all = record_path is not None
        self.rec_override: dict = {}
        # Stable per-row identities (set by a control plane to demod
        # instance ids); None -> flat indices.
        self.row_keys: Optional[list] = None
        self.on_block = on_block

        self.dist = FFTDataDistributor(
            waterfall_fft * 2, pipeline.sample_rate,
            lines_per_second=waterfall_lps, block_len=pipeline.block_len,
            dtype=pipeline.dtype).to(self.device)
        self.spec = self._spec_cls()(waterfall_fft).to(self.device)
        self.waterfall = Waterfall(waterfall_fft, waterfall_lines)
        self._st_dist = self.dist.init_state()
        self._st_spec = self.spec.init_state()

        # Demod-view spectrum (the second SpectrumVisualProcessor, ref:
        # src/CubicSDR.cpp:340,374): ONE selected demod's IQ tap, re-blocked
        # and EMA'd inside the packed post-step; its points ride the one
        # packed pull.
        self.demod_view: Optional[int] = None    # flat (group-order) index
        self.demod_view_fft = 256
        self.demod_spectrum: Optional[np.ndarray] = None
        self._dv_gi: Optional[int] = None        # group of the viewed row
        self._dv_off = 0                         # flat offset of that group
        self._dv_dist = None
        self._dv_spec = None
        self._st_dv: tuple = ()
        self._rows_idx: dict = {}                # audio rows -> device index

        self._install_post()

        # Live audio tap: rolling mix chunks for host audio listeners (the
        # AudioThread output analog, ref: src/audio/AudioThread.cpp:88-243).
        self.audio_tap: collections.deque = collections.deque(maxlen=64)
        self.audio_cond = threading.Condition()
        self._audio_seq = 0
        # Host audio playback: N named sinks, each fed the full mix, one
        # soloed demod, or a host-mixed demod subset (ref: src/audio/
        # AudioThread.cpp:370-442, :88-243).
        self.audio_sinks: dict[str, dict] = {}
        self.audio_solo: Optional[int] = None

        # Zoomed main-spectrum view (ref: src/process/
        # SpectrumVisualProcessor.cpp:283-386), created by set_zoom();
        # zoom-off stashes the view with its built fronts.
        self.zoom = None
        self._zoom_stash = None

        self._stop = threading.Event()
        self._stage_pool: Optional[_Stager] = None
        self._staged = None              # in-flight staged-block box
        self._slots: list = []           # pinned staging slots [2, L]
        self._slot_events: list = []
        self._slot_next = 0
        self._pull_slots: list = [None] * N_SLOTS   # pinned pull buffers
        self._pull_events: list = [None] * N_SLOTS
        self._pull_next = 0
        self._h2d_stream = None
        self._producer: Optional[threading.Thread] = None
        self._producer_gen = 0               # bumped to retire a producer
        self.source_error: Optional[Exception] = None
        # Serializes step dispatch and state reassignment against
        # control-plane threads (plan swap, state snapshot, view changes).
        # Held only for the dispatch, never for host fan-out.
        self.step_lock = threading.Lock()

    def _new_ring(self, pipeline) -> SampleRing:
        cap = int(pipeline.sample_rate * self._ring_seconds)
        return SampleRing(max(cap, 4 * pipeline.block_len),
                          dtype=self.ingest_dtype)

    @property
    def ring(self) -> SampleRing:
        return self._ingest[1]

    # --- producer: source -> ring (the SDRThread readLoop analog) ---
    def _produce(self, source, gen: int):
        from cubicsdr_tpu_torch.io.soapy import DeviceLostError
        try:
            for blk in source:
                if self._stop.is_set() or gen != self._producer_gen:
                    break
                blk = np.asarray(blk)
                if blk.ndim == 2 and blk.shape[0] == 2:
                    re, im = blk[0], blk[1]      # planar source (soapy)
                else:
                    re, im = blk.real, blk.imag
                n = re.shape[-1]
                dt = self.ingest_dtype
                if dt != np.float32 and re.dtype != dt:
                    if re.dtype.kind == "i":
                        # Raw->raw width change (cs8 source, cs16 ring):
                        # rescale between integer full scales.
                        k = float(np.iinfo(dt).max + 1) \
                            / float(np.iinfo(re.dtype).max + 1)
                    else:
                        # Float source into a raw-format ring: quantize at
                        # the inverse of the device-side scale.
                        k = 1.0 / self.ingest_scale
                    re = np.clip(np.asarray(re, np.float32) * k,
                                 np.iinfo(dt).min, np.iinfo(dt).max)
                    im = np.clip(np.asarray(im, np.float32) * k,
                                 np.iinfo(dt).min, np.iinfo(dt).max)
                elif dt == np.float32 and re.dtype.kind == "i":
                    # Raw-format source into an f32 ring: normalize to ±1.
                    k = 1.0 / float(np.iinfo(re.dtype).max + 1)
                    re = np.asarray(re, np.float32) * k
                    im = np.asarray(im, np.float32) * k
                ok = self.ring.write(np.ascontiguousarray(re, dt),
                                     np.ascontiguousarray(im, dt))
                self.metrics.tick("ingest", n, dropped=0 if ok else n)
                ov = getattr(source, "overflow_events", 0)
                if ov:
                    self.metrics.note("source_overflow_events", ov)
                sb = getattr(source, "short_blocks", 0)
                if sb:
                    self.metrics.note("source_short_blocks", sb)
        except DeviceLostError as e:
            # Device vanished: stop producing, surface to the app loop
            # (ref: SoapySDRThread.cpp:405-433).
            self.source_error = e

    def start_producer(self):
        self._producer = threading.Thread(
            target=self._produce, args=(self.source, self._producer_gen),
            daemon=True)
        self._producer.start()

    def stop_producer(self, timeout: float = 2.0):
        """Retire the current producer thread without stopping the app."""
        self._producer_gen += 1
        if hasattr(self.source, "stop"):
            try:
                self.source.stop()           # unblock a waiting read
            except Exception:                # noqa: BLE001
                pass
        if self._producer is not None:
            self._producer.join(timeout=timeout)
            self._producer = None

    def set_source(self, source, close_old: bool = True):
        """Swap the live source between blocks (ref: src/CubicSDR.cpp:
        797-855)."""
        was_running = self._producer is not None
        self.stop_producer()
        old = self.source
        if close_old and old is not None and old is not source:
            try:
                getattr(old, "close", lambda: None)()
            except Exception:                # noqa: BLE001
                pass
        self.source = source
        self.source_error = None
        if was_running:
            self.start_producer()

    def _check_ingest(self, pipeline):
        if self.ingest_dtype != np.float32 and pipeline.dtype != PLANAR:
            raise ValueError("raw-format (cs16/cs8) ingest needs a planar "
                             "pipeline (dtype=PLANAR)")

    def _spec_cls(self):
        return PlanarSpectrumProcessor if self.planar else SpectrumProcessor

    def _spec_core(self):
        """The spectrum's EMA core (the planar processor wraps one)."""
        return (self.spec.core
                if isinstance(self.spec, PlanarSpectrumProcessor)
                else self.spec)

    def _make_step(self, pipeline):
        """The per-block step. The ring's float32 planes are assembled in
        the pipeline's representation here, inside the step built for
        that pipeline: a block staged before a planar<->complex swap
        therefore reaches the new step in the new representation. For
        raw-format ingest (planar pipelines) the wire planes convert to
        float32 on the device and the converted block replaces the
        passthrough tap, so the visual chain sees float32."""
        if self.ingest_dtype == np.float32:
            if pipeline.dtype != PLANAR:
                def step_complex(state, inputs):
                    (re, im), controls = inputs
                    return pipeline.apply(
                        state, (torch.complex(re, im), controls))
                return step_complex

            def step(state, inputs):
                (re, im), controls = inputs
                return pipeline.apply(state, (PC(re, im), controls))
            return step
        scale = self.ingest_scale

        def step_raw(state, inputs):
            (re_raw, im_raw), controls = inputs
            iq = PC(re_raw.to(torch.float32) * scale,
                    im_raw.to(torch.float32) * scale)
            state, out = pipeline.apply(state, (iq, controls))
            return state, dict(out, iq=iq)
        return step_raw

    def _device_controls(self):
        """(host snapshot, the same controls as tensors on the device).
        Uploaded only when a value changed — an upload from pageable
        memory synchronises the stream — and compared by value, so
        controls edited in place take effect at the next block."""
        snap = [{k: np.array(v) for k, v in c.items()}
                for c in self.controls]
        hit = self._ctl_cache
        if hit is None or len(hit[0]) != len(snap) or any(
                a.keys() != b.keys()
                or any(not np.array_equal(a[k], b[k]) for k in a)
                for a, b in zip(hit[0], snap)):
            dev = [{k: torch.as_tensor(v, device=self.device)
                    for k, v in c.items()} for c in snap]
            self._ctl_cache = hit = (snap, dev)
        return hit

    def snapshot_state(self) -> object:
        """Host (numpy) copy of the streaming state, safe to read from any
        thread: taken under the step lock, in stream order behind the
        step that produced it. Checkpointing and plan-rebuild carry go
        through this."""
        with self.step_lock:
            return tree_map(lambda t: t.detach().cpu().numpy(), self.state)

    def swap_pipeline(self, pipeline, controls, state=None,
                      row_keys=None):
        """Install a new plan. When the wideband format changed (sample
        rate / block size / audio rate) the ring and visual chain are
        rebuilt and the ring generation moves on, so a block staged from
        the old ring is dropped; otherwise display continuity is
        preserved. ``state`` may hold numpy leaves (a snapshot).
        ``row_keys`` installs the new rows' stable identities atomically
        with the plan."""
        if pipeline.device != self.device:
            raise ValueError(f"pipeline is on {pipeline.device}, the "
                             f"receiver on {self.device}")
        self._check_ingest(pipeline)
        format_changed = (
            pipeline.sample_rate != self.pipeline.sample_rate
            or pipeline.block_len != self.pipeline.block_len
            or pipeline.audio_rate != self.pipeline.audio_rate)
        state = (pipeline.init_state() if state is None else tree_map(
            lambda a: torch.as_tensor(a, device=self.device), state))
        with self.step_lock:        # never mid-dispatch on the consumer
            self.pipeline = pipeline
            self.controls = controls
            self.step = self._make_step(pipeline)
            self.state = state
            if row_keys is not None:
                self.row_keys = list(row_keys)
            planar = pipeline.dtype == PLANAR
            repr_changed = planar != self.planar
            self.planar = planar
            # Flat indices (and group tap shapes) change with the plan:
            # drop the demod view atomically with the swap.
            self._set_demod_view_locked(None)
            if repr_changed and not format_changed:
                self._follow_repr_locked()
            if not format_changed:
                return
            # Format change: ring, visual chain and post-step are used
            # inside the consumer's locked dispatch, so they are replaced
            # under the same lock.
            self._ingest = (self._ingest[0] + 1, self._new_ring(pipeline),
                            pipeline.block_len)
            self.dist = FFTDataDistributor(
                self.spec.fft_size * 2, pipeline.sample_rate,
                lines_per_second=self.dist.lps,
                block_len=pipeline.block_len,
                dtype=pipeline.dtype).to(self.device)
            if repr_changed:
                self._respec()
            self._st_dist = self.dist.init_state()
            self._st_spec = self.spec.init_state()
            self._install_post()
            self.zoom = self._zoom_stash = None   # view rates changed

    def _follow_repr_locked(self):
        """The visual chain after a planar<->complex swap at an unchanged
        format: distributor and spectrum (and an open zoom view) rebuilt in
        the new representation, their display state carried (the same
        shapes: the history converts between representations), so the
        waterfall and the zoom view keep their continuity."""
        hist, pos = self._st_dist
        hist = as_pc(hist) if self.planar else to_complex(hist)
        self.dist = FFTDataDistributor(
            self.dist.fft_size, self.pipeline.sample_rate,
            lines_per_second=self.dist.lps,
            block_len=self.pipeline.block_len,
            dtype=self.pipeline.dtype).to(self.device)
        self._st_dist = (hist, pos)
        self._respec()
        self._zoom_stash = None
        if self.zoom is not None:
            old = self.zoom
            z = self._new_zoom()
            z.set_view(old.view_offset, old.view_bandwidth)
            z.st_core = old.st_core
            self.zoom = z
        self._install_post()

    def _respec(self):
        """The spectrum processor of the current representation, with the
        same size and display settings (its state's shapes are the
        same)."""
        core = self._spec_core()
        self.spec = self._spec_cls()(
            self.spec.fft_size, core.rate,
            peak_hold=core.peak_hold).to(self.device)

    def _new_zoom(self):
        from cubicsdr_tpu_torch.visual.spectrum import ZoomSpectrumView
        return ZoomSpectrumView(
            self.pipeline.sample_rate, self.pipeline.block_len,
            fft_size=self.spec.fft_size, device=self.device,
            dtype=self.pipeline.dtype)

    # --- consumer: ring -> step -> sinks ---
    def _h2d(self, re: np.ndarray, im: np.ndarray):
        """Copy ring planes through a persistent pinned slot to the
        device on the staging stream; returns (device [2, n], event)."""
        n = re.shape[0]
        if (not self._slots or self._slots[0].shape[1] != n
                or self._slots[0].numpy().dtype != re.dtype):
            self._slots = [torch.from_numpy(np.empty((2, n), re.dtype))
                           .pin_memory() for _ in range(N_SLOTS)]
            self._slot_events = [None] * N_SLOTS
            self._slot_next = 0
        if self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        i = self._slot_next
        self._slot_next = (i + 1) % N_SLOTS
        if self._slot_events[i] is not None:
            self._slot_events[i].synchronize()   # its last copy is done
        slot = self._slots[i]
        host = slot.numpy()
        host[0] = re
        host[1] = im
        with torch.cuda.stream(self._h2d_stream):
            dev = slot.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._h2d_stream)
        self._slot_events[i] = ev
        return dev, ev

    def _stage_block(self):
        """Read one block from the ring and start its host->device copy.
        Runs on the staging worker, so the copy of block i+1 overlaps
        block i's dispatch and block i-1's packed pull."""
        gen, ring, L = self._ingest
        got = ring.read(L)
        if got is None:
            return None
        re, im = got
        if self._cuda:
            dev, ev = self._h2d(re, im)
            iq = (dev[0], dev[1])
        else:
            iq, ev = (torch.from_numpy(re), torch.from_numpy(im)), None
        return _Staged(iq, (re, im), L, gen, ev)

    def run_blocks(self, max_blocks: Optional[int] = None,
                   wait: bool = True) -> int:
        """Consume ring blocks through the step with ONE block of
        lookahead: block i+1's host->device copy is staged on the worker
        as soon as block i is in hand, so it overlaps block i's dispatch
        (eager dispatch is host work here, not an async enqueue); block
        i's step and post-step are enqueued, then block i-1's host fan-out
        (its packed pull, waterfall lines, audio sinks, recorders) runs
        while the device computes block i (ref: src/sdr/
        SDRPostThread.cpp:152-199)."""
        pool = self._stage_pool
        if pool is None:
            pool = self._stage_pool = _Stager()
        if self._staged is not None and self._staged.pool is not pool:
            self._staged = None          # a retired pool's box
        n = 0
        pending = None                  # (disp, iq, out, planes)
        while not self._stop.is_set():
            if max_blocks is not None and n >= max_blocks:
                break
            if self._staged is None:
                self._staged = pool.submit(self._stage_block)
            blk = self._staged.result()
            # The box persists on self, so a bounded run_blocks call hands
            # its lookahead block to the next call.
            self._staged = (pool.submit(self._stage_block)
                            if blk is not None else None)
            dispatched = None
            if blk is not None:
                with self.step_lock:
                    # Checked UNDER the lock: a format swap may land
                    # between staging and here. The generation catches a
                    # swap that keeps block_len (rate-only change).
                    if (blk.gen != self._ingest[0]
                            or blk.n != self.pipeline.block_len):
                        self.metrics.tick("pipeline", 0, dropped=blk.n)
                        blk = None
                    else:
                        iq = blk.iq
                        if blk.ready is not None:
                            cur = torch.cuda.current_stream(self.device)
                            cur.wait_event(blk.ready)
                            iq[0].record_stream(cur)
                        snap, ctl_dev = self._device_controls()
                        self.state, out = self.step(self.state,
                                                    (iq, ctl_dev))
                        disp = self._fanout_dispatch(out, snap)
                if blk is not None:
                    self.metrics.tick("pipeline", blk.n)
                    n += 1
                    dispatched = (disp, iq, out, blk.planes)
            if dispatched is None:
                if pending is not None:     # starved: drain the lookahead
                    self._fanout_finish(*pending)
                    pending = None
                if not wait or (self._producer is not None
                                and not self._producer.is_alive()):
                    # A block may still be in flight on the worker, or a
                    # stage that raced the producer's final writes may
                    # have returned empty while blocks remain.
                    if (self._staged is not None
                            or self.ring.fill >= self.pipeline.block_len):
                        continue
                    break
                self._stop.wait(0.001)
                continue
            if pending is not None:
                self._fanout_finish(*pending)   # overlaps n's compute
            pending = dispatched
        if pending is not None:
            self._fanout_finish(*pending)
        return n

    def set_zoom(self, offset: Optional[float], bandwidth: float = 0.0):
        """Point the zoomed spectrum view at ``offset`` Hz (relative to the
        device center) with ``bandwidth`` Hz span; None disables. View
        moves preserve the smoothed display (pan/rescale, not reset)."""
        if offset is None:
            with self.step_lock:
                if self.zoom is not None:
                    self._zoom_stash = self.zoom
                self.zoom = None
            return
        if bandwidth and not (float(bandwidth) > 0.0):
            raise ValueError(f"zoom bandwidth must be > 0, got {bandwidth}")
        z = self.zoom
        if z is None and self._zoom_stash is not None \
                and self._zoom_stash.input_rate == self.pipeline.sample_rate \
                and self._zoom_stash.block_len == self.pipeline.block_len \
                and self._zoom_stash.fft_size == self.spec.fft_size \
                and self._zoom_stash.dtype == self.pipeline.dtype:
            z = self._zoom_stash
        if z is None:
            z = self._new_zoom()
        # Build the target level before attaching it: the consumer feeds
        # the view inside its locked dispatch.
        z.prewarm_level(float(bandwidth) or z.view_bandwidth)
        with self.step_lock:
            if self.zoom is None:
                self.zoom = z
            z = self.zoom
            prev_bw = z.resample_bw
            z.set_view(float(offset),
                       float(bandwidth) or z.view_bandwidth)
        if z.resample_bw != prev_bw:
            z.prewarm_adjacent()        # the levels one zoom step away

    def set_display(self, lps=None, fft_average_rate=None, peak_hold=None,
                    demod_view_fft=None):
        """Runtime display parameters (ref: src/AppFrame.cpp:2320-2352):
        rebuilds only the affected visual stages, carrying the smoothed
        display state so the waterfall never blanks. Swapped under the
        step lock, so the consumer never sees a half-replaced chain."""
        with self.step_lock:
            rebuild = False
            if lps is not None and float(lps) != self.dist.lps:
                self.dist = FFTDataDistributor(
                    self.spec.fft_size * 2, self.pipeline.sample_rate,
                    lines_per_second=float(lps),
                    block_len=self.pipeline.block_len,
                    dtype=self.pipeline.dtype).to(self.device)
                # Same state shapes (history + pacer phase): continuity.
                rebuild = True
            core = self._spec_core()
            if ((fft_average_rate is not None
                 and float(fft_average_rate) != core.rate)
                    or (peak_hold is not None
                        and bool(peak_hold) != core.peak_hold)):
                self.spec = self._spec_cls()(
                    self.spec.fft_size,
                    float(fft_average_rate) if fft_average_rate is not None
                    else core.rate,
                    peak_hold=bool(peak_hold) if peak_hold is not None
                    else core.peak_hold).to(self.device)
                rebuild = True
            if demod_view_fft is not None \
                    and int(demod_view_fft) != self.demod_view_fft:
                self.demod_view_fft = int(demod_view_fft)
                self.demod_spectrum = None
                if self._dv_gi is not None:
                    # Rebuild the demod view at the new FFT size.
                    idx = self.demod_view
                    self.demod_view = None
                    self._set_demod_view_locked(idx)
            if rebuild:
                self._install_post()

    def display_params(self) -> dict:
        core = self._spec_core()
        return {"lps": self.dist.lps, "fft_average_rate": core.rate,
                "peak_hold": bool(core.peak_hold),
                "fft_size": self.spec.fft_size,
                "demod_view_fft": self.demod_view_fft}

    @property
    def audio_output(self):
        """The 'default' sink's output (legacy single-output surface)."""
        s = self.audio_sinks.get("default")
        return s["output"] if s else None

    def set_audio_output(self, backend, device=None, rate=None):
        """Attach/replace/detach the default host playback sink."""
        self.set_audio_sink("default", backend, device, rate=rate)

    def set_audio_sink(self, name: str, backend=None, device=None,
                       demods: Optional[list] = None,
                       rate: Optional[int] = None):
        """Configure one of N named host output sinks (ref: src/audio/
        AudioThread.cpp:370-442). ``demods`` = stable row keys mixed
        host-side for this sink; None = the device-mixed full mix.
        backend None removes. ``rate``: the sink's own sample rate,
        resampled host-side from the pipeline rate (ref: src/audio/
        AudioThread.cpp:493-506)."""
        from cubicsdr_tpu_torch.io.audio_out import AudioOutput, HostResampler
        old = self.audio_sinks.pop(name, None)
        if old is not None:
            old["output"].close()
        if backend is None:
            return
        pipe_rate = int(self.pipeline.audio_rate)
        rate = int(rate) if rate else pipe_rate
        if not isinstance(backend, AudioOutput):
            backend = AudioOutput(rate, 2, backend=str(backend),
                                  device=device)
        self.audio_sinks[name] = {
            "output": backend,
            "resampler": (None if rate == pipe_rate
                          else HostResampler(pipe_rate, rate)),
            "demods": None if demods is None else list(demods)}

    def set_audio_solo(self, key):
        """Route ONE demod (stable row key) to the default sink instead of
        the mix; None restores the mix."""
        self.audio_solo = key

    def _subset_mix(self, hgroups, demods, keys, ctls
                    ) -> Optional[np.ndarray]:
        """Host-side mix of a demod subset for one sink: gain-weighted
        active rows summed, peak-normalized above 1.0 (ref: src/audio/
        AudioThread.cpp:174-240). ``keys``/``ctls`` are the dispatch-time
        row identities and (gain, active) snapshots of this block."""
        sel = set(demods)
        acc, off = None, 0
        for gi, h in enumerate(hgroups):
            rows = h["level"].shape[0]
            if "audio" not in h:
                off += rows
                continue
            gain, active = ctls[gi]
            for pos, ri in enumerate(h["audio_rows"]):
                if keys[off + ri] in sel and bool(active[ri]):
                    a = h["audio"][pos] * float(gain[ri])
                    if a.shape[0] == 1:
                        a = np.concatenate([a, a])
                    acc = a.copy() if acc is None else acc + a
            off += rows
        if acc is None:
            return None
        peak = float(np.abs(acc).max())
        if peak > 1.0:
            acc = acc / peak
        return acc

    def _solo_audio(self, hgroups, keys) -> Optional[np.ndarray]:
        """One demod's audio from the packed host groups (no extra pull),
        located by its stable row key."""
        solo, off = self.audio_solo, 0
        for h in hgroups:
            rows = h["level"].shape[0]
            for ri in range(rows):
                if keys[off + ri] == solo:
                    if "audio" not in h or ri not in h["audio_rows"]:
                        return None          # digital / not packed
                    a = h["audio"][h["audio_rows"].index(ri)]
                    return (np.concatenate([a, a]) if a.shape[0] == 1
                            else a)
            off += rows
        return None

    def set_demod_view(self, idx: Optional[int]):
        """Select which demod's IQ tap feeds the demod-view spectrum
        (flat group-order index; None disables)."""
        with self.step_lock:
            self._set_demod_view_locked(idx)

    def _set_demod_view_locked(self, idx: Optional[int]):
        if idx == self.demod_view and (idx is None
                                       or self._dv_gi is not None):
            return
        self.demod_view = idx
        self.demod_spectrum = None
        self._dv_gi, self._dv_off = None, 0
        if idx is not None:
            off = 0
            for gi, g in enumerate(self.pipeline.groups):
                if idx < off + g.count:
                    self._dv_gi, self._dv_off = gi, off
                    break
                off += g.count
        self._install_post()

    def _install_post(self):
        """(Re)build the packed post-step for the current (pipeline,
        visual chain, demod view). Eager torch compiles nothing, so the
        JAX package's program caches have no counterpart here."""
        if self._dv_gi is not None:
            # Re-block the selected row's bandwidth-rate tap to the view
            # FFT size (ref: src/CubicSDR.cpp:340,374). Fresh distributor:
            # its block_len latches to the tap length at first use.
            rate = float(self.pipeline.frontends[self._dv_gi].bandwidth)
            self._dv_dist = FFTDataDistributor(
                self.demod_view_fft * 2, rate,
                lines_per_second=self.dist.lps,
                dtype=self.pipeline.dtype).to(self.device)
            self._dv_spec = self._spec_cls()(
                self.demod_view_fft).to(self.device)
            self._st_dv = (self._dv_dist.init_state(),
                           self._dv_spec.init_state())
        else:
            self._dv_dist = self._dv_spec = None
            self._st_dv = ()
        self._post = self._make_post()

    def _make_post(self):
        """The post-step: the visual chain (distributor re-block +
        spectrum EMA) fused with output packing — every host-needed output
        of a block (display points, line count, mix audio, per-demod
        levels, squelch flags, digital symbols, selected per-demod audio,
        demod-view and zoom points) leaves the device as ONE packed float32
        vector (symbols are small integers, exact in float32), one
        device->host copy per block. Binds the visual-chain objects at
        creation, so a later swap never changes an installed post-step."""
        dist, spec = self.dist, self.spec
        dv_dist, dv_spec = self._dv_dist, self._dv_spec
        f32 = torch.float32

        def _post(sts, x, mix, g_parts, dv_tap, dv_row, extra):
            st_dist, st_spec, st_dv = sts
            st_dist, (frames, valid) = dist.apply(st_dist, x)
            st_spec, disp = spec.apply(st_spec, frames, valid=valid)
            parts = [disp["spectrum_points"].reshape(-1),
                     valid.sum().to(f32).reshape(1)]
            if mix is not None:
                parts.append(mix.reshape(-1))
            for gp in g_parts:
                parts.append(gp["level"].reshape(-1))
                for k in ("squelched", "symbols", "audio"):
                    if gp[k] is not None:
                        parts.append(gp[k].to(f32).reshape(-1))
            if dv_tap is not None:
                # The selected row of its group's bandwidth-rate tap,
                # re-blocked and EMA'd like the main spectrum.
                st_dvd, st_dvs = st_dv
                tap = (PC(dv_tap.re[dv_row], dv_tap.im[dv_row])
                       if isinstance(dv_tap, PC) else dv_tap[dv_row])
                st_dvd, (dfr, dval) = dv_dist.apply(st_dvd, tap)
                st_dvs, ddisp = dv_spec.apply(st_dvs, dfr, valid=dval)
                parts.append(ddisp["spectrum_points"].reshape(-1))
                st_dv = (st_dvd, st_dvs)
            return (st_dist, st_spec, st_dv), torch.cat(parts + extra)

        return _post

    def row_key(self, fi: int):
        """Stable identity of flat row ``fi`` (instance id when the
        control plane registered row_keys, else the index itself)."""
        return (self.row_keys[fi]
                if self.row_keys is not None and fi < len(self.row_keys)
                else fi)

    def recording_enabled(self, key) -> bool:
        """Is the row with stable key ``key`` recording right now?"""
        return bool(self.record_path) and self.rec_override.get(
            key, self.record_all)

    def any_recording(self) -> bool:
        return bool(self.record_path) and (
            self.record_all or any(self.rec_override.values()))

    def set_recording(self, key: int, on: bool,
                      path: Optional[str] = None):
        """Attach/detach ONE demod's recording sink at runtime (the 'R'
        hotkey, ref: src/demod/DemodulatorInstance.cpp:600-655). Stopping
        closes + finalizes the WAV."""
        if path:
            self.record_path = path
        if on and not self.record_path:
            raise ValueError("no recording path set")
        self.rec_override[key] = bool(on)
        if not on:
            r = self._recorders.pop(key, None)
            if r is not None:
                r.close()

    def set_record_options(self, squelch=None, time_limit=None,
                           path: Optional[str] = None):
        """Runtime recording options (ref: src/audio/
        AudioSinkFileThread.cpp:28-73), applied to sinks created
        afterwards."""
        sq, tl = self._rec_opts
        if squelch is not None:
            sq = SquelchOption(squelch)
        if time_limit is not None:
            tl = float(time_limit)
        self._rec_opts = (sq, tl)
        if path:
            self.record_path = path

    def _rows_index(self, rows: tuple) -> torch.Tensor:
        """Device index tensor of packed audio rows, built once per row
        set (a host index would upload on every block)."""
        idx = self._rows_idx.get(rows)
        if idx is None:
            if len(self._rows_idx) >= 64:
                self._rows_idx.clear()
            idx = self._rows_idx[rows] = torch.tensor(
                rows, dtype=torch.int64, device=self.device)
        return idx

    def _pack_parts(self, out):
        """(mix, g_parts) for the packed post-step. Per-demod audio is
        packed for ONLY the rows the host needs (active recorders,
        subset-sink members, the solo target); a digital group packs its
        symbols instead, and never audio or squelch flags."""
        rec = self.any_recording()
        sink_keys = set()
        for s in self.audio_sinks.values():
            if s["demods"] is not None:
                sink_keys.update(s["demods"])
        if self.audio_solo is not None and "default" in self.audio_sinks:
            sink_keys.add(self.audio_solo)
        g_parts = []
        off = 0
        for g in out["groups"]:
            n = g["level"].shape[0]
            has_audio = "audio" in g
            rows = []
            if has_audio and (rec or sink_keys):
                for ri in range(n):
                    key = self.row_key(off + ri)
                    if ((rec and self.recording_enabled(key))
                            or key in sink_keys):
                        rows.append(ri)
            g_parts.append({
                "level": g["level"],
                "squelched": g["squelched"] if rec and has_audio else None,
                "symbols": g.get("symbols"),
                "audio": (g["audio"].index_select(
                    0, self._rows_index(tuple(rows))) if rows else None),
                "audio_rows": tuple(rows),
            })
            off += n
        return out["mix"], g_parts

    def _pull(self, packed: torch.Tensor):
        """Start THE device->host copy of a block: into one of
        ``N_SLOTS`` persistent pinned buffers without blocking, with an
        event the finish synchronises on. Block i's buffer was last used
        by block i - N_SLOTS, whose finish ran before block i-1's
        dispatch; a buffer only grows, after its last copy is done."""
        if not self._cuda:
            return packed, None
        i = self._pull_next
        self._pull_next = (i + 1) % N_SLOTS
        if self._pull_events[i] is not None:
            self._pull_events[i].synchronize()
        buf, n = self._pull_slots[i], packed.numel()
        if buf is None or buf.numel() < n or buf.dtype != packed.dtype:
            buf = self._pull_slots[i] = torch.empty(
                n, dtype=packed.dtype, pin_memory=True)
        host = buf[:n]
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._pull_events[i] = ev
        return host, ev

    def _fanout_dispatch(self, out, ctl_snap):
        """Enqueue the packed post-step right behind its own block's step
        and start its pull. Returns what ``_fanout_finish`` needs."""
        mix_dev, g_parts = self._pack_parts(out)
        dv_tap = dv_row = None
        dv_n = 0
        if self._dv_gi is not None and self._dv_gi < len(out["groups"]):
            dv_tap = out["groups"][self._dv_gi]["iq"]
            dv_row = self.demod_view - self._dv_off
            dv_n = self.demod_view_fft
        # Zoomed view fed from the device-resident block; its points and
        # line count ride the same packed pull.
        extra, zoom_h = [], None
        # Its device errors propagate like the step's: the JAX package
        # notes them as advisory, which would hide a CUDA fault here.
        if self.zoom is not None:
            h = self.zoom.feed_device(out["iq"])
            if h is not None:
                pts, nv = h
                extra = [pts.reshape(-1), nv.to(torch.float32).reshape(1)]
                # Pin the VIEW OBJECT: a zoom-off before the deferred
                # finish must not leave it dereferencing None.
                zoom_h = (self.zoom, pts.numel())
        # The visual chain taps out["iq"] — the (converted float32)
        # full-band block the step saw.
        (self._st_dist, self._st_spec, self._st_dv), packed = self._post(
            (self._st_dist, self._st_spec, self._st_dv),
            out["iq"], mix_dev, g_parts, dv_tap, dv_row, extra)
        # Snapshot what the deferred finish needs AT DISPATCH (under the
        # step lock): split geometry, this block's row identities and the
        # per-row (gain, active) controls, host numpy only.
        n_rows = sum(gp["level"].shape[0] for gp in g_parts)
        keys = [self.row_key(i) for i in range(n_rows)]
        ctls = [(np.asarray(c["gain"], np.float32),
                 np.asarray(c["active"], bool)) for c in ctl_snap]
        return (self._pull(packed), mix_dev, g_parts, self.spec.fft_size,
                keys, ctls, dv_n, zoom_h)

    def _fanout_finish(self, disp, iq, out, planes=None):
        pull, mix_dev, g_parts, P, keys, ctls, dv_n, zoom_h = disp
        host, ev = pull
        if ev is not None:
            ev.synchronize()                 # the ONE device->host pull
            # Views of the block escape (audio tap, sinks, on_block), and
            # the pinned buffer is reused N_SLOTS blocks on.
            host = host.numpy().copy()
        else:
            host = host.numpy()
        pts = host[:P]
        nv = int(host[P])
        off = P + 1

        def take(shape):
            nonlocal off
            n = int(np.prod(shape))
            v = host[off:off + n].reshape(shape)
            off += n
            return v

        mix = take(mix_dev.shape) if mix_dev is not None else None
        hgroups = []
        for g, gp in zip(out["groups"], g_parts):
            h = {"level": take(gp["level"].shape)}
            if gp["squelched"] is not None:
                h["squelched"] = take(gp["squelched"].shape) > 0.5
            if gp["symbols"] is not None:
                h["symbols"] = take(gp["symbols"].shape).astype(np.int32)
            if gp["audio"] is not None:
                # Only the host-needed rows were packed; audio_rows maps
                # packed position -> group row index.
                h["audio"] = take(gp["audio"].shape)
                h["audio_rows"] = gp["audio_rows"]
            h["iq"] = g["iq"]         # device tap: pulled only on demand
            hgroups.append(h)

        if dv_n:
            self.demod_spectrum = take((dv_n,)).copy()

        if nv:
            self.waterfall.add_lines(np.tile(pts, (nv, 1)))
        # Read once: the finish runs outside the step lock, so a zoom-off
        # may set self.zoom to None between a check and a use.
        zoom = self.zoom
        if zoom_h is not None:
            z, n_pts = zoom_h
            zpts = take((n_pts,))
            if int(take((1,))[0]):
                z.points = zpts.copy()
        elif zoom is not None and planes is not None:
            # Chunk-misaligned view: fed from the host planes.
            p = np.stack(planes)
            if p.dtype != np.float32:
                p = p.astype(np.float32) * self.ingest_scale
            zoom.feed(p)
        if mix is not None:
            with self.audio_cond:
                self.audio_tap.append(mix)
                self._audio_seq += 1
                self.audio_cond.notify_all()
            for name, sink in list(self.audio_sinks.items()):
                if name == "default" and self.audio_solo is not None:
                    a = self._solo_audio(hgroups, keys)
                elif sink["demods"] is None:
                    a = mix
                else:
                    a = self._subset_mix(hgroups, sink["demods"],
                                         keys, ctls)
                if a is not None:
                    try:
                        rs = sink.get("resampler")
                        if rs is not None:
                            a = rs.process(a)
                        if a.shape[-1]:
                            sink["output"].write(a)
                    except Exception as e:       # noqa: BLE001 — device
                        self.metrics.note(f"audio_out_error_{name}",
                                          str(e))
        # Recording sinks per row, gated on the DISPATCH-time packing
        # (squelched present), not the current recording state. Digital
        # groups emit symbols, not audio: they are skipped but still
        # advance the flat index, and no recorder is opened for them.
        gi_off = 0
        for h in hgroups:
            rows = h["level"].shape[0]
            audio, squelched = h.get("audio"), h.get("squelched")
            if audio is None or squelched is None:
                gi_off += rows
                continue
            for pos, ri in enumerate(h["audio_rows"]):
                key = keys[gi_off + ri]
                if not self.recording_enabled(key):
                    continue
                if key not in self._recorders:
                    sq, tl = self._rec_opts
                    self._recorders[key] = RecordingSink(
                        f"{self.record_path}_demod{key}",
                        int(self.pipeline.audio_rate),
                        channels=audio.shape[1],
                        squelch_option=sq, time_limit_s=tl)
                self._recorders[key].write(audio[pos],
                                           bool(squelched[ri]))
            gi_off += rows
        if self.on_block is not None:
            self.on_block({"groups": hgroups, "mix": mix})

    def stop(self):
        self._stop.set()
        if hasattr(self.source, "stop"):
            try:
                # Unblock a producer stuck inside the source.
                self.source.stop()
            except Exception:                # noqa: BLE001
                pass
        if self._producer is not None:
            self._producer.join(timeout=2.0)
        if self._stage_pool is not None:
            self._stage_pool.shutdown()
            self._stage_pool = self._staged = None
        for r in self._recorders.values():
            r.close()
        for s in self.audio_sinks.values():
            s["output"].close()
        self.audio_sinks.clear()

    def status(self) -> str:
        return self.metrics.status_line()
