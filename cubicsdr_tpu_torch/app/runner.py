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

    ring (pinned, in frames of one block) --(consumer: one host->device
         copy out of the ring, own CUDA stream)--> device planes
         --> step --> packed post-step (waterfall re-block + spectrum EMA,
             levels, squelch flags, audio, demod view, zoom view)
         --> ONE device->host copy into pinned memory --> host fan-out

Threads and CUDA:

- the producer touches only numpy and the ring;
- one consumer, the thread that calls ``run_blocks``, stages, dispatches
  and fans out every block. On the card the ring's storage is one pinned
  tensor ``[frames, 2, L]`` from torch's pinned host allocator, in frames
  of one block, so a block is one contiguous ``[2, L]`` span. The
  consumer acquires the next block in place (``SampleRing.acquire``: no
  host copy) and enqueues its host->device copy, on a CUDA stream of its
  own, straight from the span into one of ``N_SLOTS`` persistent device
  buffers, recording an event; the span stays held (its samples fill the
  ring) until that event has completed, and is released by a later
  stage, the end of ``run_blocks`` or ``stop``. A device buffer is
  overwritten only after the consumer's stream has passed the block that
  last read it (an event recorded after that block's dispatch): staging
  allocates no memory per block. The loop reads only whole frames, so
  every block is handed out in place. On the CPU the ring is plain host
  memory and every block is read out (the step reads its inputs after
  staging, when a held frame could be overwritten);
- the consumer makes its stream wait on the copy's event before the
  step. It stages and dispatches block i, then finishes block i-1, whose
  packed pull synchronises on its own event first, while the device
  computes block i;
- control-plane threads (plan swaps, views, snapshots) take the step
  lock, which the consumer holds only for a block's dispatch.

The loop runs a pipeline of either representation: planar
(``dtype=PLANAR``) or complex64. The ring carries float32 planes for
both; the step assembles them in the pipeline's representation, so a
block staged before a planar<->complex swap reaches the new step in the
new representation, and the visual chain (distributor, spectrum, zoom and
demod views) follows the pipeline's. Raw cs16/cs8 ingest takes a planar
pipeline. There is no CPU fallback: a CUDA pipeline runs every stage on
the card; a CPU pipeline (the tests) runs the same code with plain host
tensors.

Compiled steps (``compiled=True``, the default; the JAX package's jitted,
donated step and post-step and their program caches). The step and the
packed post-step are ``utils/compiled.py`` ``CompiledStep``s: on the card
captured CUDA graphs over static buffers, both CUDA kernels inside the
step's graph; on the CPU the same objects run eagerly with the same
buffer rules. The step is cached per pipeline (weakly: a dropped plan
frees its graphs), and its entry owns the stream's state buffers: a swap
copies the carried state into them, so a returning plan replays its
graphs without a new capture. Its static control buffers take a control
edit at the next block. Post-steps are cached by value (the JAX key,
plus what the port fixes on the host per block: the packed audio rows,
squelch flags and symbols present, the demod-view group, the zoom extras'
size), at most ``POST_CACHE`` of them; the viewed row is a device index,
so a row change reuses the program. Each compiled step alternates two
captures with their own outputs, sharing the state buffers: block i-1's
outputs (the group iq taps ``on_block`` receives, the tap the demod view
and the zoom view read) stay valid while block i is dispatched and until
block i+1 is. Capture happens at the first block a step runs, under the
step lock, the other threads free to use the card. The zoom view's
levels are compiled steps too (``visual/spectrum.py``): ``set_zoom``
builds the target level on the caller's thread before the view switches
to it, and the levels one zoom step away on a background thread; the
view's points ride the packed post-step, which reads them before the
view's next replay. ``compiled=False`` runs the eager closures (and an
eager zoom view), asked for explicitly (an A/B switch), never as a
fallback.

Spans (``utils/metrics.py``; declared below, read by ``block_spans``):
each block's path is stamped into ``metrics.spans`` under its sequence
number, the order the consumer dispatches blocks in (``on_block``
receives it as ``seq``). The producer's ``ingest.write`` (value: the
samples written, negative where the ring shed them) and
``ingest.ready``, the accepted write that holds a block's last sample,
once per block made ready (value: the block's place, its ring
generation and its number there); the consumer's ``stage`` (on a
trace row of its own, ``staging``) from the ring holding the block (a
write in progress holds the ring's lock before that) to the
host->device copy's enqueue (value: the block's place), its
``step.dispatch``, ``post.dispatch``, ``pull.wait`` and ``fanout``
(child ``on_block``); in the compiled loop on the card
``device.step`` and ``device.post``, the device ns of the step's and the
post-step's graphs (the zoom view's not included), read after the pull,
and the step's layers, children of ``device.step``, one per
``device_mark`` of the pipeline (``DEVICE_LAYERS``): ``device.chan``
(wire conversion, channelizer, DC blocker), ``device.route`` (every
group's route, NCO and resampler stages) and ``device.kits`` (modem
kits, squelch gates, mix). The consumer counts ``starved_polls``, each
wait it enters on a ring that lacks the next block, and ``ring_wakes``,
each such wait that a write ended; ``metrics`` also
holds the plan's ``pfb.form`` (the PFB kernel's transform, an index of
``PFB_FORMS``; absent where no PFB kernel runs) and ``fanout.demods``
(the demods each block fans out), both set at each plan.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cubicsdr_tpu_torch.io.recorder import RecordingSink, SquelchOption
from cubicsdr_tpu_torch.native import SampleRing
from cubicsdr_tpu_torch.ops.kernels.pfb import PFB_FORMS
from cubicsdr_tpu_torch.ops.planar import PC, PLANAR, as_pc, to_complex
from cubicsdr_tpu_torch.utils.compiled import CompiledStep
from cubicsdr_tpu_torch.utils.metrics import (
    SPAN_BLOCKS, SPANS, Metrics, close_range, now, open_range)
from cubicsdr_tpu_torch.utils.tree import tree_map
from cubicsdr_tpu_torch.visual import (
    FFTDataDistributor, PlanarSpectrumProcessor, SpectrumProcessor,
    Waterfall)

# Device staging slots (and pinned pull buffers): block i is copied in
# while block i-1 computes and is pulled; a slot is reused only once the
# block that last read it is done, so the rest are room for blocks still
# queued on the device.
N_SLOTS = 4
# Compiled post-steps kept (the JAX package's limit); the cache empties
# when full.
POST_CACHE = 32
# Longest a starved consumer sleeps on the ring before it looks at the
# loop again (stop, a format swap, a producer that ended). A write or the
# ring's wake() ends the wait sooner, so this bounds only a wake that
# lands just before the wait begins.
WAIT_SLICE_S = 0.01


def _copy_controls(bufs: list, snap: list) -> None:
    """Write a control snapshot (numpy) into a compiled step's control
    buffers; a plan whose controls changed shape needs a new step."""
    if len(bufs) != len(snap) or any(a.keys() != b.keys()
                                     for a, b in zip(bufs, snap)):
        raise ValueError("the controls do not match the plan's groups")
    for b, c in zip(bufs, snap):
        for k, t in b.items():
            v = torch.as_tensor(c[k])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"control {k!r} has shape "
                                 f"{tuple(v.shape)}, the plan "
                                 f"{tuple(t.shape)}")
            t.copy_(v)


# The live loop's spans (module docstring): each thread's ring holds its
# spans of the last SPAN_BLOCKS blocks (up to four ring writes each).
for _thread, _per_block in (("producer", 5), ("staging", 1),
                            ("consumer", 5), ("device", 5)):
    SPANS.ring(_thread, _per_block * SPAN_BLOCKS)
_WRITE = SPANS.name("ingest.write", "producer")
_READY = SPANS.name("ingest.ready", "producer", "ingest.write")
_STAGE = SPANS.name("stage", "staging")
_STEP = SPANS.name("step.dispatch", "consumer")
_POST = SPANS.name("post.dispatch", "consumer")
_PULL = SPANS.name("pull.wait", "consumer")
_FANOUT = SPANS.name("fanout", "consumer")
_ON_BLOCK = SPANS.name("on_block", "consumer", "fanout")
_DEV_STEP = SPANS.name("device.step", "device")
_DEV_POST = SPANS.name("device.post", "device")
# The pipeline's ``device_mark`` names and the spans they end.
_LAYER_MARKS = {"chan": "device.chan", "route": "device.route",
                "kits": "device.kits"}
DEVICE_LAYERS = tuple(_LAYER_MARKS.values())
_DEV_LAYER = {m: SPANS.name(n, "device", "device.step")
              for m, n in _LAYER_MARKS.items()}
DEVICE_SPANS = ("device.step", "device.post") + DEVICE_LAYERS
BLOCK_SPANS = ("stage", "step.dispatch", "post.dispatch", "pull.wait",
               "fanout", "on_block")
_PLACE = 1 << 32            # a block's place: generation * _PLACE + number


def block_spans(log, first: int = 0, stop: Optional[int] = None) -> dict:
    """The blocks numbered ``first`` to ``stop`` - 1 that ``log`` (a
    ``LiveReceiver``'s ``metrics.spans``) still holds, by number:
    ``seq``; per span of ``BLOCK_SPANS`` (start, end) ns arrays (0:
    none); per span of ``DEVICE_SPANS`` its device ms (nan: none);
    ``ready``, the end of the ring write holding the block's last sample
    in ns (0: no longer held)."""
    b = log.by_seq(BLOCK_SPANS + DEVICE_SPANS, first, stop)
    out = {"seq": b["seq"]}
    for name in BLOCK_SPANS:
        out[name] = b[name][:2]
    for name in DEVICE_SPANS:
        a, e, _ = b[name]
        out[name] = np.where(e > 0, (e - a) / 1e6, np.nan)
    r = log.rows(("ingest.ready",))
    order = np.argsort(r["value"], kind="stable")
    places, ends = r["value"][order], r["end"][order]
    place = b["stage"][2]
    out["ready"] = np.zeros(len(place), np.int64)
    if len(places):
        j = np.minimum(np.searchsorted(places, place), len(places) - 1)
        out["ready"] = np.where(places[j] == place, ends[j], 0)
    return out


class _Staged(NamedTuple):
    """One ring block on its way to the device."""
    iq: tuple          # (re, im) on the device, ring dtype
    planes: tuple      # (re, im) host numpy copies from the ring, or None
    n: int             # samples
    gen: int           # ring/format generation it was read from
    ready: object      # CUDA event of its host->device copy, or None
    slot: int          # its staging slot (-1 on the CPU)
    place: int         # generation * _PLACE + its number there (from 1)
    spans: tuple       # stage (start, end)


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
                 ingest_dtype=None, ingest_scale: Optional[float] = None,
                 compiled: bool = True):
        self.pipeline = pipeline
        self.device = pipeline.device
        self._cuda = self.device.type == "cuda"
        self.controls = controls
        self._ctl_cache = None       # (snapshot, device controls, step)
        self.compiled = bool(compiled)
        # Compiled-step caches (the JAX package's): steps per pipeline,
        # weakly keyed, each entry owning its plan's state buffers;
        # post-steps by value. The build counters say how many were made.
        self._step_cache = weakref.WeakKeyDictionary()
        self._post_cache: dict = {}
        self._post_base = None
        self.step_builds = 0
        self.post_builds = 0
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
        self._install_step(pipeline, controls, None)
        self.metrics = Metrics()
        self._count_plan()
        self._ring_seconds = float(ring_seconds)
        # (generation, ring, block_len), replaced as one object by a format
        # swap: the consumer's stage, the producer and the control plane
        # read all three at once, and a staged block carries the generation
        # it was read under.
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
        self._dv_row = None                      # device index [1] in group
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
        self._dev_slots: list = []       # device staging slots [2, L]
        self._slot_free: list = []       # each slot's last read, consumer
        # Ring spans held for their copies: (ring, the copy's event),
        # oldest first, as the rings release them.
        self._held: collections.deque = collections.deque()
        self._held_mu = threading.Lock()
        self._slot_next = 0
        self._pull_slots: list = [None] * N_SLOTS   # pinned pull buffers
        self._pull_events: list = [None] * N_SLOTS
        self._pull_next = 0
        self._seq = 0                        # the next block's number
        self._accepted = (0, 0)              # (generation, samples) written
        self._read = (0, 0)                  # (generation, blocks) staged
        self._post_last = None               # the post-step last replayed
        self._h2d_stream = None
        self._producer: Optional[threading.Thread] = None
        self._producer_gen = 0               # bumped to retire a producer
        self.source_error: Optional[Exception] = None
        # Serializes step dispatch and state reassignment against
        # control-plane threads (plan swap, state snapshot, view changes).
        # Held only for the dispatch, never for host fan-out.
        self.step_lock = threading.Lock()

    def _new_ring(self, pipeline) -> SampleRing:
        """At least ``ring_seconds`` of samples and four blocks, rounded up
        to whole blocks, in frames of one block. On the card the storage
        is one pinned tensor ``[frames, 2, L]`` from torch's pinned host
        allocator, which holds a dropped ring's memory until the copies
        recorded on it are done."""
        L = pipeline.block_len
        cap = max(int(pipeline.sample_rate * self._ring_seconds), 4 * L)
        cap = -(-cap // L) * L
        storage = None
        if self._cuda:
            dt = torch.from_numpy(np.empty(0, self.ingest_dtype)).dtype
            storage = torch.empty((cap // L, 2, L), dtype=dt,
                                  pin_memory=True)
        return SampleRing(cap, self.ingest_dtype, frame=L, storage=storage)

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
                re = np.ascontiguousarray(re, dt)
                im = np.ascontiguousarray(im, dt)
                ring_gen, ring, L = self._ingest
                t0 = now()
                rng = open_range("ingest.write")
                ok = ring.write(re, im)
                close_range(rng)
                t1 = now()
                sp = self.metrics.spans
                sp.add(_WRITE, -1, t0, t1, n if ok else -n)
                g, before = self._accepted
                before = before if g == ring_gen else 0
                total = before + (n if ok else 0)
                self._accepted = (ring_gen, total)
                for k in range(before // L + 1, total // L + 1):
                    sp.add(_READY, -1, t0, t1, ring_gen * _PLACE + k)
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

    def _step_fn(self, pipeline):
        """The per-block step. The ring's float32 planes are assembled in
        the pipeline's representation here, inside the step built for
        that pipeline: a block staged before a planar<->complex swap
        therefore reaches the new step in the new representation. For
        raw-format ingest (planar pipelines) the wire planes convert to
        float32 on the device and the converted block replaces the
        passthrough tap, so the visual chain sees float32. The step holds
        its pipeline weakly, so that a cached step never keeps a dropped
        plan alive (the runner holds the current one)."""
        ref = weakref.ref(pipeline)
        if self.ingest_dtype == np.float32:
            if pipeline.dtype != PLANAR:
                def step_complex(state, inputs):
                    (re, im), controls = inputs
                    return ref().apply(
                        state, (torch.complex(re, im), controls))
                return step_complex

            def step(state, inputs):
                (re, im), controls = inputs
                return ref().apply(state, (PC(re, im), controls))
            return step
        scale = self.ingest_scale

        def step_raw(state, inputs):
            (re_raw, im_raw), controls = inputs
            iq = PC(re_raw.to(torch.float32) * scale,
                    im_raw.to(torch.float32) * scale)
            state, out = ref().apply(state, (iq, controls))
            return state, dict(out, iq=iq)
        return step_raw

    def _install_step(self, pipeline, controls, state):
        """Make ``pipeline``'s step current with ``state`` (tensors or
        numpy leaves; None: a fresh state). Compiled: the pipeline's
        cached ``CompiledStep`` (built here on its first use, with static
        buffers for the state, a block of the ring's format and the
        controls), the state copied into its buffers; the capture comes
        at its first block. Eager: the closure and the state as
        tensors."""
        if state is None:
            state = pipeline.init_state()
        if not self.compiled:
            self.step = self._step_fn(pipeline)
            self.state = tree_map(
                lambda a: torch.as_tensor(a, device=self.device), state)
            return
        entry = self._step_cache.get(pipeline)
        if entry is None:
            blk = np.zeros(pipeline.block_len, self.ingest_dtype)
            ctl = [{k: np.array(v) for k, v in c.items()}
                   for c in controls]
            entry = CompiledStep(self._step_fn(pipeline), self.device,
                                 marks=True)
            entry.prepare(state, ((blk, blk), ctl))
            self._step_cache[pipeline] = entry
            self.step_builds += 1
        else:
            entry.load_state(state)
        self.step = entry
        self.state = entry.state

    def _count_plan(self) -> None:
        """The current plan's counters ``pfb.form`` and
        ``fanout.demods``."""
        self.metrics.set("fanout.demods",
                         sum(g.count for g in self.pipeline.groups))
        form = self.pipeline.pfb_form
        if form is None:
            self.metrics.counters.pop("pfb.form", None)
        else:
            self.metrics.set("pfb.form", PFB_FORMS.index(form))

    def _device_controls(self):
        """(host snapshot, the same controls as tensors on the device).
        Written only when a value changed — an upload from pageable
        memory synchronises the stream — and compared by value, so
        controls edited in place take effect at the next block. Compiled,
        the step's static control buffers take the new values; eager,
        new tensors are made."""
        snap = [{k: np.array(v) for k, v in c.items()}
                for c in self.controls]
        hit = self._ctl_cache
        if hit is None or hit[2] is not self.step or len(hit[0]) != len(
                snap) or any(
                a.keys() != b.keys()
                or any(not np.array_equal(a[k], b[k]) for k in a)
                for a, b in zip(hit[0], snap)):
            if self.compiled:
                dev = self.step.inputs[1]
                _copy_controls(dev, snap)
            else:
                dev = [{k: torch.as_tensor(v, device=self.device)
                        for k, v in c.items()} for c in snap]
            self._ctl_cache = hit = (snap, dev, self.step)
        return hit[0], hit[1]

    def snapshot_state(self) -> object:
        """Host (numpy) copy of the streaming state, safe to read from any
        thread: taken under the step lock, in stream order behind the
        step that produced it. Checkpointing and plan-rebuild carry go
        through this."""
        with self.step_lock:
            return tree_map(lambda t: t.detach().cpu().numpy(), self.state)

    def post_state(self) -> tuple:
        """Host (numpy) copy of the post-step's state: the distributor's,
        the main spectrum's and the demod view's (empty while off), taken
        under the step lock, in stream order behind the post-step that
        produced it."""
        with self.step_lock:
            return tree_map(lambda t: t.detach().cpu().numpy(),
                            (self._st_dist, self._st_spec, self._st_dv))

    def set_state(self, state) -> None:
        """Install ``state`` (tensors or numpy leaves, the current plan's
        structure) as the stream's state under the step lock: copied into
        the compiled step's buffers, in stream order behind the blocks
        already dispatched (checkpoint restore goes through this)."""
        with self.step_lock:
            if self.compiled:
                self.step.load_state(state)
                self.state = self.step.state
            else:
                self.state = tree_map(
                    lambda a: torch.as_tensor(a, device=self.device), state)

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
        # A representation swap rebuilds an open zoom view in the new
        # representation: its level is built here, outside the step lock,
        # as set_zoom builds.
        zoom, fresh = self.zoom, None
        if (zoom is not None and not format_changed
                and (pipeline.dtype == PLANAR) != self.planar):
            fresh = self._new_zoom(pipeline.dtype)
            fresh.prewarm_level(zoom.view_bandwidth)
        with self.step_lock:        # never mid-dispatch on the consumer
            self._install_step(pipeline, controls, state)
            self.pipeline = pipeline
            self.controls = controls
            self._count_plan()
            if row_keys is not None:
                self.row_keys = list(row_keys)
            planar = pipeline.dtype == PLANAR
            repr_changed = planar != self.planar
            self.planar = planar
            # Flat indices (and group tap shapes) change with the plan:
            # drop the demod view atomically with the swap.
            self._set_demod_view_locked(None)
            if not format_changed:
                if repr_changed:
                    self._follow_repr_locked(fresh)
                else:
                    self._install_post()     # post-steps are per plan
                return
            # Format change: ring, visual chain and post-step are used
            # inside the consumer's locked dispatch, so they are replaced
            # under the same lock.
            old = self.ring
            self._ingest = (self._ingest[0] + 1, self._new_ring(pipeline),
                            pipeline.block_len)
            old.wake()          # a consumer waiting on it moves to the new one
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
            self._drop_zoom(self.zoom, self._zoom_stash)   # rates changed
            self.zoom = self._zoom_stash = None

    def _follow_repr_locked(self, fresh=None):
        """The visual chain after a planar<->complex swap at an unchanged
        format: distributor and spectrum (and an open zoom view) rebuilt in
        the new representation, their display state carried (the same
        shapes: the history converts between representations), so the
        waterfall and the zoom view keep their continuity. ``fresh`` is
        the new zoom view, its level built outside the lock."""
        hist, pos = self._st_dist
        hist = as_pc(hist) if self.planar else to_complex(hist)
        self.dist = FFTDataDistributor(
            self.dist.fft_size, self.pipeline.sample_rate,
            lines_per_second=self.dist.lps,
            block_len=self.pipeline.block_len,
            dtype=self.pipeline.dtype).to(self.device)
        self._st_dist = (hist, pos)
        self._respec()
        self._drop_zoom(self._zoom_stash)
        self._zoom_stash = None
        if self.zoom is not None:
            old = self.zoom
            z = fresh if fresh is not None else self._new_zoom()
            z.set_view(old.view_offset, old.view_bandwidth)
            z.load_display_state(old.st_core)
            self._drop_zoom(old)
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

    def _new_zoom(self, dtype=None):
        """A zoom view of the current format (in ``dtype``, default the
        pipeline's), compiled as the loop is; a failure of its
        background builds is noted in ``metrics``."""
        from cubicsdr_tpu_torch.visual.spectrum import ZoomSpectrumView
        z = ZoomSpectrumView(
            self.pipeline.sample_rate, self.pipeline.block_len,
            fft_size=self.spec.fft_size, device=self.device,
            dtype=self.pipeline.dtype if dtype is None else dtype,
            compiled=self.compiled)
        z.on_error = lambda bw, e: self.metrics.note(
            f"zoom_error_build_{bw:g}", repr(e))
        return z

    @staticmethod
    def _drop_zoom(*views):
        """Release dropped zoom views' levels (graphs, pools, buffers)."""
        for z in views:
            if z is not None:
                z.close()

    # --- consumer: ring -> step -> sinks ---
    def _h2d(self, src: torch.Tensor):
        """Enqueue one block's host->device copy from ``src`` (its pinned
        ring frame, [2, n]) into a persistent device slot on the staging
        stream; returns (device [2, n], its event, slot)."""
        if (not self._dev_slots or self._dev_slots[0].shape != src.shape
                or self._dev_slots[0].dtype != src.dtype):
            self._dev_slots = [torch.empty(src.shape, dtype=src.dtype,
                                           device=self.device)
                               for _ in range(N_SLOTS)]
            self._slot_free = [None] * N_SLOTS
            self._slot_next = 0
        if self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        i = self._slot_next
        self._slot_next = (i + 1) % N_SLOTS
        dev, free = self._dev_slots[i], self._slot_free[i]
        with torch.cuda.stream(self._h2d_stream):
            if free is not None:     # the consumer's last read is done
                self._h2d_stream.wait_event(free)
            dev.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._h2d_stream)
        return dev, ev, i

    def _release_spans(self, wait: bool = False):
        """Release the held ring spans whose copies are done, oldest
        first; ``wait``: every one, blocking on a copy in flight."""
        with self._held_mu:
            while self._held:
                ring, ev = self._held[0]
                if not ev.query():
                    if not wait:
                        return
                    ev.synchronize()
                ring.release()
                self._held.popleft()

    def _wait_block(self) -> bool:
        """Sleep on the ring until it holds a block (counted in
        ``starved_polls``; one a write ended, in ``ring_wakes``); False
        once the loop stops or its producer has ended. Each slice reads
        the ring anew, as a format swap replaces it."""
        self.metrics.count("starved_polls")
        while not self._stop.is_set():
            _, ring, L = self._ingest
            if ring.wait_readable(L, WAIT_SLICE_S):
                self.metrics.count("ring_wakes")
                return True
            producer = self._producer
            if producer is not None and not producer.is_alive():
                break
        return False

    def _stage_block(self):
        """Take one block from the ring and start its host->device copy;
        None while the ring lacks a block. On the card the block is copied
        straight out of its held ring frame; its host planes are copied
        out only for an open zoom view whose level's chunk is not the
        block (the others are fed on the device)."""
        gen, ring, L = self._ingest
        self._release_spans()
        if ring.readable < L:  # waits out a write that holds the ring
            return None
        t0 = now()
        rng = open_range("stage")
        if self._cuda:
            k = ring.acquire(L)
            if k is None:
                close_range(rng)
                raise RuntimeError(
                    f"no whole frame of {L} samples at the ring's read "
                    f"position ({ring.readable} readable)")
            src = ring.storage[k]
            z = self.zoom
            planes = (tuple(src.numpy().copy())
                      if z is not None and z.chunk != L else None)
            dev, ev, slot = self._h2d(src)
            with self._held_mu:
                self._held.append((ring, ev))
            iq = (dev[0], dev[1])
        else:
            planes = ring.read(L)
            if planes is None:
                close_range(rng)
                return None
            iq = (torch.from_numpy(planes[0]), torch.from_numpy(planes[1]))
            ev, slot = None, -1
        g, n = self._read
        n = (n if g == gen else 0) + 1
        self._read = (gen, n)
        close_range(rng)
        return _Staged(iq, planes, L, gen, ev, slot, gen * _PLACE + n,
                       (t0, now()))

    def run_blocks(self, max_blocks: Optional[int] = None,
                   wait: bool = True) -> int:
        """Consume ring blocks through the step, each on the calling
        thread: stage block i (its host->device copy enqueued on the
        staging stream), dispatch its step and post-step, then run block
        i-1's host fan-out (its packed pull, waterfall lines, audio sinks,
        recorders) while the device computes block i (ref: src/sdr/
        SDRPostThread.cpp:152-199).

        When the ring lacks the next block and ``wait`` is set (the loop
        is starved), the consumer finishes the block in hand, sleeps on
        the ring until the write that brings the block wakes it, and
        stages that block. The loop ends at ``stop()``, or once the
        producer has ended and the ring holds no whole block. Without
        ``wait`` it ends as soon as the ring lacks a block. A bounded
        call (``max_blocks``) takes from the ring only the blocks it
        runs."""
        n = 0
        pending = None                  # (disp, iq, out, planes, mark)
        while not self._stop.is_set():
            if max_blocks is not None and n >= max_blocks:
                break
            blk = self._stage_block()
            if blk is None and wait:
                # Starved: finish the block in hand, then sleep on the
                # ring; the write that brings the next block wakes this
                # thread, which stages it.
                if pending is not None:
                    self._fanout_finish(*pending)
                    pending = None
                if self._wait_block():
                    blk = self._stage_block()
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
                        t0 = now()
                        rng = open_range("step.dispatch")
                        iq = blk.iq
                        if blk.ready is not None:
                            cur = torch.cuda.current_stream(self.device)
                            cur.wait_event(blk.ready)
                        snap, ctl_dev = self._device_controls()
                        replay = open_range("step.replay")
                        self.state, out = self.step(self.state,
                                                    (iq, ctl_dev))
                        close_range(replay)
                        close_range(rng)
                        t1 = now()
                        rng = open_range("post.dispatch")
                        disp = self._fanout_dispatch(out, snap)
                        close_range(rng)
                        t2 = now()
                        timed = None
                        if self._cuda and self.compiled:
                            step = self._step_cache[self.pipeline]
                            post = self._post_last
                            timed = (step, step.last, post, post.last)
                        if blk.ready is not None:
                            # The staged buffer's last reader (the eager
                            # step, the post-step and the zoom view read
                            # the passthrough tap) is enqueued.
                            done = torch.cuda.Event()
                            done.record(cur)
                            self._slot_free[blk.slot] = done
                if blk is not None:
                    self.metrics.tick("pipeline", blk.n)
                    n += 1
                    seq = self._seq
                    self._seq = seq + 1
                    sp = self.metrics.spans
                    sp.add(_STAGE, seq, *blk.spans, blk.place)
                    sp.add(_STEP, seq, t0, t1)
                    sp.add(_POST, seq, t1, t2)
                    dispatched = (disp, iq, out, blk.planes,
                                  (sp, seq, timed))
            if dispatched is None:
                if pending is not None:
                    self._fanout_finish(*pending)
                    pending = None
                if not wait or (self._producer is not None
                                and not self._producer.is_alive()):
                    # A stage that raced the producer's final writes may
                    # have returned empty while blocks remain.
                    if self.ring.readable >= self.pipeline.block_len:
                        continue
                    break
                continue
            if pending is not None:
                self._fanout_finish(*pending)   # overlaps n's compute
            pending = dispatched
        if pending is not None:
            self._fanout_finish(*pending)
        self._release_spans()
        return n

    def set_zoom(self, offset: Optional[float], bandwidth: float = 0.0):
        """Point the zoomed spectrum view at ``offset`` Hz (relative to the
        device center) with ``bandwidth`` Hz span; None disables (the view
        is stashed with its built levels for the next zoom-on). View
        moves preserve the smoothed display (pan/rescale, not reset).
        The target level is built here, on the caller's thread, before
        it becomes current; a failure (one a background build kept for
        it included) raises and leaves the view as it was. A level
        change then builds the levels one zoom step away on a
        background thread."""
        if offset is None:
            with self.step_lock:
                if self.zoom is not None:
                    if self._zoom_stash is not self.zoom:
                        self._drop_zoom(self._zoom_stash)
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
            z.prewarm_adjacent()        # background: one zoom step away

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
        self._dv_gi, self._dv_off, self._dv_row = None, 0, None
        if idx is not None:
            off = 0
            for gi, g in enumerate(self.pipeline.groups):
                if idx < off + g.count:
                    self._dv_gi, self._dv_off = gi, off
                    # A device index: a row change within the group
                    # reuses the compiled post-step.
                    self._dv_row = torch.tensor(
                        [idx - off], dtype=torch.int64, device=self.device)
                    break
                off += g.count
        self._install_post()

    def _install_post(self):
        """Select the packed post-steps for the current (pipeline, visual
        chain, demod view), reusing those built before for the same
        values: the JAX package's value key (display toggles rebuild the
        distributor and spectrum objects with parameters seen before; a
        post-step binds its objects at creation, so these parameters
        determine it). The post-step of a block is then picked by what
        the host packs (``_post_for``). The demod-view state restarts."""
        dv_on = self._dv_gi is not None
        core = self._spec_core()
        key = (id(self.pipeline), self.spec.fft_size, core.rate,
               bool(core.peak_hold), self.dist.lps, self.dist.fft_size,
               self.dist.block_len, self.dist.sample_rate,
               self._dv_gi, self.demod_view_fft if dv_on else None)
        cache = self._post_cache
        for k in [k for k, e in cache.items() if e["pipeline"]() is None]:
            del cache[k]                 # a dropped plan's post-steps
        ent = cache.get(key)
        if ent is None or ent["pipeline"]() is not self.pipeline:
            dv = (None, None)
            if dv_on:
                # Re-block the selected row's bandwidth-rate tap to the
                # view FFT size (ref: src/CubicSDR.cpp:340,374). Fresh
                # distributor: its block_len latches to the tap length at
                # first use.
                rate = float(self.pipeline.frontends[self._dv_gi].bandwidth)
                dv = (FFTDataDistributor(
                    self.demod_view_fft * 2, rate,
                    lines_per_second=self.dist.lps,
                    dtype=self.pipeline.dtype).to(self.device),
                      self._spec_cls()(self.demod_view_fft).to(self.device))
            # The id in the key is only sound while that pipeline lives:
            # the entry holds it weakly and is dropped with it.
            ent = cache[key] = {"pipeline": weakref.ref(self.pipeline),
                                "dv": dv, "posts": {}}
        self._post_base = ent
        self._dv_dist, self._dv_spec = ent["dv"]
        self._st_dv = ((self._dv_dist.init_state(),
                        self._dv_spec.init_state()) if dv_on else ())

    def _post_for(self, layout):
        """The post-step for this block's ``layout`` (what the host packs:
        per group the audio rows, squelch flags and symbols present; the
        demod view on; the zoom extras' size), built at its first use.
        ``POST_CACHE`` of them are kept; the cache empties when full."""
        base = self._post_base
        post = base["posts"].get(layout)
        if post is None:
            cache = self._post_cache
            if sum(len(e["posts"]) for e in cache.values()) >= POST_CACHE:
                for k in [k for k, e in cache.items() if e is not base]:
                    del cache[k]
                base["posts"].clear()
            fn = self._make_post(layout)
            post = CompiledStep(fn, self.device) if self.compiled else fn
            base["posts"][layout] = post
            self.post_builds += 1
        return post

    def _make_post(self, layout):
        """The post-step: the visual chain (distributor re-block +
        spectrum EMA) fused with output packing — every host-needed output
        of a block (display points, line count, mix audio, per-demod
        levels, squelch flags, digital symbols, selected per-demod audio,
        demod-view and zoom points) leaves the device as ONE packed float32
        vector (symbols are small integers, exact in float32), one
        device->host copy per block. Binds the visual-chain objects and
        the audio rows' device indices at creation, so a later swap never
        changes it."""
        dist, spec = self.dist, self.spec
        dv_dist, dv_spec = self._dv_dist, self._dv_spec
        groups, _, _ = layout
        rows_idx = [self._rows_index(rows) if rows else None
                    for rows, _, _ in groups]
        f32 = torch.float32

        def _post(sts, inputs):
            x, mix, g_in, dv_tap, dv_row, extra = inputs
            st_dist, st_spec, st_dv = sts
            st_dist, (frames, valid) = dist.apply(st_dist, x)
            st_spec, disp = spec.apply(st_spec, frames, valid=valid)
            parts = [disp["spectrum_points"].reshape(-1),
                     valid.sum().to(f32).reshape(1)]
            if mix is not None:
                parts.append(mix.reshape(-1))
            for g, idx in zip(g_in, rows_idx):
                parts.append(g["level"].reshape(-1))
                for k in ("squelched", "symbols"):
                    if g[k] is not None:
                        parts.append(g[k].to(f32).reshape(-1))
                if idx is not None:
                    parts.append(g["audio"].index_select(0, idx)
                                 .to(f32).reshape(-1))
            if dv_tap is not None:
                # The selected row of its group's bandwidth-rate tap,
                # re-blocked and EMA'd like the main spectrum.
                st_dvd, st_dvs = st_dv
                tap = (PC(dv_tap.re.index_select(0, dv_row)[0],
                          dv_tap.im.index_select(0, dv_row)[0])
                       if isinstance(dv_tap, PC)
                       else dv_tap.index_select(0, dv_row)[0])
                st_dvd, (dfr, dval) = dv_dist.apply(st_dvd, tap)
                st_dvs, ddisp = dv_spec.apply(st_dvs, dfr, valid=dval)
                parts.append(ddisp["spectrum_points"].reshape(-1))
                st_dv = (st_dvd, st_dvs)
            if extra:
                pts, nv = extra
                parts += [pts.reshape(-1), nv.to(f32).reshape(1)]
            return (st_dist, st_spec, st_dv), torch.cat(parts)

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
        """(mix, per-group inputs, layout) for the packed post-step.
        Per-demod audio is packed for ONLY the rows the host needs
        (active recorders, subset-sink members, the solo target); a
        digital group packs its symbols instead, and never audio or
        squelch flags. The layout (per group: the audio rows, squelch
        flags present, symbols present) keys the post-step."""
        rec = self.any_recording()
        sink_keys = set()
        for s in self.audio_sinks.values():
            if s["demods"] is not None:
                sink_keys.update(s["demods"])
        if self.audio_solo is not None and "default" in self.audio_sinks:
            sink_keys.add(self.audio_solo)
        g_in, layout = [], []
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
            sq = rec and has_audio
            g_in.append({"level": g["level"],
                         "squelched": g["squelched"] if sq else None,
                         "symbols": g.get("symbols"),
                         "audio": g["audio"] if rows else None})
            layout.append((tuple(rows), sq, "symbols" in g))
            off += n
        return out["mix"], g_in, tuple(layout)

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
        mix, g_in, layout = self._pack_parts(out)
        dv_tap = dv_row = None
        dv_n = 0
        if self._dv_gi is not None and self._dv_gi < len(out["groups"]):
            dv_tap = out["groups"][self._dv_gi]["iq"]
            dv_row = self._dv_row
            dv_n = self.demod_view_fft
        # Zoomed view fed from the device-resident block; its points and
        # line count ride the same packed pull.
        extra, zoom_h = (), None
        # Its device errors propagate like the step's: the JAX package
        # notes them as advisory, which would hide a CUDA fault here.
        if self.zoom is not None:
            h = self.zoom.feed_device(out["iq"])
            if h is not None:
                extra = h
                # Pin the VIEW OBJECT: a zoom-off before the deferred
                # finish must not leave it dereferencing None. The points
                # sit in the view step's output slot, which the post-step
                # below reads before the view's next feed.
                zoom_h = (self.zoom, h[0].numel(),
                          (self.zoom.view_offset, self.zoom.resample_bw))
        post = self._post_for((layout, dv_tap is not None,
                               zoom_h[1] if zoom_h else 0))
        # The visual chain taps out["iq"] — the (converted float32)
        # full-band block the step saw.
        (self._st_dist, self._st_spec, self._st_dv), packed = post(
            (self._st_dist, self._st_spec, self._st_dv),
            (out["iq"], mix, g_in, dv_tap, dv_row, extra))
        self._post_last = post
        # Snapshot what the deferred finish needs AT DISPATCH (under the
        # step lock): the packed shapes, this block's row identities and
        # the per-row (gain, active) controls, host values only.
        pack = []
        for g, (rows, _, _) in zip(g_in, layout):
            pack.append({k: (None if g[k] is None else tuple(g[k].shape))
                         for k in ("level", "squelched", "symbols")})
            pack[-1]["audio"] = (None if not rows else
                                 (len(rows), *g["audio"].shape[1:]))
            pack[-1]["audio_rows"] = rows
        n_rows = sum(p["level"][0] for p in pack)
        keys = [self.row_key(i) for i in range(n_rows)]
        ctls = [(np.asarray(c["gain"], np.float32),
                 np.asarray(c["active"], bool)) for c in ctl_snap]
        return (self._pull(packed),
                None if mix is None else tuple(mix.shape), pack,
                self.spec.fft_size, keys, ctls, dv_n, zoom_h)

    def _fanout_finish(self, disp, iq, out, planes=None, mark=None):
        """Finish a dispatched block on the host. ``mark`` (the loop's:
        its span log, number, and in the compiled loop on the card its
        step and post-step with the slots they replayed) records its
        spans. A compiled step's slot is replayed again two calls on,
        after this finish."""
        pull, mix_shape, pack, P, keys, ctls, dv_n, zoom_h = disp
        host, ev = pull
        t0 = now()
        rng = open_range("pull.wait")
        if ev is not None:
            ev.synchronize()                 # the ONE device->host pull
        close_range(rng)
        t1 = now()
        rng = open_range("fanout")
        # Views of the block escape (audio tap, sinks, on_block), and the
        # pinned buffer is reused N_SLOTS blocks on (on the CPU: the
        # post-step's output, reused two blocks on).
        host = host.numpy().copy()
        pts = host[:P]
        nv = int(host[P])
        off = P + 1

        def take(shape):
            nonlocal off
            n = int(np.prod(shape))
            v = host[off:off + n].reshape(shape)
            off += n
            return v

        mix = take(mix_shape) if mix_shape is not None else None
        hgroups = []
        for g, gp in zip(out["groups"], pack):
            h = {"level": take(gp["level"])}
            if gp["squelched"] is not None:
                h["squelched"] = take(gp["squelched"]) > 0.5
            if gp["symbols"] is not None:
                h["symbols"] = take(gp["symbols"]).astype(np.int32)
            if gp["audio"] is not None:
                # Only the host-needed rows were packed; audio_rows maps
                # packed position -> group row index.
                h["audio"] = take(gp["audio"])
                h["audio_rows"] = gp["audio_rows"]
            # Device tap, pulled only on demand: valid until the block
            # after next is dispatched (a compiled step's outputs
            # alternate between two captures).
            h["iq"] = g["iq"]
            hgroups.append(h)

        if dv_n:
            self.demod_spectrum = take((dv_n,)).copy()

        if nv:
            self.waterfall.add_lines(np.tile(pts, (nv, 1)))
        # Read once: the finish runs outside the step lock, so a zoom-off
        # may set self.zoom to None between a check and a use.
        zoom = self.zoom
        if zoom_h is not None:
            z, n_pts, view = zoom_h
            zpts = take((n_pts,))
            nz = int(take((1,))[0])
            if nz:
                z.points = zpts.copy()
                z.points_view = view
                z.lines += nz
        elif zoom is not None and planes is not None:
            # Chunk-misaligned view: fed from the host planes.
            p = np.stack(planes)
            if p.dtype != np.float32:
                p = p.astype(np.float32) * self.ingest_scale
            zoom.feed(p)
        if mix is not None:
            with self.audio_cond:
                # A copy: ``mix`` is a view of the block's whole pull,
                # which the tap's 64 blocks would otherwise keep.
                self.audio_tap.append(mix.copy())
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
        on_span = (0, 0)
        if self.on_block is not None:
            t2 = now()
            r_on = open_range("on_block")
            self.on_block({"groups": hgroups, "mix": mix,
                           "seq": None if mark is None else mark[1]})
            close_range(r_on)
            on_span = (t2, now())
        close_range(rng)
        if mark is not None:
            sp, seq, timed = mark
            t3 = now()
            sp.add(_PULL, seq, t0, t1)
            sp.add(_FANOUT, seq, t1, t3)
            if on_span[0]:
                sp.add(_ON_BLOCK, seq, *on_span)
            if timed is not None:
                step, k, post, j = timed
                sp.add(_DEV_STEP, seq, 0, round(step.device_ms(k) * 1e6))
                sp.add(_DEV_POST, seq, 0, round(post.device_ms(j) * 1e6))
                for mark, ms in step.mark_ms(k).items():
                    sp.add(_DEV_LAYER[mark], seq, 0, round(ms * 1e6))

    def cache_stats(self) -> dict:
        """The compiled-step caches: steps and post-steps built, post-steps
        held, and the zoom view's (the stashed one while zoom is off)
        built levels, level builds and evictions (None without a view)."""
        z = self.zoom if self.zoom is not None else self._zoom_stash
        return {
            "step_builds": self.step_builds, "post_builds": self.post_builds,
            "post_cache": sum(len(e["posts"])
                              for e in list(self._post_cache.values())),
            "zoom_levels_built": None if z is None else z.levels_built,
            "zoom_level_builds": None if z is None else z.level_builds,
            "zoom_level_evictions": (None if z is None
                                     else z.level_evictions)}

    def stop(self):
        self._stop.set()
        self.ring.wake()                 # a starved consumer returns
        if hasattr(self.source, "stop"):
            try:
                # Unblock a producer stuck inside the source.
                self.source.stop()
            except Exception:                # noqa: BLE001
                pass
        if self._producer is not None:
            self._producer.join(timeout=2.0)
        self._release_spans(wait=True)
        for r in self._recorders.values():
            r.close()
        for s in self.audio_sinks.values():
            s["output"].close()
        self.audio_sinks.clear()

    def status(self) -> str:
        return self.metrics.status_line()
