"""The benchmark of ``cubicsdr_tpu_torch``: one cell of ``BENCHMARK.json``
on the card this process runs on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A cell names a configuration (``configs/<config>.json``: the plan, its
capture, block, wire format and display) and a traffic mix
(``traffic/<mix>.json``). Set-up makes the capture on the card from the
seed and quantises it to the wire format, builds the program's receiver
(``ReceiverPipeline`` with its defaults: planar, both CUDA kernels) and
its live loop (``LiveReceiver``: native ring, staging worker, compiled
step and post-step, one packed pull, the fan-out, ``on_block``), and runs
a few warm blocks, which build every graph the window replays. The
window then drives ``LiveReceiver.run_blocks`` for ``--seconds`` under
the mix's schedule. ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` times the harness's calls into the loop for the first part
of the window and profiles the device for a later part, and reports the
per-layer metrics (``metrics/<name>.py``) and a breakdown.

``correct`` compares what the timed path handed the host with the plain
reference (``reference/``), after the window, once the program is freed:
the warm blocks from the stream's start, and blocks of the window drawn
from the seed, each from the program's own state before it (states read
at the blocks before), with the program's state after it. ``--control
1`` also runs the comparison's control (the reference in bfloat16 in the
program's place) and prints its numbers; the benchmark's own runs never
ask for it. The last line of standard output is the result.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
# Every build and kernel cache at a fixed path inside the checkout.
CACHE = ROOT / ".bench_cache"
for _k, _d in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
               ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ.setdefault(_k, str(CACHE / _d))
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import compare, registry, roofline, synth  # noqa: E402
from benchmark import trace as tr  # noqa: E402
from benchmark.generator import TrafficSource  # noqa: E402

N_WARM = 4            # warm blocks: both output slots of each graph built
N_SAMPLES = 2         # window blocks compared from the program's state
LATE_WAIT_S = 60.0    # how long past the close a due block is awaited
FORBIDDEN = ("jax", "jaxlib", "flax", "cubicsdr_tpu")
LIMITS_FILE = HERE / "limits.json"


def process_start() -> float:
    """The wall time this process started (Linux), else this module's
    import time."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


class Recorder:
    """``on_block``: the time each block reached the host, the outputs of
    the blocks compared, the states around them, and the traced run's
    profiler window.

    A tracked block's outputs are kept, and the states the loop holds at
    its ``on_block``: the program's state and the post-step's, after
    every block dispatched so far (the loop dispatches block i + 1 before
    it finishes block i, unless it is waiting for one), keyed by the last
    block they include. A compared window block needs the states after
    the block before it and after itself, so a run of ``TRACK`` blocks is
    tracked around each block drawn."""

    TRACK = 6

    def __init__(self, warm: int):
        self.lr = None
        self.t = []                  # perf_counter of each on_block
        self.track = set()           # block indices to keep
        self.outputs = {}
        self.states = {}             # last block included -> states
        self.lines = None
        self.own_s = 0.0             # time spent in this callback
        self.sample_times = []       # perf_counter times to draw blocks at
        self.runs = []               # first block of each tracked run
        self.warm = warm
        self.trace_window = None
        self.prof = None
        self.prof_span = None

    def track_from(self, j: int):
        self.runs.append(j)
        self.track.update(range(j, j + self.TRACK))

    def samples(self) -> list:
        """Per tracked run, its first block with the states before and
        after it and its outputs kept."""
        out = []
        for a in self.runs:
            for k in range(a + 1, a + self.TRACK):
                if k - 1 in self.states and k in self.states \
                        and k in self.outputs:
                    out.append(k)
                    break
        return out

    def add_lines(self, orig):
        def run(points):
            self.lines = points
            return orig(points)
        return run

    def on_block(self, res):
        t = time.perf_counter()
        j = len(self.t)
        self.t.append(t)
        if self.sample_times and t >= self.sample_times[0]:
            self.sample_times.pop(0)
            self.track_from(j)
        if j < self.warm:
            self.outputs[j] = self._grab(res)
        elif j in self.track:
            lr = self.lr
            self.outputs[j] = self._grab(res)
            last = lr.metrics.stats["pipeline"].blocks_in - 1
            self.states[last] = (
                compare.to_host_tree(lr.snapshot_state()),
                compare.to_host_tree((lr._st_dist, lr._st_spec,
                                      lr._st_dv)))
        self.lines = None
        if self.trace_window is not None:
            self._trace(t)
        self.own_s += time.perf_counter() - t

    def _grab(self, res):
        import torch
        out = {"mix": None if res["mix"] is None else res["mix"].copy(),
               "groups": [], "lines": 0, "points": None,
               "demod_view": (None if self.lr.demod_spectrum is None
                              else self.lr.demod_spectrum.copy())}
        if self.lines is not None:
            out["lines"] = int(self.lines.shape[0])
            out["points"] = self.lines[-1].copy()
        for h in res["groups"]:
            g = {"level": np.array(h["level"]),
                 "iq": torch.stack([h["iq"].re, h["iq"].im]).cpu().numpy()}
            if "symbols" in h:
                g["symbols"] = np.array(h["symbols"])
            out["groups"].append(g)
        return out

    def _trace(self, t):
        """Start the device profile at its time. It runs to the window's
        end: stopping it processes its events, which would stall the
        loop inside the window."""
        import torch
        if self.prof is None and t >= self.trace_window:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.prof_span = [time.perf_counter(), None]


class Timed:
    """A call into the live loop, timed on the host clock and marked as a
    span for the profiler; ``spent`` accumulates until ``until``."""

    def __init__(self, fn, name: str, spent: dict, until: list):
        self.fn, self.name, self.spent, self.until = fn, name, spent, until
        self.spent.setdefault(name, 0.0)

    def __call__(self, *args, **kw):
        import torch
        t = time.perf_counter()
        try:
            with torch.autograd.profiler.record_function(self.name):
                return self.fn(*args, **kw)
        finally:
            if t < self.until[0]:
                self.spent[self.name] += time.perf_counter() - t

    def __getattr__(self, item):          # the compiled step's buffers
        return getattr(self.fn, item)


def _percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def _finite(x):
    return x if math.isfinite(x) else 1e300


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             spec: dict | None = None, device=None, control: bool = False,
             root: Path = ROOT, log=None) -> tuple[int, dict | None]:
    """One run of a cell; returns (exit code, result or None). ``device``
    None means the card and checks for it; tests pass "cpu"."""
    import torch
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = process_start()
    spec = spec or registry.load_spec(root)
    cell = registry.cell(spec, workload)
    cfg = registry.config(spec, cell["config"], root)
    mix = registry.traffic(cell["traffic"], root / "benchmark")
    wanted = registry.cell_metrics(spec, workload, trace)
    if device is None:
        if not torch.cuda.is_available():
            log("benchmark: no CUDA device (torch.cuda.is_available() is "
                "false)")
            return 3, None
        if torch.cuda.device_count() < int(cell["chips"]):
            log(f"benchmark: the cell asks for {cell['chips']} cards, "
                f"this machine has {torch.cuda.device_count()}")
            return 3, None
        device = "cuda"
    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(int(seed))

    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline

    # --- set-up: the capture, the program, warm blocks ---
    planes = synth.capture(cfg, seed, dev)
    loop = synth.wire(planes, cfg["wire"], float(cfg["wire_peak"]))
    del planes
    specs = [DemodGroupSpec(g["modem"], int(g["bandwidth"]), int(g["count"]),
                            tuple(sorted(g.get("settings", {}).items())))
             for g in cfg["groups"]]
    rx = ReceiverPipeline(float(cfg["sample_rate"]), specs,
                          chan_mode=cfg.get("chan_mode", "pfbch2"),
                          num_channels=int(cfg["num_channels"]),
                          audio_rate=int(cfg.get("audio_rate", 48000)),
                          block_len=int(cfg["block_len"]), device=dev)
    controls = rx.control_template()
    for c, g in zip(controls, cfg["groups"]):
        c["frequency"] = np.asarray(g["offsets"], np.float32)
    L = rx.block_len
    T = float(seconds)
    src = TrafficSource(mix, loop, L, float(cfg["sample_rate"]))
    n_window = (None if src.closed
                else max(1, int(T * src.rate / L)))
    trace_window = None
    until = [math.inf]
    if trace:
        # Host spans over [0, 0.6 T), the device profiled after that.
        until = [None]
        trace_window = 0.6 * T
        # The profiler's first start initialises the device tracer, which
        # takes seconds: done here, in set-up.
        warm_prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
        warm_prof.start()
        torch.ones(1, device=dev).add_(1)
        warm_prof.stop()
        del warm_prof
    rec = Recorder(N_WARM)
    disp = cfg["display"]
    lr = LiveReceiver(rx, controls, src,
                      ring_seconds=float(cfg.get("ring_seconds", 2.0)),
                      waterfall_fft=int(disp["fft"]),
                      waterfall_lines=int(disp["lines"]),
                      waterfall_lps=float(disp["lines_per_second"]),
                      on_block=rec.on_block,
                      ingest_dtype=synth.WIRE[cfg["wire"]])
    rec.lr = lr
    lr.waterfall.add_lines = rec.add_lines(lr.waterfall.add_lines)
    if disp.get("demod_view") is not None:
        lr.demod_view_fft = int(disp["demod_view_fft"])
        lr.set_demod_view(int(disp["demod_view"]))
    src.ring = lr.ring
    src.drops = lambda: lr.metrics.stats["ingest"].samples_dropped
    lr.start_producer()
    src.allow(N_WARM)
    if lr.run_blocks(max_blocks=N_WARM) != N_WARM:
        raise RuntimeError("the warm blocks did not all run")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    spent = {}
    if trace:
        lr.step = Timed(lr.step, "bench.step_dispatch", spent, until)
        lr._fanout_dispatch = Timed(lr._fanout_dispatch,
                                    "bench.post_dispatch", spent, until)
        lr._fanout_finish = Timed(lr._fanout_finish, "bench.fanout_finish",
                                  spent, until)

    # --- the window ---
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    # Compared window blocks, drawn from the seed, away from the traced
    # part of the window.
    if src.closed:
        rec.sample_times = sorted(t0 + T * rng.uniform(0.1, 0.55)
                                  for _ in range(N_SAMPLES))
    else:
        picks = rng.choice(np.arange(2, max(3, int(0.55 * n_window))),
                           size=min(N_SAMPLES, max(1, int(0.55 * n_window)
                                                   - 2)), replace=False)
        for i in sorted(int(p) for p in picks):
            rec.track_from(N_WARM + i)
    if trace:
        until[0] = rec.trace_window = t0 + trace_window
    src.start_window(t0, n_window)
    own0 = rec.own_s
    done = threading.Event()

    def watch():
        if src.closed:
            done.wait(max(0.0, t0 + T - time.perf_counter()))
        else:
            deadline = t0 + T + LATE_WAIT_S
            while time.perf_counter() < deadline and not done.is_set():
                offered = src.offered[N_WARM:]
                if len(offered) >= n_window:
                    lost = sum(1 for o in offered if o[2])
                    if len(rec.t) - N_WARM >= n_window - lost:
                        break
                done.wait(0.01)
        lr.stop()

    watcher = threading.Thread(target=watch, name="bench-watch")
    watcher.start()
    try:
        lr.run_blocks()
    finally:
        done.set()
        watcher.join()
        lr.stop()
    src.settle()
    if not src.closed:
        log(f"benchmark: the paced producer ran at most {src.late_s:.6f} s "
            f"behind its schedule")
    if rec.prof is not None and rec.prof_span[1] is None:
        if cuda:
            torch.cuda.synchronize(dev)
        rec.prof_span[1] = time.perf_counter()
        rec.prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # --- what the window measured ---
    times = np.asarray(rec.t[N_WARM:])
    offered = src.offered[N_WARM:]
    delivered = [o for o in src.offered if not o[2]]
    if src.closed:
        in_win = int(np.sum(times <= t0 + T))
        attempted = in_win + sum(1 for o in offered if o[2])
        failed = sum(1 for o in offered if o[2])
        values = {"msps": in_win * L / T / 1e6}
    else:
        attempted = n_window
        lat = []
        arrival = {}
        for j, o in enumerate(delivered):
            if j < len(rec.t):
                arrival[o[0]] = rec.t[j]
        for o in offered[:n_window]:
            if o[0] in arrival:
                lat.append((arrival[o[0]] - o[1]) * 1e3)
            else:
                lat.append((LATE_WAIT_S + T) * 1e3)   # never came
        failed = sum(1 for o in offered[:n_window]
                     if o[0] not in arrival) + max(0, n_window - len(offered))
        lat += [(LATE_WAIT_S + T) * 1e3] * max(0, n_window - len(lat))
        values = {"latency_p50_ms": _percentile(lat, 50),
                  "latency_p95_ms": _percentile(lat, 95)}
    values["setup_s"] = setup_s

    metrics, breakdown, dev_info = {}, None, {}
    if trace:
        wrec = {"closed": src.closed}
        host_end = until[0]
        n_host = int(np.sum(times < host_end))
        if n_host:
            own = rec.own_s - own0
            span = min(host_end, times[n_host - 1]) - t0
            host_ms = {k: v * 1e3 / n_host for k, v in spent.items()}
            host_ms["bench.fanout_finish"] = max(
                0.0, host_ms["bench.fanout_finish"] - own * 1e3 / n_host)
            wrec.update(host_ms_per_block=host_ms, host_blocks=n_host,
                        wall_ms_per_block=span * 1e3 / n_host)
        if rec.prof is not None:
            dev_ev, host_ev = tr.profiler_events(rec.prof)
            wrec["blocks"] = tr.blocks(dev_ev)
            breakdown = tr.breakdown(dev_ev, host_ev)
            dev_info = {"busy_s": tr.busy_seconds(dev_ev),
                        "window_s": rec.prof_span[1] - rec.prof_span[0]}
            rec.prof = None
        from benchmark.reference.step import RefDeployment
        wrec["work"] = roofline.block_kernel_work(
            RefDeployment(cfg, "cpu").rx, controls)
        for m in wanted:
            v = registry.metric_reader(m["name"], root / "benchmark")(wrec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
                if m["name"].endswith("_roofline") and v > 100.0:
                    log(f"benchmark: {m['name']} reads {v} %, above its "
                        f"roofline: the work is counted too high or the "
                        f"time misses part of it")
                    return 1, None
    else:
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}

    # --- correct: the program freed, then the reference ---
    outputs, states, samples = rec.outputs, rec.states, rec.samples()
    samples += [None] * (N_SAMPLES - len(samples))
    stream_of = [o[0] for o in delivered]
    rec.lr = None
    del lr, rx, rec, src
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, ctl = check(cfg, loop, dev, outputs, states, samples,
                         stream_of, control)
    numbers["lost_blocks"] = float(failed)
    limits = json.loads(LIMITS_FILE.read_text())
    correct, checks = compare.judge(numbers, limits)

    device_out = {"platform": "gpu" if cuda else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if cuda
                           else dev.type),
                  "count": 1, "memory_peak_bytes": int(peak), **dev_info}
    if cuda:
        device_out["power_limit"] = _power_limit()
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_out}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if ctl is not None:
        result["control"] = {k: _finite(v) for k, v in ctl.items()}
        for k, v in ctl.items():
            log(f"control {k} {v!r} limit {limits[k]!r}")
    result["checks"] = {k: {"value": _finite(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return 0, result


def check(cfg, loop, dev, outputs, states, samples, stream_of,
          control: bool):
    """The comparison's numbers (and the control's, when asked). Judged:
    the warm blocks from the stream's start (the reference from its own
    initial state), then each sampled window block from the program's
    state before it, and the program's state after it. The reference's
    route, channelizer and main spectrum take the block itself; its
    modem kits, gates, mix and demod view take the judged side's IQ taps,
    so each stage is judged from its own input (a demod in a stop band
    holds IQ at float32 rounding level, where an FM discriminator's
    output is set by that rounding)."""
    import torch

    from benchmark.reference.step import RefDeployment
    L = int(cfg["block_len"])

    def blocks_of(ks):
        return [(k, synth.stream_block(loop, L, stream_of[k])) for k in ks]

    warm = blocks_of(range(N_WARM))
    drawn = blocks_of([k for k in samples
                       if k is not None and k < len(stream_of)])
    missing = len(samples) - len(drawn)

    def taps(out):
        return [g["iq"] for g in out["groups"]]

    def judge(outs, after):
        ref = RefDeployment(cfg, dev)
        readings = [{n: float("inf") for n in compare.NUMBERS}] * missing
        with torch.no_grad():
            st, post = ref.init_states()
            for j, blk in warm:
                st, post, r = ref.block(st, post, blk, taps(outs[j]))
                readings.append(compare.compare_block(outs[j], r))
            for k, blk in drawn:
                s0, p0 = states[k - 1]
                st, post, r = ref.block(ref.to_device(s0),
                                        ref.to_device(p0), blk,
                                        taps(outs[k]))
                readings.append(compare.compare_block(outs[k], r))
                readings.append({"state_gap": compare.state_gap(
                    after[k], compare.to_host_tree(st))})
        return compare.worst(readings)

    nums = judge(outputs, {k: states[k][0] for k, _ in drawn})
    ctl = None
    if control:
        # The control in the program's place: the reference in bfloat16,
        # from the same states, judged as the program is.
        c = RefDeployment(cfg, dev, precision="bfloat16")
        c_outs, c_after = {}, {}
        with torch.no_grad():
            st, post = c.init_states()
            for j, blk in warm:
                st, post, c_outs[j] = c.block(st, post, blk)
            for k, blk in drawn:
                s0, p0 = states[k - 1]
                st, _, c_outs[k] = c.block(c.to_device(s0),
                                           c.to_device(p0), blk)
                c_after[k] = compare.to_host_tree(st)
        del c
        ctl = judge(c_outs, c_after)
    return nums, ctl


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also run the comparison's control (not a "
                    "benchmark run)")
    args = ap.parse_args(argv)
    try:
        rc, result = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), control=bool(args.control))
    except Exception:                        # noqa: BLE001 — reported
        traceback.print_exc()
        return 1
    if rc != 0:
        return rc
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}; the port "
              f"must not load JAX or the JAX package", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
