"""Single-card throughput benchmark of the port: IQ Msamples/s through the
whole channelize + demod chain (the JAX package's ``bench.py``).

    python -m cubicsdr_tpu_torch bench [--only ROW]... [--demods N]
                                       [--block L] [--no-kernels]
                                       [--live-blocks N] [--device cuda]

Six rows, one JSON line each:

  demod16   16-channel PFBCH2 channelizer + 16 FM demods at 8 MS/s,
            device-resident IQ, K = 8 blocks per dispatch.
  demod256  256 FM demods over the same 16 channels (16 per channel).
  live16    the live loop (``app/runner.py`` ``LiveReceiver``) at the
            demod16 width: a host source with back-pressure, the native
            ring, the staged host->device copy, the step and the packed
            post-step with its waterfall and audio; compiled (``value``)
            and eager (``eager_msps``) in turns.
  live16_i16, live16_i8
            live16 with int16 / int8 ring planes (the CS16 and CS8 wire
            formats), converted to float32 on the device.
  multihost the 2-process receive job against the same job at 1 process
            (``parallel/multihost.py``).

The demod rows time what the JAX package times with ``jax.jit`` over
``lax.scan`` with the state donated: on the card, K receive steps are
captured once in a CUDA graph over static buffers (the state, a [K, L]
planar IQ pair and the controls as device tensors), the final state is
copied back into the state buffers inside the graph, and a dispatch is one
replay. Beside it each row times the same K-step loop run eagerly
(``eager_msps``). Every row is stamped with the card (``nvidia-smi`` name
and power limit), the host's load and the host->device copy rate.

The entry points run on the card unless ``--device cpu`` is given; there
the K-step loop runs eagerly (no graph) and no wire rate is probed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.planar import PC
from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
from cubicsdr_tpu_torch.utils.compiled import CompiledStep, launch_counts
from cubicsdr_tpu_torch.utils.synth import demod_freqs

FS = 8_000_000
K = 8                   # blocks per dispatch
WARM_DISPATCHES = 2
DISPATCHES = 15         # per timing window
WINDOWS = 5
ROWS = ("demod16", "demod256", "live16", "live16_i16", "live16_i8",
        "multihost")


def build_pipeline(n_demods: int = 16, block_len: int | None = None,
                   use_kernels: bool = True, device="cuda"):
    """The bench's pipeline and its controls (numpy): 8 MS/s, 16 channels
    (ceil(rate / 500 kHz), ref: SoapySDRThread.cpp:676-693), FM demods at
    ((i % 16) - 8) * 500 kHz + 20 kHz, so a 256-demod farm packs 16 per
    channel. ``block_len`` defaults to the multiple of the plan's block
    multiple and 128 channel steps nearest below 2^20 (1,024,000)."""
    specs = [DemodGroupSpec("FM", 200000, n_demods)]
    if block_len is None:
        rx0 = ReceiverPipeline(FS, specs, device="cpu")
        m = math.lcm(rx0.group_block_multiple(0), rx0._decim * 128)
        block_len = max(m, ((1 << 20) // m) * m)
    rx = ReceiverPipeline(FS, specs, use_kernels=use_kernels,
                          block_len=block_len, device=device)
    controls = rx.control_template()
    controls[0]["frequency"] = demod_freqs(n_demods)
    return rx, controls


def device_controls(controls, device):
    """The control dicts as tensors on ``device`` (no upload per block)."""
    return [{k: torch.as_tensor(v, device=device) for k, v in c.items()}
            for c in controls]


def multi_step(rx, state, iqs, controls):
    """K receive steps over the planar blocks ``iqs`` (a PC of [K, L]
    planes): the body of the JAX bench's ``lax.scan``. Returns (final
    state, mix [K, 2, La], level [K, N] with the groups' levels
    concatenated)."""
    mixes, levels = [], []
    for k in range(iqs.re.shape[0]):
        state, out = rx.apply(state, (PC(iqs.re[k], iqs.im[k]), controls))
        mixes.append(out["mix"])
        levels.append(torch.cat([g["level"] for g in out["groups"]], -1))
    return state, torch.stack(mixes), torch.stack(levels)


class GraphedScan:
    """``step(rx, state, iqs, controls)`` (default ``multi_step``)
    captured once in a CUDA graph: the counterpart of
    ``jax.jit(lax.scan(...), donate_argnums=0)``, a one-slot
    ``utils/compiled.py`` ``CompiledStep`` built at construction.

    The graph reads static buffers: ``state`` (a copy of the given state),
    ``iqs`` (a PC of [K, L] planes, copied) and ``controls`` (copied to the
    device). Inside the capture the step's final state is copied back into
    ``state``, so each ``replay()`` advances the stream by K blocks, and
    its other results land in ``outputs``, which the next replay
    overwrites. New IQ goes in with ``iqs.re.copy_(...)``.

    Two warm-up calls on a side stream, each on a throwaway copy of the
    state, build what the step builds at its first call (the IIR
    constants, the route taps, the kernels' shared-memory attribute)
    before the capture; a capture that meets anything else host-side
    raises, with no eager fallback. ``launches`` holds the kernel
    launches the graph holds (K steps' worth); each replay adds them to
    the wrappers' counts."""

    def __init__(self, rx, state, iqs, controls, step=multi_step):
        if rx.device.type != "cuda":
            raise ValueError("a CUDA graph needs a pipeline on a CUDA "
                             "device; on the CPU call the step eagerly")
        self.rx, self.step = rx, step

        def scan(st, inputs):
            new_state, *outs = step(rx, st, *inputs)
            return new_state, tuple(outs)

        self._compiled = CompiledStep(scan, rx.device, slots=1)
        self._compiled.prepare(state, (PC(iqs.re, iqs.im),
                                       device_controls(controls, rx.device)))
        self._compiled.build()
        self.state = self._compiled.state
        self.iqs, self.controls = self._compiled.inputs
        self.outputs = self._compiled.outputs[0]
        self.launches = self._compiled.launches[0]

    def replay(self):
        return self._compiled(self.state, self._compiled.inputs)[1]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_name() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _host_context(device) -> dict:
    """Run-time context stamped onto every row, so drift between runs can
    be attributed from the JSON alone: the host's load, the card and the
    host->device copy rates."""
    ctx = {"device": str(device)}
    try:
        ctx["host_load1"] = round(os.getloadavg()[0], 2)
    except OSError:
        pass
    if torch.device(device).type == "cuda":
        ctx["card"] = card_name()
        ctx["kind"] = torch.cuda.get_device_name(torch.device(device))
        ctx["wire_mbps_probe"] = wire_probe(device)
    return ctx


def wire_probe(device, planes: np.ndarray | None = None) -> dict:
    """MB/s of a pageable->device and of a pinned->device copy of
    ``planes`` (default: two float32 planes of 2^20 samples), each the
    mean of two copies after a warm one."""
    if planes is None:
        planes = np.random.default_rng(99).standard_normal(
            (2, 1 << 20)).astype(np.float32)
    host = torch.from_numpy(np.ascontiguousarray(planes))
    pinned = torch.empty_like(host).pin_memory()
    pinned.copy_(host)
    rates = {}
    for name, src in (("pageable", host), ("pinned", pinned)):
        src.to(device, non_blocking=True)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(2):
            src.to(device, non_blocking=True)
        _sync(device)
        rates[name] = 2 * host.nbytes / (time.perf_counter() - t0) / 1e6
    return rates


def _emit(metric: str, msps: float, device, extra: dict | None = None
          ) -> dict:
    """Print one row: the JAX bench's ``metric``, ``value`` and ``unit``
    and the host context, then ``extra``; return it."""
    row = {"metric": metric, "value": msps, "unit": "Msamples/s"}
    row.update(_host_context(device))
    if extra:
        row.update(extra)
    print(json.dumps(row), flush=True)
    return row


def _window(dispatch, device) -> float:
    """Seconds of DISPATCHES calls of ``dispatch``, the device
    synchronised at both ends."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(DISPATCHES):
        dispatch()
    _sync(device)
    return time.perf_counter() - t0


def _rates(prefix: str, seconds: list, blocks: int, block_len: int
           ) -> dict:
    """Median MS/s over the windows (``seconds``, each of ``blocks``
    blocks), every window's, the spread ((max - min) / median) and the
    median ms per block."""
    msps = [blocks * block_len / s / 1e6 for s in seconds]
    med = float(np.median(msps))
    return {f"{prefix}msps": med, f"{prefix}msps_windows": msps,
            f"{prefix}spread": (max(msps) - min(msps)) / med,
            f"{prefix}ms_per_block": float(np.median(seconds)) / blocks
            * 1e3}


def bench_scan(n_demods: int, block_len=None, use_kernels: bool = True,
               device="cuda") -> dict:
    """Device-resident throughput, K blocks per dispatch: on the card a
    CUDA graph of ``multi_step`` replayed (``value``), beside the same
    K-step loop run eagerly (``eager_msps``), windows taken in turns
    (graph, eager); on the CPU the eager loop alone. Each of WINDOWS
    windows times DISPATCHES dispatches, after WARM_DISPATCHES."""
    rx, controls = build_pipeline(n_demods, block_len, use_kernels, device)
    dev = rx.device
    rng = np.random.default_rng(0)
    iqs = PC(*(torch.from_numpy(rng.standard_normal((K, rx.block_len))
                                .astype(np.float32)).to(dev)
               for _ in range(2)))
    ctl = device_controls(controls, dev)
    eager = {"state": rx.init_state()}

    def eager_dispatch():
        eager["state"], *eager["out"] = multi_step(rx, eager["state"], iqs,
                                                   ctl)

    for _ in range(WARM_DISPATCHES):
        eager_dispatch()
    _sync(dev)
    before = launch_counts()
    eager_dispatch()
    _sync(dev)
    eager_launches = {k: (v - before[k]) / K
                      for k, v in launch_counts().items()}
    graph = None
    if dev.type == "cuda":
        graph = GraphedScan(rx, rx.init_state(), iqs, ctl)
        for _ in range(WARM_DISPATCHES):
            graph.replay()
    t_graph, t_eager = [], []
    for _ in range(WINDOWS):
        if graph is not None:
            t_graph.append(_window(graph.replay, dev))
        t_eager.append(_window(eager_dispatch, dev))
    outs = graph.outputs if graph is not None else eager["out"]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("non-finite mix or level in the bench")
    blocks = DISPATCHES * K
    eager_rates = _rates("eager_", t_eager, blocks, rx.block_len)
    extra = {"demods": n_demods, "block_len": rx.block_len,
             "blocks_per_dispatch": K, "dispatches_per_window": DISPATCHES,
             "windows": WINDOWS, "kernels": rx.use_kernels,
             "graphed": graph is not None}
    value = eager_rates["eager_msps"]
    if graph is not None:
        extra.update(_rates("graph_", t_graph, blocks, rx.block_len))
        extra["graph_launches_per_block"] = {
            k: v / K for k, v in graph.launches.items()}
        value = extra["graph_msps"]
    extra.update(eager_rates)
    extra["eager_launches_per_block"] = eager_launches
    return _emit(f"iq_msamples_per_sec_per_chip_channelize_demod"
                 f"{n_demods}", value, dev, extra)


def bench_live(n_demods: int = 16, n_blocks: int = 240, block_len=None,
               use_kernels: bool = True, ingest_dtype=None,
               device="cuda") -> dict:
    """The live path: host numpy blocks -> native ring (producer thread,
    waiting for ring space) -> ``LiveReceiver.run_blocks`` (staged copy,
    step, packed post-step with a 1024-point waterfall, one pull, the
    fan-out): sustained MS/s over ``n_blocks`` blocks after 8, and the
    ring's drops. Two receivers, compiled (``value``: on the card the
    step and post-step replay CUDA graphs) and eager (``eager_msps``),
    run in turns over up to WINDOWS windows of ``n_blocks`` / WINDOWS
    blocks each. ``ingest_dtype`` int16 / int8 ships wire-width planes
    and converts them on the device."""
    from cubicsdr_tpu_torch.utils.metrics import Metrics
    from cubicsdr_tpu_torch.utils.synth import live_row
    rx, _ = build_pipeline(n_demods, block_len, use_kernels, device)
    ingest = np.dtype(ingest_dtype or np.float32)
    lrs = {}
    try:
        for mode in ("compiled", "eager"):
            lrs[mode] = live_row(rx, ingest.type, n_warm=8,
                                 compiled=mode == "compiled")
            lrs[mode].metrics = Metrics()
        planes = lrs["compiled"].source.blocks[0]
        wire = (wire_probe(rx.device, planes)
                if rx.device.type == "cuda" else None)
        windows = min(WINDOWS, n_blocks)
        per = n_blocks // windows
        secs = {"compiled": [], "eager": []}
        blocks = dict.fromkeys(secs, 0)
        for _ in range(windows):
            for mode, lr in lrs.items():
                t0 = time.perf_counter()
                blocks[mode] += lr.run_blocks(max_blocks=per)
                secs[mode].append(time.perf_counter() - t0)
        drops = {m: int(lr.metrics.snapshot()["ingest"]["dropped"])
                 for m, lr in lrs.items()}
    finally:
        for lr in lrs.values():
            lr.stop()
    if blocks != dict.fromkeys(secs, windows * per):
        raise AssertionError(f"live row ran {blocks} blocks, expected "
                             f"{windows * per} each")
    tag = "" if ingest == np.float32 else f"_{ingest.name}"
    compiled = _rates("compiled_", secs["compiled"], per, rx.block_len)
    extra = {"demods": n_demods, "block_len": rx.block_len,
             "blocks": blocks["compiled"], "windows": windows,
             "blocks_per_window": per,
             "ms_per_block": compiled["compiled_ms_per_block"],
             "ring_dropped_samples": drops["compiled"],
             "eager_ring_dropped_samples": drops["eager"],
             "ingest": ingest.name, **compiled,
             **_rates("eager_", secs["eager"], per, rx.block_len)}
    if wire is not None:
        extra["wire_mbps_probe_row"] = wire
    return _emit(f"iq_msamples_per_sec_per_chip_live_loop_demod{n_demods}"
                 f"{tag}", compiled["compiled_msps"], rx.device, extra)


def bench_multihost(timed_steps: int = 16, device="cuda") -> dict:
    """Multi-process scaling: the 2-process receive job (``multihost``,
    its demo plan) timed at steady state against the same job at 1
    process. On the card, with fewer than 2 cards, both jobs run their
    collectives through gloo on host copies (``host_collectives``), so
    the processes may share the card; the row's caveat says so. Each
    process runs the compiled sharded step but on host collectives,
    where it runs eagerly: ``compiled`` reports the 2-process job's."""
    from cubicsdr_tpu_torch.parallel import multihost
    on_card = torch.device(device).type == "cuda"
    host = on_card and torch.cuda.device_count() < 2
    reps = {}
    for n in (1, 2):
        rs = multihost.launch_local(n, steps=1, timed_steps=timed_steps,
                                    device=device, host_collectives=host)
        timed = [r["timed"] for r in rs]
        reps[n] = {
            "aggregate_msps": sum(t["aggregate_msps"] for t in timed)
            / len(timed),
            "ingest_scatter_share": max(t["ingest_scatter_share"]
                                        for t in timed),
            "compiled": all(r["compiled"] for r in rs)}
    m1, m2 = reps[1]["aggregate_msps"], reps[2]["aggregate_msps"]
    caveat = ("both processes share one host's cores (a loopback stand-in "
              "for a link between hosts); under-measures real multi-host "
              "scaling")
    if host:
        caveat += ("; both share one card, and every collective goes "
                   "through gloo on host copies of the card's tensors")
    return _emit("iq_msamples_per_sec_multihost_2proc", m2, device, {
        "aggregate_msps_1proc": m1, "scaling_vs_1proc": m2 / m1,
        "efficiency_vs_2x": m2 / (2 * m1),
        "ingest_scatter_share": reps[2]["ingest_scatter_share"],
        "host_collectives": host, "compiled": reps[2]["compiled"],
        "timed_steps": timed_steps,
        "host_cpus": os.cpu_count(), "caveat": caveat})


def main(argv=None) -> list[dict]:
    """Run the rows ``argv`` asks for (default: all six) and return
    them."""
    ap = argparse.ArgumentParser(prog="cubicsdr_tpu_torch bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--only", action="append", choices=ROWS,
                    help="run a subset (repeatable; default: all six)")
    ap.add_argument("--demods", type=int, default=None,
                    help="one custom scan row with N demods instead")
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--no-kernels", action="store_true",
                    help="the kernels' plain versions (use_kernels=False)")
    ap.add_argument("--live-blocks", type=int, default=240)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "K-step loop eagerly on the host)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("bench runs on the card by default and this host "
                           "has no CUDA device; pass --device cpu to run on "
                           "the host")
    kern = not args.no_kernels
    common = {"block_len": args.block, "use_kernels": kern,
              "device": args.device}
    if args.demods is not None:
        return [bench_scan(args.demods, **common)]
    rows = []
    only = args.only or ROWS
    for n in (16, 256):
        if f"demod{n}" in only:
            rows.append(bench_scan(n, **common))
    for name, dt in (("live16", None), ("live16_i16", np.int16),
                     ("live16_i8", np.int8)):
        if name in only:
            rows.append(bench_live(16, args.live_blocks, ingest_dtype=dt,
                                   **common))
    if "multihost" in only:
        rows.append(bench_multihost(device=args.device))
    return rows


if __name__ == "__main__":
    main()
