"""Where the port's receive step spends its time on one CUDA device.

    python3 -m cubicsdr_tpu_torch.utils.profile_step [--demods 16 256]
                                                     [--blocks 10]
                                                     [--plan scan58]
                                                     [--dtype complex64]
                                                     [--graph]

Runs ReceiverPipeline with its defaults (planar, both kernels; 8 MS/s,
FM demods, 1,024,000-sample blocks, device-resident IQ and controls)
under torch.profiler and prints one JSON line per demod count: the wall
time per block, the summed device kernel time per block, the device idle
share (1 - kernel time / wall time), the device kernels launched per
block and the kernels that take the most device time. The profiler slows the host, so its wall
times read above unprofiled ones. ``--plan scan58`` profiles that mixed
plan (``utils/synth.py``) instead. ``--dtype complex64`` profiles the
complex64 pipeline (no kernel of the port's own) at the same block.
``--graph`` profiles the bench's graphed step instead of the eager one:
K = 8 blocks captured once in a CUDA graph (``bench.GraphedScan``) and
replayed, so the host dispatches one replay per K blocks (planar only).

The live loop times itself: its spans and counters
(``utils/metrics.py``) are read from ``LiveReceiver.metrics.snapshot()``
and ``app/runner.py`` ``block_spans(metrics.spans)``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cubicsdr_tpu_torch.ops.planar import PC, PLANAR
from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
from cubicsdr_tpu_torch.utils.compiled import launch_counts
from cubicsdr_tpu_torch.utils.synth import demod_freqs, synth_fm

FS = 8_000_000
BLOCK = 1_024_000


DTYPES = {"planar": PLANAR, "complex64": torch.complex64}


def profile(n_demods: int, n_blocks: int, top: int = 12,
            dtype: str = "planar", graph: bool = False) -> dict:
    dev = torch.device("cuda", 0)
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, n_demods)],
                          block_len=BLOCK, device=dev, dtype=DTYPES[dtype])
    controls = rx.control_template()
    controls[0]["frequency"] = demod_freqs(n_demods)
    iq = synth_fm(demod_freqs(16), BLOCK, FS, dev, seed=3)
    return {"demods": n_demods, "dtype": dtype, "graph": graph,
            **profile_pipeline(rx, iq, controls, n_blocks, top, graph)}


def profile_plan(name: str, n_blocks: int, top: int = 12,
                 dtype: str = "planar", graph: bool = False) -> dict:
    """A named plan of ``utils/synth.py`` (scan58), built with the
    pipeline's defaults at the planar pipeline's block length, on one
    block of its capture."""
    from cubicsdr_tpu_torch.utils import synth
    plan = getattr(synth, name)()
    block_len = plan.pipeline(device="cpu").block_len
    rx = plan.pipeline(dtype=DTYPES[dtype], block_len=block_len)
    iq = plan.capture(rx.block_len, rx.device, seed=3)
    return {"plan": name, "dtype": dtype, "graph": graph,
            "demods": sum(g.count for g in plan.specs),
            "block_len": rx.block_len,
            **profile_pipeline(rx, iq, plan.controls(rx), n_blocks, top,
                               graph)}


def profile_pipeline(rx, iq, controls, n_blocks: int, top: int,
                     graph: bool = False) -> dict:
    """Profile ``rx`` stepping over the planes ``iq`` [2, block_len] with
    device-resident controls, after 3 warm-up blocks; with ``graph``, the
    bench's CUDA graph of K steps over K copies of the block, replayed
    ceil(n_blocks / K) times after one warm-up replay."""
    from cubicsdr_tpu_torch.bench import K, GraphedScan, device_controls
    controls = device_controls(controls, rx.device)
    blk = (PC(iq[0].contiguous(), iq[1].contiguous())
           if rx.dtype == PLANAR else torch.complex(iq[0], iq[1]))
    if graph:
        scan = GraphedScan(rx, rx.init_state(),
                           PC(blk.re.expand(K, -1), blk.im.expand(K, -1)),
                           controls)
        n_blocks = -(-n_blocks // K) * K
        step = scan.replay
        steps = n_blocks // K
    else:
        st = [rx.init_state()]

        def step():
            st[0], _ = rx.apply(st[0], (blk, controls))
        steps = n_blocks
    for _ in range(1 if graph else 3):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    wall_ms = wall / n_blocks * 1e3
    dev_ms, rows = _device_ms(prof, n_blocks, top)
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0)
    return {"wall_ms_per_block": wall_ms,
            "device_ms_per_block": dev_ms,
            "device_idle_share": max(0.0, 1.0 - dev_ms / wall_ms),
            "kernel_launches_per_block": launches / n_blocks,
            # The port's own kernels per block (a replay counts what its
            # graph holds).
            "port_kernel_launches_per_block": {
                k: (v - before[k]) / n_blocks
                for k, v in launch_counts().items()},
            "top": rows}


def _device_ms(prof, n_blocks: int, top: int):
    rows, dev_us = [], 0.0
    for e in prof.key_averages():
        # Kernel rows only: an aten op's row repeats its kernels' time.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
            dev_us += t
    rows.sort(reverse=True)
    return dev_us / n_blocks / 1e3, [
        {"kernel": k[:90], "ms_per_block": t / n_blocks / 1e3,
         "launches_per_block": c / n_blocks} for t, c, k in rows[:top]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demods", type=int, nargs="+", default=[16, 256])
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--plan", choices=["scan58"],
                    help="profile a mixed plan of utils/synth.py")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="planar",
                    help="the pipeline's representation")
    ap.add_argument("--graph", action="store_true",
                    help="profile the bench's CUDA graph of K steps")
    args = ap.parse_args()
    if args.graph and args.dtype != "planar":
        ap.error("--graph profiles the planar receive step only")
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    if args.plan:
        print(json.dumps(profile_plan(args.plan, args.blocks,
                                      dtype=args.dtype, graph=args.graph)),
              flush=True)
        return 0
    for n in args.demods:
        print(json.dumps(profile(n, args.blocks, dtype=args.dtype,
                                 graph=args.graph)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
