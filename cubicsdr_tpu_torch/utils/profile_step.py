"""Where the port's receive step and live loop spend their time on one
CUDA device.

    python3 -m cubicsdr_tpu_torch.utils.profile_step [--demods 16 256]
                                                     [--blocks 10] [--live]
                                                     [--plan scan58]
                                                     [--dtype complex64]

Runs ReceiverPipeline with its defaults (planar, both kernels; 8 MS/s,
FM demods, 1,024,000-sample blocks, device-resident IQ and controls)
under torch.profiler and prints one JSON line per demod count: the wall
time per block, the summed device kernel time per block, the device idle
share (1 - kernel time / wall time), the device kernels launched per
block and the kernels that take the most device time. The profiler slows the host, so its wall
times read above unprofiled ones. ``--plan scan58`` profiles that mixed
plan (``utils/synth.py``) instead. ``--dtype complex64`` profiles the
complex64 pipeline (no kernel of the port's own) at the same block.

``--live`` profiles the live loop instead (demod16, a back-pressured
cycling source, 1024-point 64-line waterfall), one line per ring format:
first an unprofiled run timed per consumer stage on the host clock (the
step, the post-step dispatch, the finish with its pull; the rest is the
wait for the staging worker), then a profiled run for device time and
idle share. Needs a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cubicsdr_tpu_torch.ops.planar import PC, PLANAR
from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
from cubicsdr_tpu_torch.utils.synth import demod_freqs, synth_fm

FS = 8_000_000
BLOCK = 1_024_000


DTYPES = {"planar": PLANAR, "complex64": torch.complex64}


def profile(n_demods: int, n_blocks: int, top: int = 12,
            dtype: str = "planar") -> dict:
    dev = torch.device("cuda", 0)
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, n_demods)],
                          block_len=BLOCK, device=dev, dtype=DTYPES[dtype])
    controls = rx.control_template()
    controls[0]["frequency"] = demod_freqs(n_demods)
    iq = synth_fm(demod_freqs(16), BLOCK, FS, dev, seed=3)
    return {"demods": n_demods, "dtype": dtype,
            **profile_pipeline(rx, iq, controls, n_blocks, top)}


def profile_plan(name: str, n_blocks: int, top: int = 12,
                 dtype: str = "planar") -> dict:
    """A named plan of ``utils/synth.py`` (scan58), built with the
    pipeline's defaults at the planar pipeline's block length, on one
    block of its capture."""
    from cubicsdr_tpu_torch.utils import synth
    plan = getattr(synth, name)()
    block_len = plan.pipeline(device="cpu").block_len
    rx = plan.pipeline(dtype=DTYPES[dtype], block_len=block_len)
    iq = plan.capture(rx.block_len, rx.device, seed=3)
    return {"plan": name, "dtype": dtype,
            "demods": sum(g.count for g in plan.specs),
            "block_len": rx.block_len,
            **profile_pipeline(rx, iq, plan.controls(rx), n_blocks, top)}


def profile_pipeline(rx, iq, controls, n_blocks: int, top: int) -> dict:
    """Profile ``rx`` stepping over the planes ``iq`` [2, block_len] with
    device-resident controls, after 3 warm-up blocks."""
    dev = rx.device
    controls = [{k: torch.as_tensor(v, device=dev) for k, v in c.items()}
                for c in controls]
    blk = (PC(iq[0].contiguous(), iq[1].contiguous())
           if rx.dtype == PLANAR else torch.complex(iq[0], iq[1]))
    st = rx.init_state()
    for _ in range(3):
        st, _ = rx.apply(st, (blk, controls))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            st, _ = rx.apply(st, (blk, controls))
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


def profile_live(ingest_dtype, n_blocks: int, top: int = 8) -> dict:
    import numpy as np

    from cubicsdr_tpu_torch.utils.synth import live_row
    dev = torch.device("cuda", 0)
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 16)],
                          use_kernels=True, block_len=BLOCK, device=dev)
    lr = live_row(rx, ingest_dtype, n_warm=8)
    spent = {"step": 0.0, "post_dispatch": 0.0, "finish": 0.0}

    def timed(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t
        return run

    lr.step = timed(lr.step, "step")
    lr._fanout_dispatch = timed(lr._fanout_dispatch, "post_dispatch")
    lr._fanout_finish = timed(lr._fanout_finish, "finish")
    t0 = time.perf_counter()
    lr.run_blocks(max_blocks=n_blocks)
    wall = time.perf_counter() - t0
    stages = {k: v / n_blocks * 1e3 for k, v in spent.items()}
    stages["other_and_staging_wait"] = (wall - sum(spent.values())
                                        ) / n_blocks * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lr.run_blocks(max_blocks=n_blocks)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    lr.stop()
    dev_ms, rows = _device_ms(prof, n_blocks, top)
    pwall_ms = pwall / n_blocks * 1e3
    return {"row": "live16", "ingest": np.dtype(ingest_dtype).name,
            "wall_ms_per_block": wall / n_blocks * 1e3,
            "host_ms_per_block_by_stage": stages,
            "profiled_wall_ms_per_block": pwall_ms,
            "device_ms_per_block": dev_ms,
            "device_idle_share": max(0.0, 1.0 - dev_ms / pwall_ms),
            "top": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demods", type=int, nargs="+", default=[16, 256])
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--live", action="store_true",
                    help="profile the live loop per ring format")
    ap.add_argument("--plan", choices=["scan58"],
                    help="profile a mixed plan of utils/synth.py")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="planar",
                    help="the pipeline's representation")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    if args.live:
        import numpy as np
        for dt in (np.float32, np.int16, np.int8):
            print(json.dumps(profile_live(dt, args.blocks)), flush=True)
        return 0
    if args.plan:
        print(json.dumps(profile_plan(args.plan, args.blocks,
                                      dtype=args.dtype)), flush=True)
        return 0
    for n in args.demods:
        print(json.dumps(profile(n, args.blocks, dtype=args.dtype)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
