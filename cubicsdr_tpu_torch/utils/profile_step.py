"""Where the port's receive step spends its time on one CUDA device.

    python3 -m cubicsdr_tpu_torch.utils.profile_step [--demods 16 256]
                                                     [--blocks 10]

Runs ReceiverPipeline(use_kernels=True) (8 MS/s, FM demods, 1,024,000-
sample blocks, device-resident IQ and controls) under torch.profiler and
prints one JSON line per demod count: the wall time per block, the summed
device kernel time per block, the device idle share (1 - kernel time /
wall time) and the kernels that take the most device time. The profiler
slows the host, so its wall times read above unprofiled ones. Needs a
CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cubicsdr_tpu_torch.ops.planar import PC
from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
from cubicsdr_tpu_torch.utils.synth import demod_freqs, synth_fm

FS = 8_000_000
BLOCK = 1_024_000


def profile(n_demods: int, n_blocks: int, top: int = 12) -> dict:
    dev = torch.device("cuda", 0)
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, n_demods)],
                          use_kernels=True, block_len=BLOCK, device=dev)
    controls = rx.control_template()
    controls[0]["frequency"] = demod_freqs(n_demods)
    controls = [{k: torch.as_tensor(v, device=dev) for k, v in c.items()}
                for c in controls]
    iq = synth_fm(demod_freqs(16), BLOCK, FS, dev, seed=3)
    blk = PC(iq[0].contiguous(), iq[1].contiguous())
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
    rows = []
    dev_us = 0.0
    for e in prof.key_averages():
        # Kernel rows only: an aten op's row repeats its kernels' time.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
            dev_us += t
    rows.sort(reverse=True)
    wall_ms = wall / n_blocks * 1e3
    dev_ms = dev_us / n_blocks / 1e3
    return {"demods": n_demods, "wall_ms_per_block": wall_ms,
            "device_ms_per_block": dev_ms,
            "device_idle_share": max(0.0, 1.0 - dev_ms / wall_ms),
            "top": [{"kernel": k[:90], "ms_per_block": t / n_blocks / 1e3,
                     "launches_per_block": c / n_blocks}
                    for t, c, k in rows[:top]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demods", type=int, nargs="+", default=[16, 256])
    ap.add_argument("--blocks", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    for n in args.demods:
        print(json.dumps(profile(n, args.blocks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
