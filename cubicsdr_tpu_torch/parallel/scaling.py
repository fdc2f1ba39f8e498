"""Weak-scaling harness (``cubicsdr_tpu/parallel/scaling.py``): the
sharded receiver's samples/s at 1 -> N ranks on the 'time' axis.

Per-rank work stays constant (``demods_per_chip`` FM rows, a fixed
per-shard block), so ideal scaling keeps each rank's rate and the
aggregate grows N-fold; ``efficiency`` is the aggregate rate over N times
the one-rank rate. Each device count runs in a world of its own (one
process per rank, ``multihost.spawn_collect``). On CPU ranks (gloo) the
rows check the machinery: the ranks share one host's cores. On the card
a world that fits the cards runs NCCL; a larger one shares them only when
the caller asks for ``host_collectives`` (gloo on host copies, as
``multihost --host-collectives``), and its rate is bound by those copies.

    python -m cubicsdr_tpu_torch.parallel.scaling [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _default_counts(device: str) -> list[int]:
    have = (torch.cuda.device_count() if device == "cuda"
            else min(8, os.cpu_count() or 1))
    return [n for n in (1, 2, 4, 8, 16, 32) if n <= have]


def _scaling_rank(rank, cfg: dict, report_path: str) -> None:
    """One rank of one world: build the sharded FM farm, run warm-up and
    timed steps on this rank's span, and (rank 0) write the row."""
    import torch.distributed as dist
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.multihost import rank_device
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec

    n = dist.get_world_size()
    dev = rank_device(cfg["device"])
    mesh = make_receiver_mesh(n_time=n, n_chan=1, device_type=dev.type,
                              host_collectives=cfg["host_collectives"])
    fs = cfg["sample_rate"]
    block_len = (cfg["per_shard_len"] * n if cfg["per_shard_len"]
                 else None)
    rx = ShardedReceiver(fs, cfg["num_channels"],
                         [DemodGroupSpec("FM", 200000,
                                         cfg["demods_per_chip"])],
                         mesh=mesh, block_len=block_len, device=dev)
    rng = np.random.default_rng(0)
    iq = rx.shard_iq((rng.standard_normal(rx.block_len)
                      + 1j * rng.standard_normal(rx.block_len))
                     .astype(np.complex64))
    controls = rx.control_template()
    controls[0]["frequency"] = np.linspace(
        -fs / 4, fs / 4, rx.n_demods).astype(np.float32)
    controls = rx.place_controls(controls)
    state = rx.init_state()

    def settle():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    for _ in range(cfg["warmup"]):
        state, outs = rx.step(state, iq, controls)
    settle()
    t0 = time.perf_counter()
    for _ in range(cfg["n_iters"]):
        state, outs = rx.step(state, iq, controls)
    settle()
    dt = time.perf_counter() - t0
    if not torch.isfinite(outs["mix"]).all():
        raise AssertionError("non-finite mix in the scaling run")
    if rank == 0:
        with open(report_path, "w") as f:
            json.dump({"devices": n, "block_len": rx.block_len,
                       "msps": rx.block_len * cfg["n_iters"] / dt / 1e6,
                       "backend": dist.get_backend(),
                       "host_collectives": cfg["host_collectives"]}, f)


def measure_scaling(sample_rate: float = 2_400_000, num_channels: int = 16,
                    demods_per_chip: int = 16,
                    device_counts: list[int] | None = None,
                    per_shard_len: int | None = None,
                    n_iters: int = 10, warmup: int = 2,
                    device: str = "cuda",
                    host_collectives: bool = False) -> dict:
    """Weak scaling: per-rank work constant (``demods_per_chip`` rows, a
    fixed per-shard block), ranks on the 'time' axis, one world per count
    in ``device_counts`` (default: the powers of two up to the cards, or
    up to 8 CPU ranks). ``host_collectives`` lets a world that outnumbers
    the cards share them (gloo on host copies); worlds that fit the cards
    run NCCL either way. Returns {"metric", "rows"}: each row has
    devices, block_len, msps (aggregate Msamples/s), efficiency (msps
    over devices times the first row's), backend and host_collectives."""
    from cubicsdr_tpu_torch.parallel.multihost import spawn_collect
    if device_counts is None:
        device_counts = _default_counts(device)
    rows = []
    for n in device_counts:
        hc = bool(host_collectives and device == "cuda"
                  and n > torch.cuda.device_count())
        cfg = dict(device=device, host_collectives=hc,
                   sample_rate=float(sample_rate),
                   num_channels=int(num_channels),
                   demods_per_chip=int(demods_per_chip),
                   per_shard_len=per_shard_len, n_iters=int(n_iters),
                   warmup=int(warmup))
        rows.append(spawn_collect(_scaling_rank, n, (cfg,), device,
                                  host_collectives=hc))
    base = rows[0]["msps"] / rows[0]["devices"]
    for r in rows:
        r["efficiency"] = r["msps"] / (base * r["devices"])
    return {"metric": "sharded_fm_farm_weak_scaling", "rows": rows}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--counts", default=None,
                    help="comma-separated rank counts (default: all)")
    ap.add_argument("--host-collectives", action="store_true")
    a = ap.parse_args(argv)
    counts = ([int(c) for c in a.counts.split(",")] if a.counts else None)
    print(json.dumps(measure_scaling(device_counts=counts, device=a.device,
                                     host_collectives=a.host_collectives),
                     indent=2))


if __name__ == "__main__":
    main()
