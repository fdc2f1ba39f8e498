"""Multi-rank dry run of the sharded receiver (the port's counterpart of
the JAX package's ``__graft_entry__.dryrun_multichip``): one full sharded
MIXED-modem step (FM + AM + BPSK) over a ('time' x 'chan') mesh of local
ranks on tiny shapes — the channelizer's halo exchange, chan-sharded
heterogeneous demod groups, the squelch collectives and the summed mix —
with the reference's shape checks on the gathered outputs. The one step
runs eagerly (``rx.step``), where the JAX dry run jits it: a shape check
of one block gains nothing from two warm-ups and a capture, and the
compiled step's own checks are ``rx --mesh``, ``multihost`` and the
scaling harness.

    python -m cubicsdr_tpu_torch.parallel.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _dryrun_rank(rank, device: str, report_path: str) -> None:
    import torch.distributed as dist
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.multihost import rank_device
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec

    n = dist.get_world_size()
    dev = rank_device(device)
    n_chan = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_receiver_mesh(n_time=n // n_chan, n_chan=n_chan,
                              device_type=dev.type)
    fs = 1_000_000
    groups = [DemodGroupSpec("FM", 200000, 2 * n_chan),
              DemodGroupSpec("AM", 6000, n_chan),
              DemodGroupSpec("BPSK", 20000, n_chan)]
    rx = ShardedReceiver(fs, 8, groups, mesh=mesh, block_len=None,
                         device=dev)
    rng = np.random.default_rng(0)
    iq = rx.shard_iq((rng.standard_normal(rx.block_len)
                      + 1j * rng.standard_normal(rx.block_len))
                     .astype(np.complex64))
    controls = rx.control_template()
    controls[0]["frequency"] = np.linspace(
        -fs / 4, fs / 4, groups[0].count).astype(np.float32)
    controls[1]["frequency"] = np.full(groups[1].count, 120e3, np.float32)
    controls[2]["frequency"] = np.full(groups[2].count, -200e3, np.float32)
    state, outs = rx.step(rx.init_state(), iq, rx.place_controls(controls))
    out = rx.gather_outputs(outs)            # a collective: every rank
    la = rx.nt * rx.local_audio_len
    fm, bpsk = out["groups"][0], out["groups"][2]
    if out["mix"].shape != (2, la):
        raise AssertionError(f"mix {out['mix'].shape}, expected (2, {la})")
    if fm["audio"].shape != (groups[0].count, 1, la):
        raise AssertionError(f"FM audio {fm['audio'].shape}")
    if bpsk["symbols"].shape[0] != groups[2].count:
        raise AssertionError(f"BPSK symbols {bpsk['symbols'].shape}")
    if not np.isfinite(out["mix"]).all():
        raise AssertionError("non-finite mix")
    if rank == 0:
        with open(report_path, "w") as f:
            json.dump({"ranks": n, "time": rx.nt, "chan": rx.nc,
                       "backend": dist.get_backend(),
                       "block_len": rx.block_len,
                       "mix": list(out["mix"].shape),
                       "fm_audio": list(fm["audio"].shape),
                       "bpsk_symbols": list(bpsk["symbols"].shape)}, f)


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> dict:
    """One sharded FM + AM + BPSK step on ``n_ranks`` local ranks (a
    time x chan mesh, chan = 2 for an even count above 1), one process
    each: NCCL on the card, one rank per GPU; gloo on CPU ranks. Raises
    if a shape is wrong; returns rank 0's report and prints its line."""
    from cubicsdr_tpu_torch.parallel.multihost import spawn_collect
    rep = spawn_collect(_dryrun_rank, n_ranks, (device,), device)
    print(f"dryrun_multichip: {rep['ranks']} ranks (time={rep['time']} x "
          f"chan={rep['chan']}, {rep['backend']}), block "
          f"{rep['block_len']} -> mix {tuple(rep['mix'])}, FM audio "
          f"{tuple(rep['fm_audio'])}, BPSK syms "
          f"{tuple(rep['bpsk_symbols'])} OK")
    return rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    dryrun_multichip(a.n_ranks, a.device)
