"""Rank programs for tests/test_torch_sharded.py: each runs on every rank
of a gloo CPU world (one process per rank) and imports only numpy, torch
and the port, so a rank starts in a few seconds. Rank 0 pickles the
results for the test to check."""

from __future__ import annotations

import pickle

import numpy as np
import torch

FS = 1_000_000
# Each group's demod frequency (Hz): FM, AM and BPSK as
# tests/test_parallel.py; CW on the carrier at -300 kHz, USB 500 Hz under
# the AM station's carrier, I/Q 1 kHz above the carrier.
FREQS = (150e3, 120e3, -300e3, -300e3, 119.5e3, -299e3)


def groups(nc: int, phase: bool = False):
    """FM + AM + BPSK, as tests/test_parallel.py; with ``phase`` also CW,
    USB and I/Q, whose audio follows the carrier's phase (I/Q on the
    gather path: no fused tile exists for its 24/125 stage)."""
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    g = [DemodGroupSpec("FM", 200000, 2 * nc),
         DemodGroupSpec("AM", 6000, nc),
         DemodGroupSpec("BPSK", 20000, nc)]
    if phase:
        g += [DemodGroupSpec("CW", 500, nc), DemodGroupSpec("USB", 6000, nc),
              DemodGroupSpec("I/Q", 48000, nc)]
    return g


def collective_cases(mesh) -> dict:
    """The halo exchange (cyclic and streaming) and the axis collectives
    on this rank's shard of arange(8 * nt)."""
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.parallel.halo import streaming_halo, with_halo
    ta, ca = mesh.time, mesh.chan
    x = torch.arange(8 * ta.index, 8 * ta.index + 8, dtype=torch.float32)
    carry = PC(torch.full((3,), -1.0), torch.full((3,), -2.0))
    z, recv = streaming_halo(PC(x, -x), 3, carry, ta)
    v = torch.tensor([float(ta.index + 1), float(ca.index)])
    return {"with_halo": with_halo(x, 3, ta).numpy(),
            "streaming": (z.re.numpy(), z.im.numpy()),
            "received": (recv.re.numpy(), recv.im.numpy()),
            "psum": ta.psum(v).numpy(), "pmax": ta.pmax(v).numpy(),
            "pmean": ta.pmean(v).numpy(),
            "gather": ta.all_gather(v).numpy(),
            "chan_psum": ca.psum(v).numpy()}


def run_world(rank: int, nt: int, nc: int, phase: bool,
              case_path: str, out_path: str) -> None:
    """The port's ShardedReceiver(device="cpu") on an nt x nc gloo mesh,
    started from the JAX receiver's state (its global layout, which
    ``place_state`` cuts into this rank's shard), over the case's blocks;
    plus the collective cases."""
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    torch.set_num_threads(1)
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    mesh = make_receiver_mesh(nt, nc, device_type="cpu")
    res = {"coord": (mesh.t, mesh.c), "collectives": collective_cases(mesh)}
    rx = ShardedReceiver(FS, 8, groups(nc, phase), mesh=mesh, device="cpu",
                         block_len=case["block_len"])
    res["fused_route"] = rx.fused_route
    state = rx.place_state(case["state"])
    controls = rx.place_controls(case["controls"])
    outs = []
    for blk in case["blocks"]:
        state, out = rx.step(state, rx.shard_iq(blk), controls)
        outs.append(rx.gather_outputs(out))
    res["outs"] = outs
    res["state"] = rx.gather_state(state)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
