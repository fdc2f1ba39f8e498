"""Rank programs for tests/test_torch_sharded.py: each runs on every rank
of a gloo CPU world (one process per rank) and imports only numpy, torch
and the port, so a rank starts in a few seconds. Rank 0 pickles the
results for the test to check. ``halo_case`` also runs on one rank in
tests/test_torch_sharded_compiled.py."""

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


def halo_step(axis):
    """A step whose state leaves go out through the halo and the permute
    and are then written over: on time shard 0 the halo is the ``tail``
    carry buffer itself; ``acc`` is sent to the next shard, then scaled
    and added to in place, returned as the new state and handed out as
    an output besides."""
    from cubicsdr_tpu_torch.parallel.halo import streaming_halo

    def step(state, inputs):
        (x,) = inputs
        z, received = streaming_halo(x, 3, state["tail"], axis)
        sent = axis.permute_prev(state["acc"])
        state["acc"].mul_(0.5).add_(z[..., :4])
        return ({"tail": received, "acc": state["acc"]},
                {"z": z, "sent": sent, "acc": state["acc"]})

    return step


def halo_case(axis, n_calls: int = 4) -> int:
    """``halo_step`` as a ``CompiledStep`` against the same step run
    eagerly (its outputs copied as they come) over ``n_calls`` blocks of
    this shard: the number of output and state leaves that differ, each
    call's outputs checked again after the next call (two slots keep
    them). On a card the same step would be captured; here the compiled
    step keeps the same buffers and runs eagerly."""
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    from cubicsdr_tpu_torch.utils.tree import tree_leaves, tree_map
    step = halo_step(axis)
    compiled = CompiledStep(step, "cpu")

    def fresh():
        return {"tail": torch.full((3,), -1.0),
                "acc": torch.arange(4, dtype=torch.float32)}

    def block(i):
        return (torch.arange(8, dtype=torch.float32)
                + 100.0 * axis.index + 1000.0 * i,)

    def differ(a, b) -> int:
        return sum(not torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    st_e, st_c, held, bad = fresh(), fresh(), None, 0
    for i in range(n_calls):
        st_e, out_e = step(st_e, block(i))
        out_e = tree_map(torch.clone, out_e)
        st_c, out_c = compiled(st_c, block(i))
        bad += differ(out_c, out_e) + differ(st_c, st_e)
        if held is not None:           # the previous call's slot
            bad += differ(*held)
        held = (out_c, out_e)
    return bad


def run_world(rank: int, nt: int, nc: int, phase: bool,
              case_path: str, out_path: str) -> None:
    """The port's ShardedReceiver(device="cpu") on an nt x nc gloo mesh,
    started from the JAX receiver's state (its global layout, which
    ``place_state`` cuts into this rank's shard), over the case's blocks,
    eagerly (``rx.step``) and then through the compiled step
    (``make_step()``) from the same state; plus the collective cases and
    ``halo_case`` on the time axis (its mismatches summed over the
    ranks)."""
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    torch.set_num_threads(1)
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    mesh = make_receiver_mesh(nt, nc, device_type="cpu")
    res = {"coord": (mesh.t, mesh.c), "collectives": collective_cases(mesh)}
    bad = torch.tensor([float(halo_case(mesh.time))])
    res["halo_case_mismatches"] = int(mesh.chan.psum(mesh.time.psum(bad)))
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
    step = rx.make_step()
    res["compiled_type"] = type(step) is CompiledStep
    state = rx.place_state(case["state"])
    outs = []
    for blk in case["blocks"]:
        state, out = step(state, (rx.shard_iq(blk), controls))
        outs.append(rx.gather_outputs(out))
    res["compiled_outs"] = outs
    res["compiled_state"] = rx.gather_state(state)
    res["compiled_state_is_buffers"] = state is step.state
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(res, f)


def rx_rank_eager(rank: int, opts: dict) -> None:
    """One rank of ``rx --mesh`` (``cli._rx_rank``) with its sharded step
    run eagerly (``make_step(compiled=False)``): what the command wrote
    before its step was compiled."""
    from cubicsdr_tpu_torch.app import cli
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    make_step = ShardedReceiver.make_step
    ShardedReceiver.make_step = (
        lambda self, compiled=True: make_step(self, compiled=False))
    cli._rx_rank(rank, opts)
