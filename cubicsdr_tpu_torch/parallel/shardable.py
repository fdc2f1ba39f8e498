"""Generic time-sharding drivers for StreamOps
(``cubicsdr_tpu/parallel/shardable.py``).

When the block's time axis is split over ranks, a stage's carried state
becomes a halo: shard i needs the tail of shard i-1's input, one cyclic
permute per stage per block (``halo.py``). ``shard_stage`` drives any
StreamOp that declares the protocol of ``stream/op.py``; block-granular
EMA ops keep replicated state with collective statistics (their
``time_axis``).
"""

from __future__ import annotations

import torch

from cubicsdr_tpu_torch.ops.planar import (
    PC, pc_mul, phasor_ramp_outer, xslice)
from cubicsdr_tpu_torch.parallel.halo import streaming_halo

TWO_PI = 6.283185307179586


def shard_stage(op, carry, x, axis):
    """Run one StreamOp on a time shard. Returns (new_carry, y).

    tail ops:       carry = input-tail halo (exchanged here)
    replicated ops: carry = the op's own state (collectives inside apply)
    stateless ops:  carry = ()
    """
    kind = op.shard_kind
    if kind == "stateless":
        _, y = op.apply(op.init_state(), x)
        return (), y
    if kind == "replicated":
        return op.apply(carry, x)
    if kind == "tail":
        h = op.shard_halo_len()
        z, new_carry = streaming_halo(x, h, carry, axis)
        state = op.state_from_tail(xslice(z, slice(0, h)))
        _, y = op.apply(state, xslice(z, slice(h, None)))
        return new_carry, y
    raise NotImplementedError(
        f"{type(op).__name__} declares no time-sharding kind")


def shard_stage_carry_init(op):
    if op.shard_kind == "stateless":
        return ()
    if op.shard_kind == "replicated":
        return op.init_state()
    return op.shard_carry_init()


def shard_phase(base, omega, n):
    """Time shard t's closed-form start phase mod(base + omega * n, 2 pi),
    n = t * L, for float32 ``base`` and ``omega``: ``base + omega * n``
    rounded to float32 once, as a fused multiply-add rounds it (the JAX
    package's compiled step mostly does; in float64 the product and the
    sum are exact). Shard 0 starts at ``base`` itself, and the base's
    advance per block is rounded as the unsharded step rounds it, so a
    one-rank mesh is the unsharded pipeline."""
    return torch.remainder(
        (base.double() + omega.double() * float(n)).float(), TWO_PI)


def nco_shard_mix(base_phase, omega, x: PC, axis):
    """Planar NCO mix with closed-form phase continuity across time
    shards: shard t starts at phase base + omega * (t * L_local), and the
    base advances by a whole global block per step. No collective.

    base_phase, omega: [...] per demod; x: PC [..., L_local]. Returns
    (new_base, y)."""
    L = x.shape[-1]
    phase0 = shard_phase(base_phase, omega, axis.index * L)
    rot = phasor_ramp_outer(phase0, omega, L)
    new_base = torch.remainder(base_phase + omega * float(axis.size * L),
                               TWO_PI)
    return new_base, pc_mul(x, rot)
