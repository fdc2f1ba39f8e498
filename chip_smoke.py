#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cubicsdr_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:

1. the card (``nvidia-smi`` name and power limit) and the torch build;
2. build of both CUDA kernels from ``cubicsdr_tpu_torch/csrc/*.cu`` into
   ``cubicsdr_tpu_torch/_build/``, with ptxas's registers, stack and
   spills per kernel instance, and which ring backend the live loop runs
   (the port's own native ring, or its numpy path);
3. each kernel vs its plain PyTorch version on the card at the main
   path's shapes (PFB at M=16 over a 1,024,000-sample block, in the FFT
   form; at M=6, and at M=10 with an odd step count and parity, in the
   register DFT form; at M=20 and M=40 over the same block (10 and 20
   MS/s sources) in the product form; at M=64 in the FFT form; and with
   12 taps per branch in the product form; route 1/5
   at 16 and 256 demods over 128,000-sample channels, and 2/5, 1/4 and
   3/5 at 16, the last on the kernel's runtime-length tap loop, 1/40 at
   NBFM's shape, whose residues 16 thread groups split, and 1/128, whose E
   table does not fit and is computed in each pass; then scan58's new
   shapes over 256,000-sample channels: AM's 3/50 at O=384 (runtime tap
   loop, 5 residue groups) at 16 demods and CW/BPSK's 1/50 with 1,249
   taps at 4 and 16), each with
   its device time warm (8 calls on one buffer set in a CUDA graph, the
   buffers L2-resident) and cold (a graph over distinct buffer sets totalling
   150 MB, 3x the L2), its bound (bytes over 3.35 TB/s or FLOPs over
   67 TFLOP/s f32, whichever is larger, from the shapes; the PFB's
   transform counted as an M-point FFT for every M) and the share of
   the bound the cold time reaches (a share above 1 fails the script);
4. the main path — ReceiverPipeline(use_kernels=True) at 8 MS/s with 16
   FM demods and 1,024,000-sample blocks (the JAX package's demod16
   bench shape), 3 blocks of synthesised FM stations on the device —
   checked against the same pipeline on the CPU (the kernels' plain
   versions), for the kernels' launch counts, and for a recovered tone;
5. main-path throughput with device-resident IQ at 16 and 256 demods,
   with the kernels and with their plain versions;
6. scan58 (``utils/synth.py``: 8 MS/s, M=16, 58 demods in six groups,
   FM, NBFM, AM, CW, BPSK and FM-stereo, every group on the fused route
   kernel, 2,048,000-sample blocks), built with the pipeline's defaults,
   3 blocks of a capture with a station under every demod, against the
   same plan on the CPU: iq taps, mix and audio, levels at the main
   path's gates, digital symbols equal wherever the CPU slicer's margin
   between its two best scores is at least 1e-5, 3 PFB and 18 route
   launches, and a tone above 40 dB through FM, NBFM and AM row 0;
7. the coverage plans (2 demods per group, 2 blocks each) against the
   CPU: I/Q with the nine constellation modems, DSB/USB/LSB and
   FSK/GMSK (the last two plans on the gather path), so that every
   registered modem runs on the card;
8. the live loop on scan58's 3 blocks, on the card and the CPU: digital
   symbols reach ``on_block`` as int32 and agree, mixes agree, both
   kernels launch per block (the loop is compiled: its step replays a
   CUDA graph per block, and the step's build adds two eager warm-up
   calls, whose launches count too); then scan58's throughput row;
9. the live loop (``app.runner.LiveReceiver``: ring -> staged host->device
   copy -> step -> packed post-step -> one device->host pull; compiled,
   the step and post-step CUDA graph replays) at the same
   demod16 width: 6 blocks of the 16-station signal with two demods
   recording, a subset audio sink, the demod view on one row, the zoom
   view at +1 MHz / 1 MHz and a 1024-point, 64-line waterfall, checked
   against the same live loop on the CPU (WAVs and mix at the pipeline
   tolerances, waterfall lines at 2e-3, lines per block exactly), for
   both kernels' launch counts (6 replays and 2 warm-ups each), no view
   or sink error and no ring drop;
10. a checkpoint of the live loop's state after 3 blocks, saved, loaded
   into a fresh receiver and run over blocks 4-6: its audio equals the
   uninterrupted run's within 1e-6;
11. compiled live-loop throughput (the JAX package's ``bench.py`` live
   rows: a cycling source with back-pressure, 8 warm-up and 40 timed
   blocks) with float32, int16 and int8 ring formats;
12. the route kernel at the first stages only the critically sampled
   'pfbch' channelizer fuses, over 128,000-sample channels: BPSK's 1/25
   at 4 demods (its plan fills 219 KB of shared memory), FM-stereo's 1/2
   at 2, and 2.4 MS/s FM-stereo's 5/8 at O=640 at 2 over 6 channels,
   each against its plain version with cold, warm, bound and share as in
   phase 3;
13. the CLI on the card, in process (``app.cli.main``), on a synthesised
   8 MS/s cf32 capture of scan58's band (3 blocks): ``demod`` FM, NBFM
   and AM, ``rx`` on a saved session of scan58's 58 demods, ``waterfall``,
   ``rx --channelizer pfbch`` and ``demod --channelizer single``, each
   against the same command with ``--device cpu`` (WAVs at the audio
   gates, waterfall lines as drawn, clipped to [0, 1], at 2e-3, NaN at
   the same points), a tone above 40 dB through FM, NBFM
   and AM, and the launches: 1 PFB + 6 route per scan58 block with
   'pfbch2', 0 + 6 with 'pfbch', neither with 'single' (``demod``, ``rx``
   and ``waterfall`` replay a compiled step per block: one block's worth
   more for each of its build's two warm-ups);
14. ``serve`` on the card: a ``WebViewer`` on an ephemeral port around a
   card ``LiveReceiver`` carrying scan58's session over the looped
   capture, driven block by block: GET /api/state, /api/spectrum and
   /api/waterfall.png; POST add (an NBFM demod), set bandwidth, set type
   and remove, each a plan rebuild after which both kernels launch on the
   next block (a new plan's first block builds its compiled step; the
   remove returns to the first plan, whose cached step replays); the mix
   and three surviving demods' audio against the same sequence on a CPU
   harness; the ms from each POST to the end of the first block on the
   new plan, and the capture's ms inside it; 0 ring drops.

15. the route kernel's streaming plan (one tile per batch, the window's
   residue rows read from global memory and the taps staged per pass) at
   the stage shapes no resident plan fits, over the channel lengths the
   pipeline gives them: 3/307 (NBFM 5 kHz at 1.024 MS/s), 1/467 and 2/467
   (NBFM at 1.4 MS/s), 2/3413 (NBFM 500 Hz at 2.56 MS/s) and 4/317 (the
   digital modems at 30.72 MS/s), 16 demods each, against the plain
   version with cold, warm, bound and share as in phase 3;
16. the PFB kernel at M = 140 and 246 (70 and 122.88 MS/s captures: one
   staged window, F tiled over blocks of output channels), likewise;
17. ``demod`` on the card against ``--device cpu`` at those shapes: NBFM
   5 kHz on a 1.024 MS/s capture and FM on a 70 MS/s capture (M=140),
   WAVs at the audio gates, a tone, one PFB and one route launch per
   block;
18. ``parallel.ShardedReceiver`` on a 1x1 mesh under NCCL, with its
   defaults (the card, both kernels), on scan58 over 3 blocks against the
   unsharded card pipeline at the pipeline's gates, 1 PFB and 6 route
   launches per block; then its compiled step (``make_step()``: two
   warm-ups, one CUDA graph per output slot, the JAX package's jitted
   ``make_step``) over the same blocks against the eager sharded step,
   bit for bit on every output and state leaf, 1 PFB and 6 route
   launches per replay; then ms per block and MS/s in turns: the
   unsharded step eager and compiled (one graph per block, as the
   CLI's), the sharded step eager and compiled; then ``rx --mesh
   "time=1,chan=1"`` (one spawned NCCL rank running the compiled sharded
   step) on the card against the same command with ``--device cpu``
   (one gloo rank) on a 3-block scan58 capture, its WAV at the audio
   gates, with the wall time of each;
19. ``multihost`` with 2 worker processes on the one card (time=2; NCCL
   takes one rank per GPU, so the phase asks for host collectives: gloo
   on host copies), scan58, each rank verified against the unsharded
   pipeline it computes, and a timed phase, bound by those copies; each
   report says ``"compiled": false`` (no graph holds a host copy);
19b. on a host with four cards or more, ``multihost`` with 4 worker
   processes, one card each, under NCCL (time=4): scan58 at 8,192,000
   samples per block (2,048,000 per rank), 3 verified steps and 8 timed,
   each rank verified against the unsharded pipeline on its own card,
   ``"compiled": true`` (its NCCL collectives inside its CUDA graphs)
   and 1 PFB + 6 route launches per step besides its build's two
   warm-ups; each rank's aggregate MS/s, ingest share and wall seconds
   per part. On fewer cards one line says that it did not run and why;
20. the complex64 pipeline (``dtype=torch.complex64``, whose default
   ``use_kernels=None`` resolves to no kernel, as the JAX package's
   complex64 path runs no Pallas kernel) on the card at demod16 and at
   scan58 (its planar block, 2,048,000 samples), 3 blocks each: against
   the same complex64 pipeline on the CPU at the main path's gates,
   against the planar card pipeline with both kernels at
   tests/test_unified_pipeline.py's gates (audio and mix atol 2e-3 /
   rtol 2e-3, level 0.1; CW, whose audio follows the carrier phase that
   the complex64 path's float32 ramp rounds, by each row's rms within
   1e-3 and magnitude spectrum within 1e-2 (relative), with the carrier
   rotation between the two steps' iq taps recorded, and the same step
   with its CW beep offset by 0.5% shown to fail that gate in every
   block), a tone above 40 dB through FM, NBFM and AM,
   zero PFB and route launches where the planar run shows its own (3 + 3
   for demod16, 3 + 18 for scan58), ``use_kernels=True`` refused; then
   the planar and complex64 steps' MS/s at both widths, in turns
   (planar, complex64, complex64, planar);
21. complex64 in the 'pfbch' and 'single' channel modes on the coverage
   plans (every modem scan58 does not run), 2 blocks each, against the
   CPU, with no kernel launch;
22. the live loop around the complex64 demod16 pipeline (float32 ring
   assembled as complex64 in the step, 6 blocks, two recording demods, a
   subset sink, the demod view, the zoom view at +1 MHz / 1 MHz, a
   1024-point waterfall) against the same loop on the CPU, no kernel
   launch and no ring drop; then a planar card loop swapped mid-stream
   to the complex64 plan and back, eager and compiled: every block
   reaches each step in that step's representation (compiled, each
   plan's apply runs only in its build, and the return replays the
   cached planar step), the kernels launch on the planar blocks only,
   no block is dropped;
23. ``parallel.dryrun.dryrun_multichip(1, "cuda")`` (one NCCL rank: a
   mixed FM + AM + BPSK sharded step with the reference's shape checks)
   and ``parallel.scaling.measure_scaling`` over 1 rank (NCCL, the
   compiled sharded step) and 2 ranks sharing the card (host
   collectives, gloo on host copies, the eager step), with the rows
   printed;
24. the bench's CUDA graph of K = 8 receive steps
   (``cubicsdr_tpu_torch.bench.GraphedScan``, the counterpart of the JAX
   bench's ``jit`` + ``lax.scan``) at demod16, demod256 and scan58 (its
   six modem kits in one graph), each on 8 blocks of a capture with
   stations under the demods: two replays against 2K eager steps from
   the same state, mix, levels, every digital group's symbols and every
   leaf of the final state within 1e-6, and the capture's launches (the
   PFB K times, the route kernel K times per fused group; the kernels
   line reports them per block); then
   ``bench.main`` for the demod16, demod256, live16, live16_int16 and
   live16_int8 rows (graphed and eager MS/s with their medians and
   spreads over 5 windows, 0 ring drops), printed as they come; the
   device idle share of demod16, demod256 and scan58, graphed and eager:
   1 - the profiled device kernel ms per block (``profile_step``, with
   ``graph=True`` for the graph) over the unprofiled wall ms per block;
   and ``entry.entry()`` on the card against ``entry("cpu")`` at the
   pipeline's gates, with one PFB and one route launch.

25. the compiled against the eager live loop, in turns (windows of 10
   blocks: compiled, eager, eager, compiled, ... after 8 each, then one
   profiled window each), on live16 (the demod view and the zoom view
   on) and scan58 (the demod view on a BPSK row), each receiver fed the
   same cycled blocks with back-pressure: every host output of every
   block (mix, levels, symbols), the waterfall and the views bit for bit,
   MS/s, ms per block, drops, launches and the card's idle share (1 -
   profiled device ms over unprofiled wall ms per block) of each;
26. every modem captured: ``apply`` as a ``CompiledStep`` against itself
   eagerly, bit for bit on every output and the final state over 3
   blocks (2 for the coverage plans): demod16 and scan58 with 'pfbch2',
   'pfbch' and 'single', the coverage plans, demod16 and scan58 in
   complex64, and the live loop's int16 and int8 ingest steps; each
   slot's graph launches the kernels as one eager block does;
27. churn on the card: tests/test_churn.py's REST adversary against a
   compiled live loop carrying scan58's session, a producer at the
   capture rate (8 MS/s) carrying the survivor's (FM row 0) station,
   a checkpoint and restore, then three cycles of the same plan edits:
   per edit that rebuilds the plan its POST ms, the ms to the first
   block on the new plan, whether a step was built and its capture ms,
   ``memory_reserved`` and ``memory_allocated``; the consumer alive, 0
   drops, the survivor's tone in all but one 250 ms window, compiled
   steps no more than distinct plans and none built in the last cycle,
   ``memory_reserved`` no higher in the last cycle than in the one
   before.

28. the compiled zoom view (each zoom level a ``CompiledStep``, built
   by ``set_zoom`` and, for the levels one step away, a background
   thread): on live16 (the demod view on row 4) the compiled loop with
   the compiled zoom and the eager loop with the eager zoom in turns
   over a walk (+1 MHz at 1 MHz, 500 kHz, 250 kHz, a retune to +1.2
   MHz, back to 1 MHz and on to 2 MHz, 3 blocks each), every block's
   zoom points, the view they show and the lines drawn bit for bit,
   each level built once and the revisit building nothing; live16 with
   both views in turns, compiled zoom against eager zoom in a compiled
   loop (ms per block, MS/s, drops, idle share); the zoom gap with a
   producer at the capture rate (8 MS/s): the ms from ``set_zoom`` to
   the first block showing the new view for a new view, a prewarmed
   adjacent level, a retune and a cold level (its build split into
   warm-ups and captures), the longest consumer block while a
   background build ran, 0 drops; ``memory_reserved`` and
   ``memory_allocated`` per level over the 15 reachable levels at
   live16's and scan58's blocks; the walk on scan58's block (1 MHz,
   500 kHz, back to 1 MHz) and its zoom gap (a new view, a prewarmed
   level, a cold level; the longest consumer block at its 256 ms
   period while a background build ran, 0 drops).

29. the port's evidence modes (``cubicsdr_tpu_torch/utils/soak.py``, in
   process, each with the kernels' counters set to 0 just before it and
   read just after, both kernels launched): ``churn_soak`` for 2 minutes
   on the ``serve`` shape (2.4 MS/s cs16, M=6, the block length pinned
   over the four plans its cycle visits; two warm cycles, then REST
   cycles of 15 control ops, a checkpoint and a restore), ``soak`` at
   4.8 MS/s cs8 for 1 minute and ``digital_check`` (FM, QPSK, QAM-16,
   QAM-256, APSK-16 and GMSK at 8 MS/s against the CPU's unfused chain),
   each failing the script when it misses its criteria (the churn soak:
   no consumer exception, 0 drops, 0.98x real time, the survivor's tone
   in all but one 250 ms window, an RSS slope under 0.5 MiB/min and no
   higher ``memory_reserved`` in the last third than in the first; the
   soak: 0 drops and 0.98x real time; the digital check: agreement >=
   0.999 on decision-stable samples, EVM delta < 0.02, stable fraction >
   0.5 per modem, the FM tone within 5 Hz of 1 kHz).

Then (30) one JSON line describing the kernels (launches on the demod16
main path and on every other path, the CLI's, serve's, the sharded
(eager and compiled) and the multihost ranks' (the four-card job's
where it ran), the complex64 paths'
(zero), the graph
captures' (per block), the compiled/eager turns', the captures' (per
replay), the churn run's, the zoom phase's and the evidence modes'
included, error, cold/warm/plain ms, bound, roofline share, every case;
no single PyTorch call computes either function, so ``library_ms`` is
null),
and as the last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0)
and no result line is printed. There is no CPU fallback: without a CUDA
device the script fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

FS = 8_000_000
BLOCK = 1_024_000
PFB_ATOL = 2e-4
ROUTE_ATOL = 5e-5
SCAN_CHAN = 256_000     # scan58's channel length: 2,048,000 / (16 / 2)
LIVE_BLOCKS = 6
WF_ATOL = 2e-3          # spectrum points (tests/test_planar_spectrum.py)
RESUME_ATOL = 1e-6      # checkpoint resume (tests/test_checkpoint.py:50)
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate and f32
# outside the tensor cores. Cold timing moves 3x the 50 MB L2 per replay.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
COLD_BYTES = 150_000_000
CENTER = 100e6          # the CLI and serve phases' capture centre
LIBRARY_NOTE = {
    "pfbch2_planar": "none: no single PyTorch call computes a polyphase "
                     "FIR, an M-point transform and the parity flip",
    "routed_shifted_resample": "none: no single PyTorch call computes a "
                               "channel gather, a modulation and a strided "
                               "polyphase resample"}


def line(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, copies: int = 8) -> float:
    """Warm device milliseconds of one ``fn()``: ``copies`` calls on the
    same buffers captured in one CUDA graph and replayed between two CUDA
    events, so host dispatch and the graph's own replay cost stay out of
    the per-call time and the buffers stay in L2 when they fit."""
    return graph_ms([fn] * copies, reps=5)


def graph_ms(calls, bursts: int = 5, reps: int = 20) -> float:
    """Device milliseconds per call of ``calls`` (a list of thunks),
    captured in order in one CUDA graph, replayed between CUDA events;
    the median over ``bursts`` bursts of ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                    # warm-up outside the graph
            for fn in calls:
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph, keep = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for fn in calls:
            keep.append(fn())                 # distinct outputs per call
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps / len(calls))
    return float(np.median(times))


def cold_ms(make_call, set_bytes: int) -> tuple[float, int]:
    """Cold-L2 device milliseconds of one call: ``make_call(i)`` returns a
    thunk over the i-th of k distinct input sets (each call allocates its
    own outputs), k chosen so the sets' inputs and outputs together pass
    COLD_BYTES (3x the 50 MB L2); the k calls are captured in one CUDA
    graph, replayed between CUDA events, and the time divided by k.
    Returns (ms, k)."""
    k = max(2, -(-COLD_BYTES // set_bytes))
    return graph_ms([make_call(i) for i in range(k)], reps=5), k


def roofline(flops: float, nbytes: float, ms: float) -> dict:
    """The least time the card could take (the larger of bytes over HBM
    rate and FLOPs over f32 CUDA-core peak), what sets it, and the share
    of it that ``ms`` reaches; a share above 1 is a counting or timing
    fault and fails the script."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_flops)
    share = bound / ms
    if not share <= 1.0:
        raise AssertionError(f"roofline share {share} > 1: bound {bound} ms"
                             f" vs measured {ms} ms")
    return {"flops": flops, "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "roofline_share": share,
            "achieved_gb_per_s": nbytes / ms / 1e6,
            "achieved_tflop_per_s": flops / ms / 1e9}


def max_err(got, ref) -> float:
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev)


def check_pfb(dev, M: int, n_steps: int, parity: int, rng,
              J: int = 8) -> dict:
    """PFB kernel vs plain version on the card, warm and cold times, and
    the roofline of the case."""
    from cubicsdr_tpu_torch.ops.channelizer import ChannelizerPFB2
    from cubicsdr_tpu_torch.ops.kernels.pfb import (
        pfb_form, pfb_plan, pfbch2_planar, pfbch2_planar_plain)
    ch = ChannelizerPFB2(M, taps_per_channel=J).to(dev)
    z_len = ch.hist_len + n_steps * ch.D
    par = torch.tensor(parity, dtype=torch.int32, device=dev)
    consts = (ch.h_poly, ch.w_re, ch.w_im, ch.c_re, ch.c_im, par)
    planes = [(randn(rng, z_len, dev), randn(rng, z_len, dev))]
    got = pfbch2_planar(*planes[0], *consts)
    ref = pfbch2_planar_plain(*planes[0], *consts)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    if not err <= PFB_ATOL:
        raise AssertionError(f"PFB M={M}: kernel vs plain max err {err}")
    nbytes = 4 * (2 * z_len + 2 * M * n_steps + M * ch.J)
    # Per step: the FIR (2 planes x M*J FMAs, 2 flops each), then the
    # transform as the function needs it, whatever form the kernel
    # computes: an M-point FFT, 5 M log2 M flops (radix 2: (M/2) log2 M
    # butterflies of a complex product and two complex sums; the same
    # count stands for mixed radix), and c_k (6 flops per output).
    form = pfb_form(M, ch.J)
    transform = 5 * M * math.log2(M) + 6 * M
    flops = int((4 * M * ch.J + transform) * n_steps)

    def make(i):
        while len(planes) <= i:
            planes.append((randn(rng, z_len, dev), randn(rng, z_len, dev)))
        zr, zi = planes[i]
        return lambda: pfbch2_planar(zr, zi, *consts)

    cold, k = cold_ms(make, nbytes)
    return {"M": M, "J": ch.J, "n_steps": n_steps, "parity": parity,
            "form": form,
            "steps_per_tile": pfb_plan(M, ch.J)[0],
            "f_rows_per_fold": pfb_plan(M, ch.J)[3], "max_abs_err": err,
            "warm_ms": cuda_ms(make(0)), "cold_ms": cold, "cold_sets": k,
            "plain_ms": cuda_ms(lambda: pfbch2_planar_plain(*planes[0],
                                                            *consts)),
            **roofline(flops, nbytes, cold)}


def check_route(dev, P: int, Q: int, N: int, chan_len: int, rng,
                M: int = 16) -> dict:
    """Route kernel vs plain version, warm and cold times, roofline."""
    from cubicsdr_tpu_torch.ops.kernels.route import (
        _tables, choose_fused_tile, route_plan, route_taps,
        routed_shifted_resample, routed_shifted_resample_plain)
    from cubicsdr_tpu_torch.ops.resample import RationalResampler
    rs = RationalResampler(P, Q, batch_shape=(N,)).to(dev)
    n_out = chan_len // Q * P
    O = choose_fused_tile(n_out, P, Q)
    toep, S, W = rs.toeplitz(O)
    total = rs.hist_len + chan_len
    ci_np = (np.arange(N) * 7 % M).astype(np.int32)
    ci = torch.from_numpy(ci_np).to(dev)
    om = torch.from_numpy(rng.uniform(-1.5, 1.5, N).astype(np.float32)
                          ).to(dev)
    pw0 = torch.from_numpy(rng.uniform(0, 6.28, N).astype(np.float32)
                           ).to(dev)
    start = rs.hist_len + rs.Q - 1 - (rs.KK - 1)
    planes = [(randn(rng, (M, total), dev), randn(rng, (M, total), dev))]

    def make(i):
        while len(planes) <= i:
            planes.append((randn(rng, (M, total), dev),
                           randn(rng, (M, total), dev)))
        zr, zi = planes[i]
        return lambda: routed_shifted_resample(zr, zi, ci, om, pw0, rs, toep)

    def plain():
        e_re, e_im, a1, a64 = _tables(om, W, S)
        return routed_shifted_resample_plain(*planes[0], ci, e_re, e_im,
                                             pw0, a1, a64, toep, S, start)

    err = max_err(make(0)(), plain())
    if not err <= ROUTE_ATOL:
        raise AssertionError(f"route {P}/{Q} N={N}: kernel vs plain max err "
                             f"{err}")
    # Each referenced channel read once, each output written once; per
    # output the FMAs of its phase's nonzero taps on both planes, plus the
    # complex modulation of each input sample of each demod.
    nnz = int(np.count_nonzero(rs.ker_np))
    nbytes = (8 * len(set(ci_np.tolist())) * total + 8 * N * n_out
              + 12 * N + 4 * rs.ker_np.size)
    flops = 4 * N * (n_out // P) * nnz + 6 * N * chan_len
    cold, k = cold_ms(make, nbytes)
    tb, groups, cq, keep_e, smem, stream = route_plan(
        P, Q, O, rs.KK, route_taps(rs.ker_np, Q)[0].shape[-1])
    return {"P": P, "Q": Q, "N": N, "M": M, "chan_len": chan_len, "O": O,
            "plan": {"tiles_per_batch": tb, "residue_groups": groups,
                     "residues_per_pass": cq, "e_resident": keep_e,
                     "window_streamed": stream, "smem_bytes": smem},
            "max_abs_err": err, "warm_ms": cuda_ms(make(0)), "cold_ms": cold,
            "cold_sets": k, "plain_ms": cuda_ms(plain),
            **roofline(flops, nbytes, cold)}


def route_line(c: dict, cases: list, smi: str, tag: str = "") -> None:
    cases.append(c)
    line(f"route {tag}{c['P']}/{c['Q']} N={c['N']} M={c['M']} O={c['O']} "
         f"chan_len={c['chan_len']} plan {json.dumps(c['plan'])}: "
         f"max_abs_err {c['max_abs_err']:.3g}; cold {c['cold_ms']:.4f}"
         f" ms, warm {c['warm_ms']:.4f} ms, plain {c['plain_ms']:.4f} "
         f"ms; bound {c['bound_ms']:.4f} ms ({c['bound_by']}), share "
         f"{c['roofline_share']:.3f}, "
         f"{c['achieved_tflop_per_s']:.2f} TFLOP/s [{smi}]")


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel instance from nvcc's -Xptxas -v
    report: its name and the registers, stack and spills ptxas states."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            raw = ln.split("'")[1]
            name = next((k for k in ("route_kernel", "pfbch2_kernel")
                         if k in raw), raw)
            if name in raw:        # keep the template arguments
                name += raw.split(name, 1)[1].split("EEv", 1)[0]
        elif name and ("Used" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def build_pipeline(n_demods: int, dev, use_kernels: bool, block=BLOCK):
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    return ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, n_demods)],
                            use_kernels=use_kernels, block_len=block,
                            device=dev)


def tone_snr(audio: np.ndarray, f0: float, fs: float) -> float:
    a = audio - audio.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    freqs = np.fft.rfftfreq(len(a), 1 / fs)
    sig = (freqs > f0 - 40) & (freqs < f0 + 40)
    noise = ~sig & (freqs > 50) & (freqs < 15000)
    return float(10 * np.log10(spec[sig].sum()
                               / max(spec[noise].sum(), 1e-30)))


def as_input(rx, blk):
    """Planes [2, L] as the pipeline's representation: a PC (planar) or
    one complex64 tensor."""
    from cubicsdr_tpu_torch.ops.planar import PC, PLANAR
    if rx.dtype == PLANAR:
        return PC(blk[0].contiguous(), blk[1].contiguous())
    return torch.complex(blk[0], blk[1])


def planes(x):
    """(re, im) of a PC or a complex tensor."""
    return (x.re, x.im) if hasattr(x, "re") else (x.real, x.imag)


def run_blocks(rx, blocks, controls):
    """Outputs of each block and the state each block started from."""
    st, outs, befores = rx.init_state(), [], []
    for blk in blocks:
        befores.append(st)
        st, out = rx.apply(st, (as_input(rx, blk), controls))
        outs.append(out)
    return outs, befores


def build_warmups(card) -> int:
    """Eager warm-up calls a compiled step makes before its captures on
    ``card`` (none on the CPU, where it runs eagerly): real launches,
    which the kernels' counters count."""
    from cubicsdr_tpu_torch.utils.compiled import WARMUPS
    return WARMUPS if torch.device(card).type == "cuda" else 0


def reset_launches() -> None:
    from cubicsdr_tpu_torch.ops.kernels.pfb import pfbch2_planar
    from cubicsdr_tpu_torch.ops.kernels.route import routed_shifted_resample
    torch.cuda.synchronize()
    pfbch2_planar.launches = 0
    routed_shifted_resample.launches = 0


def read_launches() -> dict:
    from cubicsdr_tpu_torch.ops.kernels.pfb import pfbch2_planar
    from cubicsdr_tpu_torch.ops.kernels.route import routed_shifted_resample
    torch.cuda.synchronize()
    return {"pfbch2_planar": pfbch2_planar.launches,
            "routed_shifted_resample": routed_shifted_resample.launches}


def check_main_path(dev, n_demods: int = 16, block: int = BLOCK):
    """Phase 4. Returns the launch counts of the main path's run."""
    from cubicsdr_tpu_torch.utils.synth import demod_freqs, synth_fm
    freqs = demod_freqs(n_demods, spread=15)
    iq = synth_fm(freqs[:15], 3 * block, FS, dev, seed=1)
    blocks = [iq[:, b * block:(b + 1) * block].contiguous()
              for b in range(3)]
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    # Built with the entry point's defaults: the card and both kernels.
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, n_demods)],
                          block_len=block)
    if rx.fused_route != [True] or rx.device.type != "cuda":
        raise AssertionError("the default pipeline is not on the card's "
                             "fused kernel path")
    controls = rx.control_template()
    controls[0]["frequency"] = freqs
    reset_launches()
    outs, _ = run_blocks(rx, blocks, controls)
    launches = read_launches()
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")

    rx_cpu = build_pipeline(n_demods, "cpu", True, block)
    outs_cpu, befores = run_blocks(rx_cpu, [b.cpu() for b in blocks],
                                   controls)
    worst = {}
    compare_groups(rx_cpu, outs, outs_cpu, befores, worst)
    # Tone recovery: every station's audio over blocks 2-3 (block 1 holds
    # the filters' start-up transient).
    snrs = []
    for k in range(min(n_demods, 15)):
        a = np.concatenate([o["groups"][0]["audio"][k, 0].cpu().numpy()
                            for o in outs[1:]])
        snrs.append(tone_snr(a, 700.0 + 90.0 * k, rx.audio_rate))
    if not min(snrs) > 40:
        raise AssertionError(f"tone SNR {min(snrs):.1f} dB <= 40 dB")
    worst["min_tone_snr_db"] = min(snrs)
    return launches, worst


def timed_steps(rx, blocks, controls, n_blocks: int, n_warm: int = 3):
    """Msamples/s and ms per block of ``rx``'s step on device-resident IQ
    (``blocks``, cycled) and controls, over ``n_blocks`` blocks after
    ``n_warm`` warm-up blocks."""
    controls = [{k: torch.as_tensor(v, device=rx.device)
                 for k, v in c.items()} for c in controls]
    blocks = [as_input(rx, b) for b in blocks]
    st = rx.init_state()
    for b in range(n_warm):
        st, out = rx.apply(st, (blocks[b % len(blocks)], controls))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(n_blocks):
        st, out = rx.apply(st, (blocks[b % len(blocks)], controls))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(out["mix"]).all():
        raise AssertionError("non-finite mix in a throughput run")
    return n_blocks * rx.block_len / dt / 1e6, dt / n_blocks * 1e3


def throughput(dev, n_demods: int, use_kernels: bool, n_blocks: int = 20,
               block: int = BLOCK):
    """Msamples/s and ms per block of the main path (demod``n_demods``)."""
    from cubicsdr_tpu_torch.utils.synth import demod_freqs, synth_fm
    rx = build_pipeline(n_demods, dev, use_kernels, block)
    controls = rx.control_template()
    controls[0]["frequency"] = demod_freqs(n_demods)
    iq = synth_fm(demod_freqs(16), 2 * block, FS, dev, seed=2)
    blocks = [iq[:, b * block:(b + 1) * block] for b in range(2)]
    return timed_steps(rx, blocks, controls, n_blocks)


def audio_close(a, b, what: str) -> dict:
    """Pipeline tolerances: rms of the difference < 2e-3, 99.5% quantile
    < 5e-3."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    rms, q995 = float(np.sqrt(np.mean(d * d))), float(np.quantile(d, 0.995))
    if not (rms < 2e-3 and q995 < 5e-3):
        raise AssertionError(f"{what} vs CPU: rms {rms}, q995 {q995}")
    return {"rms": rms, "q995": q995}


def live_blocks(n_demods: int = 16):
    """LIVE_BLOCKS host blocks (planes [2, BLOCK] float32) of the
    16-station signal, and the demod offsets."""
    from cubicsdr_tpu_torch.utils.synth import demod_freqs, synth_fm
    freqs = demod_freqs(n_demods, spread=15)
    iq = synth_fm(freqs[:15], LIVE_BLOCKS * BLOCK, FS, "cuda", seed=3)
    iq = iq.cpu().numpy()
    return freqs, [np.ascontiguousarray(iq[:, b * BLOCK:(b + 1) * BLOCK])
                   for b in range(LIVE_BLOCKS)]


def run_live(rx, freqs, blocks, out_dir: Path | None, views: bool):
    """One finite run of the live loop; returns (receiver, per-block mix,
    per-block waterfall line counts)."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    controls = rx.control_template()
    controls[0]["frequency"] = freqs
    mixes, lines, drawn = [], [], [0]

    def on_block(o):
        mixes.append(o["mix"].copy())
        lines.append(drawn[0])
        drawn[0] = 0

    lr = LiveReceiver(rx, controls, iter(blocks), waterfall_fft=1024,
                      waterfall_lines=64, on_block=on_block)
    add_lines = lr.waterfall.add_lines

    def count_lines(pts):
        drawn[0] += len(pts)
        add_lines(pts)

    lr.waterfall.add_lines = count_lines
    if views:
        for key in (0, 5):
            lr.set_recording(key, True, path=str(out_dir / "rec"))
        lr.set_audio_sink("sub", f"wav:{out_dir / 'sub'}", demods=[2, 3])
        lr.set_demod_view(4)
        lr.set_zoom(1e6, 1e6)
        join_prewarms()          # before the script synchronises the card
    return lr, mixes, lines


def read_pcm16(path: Path) -> np.ndarray:
    """A 16-bit PCM WAV (the recorders' format) as float32 [channels, n]."""
    with wave.open(str(path), "rb") as wf:
        if wf.getsampwidth() != 2:
            raise AssertionError(f"{path}: not 16-bit PCM")
        ch = wf.getnchannels()
        raw = wf.readframes(wf.getnframes())
    x = np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
    return x.reshape(-1, ch).T.copy()


def drive_live(lr) -> int:
    """Start the producer and run the finite source to its end."""
    lr.start_producer()
    return lr.run_blocks()


def check_live(dev):
    """Phases 9 and 10. Returns (launches in the live run, summary)."""
    from cubicsdr_tpu_torch.app.checkpoint import load_state, save_state
    freqs, blocks = live_blocks()
    rx = build_pipeline(16, dev, True)
    rx_cpu = build_pipeline(16, "cpu", True)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name, pipe in (("cuda", rx), ("cpu", rx_cpu)):
            d = Path(tmp) / name
            d.mkdir()
            lr, mixes, lines = run_live(pipe, freqs, blocks, d, views=True)
            if name == "cuda":
                reset_launches()
            t0 = time.perf_counter()
            n = drive_live(lr)
            if name == "cuda":
                launches = read_launches()
            lr.stop()
            summary[f"{name}_s"] = time.perf_counter() - t0
            if n != LIVE_BLOCKS:
                raise AssertionError(f"{name} live run took {n} blocks")
            bad = [k for k in lr.metrics.notes
                   if k.startswith(("zoom_error", "audio_out_error"))]
            if bad:
                raise AssertionError(f"{name} live run noted {bad}: "
                                     f"{lr.metrics.notes}")
            runs[name] = dict(
                lr=lr, mixes=mixes, lines=lines,
                wavs={f: read_pcm16(d / f"{f}.wav")
                      for f in ("rec_demod0", "rec_demod5", "sub")})
        g, c = runs["cuda"], runs["cpu"]
        # One replay per block, and the compiled step's two warm-ups.
        want = LIVE_BLOCKS + build_warmups("cuda")
        if launches != {"pfbch2_planar": want,
                        "routed_shifted_resample": want}:
            raise AssertionError(f"live run launches {launches}, expected "
                                 f"{want} of each ({LIVE_BLOCKS} blocks "
                                 f"and the build's warm-ups)")
        drops = (g["lr"].ring.dropped_samples,
                 g["lr"].metrics.snapshot()["ingest"]["dropped"])
        if drops != (0, 0):
            raise AssertionError(f"ring dropped samples: {drops}")
        worst = {"rms": 0.0, "q995": 0.0}
        for f in g["wavs"]:
            e = audio_close(g["wavs"][f], c["wavs"][f], f"wav {f}")
            worst = {k: max(worst[k], e[k]) for k in worst}
        for i, (a, b) in enumerate(zip(g["mixes"], c["mixes"])):
            e = audio_close(a, b, f"mix block {i}")
            worst = {k: max(worst[k], e[k]) for k in worst}
            if not np.isfinite(a).all():
                raise AssertionError("non-finite mix in the live run")
        if g["lines"] != c["lines"]:
            raise AssertionError(f"waterfall lines per block {g['lines']} "
                                 f"vs CPU {c['lines']}")
        # The first two lines of a stream are 0/0-conditioned (a frame of
        # history zeros plus one sample has a flat |FFT|, so ceiling ==
        # floor, and the double EMA carries it into line 2): rounding
        # decides them on either device, so they are not compared. Early
        # lines may hold NaN points (log10 of a negative while the EMA'd
        # floor still sits above the spectrum), as in the JAX package:
        # those must sit at the same points.
        total = sum(g["lines"])
        wf = [r["lr"].waterfall.buffer[-(total - 2):] for r in (g, c)]
        views = {"zoom": [r["lr"].zoom.points for r in (g, c)],
                 "demod_view": [r["lr"].demod_spectrum for r in (g, c)]}
        errs = {}
        for what, (a, b) in {"waterfall": wf, **views}.items():
            np.testing.assert_allclose(a, b, atol=WF_ATOL, err_msg=what)
            ok = np.isfinite(a)
            errs[what] = float(np.abs(a[ok] - b[ok]).max())
            errs[f"{what}_nan_points"] = int((~ok).sum())
        summary.update(audio=worst, points_err=errs,
                       waterfall_lines=g["lines"],
                       ring_dropped_samples=drops[0])

        # Phase 10: checkpoint after 3 blocks, resume in a fresh receiver.
        lr_a, _, _ = run_live(rx, freqs, blocks[:3], None, views=False)
        if drive_live(lr_a) != 3:
            raise AssertionError("checkpoint run: first half short")
        p = str(Path(tmp) / "live.npz")
        save_state(p, lr_a.snapshot_state(), meta={"blocks": 3})
        lr_a.stop()
        lr_b, mixes_b, _ = run_live(rx, freqs, blocks[3:], None,
                                    views=False)
        lr_b.state, meta = load_state(p, rx.init_state())
        if drive_live(lr_b) != LIVE_BLOCKS - 3 or meta != {"blocks": 3}:
            raise AssertionError("checkpoint run: second half short")
        lr_b.stop()
        resume_err = max(float(np.abs(a - b).max())
                         for a, b in zip(mixes_b, g["mixes"][3:]))
        if not resume_err <= RESUME_ATOL:
            raise AssertionError(f"resumed audio differs by {resume_err}")
        summary["resume_err"] = resume_err
    return launches, summary


def live_throughput(rx, ingest_dtype, n_warm: int = 8, n_timed: int = 40):
    """The live loop's Msamples/s with a back-pressured cycling source
    (the shape of the JAX package's bench.py:175-258)."""
    from cubicsdr_tpu_torch.utils.metrics import Metrics
    from cubicsdr_tpu_torch.utils.synth import live_row
    lr = live_row(rx, ingest_dtype, n_warm)
    lr.metrics = Metrics()
    t0 = time.perf_counter()
    n = lr.run_blocks(max_blocks=n_timed)
    dt = time.perf_counter() - t0
    snap = lr.metrics.snapshot()
    lr.stop()
    if n != n_timed:
        raise AssertionError(f"live throughput ran {n} of {n_timed} blocks")
    return {"msamples_per_s": n * rx.block_len / dt / 1e6,
            "ms_per_block": dt / n * 1e3, "blocks": n,
            "ring_dropped_samples": int(snap["ingest"]["dropped"])}


SYMBOL_MARGIN = 1e-5    # slicer score gap below which a symbol may flip


def compare_groups(rx_cpu, outs, outs_cpu, befores_cpu, worst) -> None:
    """Every group of every block on the card against the CPU at the
    pipeline's gates: iq tap atol 3e-4 / rtol 1e-3, mix and audio rms
    < 2e-3 and 99.5% quantile < 5e-3, level 0.05; digital symbols equal
    wherever the CPU slicer's margin between its two best scores is at
    least SYMBOL_MARGIN. Folds the worst values into ``worst``."""
    def fold(k, v):
        worst[k] = max(worst.get(k, 0.0), v)

    for o, r, st in zip(outs, outs_cpu, befores_cpu):
        if not torch.isfinite(o["mix"]).all():
            raise AssertionError("non-finite mix")
        if o["mix"].numel():                 # a plan with audio
            e = audio_close(o["mix"].cpu().numpy(), r["mix"].numpy(), "mix")
            fold("audio_rms", e["rms"])
            fold("audio_q995", e["q995"])
        for gi, (g, gr) in enumerate(zip(o["groups"], r["groups"])):
            if set(g) != set(gr):
                raise AssertionError(f"group {gi} outputs {sorted(g)} vs "
                                     f"CPU {sorted(gr)}")
            for p, q in zip(planes(g["iq"]), planes(gr["iq"])):
                p, q = p.cpu().numpy(), q.numpy()
                np.testing.assert_allclose(p, q, atol=3e-4, rtol=1e-3)
                fold("iq_err", float(np.abs(p - q).max()))
            lv = float(np.abs(g["level"].cpu().numpy()
                              - gr["level"].numpy()).max())
            if not lv <= 0.05:
                raise AssertionError(f"group {gi} level vs CPU: {lv}")
            fold("level_err", lv)
            if rx_cpu.is_digital[gi]:
                margin = rx_cpu.kits[gi].decision_margin(
                    st["groups"][gi][1], gr["iq"]).numpy()
                flip = g["symbols"].cpu().numpy() != gr["symbols"].numpy()
                bad = int((flip & (margin >= SYMBOL_MARGIN)).sum())
                if bad or g["symbols"].dtype != torch.int32:
                    raise AssertionError(f"group {gi}: {bad} symbols differ "
                                         f"from the CPU above the margin")
                worst["symbols"] = worst.get("symbols", 0) + flip.size
                worst["symbol_flips_under_margin"] = worst.get(
                    "symbol_flips_under_margin", 0) + int(flip.sum())
            else:
                e = audio_close(g["audio"].cpu().numpy(),
                                gr["audio"].numpy(), f"group {gi} audio")
                fold("audio_rms", e["rms"])
                fold("audio_q995", e["q995"])
                if not torch.isfinite(g["audio"]).all():
                    raise AssertionError(f"group {gi}: non-finite audio")


def plan_blocks(plan, n_blocks: int, block_len: int, seed: int):
    """The plan's synthetic capture on the card, cut into blocks."""
    iq = plan.capture(n_blocks * block_len, "cuda", seed=seed)
    return [iq[:, b * block_len:(b + 1) * block_len].contiguous()
            for b in range(n_blocks)]


def check_plan(plan, n_blocks: int, seed: int):
    """A plan built with the pipeline's defaults (the card, both
    kernels) over ``n_blocks`` blocks of its capture, against the same
    plan on the CPU. Returns (launches, worst, card outputs, CPU outputs,
    CPU states before each block, blocks, pipelines)."""
    rx = plan.pipeline()
    if rx.device.type != "cuda":
        raise AssertionError(f"{plan.name}: the default is not the card")
    rx_cpu = plan.pipeline(device="cpu")
    blocks = plan_blocks(plan, n_blocks, rx.block_len, seed)
    reset_launches()
    outs, _ = run_blocks(rx, blocks, plan.controls(rx))
    launches = read_launches()
    outs_cpu, befores = run_blocks(rx_cpu, [b.cpu() for b in blocks],
                                   plan.controls(rx_cpu))
    worst = {}
    compare_groups(rx_cpu, outs, outs_cpu, befores, worst)
    return launches, worst, outs, outs_cpu, befores, blocks, (rx, rx_cpu)


def check_scan58():
    """scan58 on the card: 3 blocks against the CPU, both kernels'
    launches (1 PFB and 6 route per block), and a tone through one FM,
    one NBFM and one AM row (blocks 2-3)."""
    from cubicsdr_tpu_torch.utils.synth import scan58
    plan = scan58()
    launches, worst, outs, outs_cpu, befores, blocks, (rx, rx_cpu) = \
        check_plan(plan, 3, seed=11)
    if rx.fused_route != [True] * 6:
        raise AssertionError(f"scan58 fused {rx.fused_route}")
    if launches != {"pfbch2_planar": 3, "routed_shifted_resample": 18}:
        raise AssertionError(f"scan58 launches {launches}, expected 3 PFB "
                             f"and 18 route")
    for gi, (name, tone) in enumerate((("FM", 700.0), ("NBFM", 1000.0),
                                       ("AM", 400.0))):
        a = np.concatenate([o["groups"][gi]["audio"][0, 0].cpu().numpy()
                            for o in outs[1:]])
        snr = tone_snr(a, tone, rx.audio_rate)
        if not snr > 40:
            raise AssertionError(f"scan58 {name} row 0 tone SNR {snr:.1f}")
        worst[f"{name}_tone_snr_db"] = snr
    return launches, worst, (plan, blocks, outs_cpu, befores, rx, rx_cpu)


def check_coverage():
    """Every modem scan58 does not run, on the card against the CPU in
    the coverage plans (2 blocks each); returns the modems covered, the
    launches summed over the plans, and the worst values."""
    from cubicsdr_tpu_torch.utils.synth import coverage_plans
    covered, total, worst, rows = [], None, {}, []
    for i, plan in enumerate(coverage_plans()):
        launches, w, *_, (rx, _) = check_plan(plan, 2, seed=20 + i)
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
        for k, v in w.items():
            worst[k] = worst.get(k, 0) + v if k.startswith("symbol") \
                else max(worst.get(k, 0.0), v)
        covered += [g.modem_name for g in plan.specs]
        rows.append({"plan": plan.name, "block_len": rx.block_len,
                     "fused": rx.fused_route, "launches": launches})
    return covered, total, worst, rows


def check_live_scan58(ctx):
    """The live loop on scan58's 3 blocks, on the card and on the CPU:
    digital symbols reach on_block as int32, equal to the CPU loop's
    above the slicer margin; the CPU loop equals the CPU pipeline run;
    mixes within the pipeline gates; both kernels' launches."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    plan, blocks, outs_cpu, befores, rx, rx_cpu = ctx
    host = [b.cpu().numpy() for b in blocks]
    got = {}
    for name, pipe in (("cuda", rx), ("cpu", rx_cpu)):
        seen = []
        lr = LiveReceiver(pipe, plan.controls(pipe), iter(host),
                          waterfall_fft=1024, waterfall_lines=64,
                          on_block=seen.append)
        if name == "cuda":
            reset_launches()
        lr.start_producer()
        n = lr.run_blocks()
        if name == "cuda":
            launches = read_launches()
        lr.stop()
        if n != len(host):
            raise AssertionError(f"{name} live scan58 ran {n} blocks")
        got[name] = seen
    steps = 3 + build_warmups("cuda")        # 3 replays, 2 warm-ups
    if launches != {"pfbch2_planar": steps,
                    "routed_shifted_resample": 6 * steps}:
        raise AssertionError(f"live scan58 launches {launches}")
    worst, n_syms = {"rms": 0.0, "q995": 0.0}, 0
    dig = [gi for gi, d in enumerate(rx_cpu.is_digital) if d]
    for b, (g, c) in enumerate(zip(got["cuda"], got["cpu"])):
        e = audio_close(g["mix"], c["mix"], f"live mix block {b}")
        worst = {k: max(worst[k], e[k]) for k in worst}
        for gi in dig:
            sg, sc = g["groups"][gi]["symbols"], c["groups"][gi]["symbols"]
            if sg.dtype != np.int32 or sc.dtype != np.int32:
                raise AssertionError("live symbols are not int32")
            np.testing.assert_array_equal(
                sc, outs_cpu[b]["groups"][gi]["symbols"].numpy())
            margin = rx_cpu.kits[gi].decision_margin(
                befores[b]["groups"][gi][1],
                outs_cpu[b]["groups"][gi]["iq"]).numpy()
            if ((sg != sc) & (margin >= SYMBOL_MARGIN)).any():
                raise AssertionError(f"live symbols of group {gi} differ")
            n_syms += sg.size
    return launches, {"audio": worst, "symbols_delivered": n_syms}


def plan_throughput(plan, n_blocks: int = 10):
    """A plan's row: Msamples/s and ms per block of its step."""
    rx = plan.pipeline()
    msps, ms = timed_steps(rx, plan_blocks(plan, 2, rx.block_len, 3),
                           plan.controls(rx), n_blocks)
    return {"row": plan.name, "msamples_per_s": msps, "ms_per_block": ms,
            "block_len": rx.block_len, "blocks": n_blocks}


def write_cf32(path: Path, planes: torch.Tensor) -> None:
    """Planes [2, n] as an interleaved float32 IQ capture file."""
    x = planes.cpu().numpy()
    np.stack([x[0], x[1]], axis=1).astype(np.float32).tofile(path)


def cli_run(argv) -> tuple[dict, float]:
    """``app.cli.main(argv)`` in this process: (kernel launches, wall
    seconds, the device synchronised at the end)."""
    from cubicsdr_tpu_torch.app import cli
    reset_launches()
    t0 = time.perf_counter()
    if cli.main([str(a) for a in argv]) != 0:
        raise AssertionError(f"cli {argv} failed")
    launches = read_launches()
    return launches, time.perf_counter() - t0


def waterfall_capture():
    """Wraps the port's Waterfall so that a CLI run's rendered buffer and
    its produced line count are kept; returns (kept dict, restore)."""
    from cubicsdr_tpu_torch.visual.waterfall import Waterfall
    kept = {"lines": 0}
    add, render = Waterfall.add_lines, Waterfall.render_png

    def add_lines(self, pts):
        kept["lines"] += len(np.atleast_2d(pts))
        add(self, pts)

    def render_png(self, path):
        kept["buffer"] = self.buffer.copy()
        render(self, path)

    Waterfall.add_lines, Waterfall.render_png = add_lines, render_png

    def restore():
        Waterfall.add_lines, Waterfall.render_png = add, render
    return kept, restore


def check_cli(tmp: Path, plan, card: str = "cuda", fused_groups: int = 6):
    """Phase 13. Each subcommand on the card (``card``) against
    ``--device cpu``; returns (per command its launches, its seconds on
    the card and the comparison; the capture and session paths)."""
    from cubicsdr_tpu_torch.app.session import SessionMgr
    from cubicsdr_tpu_torch.io.wav import read_wav
    n = 3 * 2_048_000
    cap, sess = tmp / "scan58.cf32", tmp / "scan58.json"
    write_cf32(cap, plan.capture(n, card, seed=11))
    s = SessionMgr(plan.manager(CENTER))
    s.center_freq, s.sample_rate = int(CENTER), int(plan.fs)
    s.save_session(str(sess))
    fs, fm, nbfm, am = (int(plan.fs), plan.freqs[0][0], plan.freqs[1][0],
                        plan.freqs[2][0])

    def demod(modem, bw, f, *extra):
        return ["demod", cap, "-r", fs, "-c", int(CENTER), "-f",
                int(CENTER + f), "-m", modem, "-b", bw, *extra]

    warm = build_warmups(card)

    def demod_launches(modem, bw):
        """(PFB, route) launches of a one-demod 'pfbch2' plan over the
        capture: one of each per block of its own length, and per
        warm-up of the compiled step's build."""
        from cubicsdr_tpu_torch.receiver import (
            DemodGroupSpec, ReceiverPipeline)
        rx = ReceiverPipeline(fs, [DemodGroupSpec(modem, bw, 1)],
                              device="cpu")
        if rx.fused_route != [True]:
            raise AssertionError(f"{modem} does not fuse")
        return (-(-n // rx.block_len) + warm,) * 2

    n_blocks = -(-n // 2_048_000) + warm      # replays and warm-ups
    cases = (  # name, argv, output suffix, tone Hz, (PFB, route) launches
        ("demod_fm", demod("FM", 200000, fm), ".wav", 700.0,
         demod_launches("FM", 200000)),
        ("demod_nbfm", demod("NBFM", 12500, nbfm), ".wav", 1000.0,
         demod_launches("NBFM", 12500)),
        ("demod_am", demod("AM", 6000, am), ".wav", 400.0,
         demod_launches("AM", 6000)),
        ("rx", ["rx", sess, cap], ".wav", None,
         (n_blocks, fused_groups * n_blocks)),
        ("waterfall", ["waterfall", cap, "-r", fs, "--fft-size", 1024,
                       "--lines", 64, "--lps", 60], ".png", None, (0, 0)),
        ("rx_pfbch", ["rx", sess, cap, "--channelizer", "pfbch"], ".wav",
         None, (0, fused_groups * n_blocks)),
        ("demod_single", demod("FM", 200000, fm, "--channelizer", "single"),
         ".wav", 700.0, (0, 0)),
    )
    rows = {}
    for name, argv, ext, tone, want in cases:
        runs = {}                    # "card" / "cpu": (output, kept, ...)
        for side, dev in (("card", card), ("cpu", "cpu")):
            out = tmp / f"{name}_{side}{ext}"
            keep, restore = waterfall_capture()
            try:
                launches, secs = cli_run([*argv, "-o", out, "--device", dev])
            finally:
                restore()
            runs[side] = (out, keep, launches, secs)
        (out, g, launches, secs), (out_c, c, _, _) = runs["card"], runs["cpu"]
        row = {"launches": launches, "card_s": secs}
        if (launches["pfbch2_planar"],
                launches["routed_shifted_resample"]) != want:
            raise AssertionError(f"cli {name} launches {launches}, "
                                 f"expected {want}")
        if ext == ".wav":
            a, ra = read_wav(str(out))
            b, rb = read_wav(str(out_c))
            if ra != rb or not np.isfinite(a).all():
                raise AssertionError(f"cli {name}: bad WAV")
            row.update(audio_close(a, b, f"cli {name} WAV"))
            if tone is not None:
                snr = tone_snr(a[0, a.shape[1] // 3:], tone, ra)
                if not snr > 40:
                    raise AssertionError(f"cli {name} tone SNR {snr:.1f}")
                row["tone_snr_db"] = snr
        else:
            if g["lines"] != c["lines"] or g["lines"] < 8:
                raise AssertionError(f"waterfall lines {g['lines']} vs "
                                     f"{c['lines']}")
            # The stream's first two lines are 0/0-conditioned (phase 9).
            # The lines are compared as the waterfall draws them, clipped
            # to [0, 1]: below the floor the display math is log10 near
            # its zero crossing, where float32 rounding moves a point by
            # more than 2e-3 between any two implementations (on this
            # capture the port's and the JAX package's CPU runs differ by
            # 3.4e-3 at a point at -1.23, drawn as the floor by both).
            k = min(g["lines"], 64) - 2
            a, b = g["buffer"][-k:], c["buffer"][-k:]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(np.clip(a, 0, 1), np.clip(b, 0, 1),
                                       atol=WF_ATOL, err_msg="cli waterfall")
            ok = np.isfinite(a)
            row.update(drawn_points_err=float(np.abs(
                np.clip(a[ok], 0, 1) - np.clip(b[ok], 0, 1)).max()),
                raw_points_err=float(np.abs(a[ok] - b[ok]).max()),
                lines=g["lines"], nan_points=int((~ok).sum()))
            if out.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("cli waterfall wrote no PNG")
        if name.startswith("rx"):
            row["msamples_per_s"] = n / secs / 1e6
        rows[name] = row
    return rows, (cap, sess)


# Phase 14's plan edits, each a rebuild: index 58 is the added demod.
SERVE_EDITS = (
    ("add", {"action": "add", "type": "NBFM", "bandwidth": 12500}),
    ("set bandwidth", {"action": "set", "index": 58, "key": "bandwidth",
                       "value": 10000}),
    ("set type", {"action": "set", "index": 58, "key": "type",
                  "value": "AM"}),
    ("remove", {"action": "remove", "index": 58}),
)
SERVE_ROWS = [0, 16, 32]     # FM, NBFM and AM row 0 survive every edit


def serve_harness(device: str, sess: Path, cap: Path):
    """A live receiver on ``device`` carrying the session over the looped
    capture (its producer never starts: blocks are fed one by one), a
    subset sink pulling SERVE_ROWS' audio, and its WebViewer."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.app.session import SessionMgr
    from cubicsdr_tpu_torch.app.webview import WebViewer
    from cubicsdr_tpu_torch.io import FileIQSource
    from cubicsdr_tpu_torch.receiver import (
        DemodulatorMgr, ReceiverPipeline, controls_from_manager,
        plan_from_manager)
    mgr = DemodulatorMgr()
    s = SessionMgr(mgr)
    if not s.load_session(str(sess)):
        raise AssertionError("cannot load the scan58 session")
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(s.sample_rate, specs, device=device)
    src = FileIQSource(str(cap), s.sample_rate, rx.block_len, loop=True)
    blocks = []

    def on_block(o):
        blocks.append((o["mix"].copy(),
                       [(g.get("audio_rows"), g.get("audio"))
                        for g in o["groups"]]))

    lr = LiveReceiver(rx, controls_from_manager(mgr, rx, keyed,
                                                s.center_freq), src,
                      center_freq=s.center_freq, waterfall_fft=1024,
                      waterfall_lines=64, on_block=on_block)
    viewer = WebViewer(lr, mgr, keyed, port=0)
    if not viewer.control({"action": "audio_output", "name": "rows",
                           "backend": "null", "demods": SERVE_ROWS})["ok"]:
        raise AssertionError("serve: subset sink refused")
    return lr, viewer, src, blocks


def feed_block(lr, src) -> None:
    """One block of the looped capture into the ring, then through the
    loop; a block the ring refuses is a drop and fails the phase."""
    blk = next(src)
    if not lr.ring.write(np.ascontiguousarray(blk.real),
                         np.ascontiguousarray(blk.imag)):
        raise AssertionError("serve: the ring dropped a block")
    if lr.run_blocks(max_blocks=1, wait=False) != 1:
        raise AssertionError("serve: a block did not run")


def check_serve(sess: Path, cap: Path, plan, card: str = "cuda"):
    """Phase 14 on ``card``. Returns (launches after the rebuilds,
    summary)."""
    from cubicsdr_tpu_torch.utils.soak import http
    add_freq = CENTER + plan.freqs[1][1]           # NBFM station 1
    edits = [(name, dict(cmd, freq=add_freq) if name == "add" else cmd)
             for name, cmd in SERVE_EDITS]
    lr, viewer, src, got = serve_harness(card, sess, cap)
    viewer.start()
    summary, total = {"rebuilds": []}, {"pfbch2_planar": 0,
                                        "routed_shifted_resample": 0}
    try:
        for _ in range(2):
            feed_block(lr, src)
        st = json.loads(http(viewer.port, "/api/state"))
        if len(st["demods"]) != 58 or not any(d["level"] for d in
                                              st["demods"]):
            raise AssertionError(f"serve /api/state: {len(st['demods'])} "
                                 f"demods")
        sp = json.loads(http(viewer.port, "/api/spectrum"))
        png = http(viewer.port, "/api/waterfall.png")
        if len(sp["points"]) != 1024 or png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("serve: spectrum or waterfall missing")
        for name, cmd in edits:
            old, builds = lr.pipeline, lr.step_builds
            t0 = time.perf_counter()
            res = json.loads(http(viewer.port, "/api/control", cmd))
            t1 = time.perf_counter()
            if not res.get("ok") or lr.pipeline is old:
                raise AssertionError(f"serve {name}: no rebuild ({res})")
            reset_launches()
            feed_block(lr, src)
            launches = read_launches()
            t2 = time.perf_counter()
            groups = len(lr.pipeline.groups)
            # A new plan's first block builds its compiled step (the
            # warm-ups launch too); a returning plan (the remove) replays
            # the step cached for it.
            built = lr.step_builds - builds
            steps = 1 + build_warmups(card) * built
            if (lr.pipeline.fused_route != [True] * groups
                    or launches != {"pfbch2_planar": steps,
                                    "routed_shifted_resample":
                                        groups * steps}):
                raise AssertionError(f"serve {name}: launches {launches} "
                                     f"for {groups} groups, {built} builds")
            for k in total:
                total[k] += launches[k]
            summary["rebuilds"].append({
                "edit": name, "groups": groups, "launches": launches,
                "step_built": bool(built), "capture_ms":
                    lr.step.build_ms if built else None,
                "capture_split_ms":
                    lr.step.build_split_ms if built else None,
                "post_ms": (t1 - t0) * 1e3, "first_block_ms": (t2 - t1) * 1e3,
                "post_to_first_block_ms": (t2 - t0) * 1e3})
        if summary["rebuilds"][-1]["step_built"]:
            raise AssertionError("serve: the remove back to the first plan "
                                 "built a new step")
        drops = (lr.ring.dropped_samples,
                 lr.metrics.snapshot()["pipeline"]["dropped"])
    finally:
        viewer.stop()
        lr.stop()
    if drops != (0, 0):
        raise AssertionError(f"serve: ring/pipeline drops {drops}")
    summary["ring_dropped_samples"] = drops[0]

    lr_c, viewer_c, src_c, got_c = serve_harness("cpu", sess, cap)
    for _ in range(2):
        feed_block(lr_c, src_c)
    for name, cmd in edits:
        if not viewer_c.control(cmd)["ok"]:
            raise AssertionError(f"serve on the CPU: {name} refused")
        feed_block(lr_c, src_c)
    lr_c.stop()
    if not len(got) == len(got_c) == 2 + len(edits):
        raise AssertionError(f"serve blocks {len(got)} vs {len(got_c)}")
    worst = {"rms": 0.0, "q995": 0.0}
    for b, ((mix, rows), (mix_c, rows_c)) in enumerate(zip(got, got_c)):
        pairs = [(mix, mix_c, "mix")]
        for gi, ((r, a), (rc, ac)) in enumerate(zip(rows, rows_c)):
            if r != rc:
                raise AssertionError(f"serve block {b} group {gi}: rows "
                                     f"{r} vs {rc}")
            if a is not None:
                pairs.append((a, ac, f"group {gi} rows {r}"))
        if len(pairs) != 1 + len(SERVE_ROWS):
            raise AssertionError(f"serve block {b}: {len(pairs) - 1} "
                                 f"surviving row sets pulled")
        for a, c, what in pairs:
            e = audio_close(a, c, f"serve block {b} {what}")
            worst = {k: max(worst[k], e[k]) for k in worst}
    summary["audio_vs_cpu"] = worst
    return total, summary


# Stage shapes that no resident shared-memory plan fits (the route
# kernel's streaming plan): P, Q, N, channel length and channel count of
# the pipeline that fuses them. NBFM 5 kHz at 1.024 MS/s (3/307, O=384),
# NBFM 1.5 and 3 kHz at 1.4 MS/s (1/467, 2/467), NBFM 500 Hz at 2.56 MS/s
# (2/3413, whose window is 477,819 samples) and the 12 digital modems at
# 12.5 kHz on a 30.72 MS/s capture (4/317, O=512).
STREAMING_ROUTES = ((3, 307, 16, 196_480, 4), (1, 467, 16, 59_776, 4),
                    (2, 467, 16, 59_776, 4), (2, 3413, 16, 436_864, 6),
                    (4, 317, 16, 40_576, 62))
# Channel counts above 133 (captures above 66 MS/s): the PFB kernel's
# single-staged plan with F tiled over output channels, over 4,096,000
# samples each (70 MS/s -> M=140, 122.88 MS/s -> M=246).
WIDE_PFBS = ((140, 4_096_000 // 70, 0), (246, 4_096_000 // 123, 1))


def check_cli_wide(tmp: Path, card: str = "cuda"):
    """Phase 17: ``demod`` on the card at the new kernel shapes against
    ``--device cpu``: NBFM 5 kHz on a 1.024 MS/s capture (the route
    kernel's streaming plan, 3/307) and FM on a 70 MS/s capture (M=140:
    the PFB kernel's tiled plan); each WAV at the audio gates, a tone
    above 30 dB (NBFM) and 40 dB (FM), one PFB and one route launch per
    block. The NBFM station deviates 600 Hz at an 800 Hz tone, so its
    FM sidebands fit the 5 kHz channel."""
    from cubicsdr_tpu_torch.io.wav import read_wav
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    from cubicsdr_tpu_torch.utils.synth import Station, synth_capture
    cases = (  # name, rate, modem, bandwidth, station, tone floor dB,
        #          blocks (about 0.1 s of audio or more for the tone)
        ("demod_nbfm_1024k", 1_024_000, "NBFM", 5000,
         Station("nbfm", 128e3 + 20e3, 800.0, deviation=600.0), 30.0, 3),
        ("demod_fm_70m", 70_000_000, "FM", 200000,
         Station("fm", 3 * 500e3 + 20e3, 700.0), 40.0, 8))
    rows = {}
    for name, fs, modem, bw, st, floor, n_blocks in cases:
        rx = ReceiverPipeline(fs, [DemodGroupSpec(modem, bw, 1)],
                              device="cpu")
        if rx.fused_route != [True]:
            raise AssertionError(f"{name} does not fuse")
        cap = tmp / f"{name}.cf32"
        write_cf32(cap, synth_capture([st], n_blocks * rx.block_len, fs,
                                      card, seed=3))
        argv = ["demod", cap, "-r", fs, "-c", int(CENTER), "-f",
                int(CENTER + st.frequency), "-m", modem, "-b", bw]
        outs = {}
        for side, dev in (("card", card), ("cpu", "cpu")):
            out = tmp / f"{name}_{side}.wav"
            launches, secs = cli_run([*argv, "-o", out, "--device", dev])
            outs[side] = (out, launches, secs)
        (out, launches, secs), (out_c, _, _) = outs["card"], outs["cpu"]
        steps = n_blocks + build_warmups(card)
        if launches != {"pfbch2_planar": steps,
                        "routed_shifted_resample": steps}:
            raise AssertionError(f"cli {name} launches {launches}")
        a, ra = read_wav(str(out))
        b, rb = read_wav(str(out_c))
        if ra != rb or not np.isfinite(a).all():
            raise AssertionError(f"cli {name}: bad WAV")
        row = {"launches": launches, "card_s": secs, "M": rx.M,
               "block_len": rx.block_len,
               **audio_close(a, b, f"cli {name} WAV")}
        snr = tone_snr(a[0, a.shape[1] // 3:], st.tone, ra)
        if not snr > floor:
            raise AssertionError(f"cli {name} tone SNR {snr:.1f}")
        row["tone_snr_db"] = snr
        rows[name] = row
    return rows


def same_tree(a, b, what: str) -> int:
    """Every tensor leaf of two nests equal bit for bit (on the device);
    returns the number of leaves compared."""
    from cubicsdr_tpu_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or not la:
        raise AssertionError(f"{what}: {len(la)} leaves vs {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: leaf {i} differs")
    return len(la)


def check_sharded(smi: str):
    """Phase 18: ShardedReceiver on a 1x1 mesh under NCCL, built with its
    defaults (the card, both kernels), on scan58's plan over 3 blocks,
    against the unsharded ReceiverPipeline on the card at the pipeline's
    gates (symbols by the CPU slicer's margin); exactly 1 PFB and 6 route
    launches per block. Then the compiled sharded step (``make_step()``)
    over the same blocks, bit for bit against the eager sharded step on
    every output and state leaf, 1 PFB and 6 route launches per replay
    (and the build's two eager warm-ups); then ms per block and MS/s in
    turns, each on device-resident blocks after 3 warm-up blocks: the
    unsharded step eager and compiled (a ``CompiledStep`` of ``apply``,
    one graph per block, as the CLI's), the sharded step eager and
    compiled. Returns the eager and the compiled launches, the gates'
    worst values and the row."""
    import torch.distributed as dist
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.multihost import free_port
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    from cubicsdr_tpu_torch.utils.synth import scan58
    from cubicsdr_tpu_torch.utils.tree import tree_map
    plan = scan58()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        srx = ShardedReceiver(plan.fs, plan.num_channels, list(plan.specs),
                              mesh=make_receiver_mesh(1, 1, "cuda"))
        if srx.device.type != "cuda" or srx.fused_route != [True] * 6:
            raise AssertionError(f"sharded scan58 on {srx.device}, fused "
                                 f"{srx.fused_route}")
        rx, rx_cpu = plan.pipeline(), plan.pipeline(device="cpu")
        if srx.block_len != rx.block_len:
            raise AssertionError(f"block {srx.block_len} vs {rx.block_len}")
        blocks = plan_blocks(plan, 3, rx.block_len, seed=11)
        ref, befores = run_blocks(rx, blocks, plan.controls(rx))
        controls = srx.place_controls(plan.controls(srx))
        st, outs = srx.init_state(), []
        reset_launches()
        for blk in blocks:
            st, o = srx.step(st, PC(blk[0], blk[1]), controls)
            outs.append(o)
        launches = read_launches()
        if launches != {"pfbch2_planar": 3, "routed_shifted_resample": 18}:
            raise AssertionError(f"sharded scan58 launches {launches}, "
                                 f"expected 3 PFB and 18 route")
        worst = {}
        to_cpu = (lambda tree: tree_map(
            lambda t: t.cpu() if torch.is_tensor(t) else t, tree))
        compare_groups(rx_cpu, outs, [to_cpu(o) for o in ref],
                       [to_cpu(b) for b in befores], worst)

        # The compiled sharded step against the eager one, bit for bit.
        step = srx.make_step()
        if not isinstance(step, CompiledStep):
            raise AssertionError(f"make_step() gave {type(step).__name__}")
        pcs = [PC(b[0], b[1]) for b in blocks]
        reset_launches()
        sc, n_leaves = srx.init_state(), 0
        for i, pc in enumerate(pcs):
            sc, oc = step(sc, (pc, controls))
            n_leaves += same_tree(oc, outs[i], f"compiled sharded block {i}")
        n_leaves += same_tree(sc, st, "compiled sharded state")
        compiled_launches = read_launches()
        per_block = {"pfbch2_planar": 1, "routed_shifted_resample": 6}
        if step.launches != [per_block] * step.slots:
            raise AssertionError(f"compiled sharded replays hold "
                                 f"{step.launches}, expected {per_block}")
        calls = build_warmups("cuda") + len(pcs)
        if compiled_launches != {k: calls * v for k, v in per_block.items()}:
            raise AssertionError(f"compiled sharded scan58 launches "
                                 f"{compiled_launches}, expected {calls} x "
                                 f"{per_block}")
        worst["compiled_vs_eager_leaves_equal"] = n_leaves
        worst["compiled_build_ms"] = step.build_ms

        unsharded = CompiledStep(rx.apply, rx.device)
        dev_controls = [{k: torch.as_tensor(v, device=rx.device)
                         for k, v in c.items()} for c in plan.controls(rx)]
        eager = srx.make_step(compiled=False)
        calls = {
            "unsharded_compiled": lambda s, i: unsharded(
                s, (as_input(rx, blocks[i % 3]), dev_controls)),
            "sharded_eager": lambda s, i: eager(s, (pcs[i % 3], controls)),
            "sharded_compiled": lambda s, i: step(s, (pcs[i % 3],
                                                      controls)),
        }
        inits = {"unsharded_compiled": rx.init_state,
                 "sharded_eager": srx.init_state,
                 "sharded_compiled": srx.init_state}

        def rate(turn, n_blocks=10, n_warm=3):
            if turn == "unsharded_eager":
                return timed_steps(rx, blocks, plan.controls(rx), n_blocks)
            s = inits[turn]()
            for b in range(n_warm):
                s, o = calls[turn](s, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(n_blocks):
                s, o = calls[turn](s, b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not torch.isfinite(o["mix"]).all():
                raise AssertionError(f"non-finite mix in the {turn} turn")
            return n_blocks * srx.block_len / dt / 1e6, dt / n_blocks * 1e3

        turns = ("unsharded_eager", "unsharded_compiled", "sharded_eager",
                 "sharded_compiled")
        rates = {}
        for turn in turns + turns[::-1]:
            rates.setdefault(turn, []).append(rate(turn))
        row = {"row": "sharded1x1_scan58", "backend": dist.get_backend(),
               "block_len": srx.block_len, "card": smi,
               "compiled_build_ms": step.build_ms,
               "compiled_build_split_ms": step.build_split_ms,
               **{f"{k}_msamples_per_s": [r[0] for r in v]
                  for k, v in rates.items()},
               **{f"{k}_ms_per_block": [r[1] for r in v]
                  for k, v in rates.items()}}
    finally:
        dist.destroy_process_group()
    return launches, compiled_launches, worst, row


def check_rx_mesh(tmp: Path, plan, smi: str, card: str = "cuda",
                  mesh: str = "time=1,chan=1") -> dict:
    """Phase 18's ``rx --mesh "time=1,chan=1"`` as a user runs it, on
    ``card`` (one NCCL rank per card: its compiled sharded step is a
    CUDA graph) and with ``--device cpu`` (gloo ranks, the same buffers
    run eagerly), on a 3-block scan58 capture with the spectrum and a
    checkpoint: the WAVs at the audio gates and finite; the wall time of
    each command (process start-up, plan build and compile included).
    ``mesh`` takes a larger mesh on a host with that many cards."""
    from cubicsdr_tpu_torch.app import cli
    from cubicsdr_tpu_torch.app.session import SessionMgr
    from cubicsdr_tpu_torch.io.wav import read_wav
    cap, sess = tmp / "mesh.cf32", tmp / "mesh.json"
    write_cf32(cap, plan.capture(3 * 2_048_000, card, seed=13))
    s = SessionMgr(plan.manager(CENTER))
    s.center_freq, s.sample_rate = int(CENTER), int(plan.fs)
    s.save_session(str(sess))
    row = {"row": "cli_rx_mesh_scan58", "mesh": mesh, "card": smi}
    wavs = {}
    for side, dev in (("card", card), ("cpu", "cpu")):
        out = tmp / f"mesh_{side}.wav"
        t0 = time.perf_counter()
        if cli.main(["rx", str(sess), str(cap), "-o", str(out), "--mesh",
                     mesh, "--checkpoint",
                     str(tmp / f"mesh_{side}.npz"), "--device", dev]) != 0:
            raise AssertionError(f"rx --mesh on {dev} failed")
        row[f"{side}_s"] = time.perf_counter() - t0
        wavs[side] = read_wav(str(out))
    (a, ra), (b, rb) = wavs["card"], wavs["cpu"]
    if ra != rb or a.shape != b.shape or not np.isfinite(a).all() \
            or np.abs(a).max() < 0.01:
        raise AssertionError(f"rx --mesh WAVs {a.shape} at {ra} vs "
                             f"{b.shape} at {rb}")
    row.update(audio_close(a, b, "rx --mesh WAV"), samples=3 * 2_048_000,
               note="wall time of cli.main: a spawned rank process, plan "
                    "build, compiled step build, 3 blocks, WAV, PNG and "
                    "checkpoint written")
    return row


def check_multihost(smi: str):
    """Phase 19: ``multihost`` as a user launches it, two worker processes
    on the one card (time=2): NCCL takes one rank per GPU, so the phase
    asks for host collectives, gloo on host copies (the stand-in for a
    link between hosts); scan58's plan, each rank verified against the
    unsharded ReceiverPipeline it computes on the card; then a timed
    phase, bound by those host copies."""
    from cubicsdr_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    reports = multihost.launch_local(2, steps=2, device="cuda",
                                     plan="scan58", timed_steps=4,
                                     timeout_s=600, host_collectives=True)
    wall = time.perf_counter() - t0
    for rep in reports:
        if not (rep["ok"] and rep["verified"] and rep["process_count"] == 2
                and rep["host_collectives"] and rep["backend"] == "gloo"
                and rep["compiled"] is False):
            raise AssertionError(f"multihost report {rep}")
        if rep["launches"] != {"pfbch2_planar": 2,
                               "routed_shifted_resample": 12}:
            raise AssertionError(f"multihost rank launches "
                                 f"{rep['launches']}")
    return reports, {"row": "multihost2_scan58_one_card",
                     "collectives": "gloo on host copies (2 ranks, 1 GPU)",
                     "compiled": False,
                     "block_len": reports[0]["block_len"],
                     "aggregate_msamples_per_s": [
                         r["timed"]["aggregate_msps"] for r in reports],
                     "timed_steps": reports[0]["timed"]["steps"],
                     "wall_s_with_start_up": wall,
                     "note": "host-copy bound: every halo, sum and "
                             "gather leaves the card for gloo",
                     "card": smi}


MULTIHOST_CARDS = 4


def check_multihost_cards(smi: str):
    """Phase 19b: the four-card ``multihost`` job as a user launches it
    (``multihost --nprocs 4 --devices cuda --plan scan58 --steps 3
    --timed-steps 8``), one rank per card under NCCL, each rank's step
    compiled; the checks of phase 19 plus NCCL, ``"compiled": true`` and
    the launches of 3 steps and the build's warm-ups. Returns (reports,
    row), or (None, None) with a line saying why where the host has
    fewer cards."""
    from cubicsdr_tpu_torch.parallel import multihost
    have = torch.cuda.device_count()
    if have < MULTIHOST_CARDS:
        line(f"multihost {MULTIHOST_CARDS} processes on "
             f"{MULTIHOST_CARDS} cards (NCCL), scan58: not run, this host "
             f"has {have} CUDA device(s)")
        return None, None
    steps = 3
    t0 = time.perf_counter()
    reports = multihost.launch_local(MULTIHOST_CARDS, steps=steps,
                                     device="cuda", plan="scan58",
                                     timed_steps=8, timeout_s=900)
    wall = time.perf_counter() - t0
    calls = build_warmups("cuda") + steps
    want = {"pfbch2_planar": calls, "routed_shifted_resample": 6 * calls}
    for rep in reports:
        if not (rep["ok"] and rep["verified"]
                and rep["process_count"] == MULTIHOST_CARDS
                and not rep["host_collectives"]
                and rep["backend"] == "nccl" and rep["compiled"] is True):
            raise AssertionError(f"multihost report {rep}")
        if rep["launches"] != want:
            raise AssertionError(f"multihost rank {rep['process_id']} "
                                 f"launches {rep['launches']}, expected "
                                 f"{want}")
    return reports, {"row": "multihost4_scan58_four_cards",
                     "collectives": f"NCCL ({MULTIHOST_CARDS} ranks, one "
                                    f"card each)",
                     "compiled": True,
                     "block_len": reports[0]["block_len"],
                     "aggregate_msamples_per_s": [
                         r["timed"]["aggregate_msps"] for r in reports],
                     "ingest_scatter_share": [
                         r["timed"]["ingest_scatter_share"]
                         for r in reports],
                     "seconds": [r["seconds"] for r in reports],
                     "timed_steps": reports[0]["timed"]["steps"],
                     "wall_s_with_start_up": wall,
                     "devices": sorted({r["device"] for r in reports}),
                     "card": smi}


C64 = torch.complex64
UNIFIED_ATOL = 2e-3     # planar vs complex64 (tests/test_unified_pipeline.py)
# CW audio, complex64 vs planar step: each row's rms and its magnitude
# spectrum, relative. Sound runs on an NVIDIA H100 80GB HBM3 (700 W) read
# 1.8e-5 and 2.2e-3 (the float32 ramp's carrier phase); the CW beep offset
# by 0.5%, planted in every run (``planted_cw_pitch``), must read above
# the spectrum limit.
CW_RMS_LIMIT = 1e-3
CW_SPECTRUM_LIMIT = 1e-2
CW_PITCH_FAULT = 1.005


def phase_audio_distance(got, want) -> tuple[float, float]:
    """The largest row's rms difference (relative) and magnitude-spectrum
    distance between two audio tensors [..., C, L]."""
    from cubicsdr_tpu_torch.parallel.multihost import _spectrum_distance
    got, want = (x.cpu().numpy().astype(np.float64) for x in (got, want))
    p, q = (np.sqrt(np.mean(x * x, axis=(-2, -1))) for x in (got, want))
    e = float(np.max(np.abs(p - q) / np.maximum(q, 1e-9)))
    return e, float(np.max(_spectrum_distance(got, want)))


def complex_vs_planar(rx, outs_c, outs_p, worst) -> None:
    """The complex64 step against the planar step with both kernels, at
    tests/test_unified_pipeline.py's gates: mix and analog audio atol
    2e-3 / rtol 2e-3, every group's level atol 0.1. CW audio follows the
    carrier's phase, and the complex64 path's float32 ramp rounds
    omega*k to half an ulp (up to 0.0078 rad at k = 256,000, omega =
    0.94) where the route kernel builds its phase from pre-wrapped
    increments: its rows are held by rms (CW_RMS_LIMIT) and magnitude
    spectrum (CW_SPECTRUM_LIMIT), and the rotation between the two
    steps' iq taps is recorded (``carrier_rotation_rad``)."""
    def fold(k, v):
        worst[k] = max(worst.get(k, 0.0), v)

    for oc, op in zip(outs_c, outs_p):
        pairs = [("mix", oc["mix"], op["mix"])]
        for gi, (gc, gp) in enumerate(zip(oc["groups"], op["groups"])):
            lv = float((gc["level"] - gp["level"]).abs().max())
            if not lv <= 0.1:
                raise AssertionError(f"group {gi} level vs planar: {lv}")
            fold("level_err", lv)
            if "audio" not in gp:
                continue
            if rx.groups[gi].modem_name != "CW":
                pairs.append((f"group {gi} audio", gc["audio"],
                              gp["audio"]))
                continue
            yc = gc["iq"].cpu().numpy()
            yp = gp["iq"]
            yp = (yp.re + 1j * yp.im).cpu().numpy()
            rot = np.angle((yc * np.conj(yp)).sum(axis=-1))
            fold("carrier_rotation_rad", float(np.abs(rot).max()))
            e, d = phase_audio_distance(gc["audio"], gp["audio"])
            if e > CW_RMS_LIMIT or d > CW_SPECTRUM_LIMIT:
                raise AssertionError(f"group {gi} CW audio vs planar: rms "
                                     f"{e}, spectrum {d}")
            fold("cw_audio_rms_rel", e)
            fold("cw_audio_spectrum_rel", d)
        for what, a, b in pairs:
            a, b = a.cpu().numpy(), b.cpu().numpy()
            np.testing.assert_allclose(a, b, atol=UNIFIED_ATOL,
                                       rtol=UNIFIED_ATOL, err_msg=what)
            if a.size:
                fold("audio_err", float(np.abs(a - b).max()))


def planted_cw_pitch(plan, scan_block, blocks, ctl, outs_p) -> dict:
    """scan58's complex64 step with its CW beep offset by CW_PITCH_FAULT
    against the planar step: every block must fail the CW gate."""
    from dataclasses import replace
    cw = [gi for gi, s in enumerate(plan.specs) if s.modem_name == "CW"]
    specs = list(plan.specs)
    for gi in cw:
        specs[gi] = replace(specs[gi], settings=(
            ("offset", 650.0 * CW_PITCH_FAULT),))
    rx = replace(plan, specs=tuple(specs)).pipeline(block_len=scan_block,
                                                    dtype=C64)
    outs, _ = run_blocks(rx, blocks, ctl)
    reads = [phase_audio_distance(o["groups"][gi]["audio"],
                                  p["groups"][gi]["audio"])
             for o, p in zip(outs, outs_p) for gi in cw]
    least = min(d for _, d in reads)
    if not least > CW_SPECTRUM_LIMIT:
        raise AssertionError(f"CW beep x{CW_PITCH_FAULT} passes the gate: "
                             f"spectrum {least}")
    return {"pitch_ratio": CW_PITCH_FAULT,
            "min_spectrum_rel": least,
            "min_rms_rel": min(e for e, _ in reads)}


def complex_widths():
    """(name, pipeline factory, blocks on the card, controls, tone rows)
    for demod16 and scan58 (a factory takes the pipeline's keywords),
    scan58's plan and its block length."""
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    from cubicsdr_tpu_torch.utils.synth import demod_freqs, scan58, synth_fm
    freqs = demod_freqs(16, spread=15)
    iq = synth_fm(freqs[:15], 3 * BLOCK, FS, "cuda", seed=1)
    d16_blocks = [iq[:, b * BLOCK:(b + 1) * BLOCK].contiguous()
                  for b in range(3)]

    def d16(**kw):
        return ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 16)],
                                block_len=BLOCK, **kw)

    plan = scan58()
    scan_block = plan.pipeline(device="cpu").block_len

    def s58(**kw):
        return plan.pipeline(block_len=scan_block, **kw)

    ctl16 = d16(device="cpu").control_template()
    ctl16[0]["frequency"] = freqs
    widths = [("demod16", d16, d16_blocks, ctl16,
               [(0, k, 700.0 + 90.0 * k) for k in range(15)]),
              ("scan58", s58, plan_blocks(plan, 3, scan_block, 11),
               plan.controls(s58(device="cpu")),
               [(0, 0, 700.0), (1, 0, 1000.0), (2, 0, 400.0)])]
    return widths, plan, scan_block


def check_complex64(smi: str):
    """Phase 20. Returns (complex64 launches by width, summary, rate
    rows)."""
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    try:
        ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 16)], dtype=C64,
                         use_kernels=True)
    except ValueError:
        pass
    else:
        raise AssertionError("use_kernels=True with complex64 ran")
    launches, summary, rows = {}, {}, []
    widths, plan, scan_block = complex_widths()
    for name, make, blocks, ctl, tones in widths:
        rx_c = make(dtype=C64)
        if (rx_c.use_kernels or any(rx_c.fused_route)
                or rx_c.device.type != "cuda"):
            raise AssertionError(f"{name} complex64 default: kernels "
                                 f"{rx_c.use_kernels}, fused "
                                 f"{rx_c.fused_route}, {rx_c.device}")
        rx_p = make()
        reset_launches()
        outs_c, _ = run_blocks(rx_c, blocks, ctl)
        launches[name] = read_launches()
        reset_launches()
        outs_p, _ = run_blocks(rx_p, blocks, ctl)
        planar_launches = read_launches()
        if min(planar_launches.values()) < 3 or any(launches[name].values()):
            raise AssertionError(f"{name} launches: complex64 "
                                 f"{launches[name]}, planar "
                                 f"{planar_launches}")
        rx_cpu = make(dtype=C64, device="cpu")
        outs_cpu, befores = run_blocks(rx_cpu, [b.cpu() for b in blocks],
                                       ctl)
        w_cpu, w_planar = {}, {}
        compare_groups(rx_cpu, outs_c, outs_cpu, befores, w_cpu)
        complex_vs_planar(rx_c, outs_c, outs_p, w_planar)
        if name == "scan58":
            w_planar["planted_cw_pitch"] = planted_cw_pitch(
                plan, scan_block, blocks, ctl, outs_p)
        for gi, row, f0 in tones:
            a = np.concatenate([o["groups"][gi]["audio"][row, 0].cpu()
                                .numpy() for o in outs_c[1:]])
            snr = tone_snr(a, f0, rx_c.audio_rate)
            if not snr > 40:
                raise AssertionError(f"{name} complex64 group {gi} row "
                                     f"{row}: tone SNR {snr:.1f} dB")
            w_cpu["min_tone_snr_db"] = min(w_cpu.get("min_tone_snr_db",
                                                     1e9), snr)
        summary[name] = {"block_len": rx_c.block_len,
                         "launches_complex64": launches[name],
                         "launches_planar": planar_launches,
                         "vs_cpu": w_cpu, "vs_planar_kernels": w_planar}
        rates = {}
        for turn in ("planar", "complex64", "complex64", "planar"):
            rx = rx_p if turn == "planar" else rx_c
            rates.setdefault(turn, []).append(
                timed_steps(rx, blocks[:2], ctl, 10))
        rows.append({"row": f"{name}_complex64_vs_planar",
                     "block_len": rx_c.block_len,
                     **{f"{k}_msamples_per_s": [r[0] for r in v]
                        for k, v in rates.items()},
                     **{f"{k}_ms_per_block": [r[1] for r in v]
                        for k, v in rates.items()}, "card": smi})
        del rx_c, rx_p, rx_cpu, outs_c, outs_p, outs_cpu, befores
    return launches, summary, rows


def check_complex_modes():
    """Phase 21: complex64 in 'pfbch' and 'single' on the coverage plans,
    2 blocks each, against the CPU; no kernel launch."""
    from cubicsdr_tpu_torch.utils.synth import coverage_plans
    total, worst, rows = {}, {}, []
    for i, plan in enumerate(coverage_plans()):
        for mode in ("pfbch", "single"):
            rx = plan.pipeline(dtype=C64, chan_mode=mode)
            rx_cpu = plan.pipeline(dtype=C64, chan_mode=mode, device="cpu")
            blocks = plan_blocks(plan, 2, rx.block_len, 30 + i)
            reset_launches()
            outs, _ = run_blocks(rx, blocks, plan.controls(rx))
            launches = read_launches()
            outs_cpu, befores = run_blocks(
                rx_cpu, [b.cpu() for b in blocks], plan.controls(rx_cpu))
            w = {}
            compare_groups(rx_cpu, outs, outs_cpu, befores, w)
            for k, v in w.items():
                worst[k] = (worst.get(k, 0) + v if k.startswith("symbol")
                            else max(worst.get(k, 0.0), v))
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            rows.append({"plan": plan.name, "mode": mode,
                         "block_len": rx.block_len, "M": rx.M})
    if any(total.values()):
        raise AssertionError(f"complex64 modes launched kernels: {total}")
    return total, worst, rows


def check_live_complex():
    """Phase 22. Returns (launches of the complex64 live run, of the
    planar blocks of the swap run, summary)."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    from cubicsdr_tpu_torch.utils.synth import demod_freqs, synth_fm
    freqs = demod_freqs(16, spread=15)
    iq = synth_fm(freqs[:15], LIVE_BLOCKS * BLOCK, FS, "cuda", seed=3)
    iq = iq.cpu().numpy()
    blocks = [np.ascontiguousarray(iq[:, b * BLOCK:(b + 1) * BLOCK])
              for b in range(LIVE_BLOCKS)]

    def pipe(**kw):
        return ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 16)],
                                block_len=BLOCK, **kw)

    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name, dev in (("card", "cuda"), ("cpu", "cpu")):
            d = Path(tmp) / name
            d.mkdir()
            lr, mixes, lines = run_live(pipe(dtype=C64, device=dev), freqs,
                                        blocks, d, views=True)
            if lr.planar or lr.zoom.planar:
                raise AssertionError("complex64 live loop is planar")
            reset_launches()
            n = drive_live(lr)
            launches = read_launches() if name == "card" else None
            lr.stop()
            if n != LIVE_BLOCKS:
                raise AssertionError(f"{name} complex64 live: {n} blocks")
            runs[name] = dict(lr=lr, mixes=mixes, lines=lines, l=launches,
                              wavs={f: read_pcm16(d / f"{f}.wav")
                                    for f in ("rec_demod0", "rec_demod5",
                                              "sub")})
        g, c = runs["card"], runs["cpu"]
        if any(g["l"].values()):
            raise AssertionError(f"complex64 live launches {g['l']}")
        drops = (g["lr"].ring.dropped_samples,
                 g["lr"].metrics.snapshot()["ingest"]["dropped"])
        if drops != (0, 0):
            raise AssertionError(f"complex64 live ring drops {drops}")
        worst = {"rms": 0.0, "q995": 0.0}
        for f in g["wavs"]:
            e = audio_close(g["wavs"][f], c["wavs"][f], f"c64 wav {f}")
            worst = {k: max(worst[k], e[k]) for k in worst}
        for i, (a, b) in enumerate(zip(g["mixes"], c["mixes"])):
            e = audio_close(a, b, f"c64 live mix block {i}")
            worst = {k: max(worst[k], e[k]) for k in worst}
        if g["lines"] != c["lines"]:
            raise AssertionError(f"c64 waterfall lines {g['lines']} vs "
                                 f"{c['lines']}")
        total = sum(g["lines"])
        errs = {}
        for what, (a, b) in {
                "waterfall": [r["lr"].waterfall.buffer[-(total - 2):]
                              for r in (g, c)],
                "zoom": [r["lr"].zoom.points for r in (g, c)],
                "demod_view": [r["lr"].demod_spectrum for r in (g, c)]
        }.items():
            np.testing.assert_allclose(a, b, atol=WF_ATOL, err_msg=what)
            ok = np.isfinite(a)
            errs[what] = float(np.abs(a[ok] - b[ok]).max())
        summary["complex64_live"] = {"audio": worst, "points_err": errs,
                                     "waterfall_lines": g["lines"]}

        # A planar card loop swapped to the complex64 plan mid-stream and
        # back: each step sees only its own representation. Eager, every
        # block calls its pipeline's apply; compiled, only each plan's
        # first block does (two warm-ups and two captures), and the
        # return to the planar plan replays its cached step.
        summary["swap"] = {}
        for compiled in (False, True):
            rx_p, rx_c = pipe(), pipe(dtype=C64)
            seen = []
            for rx in (rx_p, rx_c):
                def apply(st, inputs, rx=rx, orig=rx.apply):
                    seen.append((rx is rx_c, isinstance(inputs[0], PC)))
                    return orig(st, inputs)
                rx.apply = apply
            ctl = rx_p.control_template()
            ctl[0]["frequency"] = freqs
            lr = LiveReceiver(rx_p, ctl, iter(blocks), waterfall_fft=1024,
                              waterfall_lines=64, compiled=compiled)
            lr.set_zoom(1e6, 1e6)
            join_prewarms()
            lr.start_producer()
            reset_launches()
            n = lr.run_blocks(max_blocks=2)
            lr.swap_pipeline(rx_c, ctl)
            n += lr.run_blocks(max_blocks=2)
            lr.swap_pipeline(rx_p, ctl)
            n += lr.run_blocks()
            swap_launches = read_launches()
            lr.stop()
            if compiled:        # per build: the warm-ups and 2 captures
                calls = build_warmups("cuda") + 2
                want = [(False, True)] * calls + [(True, False)] * calls
            else:
                want = ([(False, True)] * 2 + [(True, False)] * 2
                        + [(False, True)] * 2)
            snap = lr.metrics.snapshot()
            if (n != LIVE_BLOCKS or seen != want
                    or snap["pipeline"]["dropped"] or lr.ring.dropped_samples):
                raise AssertionError(
                    f"swap run (compiled={compiled}): {n} blocks, steps saw "
                    f"{seen}, {snap['pipeline']}, ring drops "
                    f"{lr.ring.dropped_samples}")
            steps = 4 + build_warmups("cuda") * compiled
            if swap_launches != {"pfbch2_planar": steps,
                                 "routed_shifted_resample": steps}:
                raise AssertionError(f"swap run (compiled={compiled}) "
                                     f"launches {swap_launches}")
            if compiled and lr.step_builds != 2:
                raise AssertionError(f"swap run built {lr.step_builds} "
                                     f"steps for 2 plans")
            summary["swap"]["compiled" if compiled else "eager"] = {
                "blocks": n, "planar_blocks": 4, "complex64_blocks": 2,
                "apply_calls": len(seen), "launches": swap_launches,
                "ring_dropped": 0}
    return g["l"], swap_launches, summary


def check_scaling(smi: str):
    """Phase 23: the dry run on one NCCL rank, then the weak-scaling rows
    over 1 rank (NCCL: the compiled sharded step) and 2 ranks sharing the
    card (host collectives: the eager step, ``"compiled": false``)."""
    from cubicsdr_tpu_torch.parallel.dryrun import dryrun_multichip
    from cubicsdr_tpu_torch.parallel.scaling import measure_scaling
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, "cuda")
    t1 = time.perf_counter()
    rep = measure_scaling(device_counts=[1, 2], device="cuda",
                          host_collectives=True)
    t2 = time.perf_counter()
    one, two = rep["rows"]
    if dry["backend"] != "nccl" or one["backend"] != "nccl" \
            or not all(r["msps"] > 0 for r in rep["rows"]) \
            or (one["compiled"], two["compiled"]) != (True, False) \
            or (one["host_collectives"], two["host_collectives"]) != (
                False, True):
        raise AssertionError(f"dry run {dry}, scaling {rep}")
    return dry, {**rep, "dryrun_wall_s": t1 - t0, "scaling_wall_s": t2 - t1,
                 "card": smi}


GRAPH_ATOL = 1e-6      # a CUDA graph replays the eager step's kernels


def graph_step(rx, state, iqs, controls):
    """The bench's K-block step (``bench.multi_step``) with every digital
    group's symbols beside the mix and the levels."""
    from cubicsdr_tpu_torch.ops.planar import PC
    mixes, levels, symbols = [], [], []
    for k in range(iqs.re.shape[0]):
        state, out = rx.apply(state, (PC(iqs.re[k], iqs.im[k]), controls))
        mixes.append(out["mix"])
        levels.append(torch.cat([g["level"] for g in out["groups"]], -1))
        symbols.append([g["symbols"] for g in out["groups"]
                        if "symbols" in g])
    return (state, torch.stack(mixes), torch.stack(levels),
            *(torch.stack(s) for s in zip(*symbols)))


def graph_vs_eager(name, rx, iqs, controls) -> dict:
    """Two replays of the graphed K-block step against 2K eager steps
    from the same state on the same inputs: every output and every leaf
    of the final state within GRAPH_ATOL; the capture launches the PFB K
    times and the route kernel K times per fused group. Then the
    unprofiled wall ms per block of each, over 3 dispatches after one."""
    from cubicsdr_tpu_torch.bench import K, GraphedScan, device_controls
    from cubicsdr_tpu_torch.utils.tree import tree_leaves
    ctl = device_controls(controls, rx.device)
    graph = GraphedScan(rx, rx.init_state(), iqs, ctl, step=graph_step)
    want = {"pfbch2_planar": K,
            "routed_shifted_resample": K * sum(rx.fused_route)}
    if graph.launches != want:
        raise AssertionError(f"{name}: graph captured {graph.launches}, "
                             f"expected {want}")
    got = [[o.clone() for o in graph.replay()] for _ in range(2)]
    st = rx.init_state()
    eager = []
    for _ in range(2):
        st, *outs = graph_step(rx, st, iqs, ctl)
        eager.append(outs)
    torch.cuda.synchronize()
    worst = 0.0
    pairs = [(g, e) for gs, es in zip(got, eager) for g, e in zip(gs, es)]
    pairs += list(zip(tree_leaves(graph.state), tree_leaves(st)))
    for g, e in pairs:
        if g.shape != e.shape or g.dtype != e.dtype:
            raise AssertionError(f"{name}: graph output {g.shape} "
                                 f"{g.dtype} vs eager {e.shape} {e.dtype}")
        worst = max(worst, float((g.double() - e.double()).abs().max()))
    if not worst <= GRAPH_ATOL:
        raise AssertionError(f"{name}: graph vs eager max abs diff {worst}")

    def wall_ms(dispatch):
        dispatch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dispatch()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (3 * K) * 1e3

    state = [st]

    def eager_dispatch():
        state[0], *_ = graph_step(rx, state[0], iqs, ctl)

    return {"max_abs_diff": worst, "outputs_compared": len(pairs),
            "symbol_groups": len(got[0]) - 2, "capture_launches":
            graph.launches, "graph_ms_per_block": wall_ms(graph.replay),
            "eager_ms_per_block": wall_ms(eager_dispatch)}


def check_graphs(smi: str):
    """Phase 24: the bench's CUDA graph of K receive steps on demod16,
    demod256 and scan58 (all six modem kits in one graph), each against
    the eager step (``graph_vs_eager``) on K blocks of a synthesised
    capture with a station under the demods; ``bench.main`` for the
    demod16, demod256 and live16 rows (printed as they come); each demod
    row's device idle share, eager and graphed: 1 - the profiled device
    kernel ms per block (``profile_step``) over the bench's unprofiled
    wall ms per block; and ``entry()`` on the card against itself on the
    CPU at the pipeline's gates. Returns (capture launches per path,
    results)."""
    from cubicsdr_tpu_torch import bench
    from cubicsdr_tpu_torch.entry import entry
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.utils import profile_step
    from cubicsdr_tpu_torch.utils.synth import demod_freqs, scan58, synth_fm
    K = bench.K
    res, launches = {}, {}
    iq = synth_fm(demod_freqs(16, spread=15)[:15], K * BLOCK, FS, "cuda",
                  seed=4).reshape(2, K, BLOCK)
    for n in (16, 256):
        rx = build_pipeline(n, "cuda", True)
        ctl = rx.control_template()
        ctl[0]["frequency"] = demod_freqs(n, spread=15)
        r = graph_vs_eager(f"demod{n}", rx, PC(iq[0], iq[1]), ctl)
        res[f"graph_demod{n}"] = r
        # Per block: a replay of the K-step graph launches its kernels
        # once per step.
        launches[f"graph_capture_demod{n}"] = {
            k: v / K for k, v in r["capture_launches"].items()}
        line(f"graph demod{n}: {json.dumps(r)} [{smi}]")
        del rx
    del iq
    plan = scan58()
    rx = plan.pipeline()
    iq = plan.capture(K * rx.block_len, "cuda", seed=12).reshape(
        2, K, rx.block_len)
    r = graph_vs_eager("scan58", rx, PC(iq[0], iq[1]), plan.controls(rx))
    if r["symbol_groups"] != sum(rx.is_digital):
        raise AssertionError(f"scan58 graph compared {r['symbol_groups']} "
                             f"symbol groups of {sum(rx.is_digital)}")
    res["graph_scan58"] = r
    launches["graph_capture_scan58"] = {
        k: v / K for k, v in r["capture_launches"].items()}
    line(f"graph scan58: {json.dumps(r)} [{smi}]")
    del rx, iq

    rows = bench.main(["--only", "demod16", "--only", "demod256",
                       "--only", "live16", "--only", "live16_i16",
                       "--only", "live16_i8"])
    for r in rows:
        if "live_loop" in r["metric"] and (
                r["ring_dropped_samples"] or r["eager_ring_dropped_samples"]):
            raise AssertionError(f"bench row dropped samples: {r}")
    idle = {}
    profiles = [(f"demod{n}", lambda g, n=n: profile_step.profile(
        n, 16, top=4, graph=g)) for n in (16, 256)]
    profiles.append(("scan58", lambda g: profile_step.profile_plan(
        "scan58", 16, top=4, graph=g)))
    walls = {f"demod{n}": next(
        (r["graph_ms_per_block"], r["eager_ms_per_block"]) for r in rows
        if r["metric"].endswith(f"demod{n}")) for n in (16, 256)}
    walls["scan58"] = (res["graph_scan58"]["graph_ms_per_block"],
                       res["graph_scan58"]["eager_ms_per_block"])
    for name, prof in profiles:
        for graphed, wall in zip((True, False), walls[name]):
            p = prof(graphed)
            key = f"{name}_{'graph' if graphed else 'eager'}"
            idle[key] = {
                "device_ms_per_block": p["device_ms_per_block"],
                "unprofiled_wall_ms_per_block": wall,
                "idle_share": 1.0 - p["device_ms_per_block"] / wall,
                "profiled_wall_ms_per_block": p["wall_ms_per_block"],
                "profiled_idle_share": p["device_idle_share"],
                "device_launches_per_block":
                    p["kernel_launches_per_block"],
                "top": p["top"]}
            line(json.dumps({"row": f"idle_{key}", **idle[key],
                             "card": smi}))
    res["idle"] = idle

    reset_launches()
    fn, (st, x) = entry()
    st, mix, level = fn(st, x)
    launches["entry"] = read_launches()
    fn_c, (st_c, x_c) = entry("cpu")
    _, mix_c, level_c = fn_c(st_c, x_c)
    if launches["entry"] != {"pfbch2_planar": 1,
                             "routed_shifted_resample": 1}:
        raise AssertionError(f"entry() launches {launches['entry']}")
    worst = {"mix": audio_close(mix.cpu().numpy(), mix_c.numpy(),
                                "entry() mix"),
             "level": float((level.cpu() - level_c).abs().max())}
    if not worst["level"] <= 0.05:
        raise AssertionError(f"entry() level off by {worst['level']}")
    res["entry"] = {"block_len": int(x.re.shape[0]),
                    "mix_shape": list(mix.shape), **worst}
    line(f"entry() on the card vs the CPU: launches {launches['entry']}, "
         f"{json.dumps(res['entry'])} [{smi}]")
    return launches, res, rows


LIVE_TURN = 10          # blocks per timed window of phase 25's turns


def host_outputs(o) -> dict:
    """What ``on_block`` hands the host for one block, copied: the mix and
    each group's level, symbols, squelch flags and packed audio."""
    return {"mix": o["mix"].copy(), "groups": [
        {k: g[k].copy() for k in ("level", "symbols", "squelched", "audio")
         if k in g} for g in o["groups"]]}


def same_outputs(a: list, b: list, what: str) -> int:
    """Every host output of two runs equal bit for bit (NaN at the same
    points); returns the number of arrays compared."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} blocks vs {len(b)}")
    n = 0
    for i, (x, y) in enumerate(zip(a, b)):
        pairs = [(x["mix"], y["mix"], "mix")]
        for gi, (gx, gy) in enumerate(zip(x["groups"], y["groups"])):
            if gx.keys() != gy.keys():
                raise AssertionError(f"{what} block {i} group {gi}: "
                                     f"{sorted(gx)} vs {sorted(gy)}")
            pairs += [(gx[k], gy[k], f"group {gi} {k}") for k in gx]
        for p, q, name in pairs:
            if p.dtype != q.dtype or not np.array_equal(p, q,
                                                        equal_nan=True):
                raise AssertionError(f"{what} block {i} {name} differs")
            n += 1
    return n


def live_turns(name, rx, controls, blocks, views, n_warm: int = 8,
               windows: int = 4, zoom_only: bool = False
               ) -> tuple[dict, dict]:
    """Phase 25 on one plan: a compiled and an eager ``LiveReceiver`` on
    ``rx``, each fed ``blocks`` cycled with back-pressure (so both see
    the same stream), ``views(lr)`` applied to each; ``n_warm`` blocks
    each, then ``windows`` timed windows of LIVE_TURN blocks in turns
    (compiled, eager, eager, compiled, ...), then one profiled window
    each for the device time. Every host output of every block, the
    waterfall and the views compared bit for bit. With ``zoom_only``
    (phase 28) both loops are compiled and only the "eager" one's zoom
    view steps eagerly. Returns (per mode its launches, the summary)."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    from cubicsdr_tpu_torch.utils.profile_step import _device_ms
    from cubicsdr_tpu_torch.utils.synth import CycleSource
    from cubicsdr_tpu_torch.visual.spectrum import ZoomSpectrumView
    modes = ("compiled", "eager")
    lrs, seen = {}, {m: [] for m in modes}
    for mode in modes:
        src = CycleSource(blocks)
        lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                          waterfall_lines=64,
                          compiled=zoom_only or mode == "compiled",
                          on_block=lambda o, s=seen[mode]: s.append(
                              host_outputs(o)))
        src.ring = lr.ring
        if zoom_only and mode == "eager":
            # The stashed view is what set_zoom attaches.
            lr._zoom_stash = ZoomSpectrumView(
                rx.sample_rate, rx.block_len, fft_size=1024,
                device="cuda", dtype=rx.dtype, compiled=False)
        views(lr)
        join_prewarms()          # before the script synchronises the card
        if lr.zoom is not None and isinstance(
                lr.zoom._step, CompiledStep) != (mode == "compiled"):
            raise AssertionError(f"{name} {mode}: the zoom view's step "
                                 f"is {type(lr.zoom._step).__name__}")
        lrs[mode] = lr
    launches = {m: {"pfbch2_planar": 0, "routed_shifted_resample": 0}
                for m in modes}
    ran = dict.fromkeys(modes, 0)

    def window(mode, n):
        reset_launches()
        t0 = time.perf_counter()
        k = lrs[mode].run_blocks(max_blocks=n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if k != n:
            raise AssertionError(f"{name} {mode}: {k} of {n} blocks")
        ran[mode] += k
        for kk, v in read_launches().items():
            launches[mode][kk] += v
        return dt

    secs = {m: [] for m in modes}
    idle = {}
    try:
        for mode in modes:
            lrs[mode].start_producer()
            window(mode, n_warm)
        for w in range(windows):
            order = modes if w % 2 == 0 else modes[::-1]
            for mode in order:
                secs[mode].append(window(mode, LIVE_TURN))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for mode in modes:
            with torch.profiler.profile(activities=acts) as prof:
                pwall = window(mode, LIVE_TURN)
            dev_ms, top = _device_ms(prof, LIVE_TURN, 4)
            wall_ms = float(np.median(secs[mode])) / LIVE_TURN * 1e3
            idle[mode] = {"device_ms_per_block": dev_ms,
                          "wall_ms_per_block": wall_ms,
                          "idle_share": 1.0 - dev_ms / wall_ms,
                          "profiled_wall_ms_per_block":
                              pwall / LIVE_TURN * 1e3, "top": top}
    finally:
        for lr in lrs.values():
            lr.stop()
    lc, le = lrs["compiled"], lrs["eager"]
    for lr in (lc, le) if zoom_only else (lc,):
        if not isinstance(lr.step, CompiledStep) or lr.step_builds != 1:
            raise AssertionError(f"{name}: a compiled loop built "
                                 f"{lr.step_builds} steps")
    compared = same_outputs(seen["compiled"], seen["eager"], name)
    for what, a, b in (("waterfall", lc.waterfall.buffer,
                        le.waterfall.buffer),
                       ("demod view", lc.demod_spectrum, le.demod_spectrum),
                       ("zoom", None if lc.zoom is None else lc.zoom.points,
                        None if le.zoom is None else le.zoom.points)):
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b, equal_nan=True)):
            raise AssertionError(f"{name}: {what} compiled vs eager differs")
        compared += a is not None
    drops = {m: (lr.ring.dropped_samples,
                 lr.metrics.snapshot()["pipeline"]["dropped"])
             for m, lr in lrs.items()}
    if any(d != (0, 0) for d in drops.values()):
        raise AssertionError(f"{name}: drops {drops}")
    per = {"pfbch2_planar": 1,
           "routed_shifted_resample": sum(rx.fused_route)}
    for mode in modes:
        steps = ran[mode] + build_warmups("cuda") * (
            zoom_only or mode == "compiled")
        want = {k: v * steps for k, v in per.items()}
        if launches[mode] != want:
            raise AssertionError(f"{name} {mode}: launches "
                                 f"{launches[mode]}, expected {want}")
    rates = {}
    for mode in modes:
        ms = [t / LIVE_TURN * 1e3 for t in secs[mode]]
        msps = [rx.block_len / (m * 1e3) for m in ms]
        rates[mode] = {"msamples_per_s": float(np.median(msps)),
                       "msamples_per_s_windows": msps,
                       "ms_per_block": float(np.median(ms)),
                       **{k: v for k, v in idle[mode].items() if k != "top"},
                       "top": idle[mode]["top"],
                       "blocks": ran[mode], "launches": launches[mode]}
    return launches, {
        "block_len": rx.block_len, "blocks_per_window": LIVE_TURN,
        "windows": windows, "outputs_compared": compared,
        "bit_for_bit": True, "ring_dropped_samples": 0,
        "step_capture_ms": lc.step.build_ms,
        "post_steps_built": lc.post_builds, **rates}


def check_compiled_vs_eager(smi: str):
    """Phase 25: the compiled and the eager live loop in turns on live16
    (demod16 over the 16-station signal, the demod view on row 4 and the
    zoom view at +1 MHz / 1 MHz) and on scan58 (its capture, the demod
    view on BPSK row 1), bit for bit on every host output, with MS/s, ms
    per block, drops and the card's idle share for each."""
    from cubicsdr_tpu_torch.utils.synth import scan58
    freqs, blocks = live_blocks()
    rx = build_pipeline(16, "cuda", True)
    ctl = rx.control_template()
    ctl[0]["frequency"] = freqs

    def views16(lr):
        lr.set_demod_view(4)
        lr.set_zoom(1e6, 1e6)

    res, launches = {}, {}
    launches["live16"], res["live16"] = live_turns(
        "live16", rx, ctl, blocks[:4], views16)
    line(f"compiled vs eager live16: {json.dumps(res['live16'])} [{smi}]")
    del rx
    plan = scan58()
    rx = plan.pipeline()
    cap = plan.capture(4 * rx.block_len, "cuda", seed=13).cpu().numpy()
    sblocks = [np.ascontiguousarray(cap[:, b * rx.block_len:
                                        (b + 1) * rx.block_len])
               for b in range(4)]
    launches["scan58"], res["scan58"] = live_turns(
        "scan58", rx, plan.controls(rx), sblocks,
        lambda lr: lr.set_demod_view(16 * 3 + 4 + 1))
    line(f"compiled vs eager live scan58: {json.dumps(res['scan58'])} "
         f"[{smi}]")
    return launches, res


def capture_case(name, rx, step, eager, blocks, controls) -> dict:
    """One compiled step against its eager function on ``blocks`` from the
    same state: every output and the final state bit for bit; each
    slot's graph launches the kernels as one eager block does."""
    from cubicsdr_tpu_torch.utils.tree import tree_leaves
    st_c = st_e = rx.init_state()
    reset_launches()
    st_e, _ = eager(st_e, (blocks[0], controls))
    per_block = read_launches()
    st_e = rx.init_state()
    n = 0
    for blk in blocks:
        st_e, oe = eager(st_e, (blk, controls))
        st_c, oc = step(st_c, (blk, controls))
        for a, b in zip(tree_leaves(oe), tree_leaves(oc)):
            if (a.shape != b.shape or a.dtype != b.dtype
                    or not torch.equal(a, b)):
                raise AssertionError(f"{name}: compiled output differs")
            n += 1
    for a, b in zip(tree_leaves(st_e), tree_leaves(st_c)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: compiled state differs")
        n += 1
    if any(g != per_block for g in step.launches):
        raise AssertionError(f"{name}: graphs hold {step.launches}, an "
                             f"eager block launches {per_block}")
    return {"case": name, "blocks": len(blocks), "compared": n,
            "max_abs_diff": 0.0, "capture_ms": step.build_ms,
            "launches_per_replay": per_block}


def check_captures(smi: str) -> list[dict]:
    """Phase 26: every modem captured. Each plan's ``apply`` as a
    ``CompiledStep`` (the CLI's) against itself eagerly: demod16 and
    scan58 with 'pfbch2' (both kernels), 'pfbch' and 'single', the
    coverage plans (every other modem), demod16 and scan58 in complex64,
    and the live loop's int16 and int8 ingest steps at demod16 against
    their eager closures, 3 blocks each (2 for the coverage plans)."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    from cubicsdr_tpu_torch.utils.synth import coverage_plans, scan58
    rows = []

    def planar(x):
        return [PC(b[0], b[1]) for b in x]

    def complex64(x):
        return [torch.complex(b[0], b[1]) for b in x]

    def case(name, rx, blocks, controls):
        ctl = [{k: torch.as_tensor(v, device="cuda") for k, v in c.items()}
               for c in controls]
        x = complex64(blocks) if rx.dtype == torch.complex64 else \
            planar(blocks)
        r = capture_case(name, rx, CompiledStep(rx.apply, rx.device),
                         rx.apply, x, ctl)
        rows.append(r)
        line(f"capture {json.dumps(r)} [{smi}]")

    freqs, live = live_blocks()
    d16 = [torch.from_numpy(b).cuda() for b in live[:3]]
    for dtype in (None, torch.complex64):
        kw = {} if dtype is None else {"dtype": dtype}
        rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 16)],
                              block_len=BLOCK, **kw)
        ctl = rx.control_template()
        ctl[0]["frequency"] = freqs
        case(f"demod16{'' if dtype is None else '_complex64'}", rx, d16,
             ctl)
    plan = scan58()
    for mode, dtype in (("pfbch2", None), ("pfbch", None), ("single", None),
                        ("pfbch2", torch.complex64)):
        kw = {"chan_mode": mode}
        if dtype is not None:
            kw.update(dtype=dtype,
                      block_len=plan.pipeline(device="cpu").block_len)
        rx = plan.pipeline(**kw)
        blocks = plan_blocks(plan, 3, rx.block_len, seed=11)
        case(f"scan58_{mode}{'' if dtype is None else '_complex64'}", rx,
             blocks, plan.controls(rx))
    for i, p in enumerate(coverage_plans()):
        rx = p.pipeline()
        case(p.name, rx, plan_blocks(p, 2, rx.block_len, 20 + i),
             p.controls(rx))
    for dt in (np.int16, np.int8):
        rx = build_pipeline(16, "cuda", True)
        ctl = rx.control_template()
        ctl[0]["frequency"] = freqs
        full = float(np.iinfo(dt).max + 1)
        raw = [tuple(torch.from_numpy(np.clip(b * full, -full, full - 1)
                                      .astype(dt)).cuda())
               for b in live[:3]]
        lrs = [LiveReceiver(rx, ctl, iter(()), ingest_dtype=dt,
                            compiled=c) for c in (True, False)]
        _, dctl = lrs[1]._device_controls()
        r = capture_case(f"live16_{np.dtype(dt).name}", rx, lrs[0].step,
                         lrs[1].step, raw, dctl)
        for lr in lrs:
            lr.stop()
        rows.append(r)
        line(f"capture {json.dumps(r)} [{smi}]")
    return rows


CHURN_TONE = 700.0      # scan58's FM row 0 station


def station_source(rate: float, offset: float, chunk: int = 1 << 16):
    """The survivor's FM station at ``rate`` samples/s as a
    ``utils/soak.py`` ``PacedSource``: planar float32 chunks of ``chunk``
    samples at their real-time deadlines, as a receiver's SDR delivers
    (the ring absorbs a stall of the consumer and sheds what overflows
    it, counted as ingest drops). Chunks, not blocks: the plan edits of
    phase 27 change the block length. One second of the station
    (``io.sources.SyntheticSource``, its carrier and tone whole numbers
    of cycles per second, so the loop is seamless) is synthesised up
    front and looped, so that producing costs the host a copy."""
    from cubicsdr_tpu_torch.io.sources import Station, SyntheticSource
    from cubicsdr_tpu_torch.utils.soak import PacedSource
    n = int(rate)
    if float(offset) != int(offset) or n != rate:
        raise ValueError("a seamless 1 s loop needs whole-Hz rates")
    iq = next(SyntheticSource(rate, n, [Station(
        offset, "fm", audio_freq=CHURN_TONE, amplitude=0.5)],
        noise=0.01, seed=7))
    return PacedSource(np.stack([iq.real, iq.imag]).astype(np.float32),
                       chunk, rate)


def tone_windows(path: Path, tone: float) -> tuple[int, int]:
    """(windows holding ``tone``, windows) over 250 ms windows of a PCM16
    WAV: the peak above 100 Hz within 40 Hz of the tone
    (tests/test_churn.py's test)."""
    from cubicsdr_tpu_torch.utils.soak import ToneWindows
    tw = ToneWindows(tone)
    tw.add_file(path)
    return tw.good, tw.windows


def check_churn(tmp: Path, plan, card: str = "cuda", cycles: int = 3,
                smi: str = ""):
    """Phase 27: tests/test_churn.py's REST adversary against a compiled
    live loop carrying ``plan``'s session (scan58 on the card), its
    producer at the capture rate with the survivor's (FM row 0) station,
    ``cycles`` cycles of the adversary's plan edits after a checkpoint
    and restore (each cycle ends by restoring the display's line rate,
    so that every cycle runs the same plans and views from the same
    start). Each edit that rebuilds the plan: its POST ms, the ms
    from the POST's return to the first block dispatched on the new plan
    (the capture inside it for a new plan), whether a step was built and
    its capture ms, and ``memory_reserved`` after that block. Fails on a
    dead consumer, a drop, the survivor's tone missing from more than one
    250 ms window, more compiled steps than distinct plans, or a last
    cycle whose ``memory_reserved`` peak is above the cycle's before (the
    second cycle may still grow a little: a view or recording state the
    adversary's timing first reaches then builds its post-step, and the
    caching allocator may split a new segment while ``memory_allocated``
    stays flat; the last cycle must not). The summary line is printed
    first. Returns (the kernels' launches over the run, on the card;
    summary)."""
    import threading
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.app.webview import WebViewer
    from cubicsdr_tpu_torch.receiver import (
        ReceiverPipeline, controls_from_manager, plan_from_manager)
    from cubicsdr_tpu_torch.utils.soak import http
    mgr = plan.manager(CENTER)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(plan.fs, specs, device=card)
    src = station_source(plan.fs, plan.freqs[0][0])
    lr = LiveReceiver(rx, controls_from_manager(mgr, rx, keyed, CENTER),
                      src, center_freq=CENTER, waterfall_fft=1024,
                      waterfall_lines=64)
    plans = {(rx.block_len, tuple(rx.groups))}
    swap = lr.swap_pipeline

    def swap_and_note(pipeline, *a, **kw):
        plans.add((pipeline.block_len, tuple(pipeline.groups)))
        return swap(pipeline, *a, **kw)

    lr.swap_pipeline = swap_and_note
    viewer = WebViewer(lr, mgr, keyed, port=0).start()
    port = viewer.port

    def post(path, body):
        res = json.loads(http(port, path, body))
        if not res.get("ok"):
            raise AssertionError(f"churn {path} {body}: {res}")
        return res

    def blocks_at():
        return lr.metrics.snapshot().get("pipeline", {}).get("blocks", 0)

    consumer_exc = []

    def consume():
        try:
            lr.run_blocks()
        except Exception as e:               # noqa: BLE001 — the check
            consumer_exc.append(e)

    def wait_blocks(n, timeout=120.0):
        t0, base = time.time(), blocks_at()
        while blocks_at() < base + n and time.time() - t0 < timeout:
            time.sleep(0.002)
            if consumer_exc:
                raise consumer_exc[0]
        if blocks_at() < base + n:
            raise AssertionError(f"churn: {n} blocks took over {timeout} s")

    edits = []

    def rebuild(name, cycle, path, body):
        """A plan-changing edit, timed to the first block on the new
        plan."""
        builds, old = lr.step_builds, lr.pipeline
        t0 = time.perf_counter()
        post(path, body)
        t1 = time.perf_counter()
        if lr.pipeline is old:
            raise AssertionError(f"churn {name}: no rebuild")
        wait_blocks(1)
        t2 = time.perf_counter()
        built = lr.step_builds - builds
        edits.append({
            "steps_built_so_far": lr.step_builds,
            "post_steps_built_so_far": lr.post_builds,
            "edit": name, "cycle": cycle, "demods": sum(
                g.count for g in lr.pipeline.groups),
            "post_ms": (t1 - t0) * 1e3, "first_block_ms": (t2 - t1) * 1e3,
            "post_to_first_block_ms": (t2 - t0) * 1e3,
            "step_built": bool(built),
            "capture_ms": lr.step.build_ms if built else None,
            "capture_split_ms": lr.step.build_split_ms if built else None,
            "memory_reserved": (torch.cuda.memory_reserved()
                                if on_card else None),
            "memory_allocated": (torch.cuda.memory_allocated()
                                 if on_card else None),
            "segments": (torch.cuda.memory_stats().get(
                "segment.all.current") if on_card else None)})

    wav = tmp / "churn_survivor.wav"
    lps0 = lr.display_params()["lps"]
    th = threading.Thread(target=consume, daemon=True)
    on_card = torch.device(card).type == "cuda"
    if on_card:
        reset_launches()
    # The receiver's first blocks build its step (the first eager calls
    # of a plan on the card also build the libraries' plans): run three
    # blocks of the station before the producer starts at capture rate.
    for b in range(3):
        blk = src.loop[:, b * rx.block_len:(b + 1) * rx.block_len]
        if not lr.ring.write(np.ascontiguousarray(blk[0]),
                             np.ascontiguousarray(blk[1])):
            raise AssertionError("churn: the ring refused a warm-up block")
    if lr.run_blocks(max_blocks=3, wait=False) != 3:
        raise AssertionError("churn: the warm-up blocks did not run")
    posts0 = lr.post_builds
    t_start = time.perf_counter()
    lr.start_producer()
    th.start()
    try:
        wait_blocks(2)
        ck = str(tmp / "churn_ck.json")
        post("/api/session", {"op": "checkpoint", "path": ck})
        rebuild("add AM", 0, "/api/control", {
            "action": "add", "freq": CENTER - 300e3, "type": "AM",
            "bandwidth": 10000})
        wait_blocks(1)
        rebuild("restore", 0, "/api/session", {"op": "restore",
                                               "path": ck})
        wait_blocks(1)
        post("/api/control", {"action": "audio_output", "name": "surv",
                              "backend": f"wav:{wav}", "demods": [0]})
        for cycle in range(1, cycles + 1):
            for it in range(3):
                rebuild(f"add {('FM', 'AM', 'BPSK')[it]}", cycle,
                        "/api/control", {
                            "action": "add", "freq": CENTER - 300e3,
                            "type": ("FM", "AM", "BPSK")[it],
                            "bandwidth": (200000, 10000, 20000)[it]})
                idx = len(mgr.get_demodulators()) - 1
                wait_blocks(1)
                if it == 0:
                    rebuild("set type", cycle, "/api/control", {
                        "action": "set", "index": idx, "key": "type",
                        "value": "NBFM"})
                if it == 1:
                    rebuild("set bandwidth", cycle, "/api/control", {
                        "action": "set", "index": idx, "key": "bandwidth",
                        "value": 12500})
                for body in (
                        {"action": "set", "index": 0, "key": "frequency",
                         "value": CENTER + plan.freqs[0][0] + it},
                        {"action": "set", "index": idx, "key": "gain",
                         "value": 0.5}):
                    post("/api/control", body)
                if it != 2:
                    post("/api/control", {
                        "action": "set", "index": idx, "key": "recording",
                        "value": True, "path": str(tmp / "rec")})
                    wait_blocks(1)
                    post("/api/control", {
                        "action": "set", "index": idx, "key": "recording",
                        "value": False})
                for path, body in (
                        ("/api/control", {"action": "zoom",
                                          "offset": 200e3,
                                          "bandwidth": 250e3}),
                        ("/api/control", {"action": "display",
                                          "lps": 20.0 + it}),
                        ("/api/control", {"action": "ppm", "delta": 1}),
                        ("/api/bookmarks", {"op": "add", "index": 0,
                                            "group": "churn"}),
                        ("/api/control", {"action": "audio_output",
                                          "name": "chsink",
                                          "backend": "null", "rate": 44100,
                                          "demods": [0]}),
                        ("/api/control", {"action": "audio_solo",
                                          "index": 0}),
                        ("/api/control", {"action": "view", "index": 0})):
                    post(path, body)
                wait_blocks(2)
                for body in ({"action": "audio_solo", "index": None},
                             {"action": "view", "index": None},
                             {"action": "zoom", "offset": None}):
                    post("/api/control", body)
                rebuild("remove", cycle, "/api/control",
                        {"action": "remove", "index": idx})
                wait_blocks(1)
            post("/api/control", {"action": "display", "lps": lps0})
        wait_blocks(4)
    finally:
        src.stop()
        lr._stop.set()
        th.join(timeout=30)
        wall = time.perf_counter() - t_start
        lr.stop()
        viewer.stop()
    join_prewarms()
    launches = read_launches() if on_card else None
    if consumer_exc:
        raise AssertionError(f"churn: the consumer died: {consumer_exc!r}")
    if th.is_alive():
        raise AssertionError("churn: the consumer hung")
    snap = lr.metrics.snapshot()
    drops = {"ingest": int(snap["ingest"]["dropped"]),
             "pipeline": int(snap["pipeline"]["dropped"])}
    good, n_win = tone_windows(wav, CHURN_TONE)
    summary = {"demods": sum(g.count for g in rx.groups),
               "block_len": rx.block_len, "seconds": wall,
               "capture_rate_msps": plan.fs / 1e6,
               "blocks": int(snap["pipeline"]["blocks"]),
               "msamples_per_s": snap["pipeline"]["samples"] / wall / 1e6,
               "producer_late_s": src.late_s, "drops": drops,
               "survivor_tone_windows": [good, n_win],
               "distinct_plans": len(plans),
               "steps_built": lr.step_builds,
               "post_steps_built": lr.post_builds,
               # On the card each build is one capture per output slot.
               "captures": (lr.step_builds + lr.post_builds if on_card
                            else 0), "edits": edits}
    by_cycle = [[e for e in edits if e["cycle"] == c]
                for c in range(cycles + 1)]
    summary["steps_built_by_cycle"] = [sum(e["step_built"] for e in c)
                                       for c in by_cycle]
    summary["post_steps_built_by_cycle"] = [
        c[-1]["post_steps_built_so_far"] - (p[-1]["post_steps_built_so_far"]
                                            if p else posts0)
        for p, c in zip([None] + by_cycle, by_cycle)]
    peak = None
    if on_card:
        peak = [max(e["memory_reserved"] for e in c) for c in by_cycle]
        summary["memory_reserved_peak_by_cycle"] = peak
        summary["memory_allocated_last_by_cycle"] = [
            c[-1]["memory_allocated"] for c in by_cycle]
    line(f"churn {plan.name} on {card}: {json.dumps(summary)} [{smi}]")
    if any(drops.values()):
        raise AssertionError(f"churn: drops {drops}")
    if n_win < 8 or good < n_win - 1:
        raise AssertionError(f"churn: survivor tone in {good} of {n_win} "
                             f"windows")
    if lr.step_builds > len(plans):
        raise AssertionError(f"churn: {lr.step_builds} compiled steps for "
                             f"{len(plans)} distinct plans")
    if cycles >= 2 and summary["steps_built_by_cycle"][-1]:
        raise AssertionError("churn: the last cycle built compiled steps")
    if peak is not None and cycles >= 2 and peak[-1] > peak[-2]:
        raise AssertionError(f"churn: memory_reserved grew in the last "
                             f"cycle: {peak}")
    return launches, summary


SOAK_MODES = (("soak_churn_serve_cs16",
                ["churn_soak", "--minutes", "2", "--format", "cs16"]),
               ("soak_cs8", ["soak", "--format", "cs8", "--minutes", "1"]),
               ("soak_digital_check", ["digital_check"]))


def check_soaks(smi: str) -> dict:
    """Phase 29: ``utils/soak.py``'s modes in process (``SOAK_MODES``),
    the kernels' counters set to 0 just before each and read just after.
    Fails when a mode misses its criteria or a kernel did not launch.
    Returns each mode's launches."""
    from cubicsdr_tpu_torch.utils import soak
    launches = {}
    for name, argv in SOAK_MODES:
        args = soak.parser().parse_args(argv)
        join_prewarms()
        reset_launches()
        t0 = time.perf_counter()
        res = soak.MODES[args.mode](args)
        wall = time.perf_counter() - t0
        join_prewarms()
        launches[name] = read_launches()
        samples = res.pop("samples", None)
        line(f"{name} ({' '.join(argv)}): {wall:.1f} s, launches "
             f"{launches[name]}, {json.dumps(res)} [{smi}]")
        if samples:
            line(f"{name} samples: {json.dumps(samples)}")
        if not res["ok"]:
            raise AssertionError(f"{name} missed its criteria")
        if not all(launches[name].values()):
            raise AssertionError(f"{name}: a kernel did not launch: "
                                 f"{launches[name]}")
    return launches


# Phase 28's zoom walk at live16: +1 MHz at 1 MHz, two zoom-ins, a retune
# at the same level, then back out to the start (a revisit) and past it
# (2 MHz, a level the background prewarm built).
ZOOM_WALK = ((1e6, 1e6), (1e6, 500e3), (1e6, 250e3), (1.2e6, 250e3),
             (1.2e6, 1e6), (1.2e6, 2e6))
ZOOM_STAGE = 3          # blocks per stage of the walk


def join_prewarms() -> None:
    """``utils/soak.py``'s: wait for the zoom views' background level
    builds before a device-wide synchronisation (``reset_launches``
    makes one); raises if one hangs."""
    from cubicsdr_tpu_torch.utils.soak import join_prewarms as join
    join()


def zoom_notes(lr) -> list:
    return [k for k in lr.metrics.notes if k.startswith("zoom_error")]


def zoom_walk(name, rx, controls, blocks, walk, card: str = "cuda",
              per_stage: int = ZOOM_STAGE) -> tuple[dict, dict]:
    """Phase 28's walk on one plan: the compiled live loop with the
    compiled zoom view and the eager loop with the eager view, fed the
    same cycled ``blocks`` with back-pressure, stage by stage in turns
    (each ``set_zoom`` of ``walk``, the background builds joined, then
    ``per_stage`` blocks each): every block's zoom points, the view they
    show and the lines drawn, bit for bit. Each level is built once, the
    revisited level (the walk's stage 4) builds nothing, and every
    visited level is built. Returns (launches per mode, summary)."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    from cubicsdr_tpu_torch.utils.synth import CycleSource
    on_card = torch.device(card).type == "cuda"
    modes = ("compiled", "eager")
    lrs, seen = {}, {}
    launches = {m: {"pfbch2_planar": 0, "routed_shifted_resample": 0}
                for m in modes}
    for mode in modes:
        src = CycleSource(blocks)
        per = seen[mode] = []
        lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                          waterfall_lines=64, compiled=mode == "compiled")
        src.ring = lr.ring
        lr.on_block = lambda o, lr=lr, per=per: per.append(
            None if lr.zoom is None or lr.zoom.points is None else
            (lr.zoom.points.copy(), lr.zoom.points_view, lr.zoom.lines))
        lrs[mode] = lr
    builds_after = []
    try:
        for lr in lrs.values():
            lr.start_producer()
        for off, bw in walk:
            for mode, lr in lrs.items():
                if on_card:
                    reset_launches()
                lr.set_zoom(off, bw)
                join_prewarms()
                if lr.run_blocks(max_blocks=per_stage) != per_stage:
                    raise AssertionError(f"zoom {name} {mode}: short run")
                if on_card:
                    for k, v in read_launches().items():
                        launches[mode][k] += v
            builds_after.append(lrs["compiled"].zoom.level_builds)
    finally:
        for lr in lrs.values():
            lr.stop()
    zc, ze = lrs["compiled"].zoom, lrs["eager"].zoom
    if not isinstance(zc._step, CompiledStep) or isinstance(
            ze._step, CompiledStep):
        raise AssertionError(f"zoom {name}: compiled {type(zc._step)}, "
                             f"eager {type(ze._step)}")
    a, b = seen["compiled"], seen["eager"]
    if len(a) != len(walk) * per_stage or len(a) != len(b):
        raise AssertionError(f"zoom {name}: {len(a)} vs {len(b)} blocks")
    compared = 0
    for i, (x, y) in enumerate(zip(a, b)):
        if (x is None) != (y is None) or (x is not None and (
                x[0].dtype != y[0].dtype or x[1:] != y[1:]
                or not np.array_equal(x[0], y[0], equal_nan=True))):
            raise AssertionError(f"zoom {name} block {i}: compiled vs "
                                 f"eager zoom differs")
        compared += x is not None
    if compared < len(a) - per_stage:
        raise AssertionError(f"zoom {name}: points on {compared} blocks")
    views = [v for v in (x[1] for x in a if x is not None)]
    stage_views = {(off, zc._snap_bw(bw)) for off, bw in walk}
    if set(views) != stage_views:
        raise AssertionError(f"zoom {name}: views shown {set(views)}, "
                             f"walked {stage_views}")
    built = {lv.bw: lv for lv in zc._front_cache.values() if lv.built}
    visited = {zc._snap_bw(bw) for _, bw in walk}
    if (zc.level_builds - zc.level_evictions != len(built)
            or not visited <= set(built)):
        raise AssertionError(f"zoom {name}: {zc.level_builds} builds, "
                             f"{zc.level_evictions} evicted, built "
                             f"{sorted(built)}, visited {sorted(visited)}")
    revisit = next(i for i in range(2, len(walk))
                   if zc._snap_bw(walk[i][1]) in {
                       zc._snap_bw(w) for _, w in walk[:i - 1]})
    if builds_after[revisit] != builds_after[revisit - 1]:
        raise AssertionError(f"zoom {name}: the revisit at stage {revisit} "
                             f"built {builds_after}")
    bad = zoom_notes(lrs["compiled"]) + zoom_notes(lrs["eager"])
    drops = {m: (lr.ring.dropped_samples,
                 lr.metrics.snapshot()["pipeline"]["dropped"])
             for m, lr in lrs.items()}
    if bad or any(d != (0, 0) for d in drops.values()):
        raise AssertionError(f"zoom {name}: notes {bad}, drops {drops}")
    if on_card:
        per = {"pfbch2_planar": 1,
               "routed_shifted_resample": sum(rx.fused_route)}
        for mode in modes:
            steps = len(a) + build_warmups(card) * (mode == "compiled")
            want = {k: v * steps for k, v in per.items()}
            if launches[mode] != want:
                raise AssertionError(f"zoom {name} {mode}: launches "
                                     f"{launches[mode]}, expected {want}")
    return launches, {
        "block_len": rx.block_len, "walk": [list(w) for w in walk],
        "blocks_per_stage": per_stage, "blocks_compared": compared,
        "bit_for_bit": True, "drops": 0,
        "levels_visited": sorted(visited),
        "levels_built": sorted(built), "level_builds": zc.level_builds,
        "level_evictions": zc.level_evictions,
        "builds_after_stage": builds_after,
        "revisit_stage": revisit, "lines": zc.lines,
        "build_ms": {f"{bw:g}": lv.step.build_ms
                     for bw, lv in sorted(built.items())},
        "build_split_ms": {f"{bw:g}": lv.step.build_split_ms
                           for bw, lv in sorted(built.items())}}


ZOOM_GAP_CASES = (("new view, cold level", 1e6, 1e6),
                  ("prewarmed adjacent level", 1e6, 500e3),
                  ("retune at the same level", 1.2e6, 500e3),
                  ("cold level", 1.2e6, 62_500.0),
                  ("prewarmed adjacent level", 1.2e6, 125e3))


def zoom_gap(name, rx, controls, smi: str,
             zooms=ZOOM_GAP_CASES) -> dict:
    """Phase 28's zoom gap: a compiled live loop on ``rx`` fed by a
    producer at the capture rate (8 MS/s, an FM station at +1.1 MHz),
    its consumer on a thread, zoomed from the control thread through
    ``zooms`` (case, offset, bandwidth): the ms from ``set_zoom`` to the
    end of the first block whose points show the new view, for a new
    view's first level (cold), a prewarmed adjacent level, a retune at
    the same level and a cold level (its build split into warm-ups and
    captures), with ``set_zoom``'s own ms; each consumer block's ms from
    its dispatch to the end of its fan-out, the longest one while a
    background build ran (each background build timed here, around
    ``CompiledStep.build``); 0 drops, no zoom error noted, the consumer
    alive."""
    import threading
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    spans = []
    build = CompiledStep.build

    def timed_build(step, background=False):
        t = time.perf_counter()
        build(step, background)
        if background:
            spans.append((t, time.perf_counter()))

    src = station_source(FS, 1_100_000)
    lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                      waterfall_lines=64)
    shown, dispatched, exc = [], [], []
    lr.on_block = lambda o: shown.append((
        time.perf_counter(), None if lr.zoom is None
        else lr.zoom.points_view))
    dispatch = lr._fanout_dispatch

    def timed_dispatch(*a):
        dispatched.append(time.perf_counter())
        return dispatch(*a)

    lr._fanout_dispatch = timed_dispatch

    def consume():
        try:
            lr.run_blocks()
        except Exception as e:               # noqa: BLE001 — the check
            exc.append(e)

    def wait_view(view, t0, timeout=30.0):
        while time.perf_counter() - t0 < timeout:
            if exc:
                raise exc[0]
            hit = [t for t, v in list(shown) if t > t0 and v == view]
            if hit:
                return hit[0]
            time.sleep(0.001)
        raise AssertionError(f"zoom gap {name}: no block showed {view}")

    cases = []

    def zoom(case, off, bw):
        z = lr.zoom
        cold = z is None or not any(
            lv.built and lv.bw == z._snap_bw(bw)
            for lv in z._front_cache.values())
        t0 = time.perf_counter()
        lr.set_zoom(off, bw)
        t1 = time.perf_counter()
        z = lr.zoom
        t2 = wait_view((off, z.resample_bw), t0)
        lv = z._level
        cases.append({
            "case": case, "offset": off, "bandwidth": z.resample_bw,
            "level_was_built": not cold,
            "set_zoom_ms": (t1 - t0) * 1e3,
            "set_zoom_to_points_ms": (t2 - t0) * 1e3,
            "build_ms": lv.step.build_ms if cold else None,
            "build_split_ms": lv.step.build_split_ms if cold else None})
        t_join = time.perf_counter()
        join_prewarms()
        mine = [(a, b) for a, b in spans if a >= t0]
        cases[-1]["background_builds"] = len(mine)
        cases[-1]["background_build_ms"] = [(b - a) * 1e3
                                             for a, b in mine]
        cases[-1]["join_ms"] = (time.perf_counter() - t_join) * 1e3
        time.sleep(0.5)

    th = threading.Thread(target=consume, daemon=True)
    CompiledStep.build = timed_build
    lr.start_producer()
    th.start()
    try:
        t_start = time.perf_counter()
        while len(shown) < 4 and time.perf_counter() - t_start < 60:
            if exc:
                raise exc[0]
            time.sleep(0.01)
        for case in zooms:
            zoom(*case)
    finally:
        src.stop()
        lr._stop.set()
        th.join(timeout=30)
        lr.stop()
        CompiledStep.build = build
    if exc:
        raise AssertionError(f"zoom gap {name}: the consumer died: "
                             f"{exc[0]!r}")
    if th.is_alive():
        raise AssertionError(f"zoom gap {name}: the consumer hung")
    ends = [t for t, _ in shown]
    busy = [(d, e - d) for d, e in zip(dispatched, ends)]
    during = [b for d, b in busy
              if any(a <= d + b and d <= e for a, e in spans)]
    snap = lr.metrics.snapshot()
    drops = {"ring": lr.ring.dropped_samples,
             "ingest": int(snap["ingest"]["dropped"]),
             "pipeline": int(snap["pipeline"]["dropped"])}
    bad = zoom_notes(lr)
    if bad or any(drops.values()):
        raise AssertionError(f"zoom gap {name}: notes {bad}, drops {drops}")
    return {"plan": name, "capture_rate_msps": FS / 1e6,
            "block_len": rx.block_len,
            "block_period_ms": rx.block_len / FS * 1e3,
            "blocks": len(busy), "drops": 0, "cases": cases,
            "consumer_block_ms_median": float(np.median(
                [b for _, b in busy])) * 1e3,
            "consumer_block_ms_max": max(b for _, b in busy) * 1e3,
            "consumer_blocks_during_background_builds": len(during),
            "consumer_block_ms_max_during_background_builds":
                max(during) * 1e3 if during else None,
            "producer_late_s": src.late_s, "card": smi}


def zoom_memory(block_len: int, keep: int | None = None,
                rate: float = FS) -> dict:
    """Phase 28's memory: one compiled zoom view on the card at
    ``block_len``, each of its 15 reachable levels (``rate`` / 2^k, k =
    0..14) built in turn, ``memory_reserved`` and ``memory_allocated``
    before and after each build (the caching allocator emptied first),
    keeping at most ``keep`` levels (None: the view's ``ZOOM_LEVELS``;
    15 measures what every level would hold without the bound). Earlier
    phases' garbage is collected first: freed during the measurement, it
    would leave the cache at a capture's ``empty_cache``."""
    import gc
    from cubicsdr_tpu_torch.visual import spectrum
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r00, a00 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    bound = spectrum.ZOOM_LEVELS
    spectrum.ZOOM_LEVELS = bound if keep is None else keep
    try:
        z = spectrum.ZoomSpectrumView(rate, block_len, fft_size=1024,
                                      device="cuda")
        rows = []
        for k in range(15):
            bw = rate / (1 << k)
            torch.cuda.synchronize()
            r0 = torch.cuda.memory_reserved()
            a0 = torch.cuda.memory_allocated()
            z.prewarm_level(bw)
            torch.cuda.synchronize()
            r1 = torch.cuda.memory_reserved()
            a1 = torch.cuda.memory_allocated()
            lv = z._make_front(bw)
            rows.append({"bandwidth": bw, "chunk": lv.chunk,
                         "reserved_mb": (r1 - r0) / 1e6,
                         "allocated_mb": (a1 - a0) / 1e6,
                         "build_ms": lv.step.build_ms})
            del lv
        torch.cuda.synchronize()
        out = {"block_len": block_len,
               "levels_kept_at_most": spectrum.ZOOM_LEVELS,
               "levels_built": z.level_builds,
               "levels_evicted": z.level_evictions,
               "reserved_mb_after_15_levels":
                   (torch.cuda.memory_reserved() - r00) / 1e6,
               "allocated_mb_after_15_levels":
                   (torch.cuda.memory_allocated() - a00) / 1e6,
               "per_level": rows}
        z.close()
    finally:
        spectrum.ZOOM_LEVELS = bound
    return out


def check_zoom(smi: str) -> dict:
    """Phase 28: the compiled zoom view. The walk at live16 (demod16 over
    the 16-station signal, the demod view on row 4) and at scan58's
    block (two levels), compiled against eager bit for bit; live16 with
    both views in turns, the compiled zoom against the eager zoom in a
    compiled loop; the zoom gap at the capture rate on both; memory per
    level at live16's and scan58's blocks. Returns the kernels' launches
    by run."""
    from cubicsdr_tpu_torch.utils.synth import scan58
    t0 = time.perf_counter()
    freqs, blocks = live_blocks()
    rx = build_pipeline(16, "cuda", True)
    ctl = rx.control_template()
    ctl[0]["frequency"] = freqs
    launches = {}
    launches["zoom_walk_live16"], walk16 = zoom_walk(
        "live16", rx, ctl, blocks[:4], ZOOM_WALK)
    line(f"zoom walk live16, compiled vs eager: {json.dumps(walk16)} "
         f"[{smi}]")

    def views16(lr):
        lr.set_demod_view(4)
        lr.set_zoom(1e6, 1e6)

    launches["zoom_turns_live16"], turns = live_turns(
        "live16 zoom", rx, ctl, blocks[:4], views16, zoom_only=True)
    turns["modes"] = {"compiled": "compiled loop, compiled zoom",
                      "eager": "compiled loop, eager zoom"}
    line(f"zoom turns live16, both views, compiled zoom vs eager zoom: "
         f"{json.dumps(turns)} [{smi}]")
    gap = zoom_gap("live16", rx, ctl, smi)
    line(f"zoom gap live16 at 8 MS/s: {json.dumps(gap)}")
    del rx
    from cubicsdr_tpu_torch.visual.spectrum import ZOOM_LEVELS
    for keep in (15, ZOOM_LEVELS):
        mem = {n: zoom_memory(n, keep) for n in (BLOCK, 2 * BLOCK)}
        line(f"zoom memory per level, at most {keep} kept: "
             f"{json.dumps(mem)} [{smi}]")
    plan = scan58()
    rx = plan.pipeline()
    cap = plan.capture(4 * rx.block_len, "cuda", seed=13).cpu().numpy()
    sblocks = [np.ascontiguousarray(cap[:, b * rx.block_len:
                                        (b + 1) * rx.block_len])
               for b in range(4)]
    launches["zoom_walk_scan58"], walk58 = zoom_walk(
        "scan58", rx, plan.controls(rx), sblocks,
        ((1e6, 1e6), (1e6, 500e3), (1e6, 1e6)), per_stage=2)
    line(f"zoom walk scan58, compiled vs eager: {json.dumps(walk58)} "
         f"[{smi}]")
    gap = zoom_gap("scan58", rx, plan.controls(rx), smi, zooms=(
        ZOOM_GAP_CASES[0], ZOOM_GAP_CASES[1],
        ("cold level", 1e6, 125e3)))
    line(f"zoom gap scan58 at 8 MS/s: {json.dumps(gap)}")
    line(f"zoom phase: {time.perf_counter() - t0:.1f} s [{smi}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from cubicsdr_tpu_torch.ops.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    line(f"card: {smi}")
    line(f"torch: {torch.cuda.get_device_name(0)}, torch "
         f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = build.load_library()
    line(f"build: {time.perf_counter() - t0:.2f} s -> "
         f"{build.library_path().relative_to(build.PKG_DIR.parent)}")

    for ln in ptxas_lines(lib.build_log):
        line(f"ptxas: {ln}")
    from cubicsdr_tpu_torch import native
    line(f"ring backend: {native.backend()}")

    rng = np.random.default_rng(0)
    pfb_cases, route_cases = [], []
    for M, n_steps, parity, J in (
            (16, BLOCK // 8, 0, 8), (6, BLOCK // 8, 0, 8), (10, 12345, 1, 8),
            (20, BLOCK // 10, 0, 8), (40, BLOCK // 20, 1, 8),
            (64, BLOCK // 32, 0, 8), (6, 9999, 1, 12)):
        c = check_pfb(dev, M, n_steps, parity, rng, J)
        pfb_cases.append(c)
        line(f"pfb M={M} J={J} steps={n_steps} parity={parity} "
             f"({c['form']}, T={c['steps_per_tile']}): max_abs_err "
             f"{c['max_abs_err']:.3g}; cold {c['cold_ms']:.4f} ms, warm "
             f"{c['warm_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; bound "
             f"{c['bound_ms']:.4f} ms ({c['bound_by']}), share "
             f"{c['roofline_share']:.3f}, {c['achieved_gb_per_s']:.0f} GB/s"
             f" [{smi}]")
    # The demod16 shapes, then scan58's new ones over its 256,000-sample
    # channels: AM's 3/50 at O=384 (runtime tap loop, 5 residue groups)
    # and CW/BPSK's 1/50 with 1,249 taps at N=4 and N=16.
    for P, Q, N, chan_len in ((1, 5, 16, BLOCK // 8), (1, 5, 256, BLOCK // 8),
                              (2, 5, 16, BLOCK // 8), (1, 4, 16, BLOCK // 8),
                              (3, 5, 16, BLOCK // 8), (1, 40, 16, BLOCK // 8),
                              (1, 128, 16, 131072), (3, 50, 16, SCAN_CHAN),
                              (1, 50, 4, SCAN_CHAN), (1, 50, 16, SCAN_CHAN)):
        route_line(check_route(dev, P, Q, N, chan_len, rng), route_cases,
                   smi)
    # Phase 12: the first stages only 'pfbch' fuses (128,000-sample
    # channels): BPSK's 1/25 with its 219 KB plan, FM-stereo's 1/2, and
    # 2.4 MS/s FM-stereo's 5/8 at O=640 over 6 channels.
    for P, Q, N, M in ((1, 25, 4, 16), (1, 2, 2, 16), (5, 8, 2, 6)):
        route_line(check_route(dev, P, Q, N, 128_000, rng, M=M),
                   route_cases, smi, "pfbch ")
    # Phase 15: the route kernel's streaming plan at the stage shapes no
    # resident plan fits; phase 16: the PFB kernel at M >= 134.
    for P, Q, N, chan_len, M in STREAMING_ROUTES:
        route_line(check_route(dev, P, Q, N, chan_len, rng, M=M),
                   route_cases, smi, "streaming ")
    for M, n_steps, parity in WIDE_PFBS:
        c = check_pfb(dev, M, n_steps, parity, rng)
        pfb_cases.append(c)
        line(f"pfb M={M} steps={n_steps} parity={parity} ({c['form']}, "
             f"T={c['steps_per_tile']}, F rows per fold "
             f"{c['f_rows_per_fold']}): max_abs_err {c['max_abs_err']:.3g}; "
             f"cold {c['cold_ms']:.4f} ms, warm {c['warm_ms']:.4f} ms, plain "
             f"{c['plain_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms "
             f"({c['bound_by']}), share {c['roofline_share']:.3f} [{smi}]")

    launches, worst = check_main_path(dev)
    line(f"main path demod16 x3 blocks: launches {launches}, vs CPU "
         f"{json.dumps(worst)} [{smi}]")

    for n in (16, 256):
        for kern in (True, False):
            msps, ms = throughput(dev, n, kern)
            line(json.dumps({"row": f"demod{n}", "kernels": kern,
                             "msamples_per_s": msps, "ms_per_block": ms,
                             "block_len": BLOCK, "card": smi}))

    scan_launches, scan, scan_ctx = check_scan58()
    line(f"scan58 x3 blocks (58 demods, 6 groups): launches "
         f"{scan_launches}, vs CPU {json.dumps(scan)} [{smi}]")
    covered, cov_launches, cov, cov_rows = check_coverage()
    ran = set(covered) | {g.modem_name for g in scan_ctx[0].specs}
    from cubicsdr_tpu_torch.modems import modem_names
    if ran != set(modem_names()):
        raise AssertionError(f"modems not run on the card: "
                             f"{set(modem_names()) - ran}")
    line(f"coverage plans {json.dumps(cov_rows)}: {len(ran)} of "
         f"{len(modem_names())} modems run on the card, vs CPU "
         f"{json.dumps(cov)} [{smi}]")
    live_scan_launches, live_scan = check_live_scan58(scan_ctx)
    line(f"live loop scan58 x3 blocks: launches {live_scan_launches}, "
         f"symbols to on_block, vs CPU {json.dumps(live_scan)} [{smi}]")
    line(json.dumps({**plan_throughput(scan_ctx[0]), "card": smi}))
    del scan_ctx

    live_launches, live = check_live(dev)
    line(f"live loop demod16 x{LIVE_BLOCKS} blocks: launches "
         f"{live_launches}, vs CPU {json.dumps(live)} [{smi}]")

    rx = build_pipeline(16, dev, True)
    for row, dt in (("live16", np.float32), ("live16_int16", np.int16),
                    ("live16_int8", np.int8)):
        r = live_throughput(rx, dt)
        line(json.dumps({"row": row, **r, "block_len": BLOCK, "card": smi}))
    del rx

    from cubicsdr_tpu_torch.utils.synth import scan58
    with tempfile.TemporaryDirectory() as tmp:
        cli_rows, (cap, sess) = check_cli(Path(tmp), scan58())
        for name, r in cli_rows.items():
            line(f"cli {name} on the card vs --device cpu: "
                 f"{json.dumps(r)} [{smi}]")
        for name in ("rx", "rx_pfbch"):
            line(json.dumps({
                "row": f"cli_{name}_scan58", "msamples_per_s":
                cli_rows[name]["msamples_per_s"], "seconds":
                cli_rows[name]["card_s"], "samples": 3 * 2_048_000,
                "note": "wall time of cli.main: file read, plan build, "
                        "3 blocks, WAV write", "card": smi}))
        serve_launches, serve = check_serve(sess, cap, scan58())
        line(f"serve scan58 on the card, 4 plan rebuilds: launches "
             f"{serve_launches}, {json.dumps(serve)} [{smi}]")
        line(json.dumps({"row": "serve_rebuild_scan58", "post_to_first_"
                         "block_ms": [r["post_to_first_block_ms"]
                                      for r in serve["rebuilds"]],
                         "card": smi}))
        wide_rows = check_cli_wide(Path(tmp))
        for name, r in wide_rows.items():
            line(f"cli {name} on the card vs --device cpu: {json.dumps(r)} "
                 f"[{smi}]")

    sharded_launches, sharded_compiled_launches, sharded, sharded_row = \
        check_sharded(smi)
    line(f"sharded 1x1 (NCCL) scan58 x3 blocks: launches {sharded_launches}"
         f" (compiled, with its build's warm-ups: "
         f"{sharded_compiled_launches}), vs the unsharded card pipeline and "
         f"compiled vs eager {json.dumps(sharded)} [{smi}]")
    line(json.dumps(sharded_row))
    with tempfile.TemporaryDirectory() as tmp:
        line(json.dumps(check_rx_mesh(Path(tmp), scan58(), smi)))
    mh_reports, mh_row = check_multihost(smi)
    line(f"multihost 2 processes on cuda:0 (time=2, gloo on host copies), "
         f"scan58: both ranks verified against the unsharded pipeline, "
         f"launches per rank {[r['launches'] for r in mh_reports]}, worst "
         f"{json.dumps([r['worst'] for r in mh_reports])} [{smi}]")
    line(json.dumps(mh_row))
    mh4_reports, mh4_row = check_multihost_cards(smi)
    if mh4_reports:
        line(f"multihost {MULTIHOST_CARDS} processes on {MULTIHOST_CARDS} "
             f"cards (time={MULTIHOST_CARDS}, NCCL, compiled), scan58: "
             f"every rank verified against the unsharded pipeline, "
             f"launches per rank {[r['launches'] for r in mh4_reports]}, "
             f"worst {json.dumps([r['worst'] for r in mh4_reports])} "
             f"[{smi}]")
        line(json.dumps(mh4_row))

    c64_launches, c64, c64_rows = check_complex64(smi)
    for name, r in c64.items():
        line(f"complex64 {name} x3 blocks (no kernel): {json.dumps(r)} "
             f"[{smi}]")
    for r in c64_rows:
        line(json.dumps(r))
    modes_launches, modes, mode_rows = check_complex_modes()
    line(f"complex64 'pfbch'/'single' on the coverage plans "
         f"{json.dumps(mode_rows)}: launches {modes_launches}, vs CPU "
         f"{json.dumps(modes)} [{smi}]")
    live_c64_launches, swap_launches, live_c64 = check_live_complex()
    line(f"live loop complex64 demod16 x{LIVE_BLOCKS} blocks and the "
         f"planar<->complex64 swap: {json.dumps(live_c64)} [{smi}]")
    dry, scaling = check_scaling(smi)
    line(f"dryrun_multichip(1, 'cuda'): {json.dumps(dry)} [{smi}]")
    line(json.dumps(scaling))
    graph_launches, _, _ = check_graphs(smi)
    turn_launches, _ = check_compiled_vs_eager(smi)
    capture_rows = check_captures(smi)
    with tempfile.TemporaryDirectory() as tmp:
        churn_launches, _ = check_churn(Path(tmp), scan58(), smi=smi)
    zoom_launches = check_zoom(smi)
    soak_launches = check_soaks(smi)

    def kernel_row(name, source, replaces, cases):
        main = cases[0]           # the main path's shape (demod16)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "launches_by_path": {
                    "demod16": launches[name], "scan58": scan_launches[name],
                    "coverage": cov_launches[name],
                    "live_scan58": live_scan_launches[name],
                    "live16": live_launches[name],
                    **{f"cli_{k}": r["launches"][name]
                       for k, r in cli_rows.items()},
                    "serve_after_rebuilds": serve_launches[name],
                    **{f"cli_{k}": r["launches"][name]
                       for k, r in wide_rows.items()},
                    "sharded_1x1_scan58": sharded_launches[name],
                    "sharded_1x1_scan58_compiled":
                        sharded_compiled_launches[name],
                    "multihost_rank0_scan58":
                        mh_reports[0]["launches"][name],
                    **{f"multihost4_rank{r['process_id']}_scan58":
                       r["launches"][name] for r in mh4_reports or ()},
                    **{f"complex64_{k}": v[name]
                       for k, v in c64_launches.items()},
                    "complex64_pfbch_single_modes": modes_launches.get(
                        name, 0),
                    "complex64_live16": live_c64_launches[name],
                    "live16_planar_complex64_swap": swap_launches[name],
                    **{k: v[name] for k, v in graph_launches.items()},
                    **{f"{plan}_{mode}_turns": v[mode][name]
                       for plan, v in turn_launches.items()
                       for mode in v},
                    **{f"capture_{r['case']}_per_replay":
                       r["launches_per_replay"][name] for r in capture_rows},
                    "churn_scan58": churn_launches[name],
                    **{f"{run}_{mode}": v[mode][name]
                       for run, v in zoom_launches.items() for mode in v},
                    **{k: v[name] for k, v in soak_launches.items()}},
                "live_launches": live_launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": main["cold_ms"], "cold_ms": main["cold_ms"],
                "warm_ms": main["warm_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "roofline_share": main["roofline_share"],
                "library_ms": None, "library": LIBRARY_NOTE[name],
                "card": smi, "cases": cases}

    kernels = [
        kernel_row("pfbch2_planar", "cubicsdr_tpu_torch/csrc/pfb.cu",
                   "cubicsdr_tpu/ops/pallas/pfb.py:110", pfb_cases),
        kernel_row("routed_shifted_resample",
                   "cubicsdr_tpu_torch/csrc/route.cu",
                   "cubicsdr_tpu/ops/pallas/route.py:161", route_cases),
    ]
    line(json.dumps({"kernels": kernels}))
    line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
