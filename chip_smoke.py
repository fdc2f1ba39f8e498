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
   kernels launch per block; then scan58's throughput row;
9. the live loop (``app.runner.LiveReceiver``: ring -> staged host->device
   copy -> step -> packed post-step -> one device->host pull) at the same
   demod16 width: 6 blocks of the 16-station signal with two demods
   recording, a subset audio sink, the demod view on one row, the zoom
   view at +1 MHz / 1 MHz and a 1024-point, 64-line waterfall, checked
   against the same live loop on the CPU (WAVs and mix at the pipeline
   tolerances, waterfall lines at 2e-3, lines per block exactly), for
   both kernels' launch counts (6 each), no view or sink error and no
   ring drop;
10. a checkpoint of the live loop's state after 3 blocks, saved, loaded
   into a fresh receiver and run over blocks 4-6: its audio equals the
   uninterrupted run's within 1e-6;
11. live-loop throughput (the JAX package's ``bench.py`` live rows: a
   cycling source with back-pressure, 8 warm-up and 40 timed blocks) with
   float32, int16 and int8 ring formats;
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
   'pfbch2', 0 + 6 with 'pfbch', neither with 'single';
14. ``serve`` on the card: a ``WebViewer`` on an ephemeral port around a
   card ``LiveReceiver`` carrying scan58's session over the looped
   capture, driven block by block: GET /api/state, /api/spectrum and
   /api/waterfall.png; POST add (an NBFM demod), set bandwidth, set type
   and remove, each a plan rebuild after which both kernels launch on the
   next block; the mix and three surviving demods' audio against the same
   sequence on a CPU harness; the ms from each POST to the end of the
   first block on the new plan; 0 ring drops.

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
   launches per block, and the sharded and unsharded steps' MS/s;
19. ``multihost`` with 2 worker processes on the one card (time=2; NCCL
   takes one rank per GPU, so the phase asks for host collectives: gloo
   on host copies), scan58, each rank verified against the unsharded
   pipeline it computes, and a timed phase, bound by those copies;
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
   to the complex64 plan and back: every block reaches each step in that
   step's representation, the kernels launch on the planar blocks only,
   no block is dropped;
23. ``parallel.dryrun.dryrun_multichip(1, "cuda")`` (one NCCL rank: a
   mixed FM + AM + BPSK sharded step with the reference's shape checks)
   and ``parallel.scaling.measure_scaling`` over 1 rank (NCCL) and 2
   ranks sharing the card (host collectives, gloo on host copies), with
   the rows printed.

Then (24) one JSON line describing the kernels (launches on the demod16
main path and on every other path, the CLI's, serve's, the sharded and
the multihost ranks' and the complex64 paths' (zero) included, error,
cold/warm/plain ms, bound, roofline share, every case; no single
PyTorch call computes either function, so ``library_ms`` is null),
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
        if launches != {"pfbch2_planar": LIVE_BLOCKS,
                        "routed_shifted_resample": LIVE_BLOCKS}:
            raise AssertionError(f"live run launches {launches}, expected "
                                 f"{LIVE_BLOCKS} of each")
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
    if launches != {"pfbch2_planar": 3, "routed_shifted_resample": 18}:
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

    def demod_launches(modem, bw):
        """(PFB, route) launches of a one-demod 'pfbch2' plan over the
        capture: one of each per block of its own length."""
        from cubicsdr_tpu_torch.receiver import (
            DemodGroupSpec, ReceiverPipeline)
        rx = ReceiverPipeline(fs, [DemodGroupSpec(modem, bw, 1)],
                              device="cpu")
        if rx.fused_route != [True]:
            raise AssertionError(f"{modem} does not fuse")
        return (-(-n // rx.block_len),) * 2

    n_blocks = -(-n // 2_048_000)
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


def http(port: int, path: str, body=None) -> bytes:
    """A request to the local WebViewer, never through a proxy."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=120) as r:
        return r.read()


def check_serve(sess: Path, cap: Path, plan, card: str = "cuda"):
    """Phase 14 on ``card``. Returns (launches after the rebuilds,
    summary)."""
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
            old = lr.pipeline
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
            if (lr.pipeline.fused_route != [True] * groups
                    or launches != {"pfbch2_planar": 1,
                                    "routed_shifted_resample": groups}):
                raise AssertionError(f"serve {name}: launches {launches} "
                                     f"for {groups} groups")
            for k in total:
                total[k] += launches[k]
            summary["rebuilds"].append({
                "edit": name, "groups": groups, "launches": launches,
                "post_ms": (t1 - t0) * 1e3, "first_block_ms": (t2 - t1) * 1e3,
                "post_to_first_block_ms": (t2 - t0) * 1e3})
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
        if launches != {"pfbch2_planar": n_blocks,
                        "routed_shifted_resample": n_blocks}:
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


def check_sharded(smi: str):
    """Phase 18: ShardedReceiver on a 1x1 mesh under NCCL, built with its
    defaults (the card, both kernels), on scan58's plan over 3 blocks,
    against the unsharded ReceiverPipeline on the card at the pipeline's
    gates (symbols by the CPU slicer's margin); exactly 1 PFB and 6 route
    launches per block; the sharded and unsharded steps' MS/s."""
    import torch.distributed as dist
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.multihost import free_port
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
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

        def sharded_rate(n_blocks=10, n_warm=3):
            s = srx.init_state()
            pcs = [PC(b[0], b[1]) for b in blocks]
            for b in range(n_warm):
                s, o = srx.step(s, pcs[b % 3], controls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(n_blocks):
                s, o = srx.step(s, pcs[b % 3], controls)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return n_blocks * srx.block_len / dt / 1e6, dt / n_blocks * 1e3

        rates = {}
        for turn in ("unsharded", "sharded", "sharded", "unsharded"):
            r = (timed_steps(rx, blocks, plan.controls(rx), 10)
                 if turn == "unsharded" else sharded_rate())
            rates.setdefault(turn, []).append(r)
        row = {"row": "sharded1x1_scan58", "backend": dist.get_backend(),
               "block_len": srx.block_len, "card": smi,
               **{f"{k}_msamples_per_s": [r[0] for r in v]
                  for k, v in rates.items()},
               **{f"{k}_ms_per_block": [r[1] for r in v]
                  for k, v in rates.items()}}
    finally:
        dist.destroy_process_group()
    return launches, worst, row


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
                and rep["host_collectives"] and rep["backend"] == "gloo"):
            raise AssertionError(f"multihost report {rep}")
        if rep["launches"] != {"pfbch2_planar": 2,
                               "routed_shifted_resample": 12}:
            raise AssertionError(f"multihost rank launches "
                                 f"{rep['launches']}")
    return reports, {"row": "multihost2_scan58_one_card",
                     "collectives": "gloo on host copies (2 ranks, 1 GPU)",
                     "block_len": reports[0]["block_len"],
                     "aggregate_msamples_per_s": [
                         r["timed"]["aggregate_msps"] for r in reports],
                     "timed_steps": reports[0]["timed"]["steps"],
                     "wall_s_with_start_up": wall,
                     "note": "host-copy bound: every halo, sum and "
                             "gather leaves the card for gloo",
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
        # back: each step sees only its own representation.
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
                          waterfall_lines=64)
        lr.set_zoom(1e6, 1e6)
        lr.start_producer()
        reset_launches()
        n = lr.run_blocks(max_blocks=2)
        lr.swap_pipeline(rx_c, ctl)
        n += lr.run_blocks(max_blocks=2)
        lr.swap_pipeline(rx_p, ctl)
        n += lr.run_blocks()
        swap_launches = read_launches()
        lr.stop()
        want = [(False, True)] * 2 + [(True, False)] * 2 + [(False, True)] * 2
        snap = lr.metrics.snapshot()
        if (n != LIVE_BLOCKS or seen != want
                or snap["pipeline"]["dropped"] or lr.ring.dropped_samples):
            raise AssertionError(f"swap run: {n} blocks, steps saw {seen}, "
                                 f"{snap['pipeline']}, ring drops "
                                 f"{lr.ring.dropped_samples}")
        if swap_launches != {
                "pfbch2_planar": 4, "routed_shifted_resample": 4}:
            raise AssertionError(f"swap run launches {swap_launches}")
        summary["swap"] = {"blocks": n, "planar_blocks": 4,
                           "complex64_blocks": 2,
                           "launches": swap_launches, "ring_dropped": 0}
    return g["l"], swap_launches, summary


def check_scaling(smi: str):
    """Phase 23: the dry run on one NCCL rank, then the weak-scaling rows
    over 1 rank (NCCL) and 2 ranks sharing the card (host collectives)."""
    from cubicsdr_tpu_torch.parallel.dryrun import dryrun_multichip
    from cubicsdr_tpu_torch.parallel.scaling import measure_scaling
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, "cuda")
    t1 = time.perf_counter()
    rep = measure_scaling(device_counts=[1, 2], device="cuda",
                          host_collectives=True)
    t2 = time.perf_counter()
    if dry["backend"] != "nccl" or rep["rows"][0]["backend"] != "nccl" \
            or not all(r["msps"] > 0 for r in rep["rows"]):
        raise AssertionError(f"dry run {dry}, scaling {rep}")
    return dry, {**rep, "dryrun_wall_s": t1 - t0, "scaling_wall_s": t2 - t1,
                 "card": smi}



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

    sharded_launches, sharded, sharded_row = check_sharded(smi)
    line(f"sharded 1x1 (NCCL) scan58 x3 blocks: launches {sharded_launches}"
         f", vs the unsharded card pipeline {json.dumps(sharded)} [{smi}]")
    line(json.dumps(sharded_row))
    mh_reports, mh_row = check_multihost(smi)
    line(f"multihost 2 processes on cuda:0 (time=2, gloo on host copies), "
         f"scan58: both ranks verified against the unsharded pipeline, "
         f"launches per rank {[r['launches'] for r in mh_reports]}, worst "
         f"{json.dumps([r['worst'] for r in mh_reports])} [{smi}]")
    line(json.dumps(mh_row))

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
                    "multihost_rank0_scan58":
                        mh_reports[0]["launches"][name],
                    **{f"complex64_{k}": v[name]
                       for k, v in c64_launches.items()},
                    "complex64_pfbch_single_modes": modes_launches.get(
                        name, 0),
                    "complex64_live16": live_c64_launches[name],
                    "live16_planar_complex64_swap": swap_launches[name]},
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
