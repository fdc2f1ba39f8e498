"""Operations and bytes of the port's two CUDA kernels' functions, from
the function's own shapes (a frozen copy of ``chip_smoke.py``'s
``check_pfb`` and ``check_route`` counts), and the least time one
NVIDIA H100 needs for them at its published peaks (NVIDIA's data sheet,
SXM, 700 W: 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor
cores). Counts come from the configuration's shapes and the reference's
own filter designs, never from a kernel's plan, so a share reads the same
work whatever later implements it.
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def pfb_counts(M: int, J: int, n_steps: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one PFBCH2 analysis of ``n_steps`` channel steps:
    per step the FIR (2 planes x M*J FMAs, 2 flops each), the transform as
    an M-point FFT (5 M log2 M flops) and c_k (6 flops per output); the
    input planes with their (2J - 1) M/2 samples of history read once,
    the [M, n_steps] output planes written once, the M*J taps read once."""
    D = M // 2
    z_len = (2 * J - 1) * D + n_steps * D
    nbytes = 4 * (2 * z_len + 2 * M * n_steps + M * J)
    flops = int((4 * M * J + 5 * M * math.log2(M) + 6 * M) * n_steps)
    return flops, nbytes


def route_counts(P: int, Q: int, N: int, chan_len: int, hist_len: int,
                 n_channels_read: int, ker: np.ndarray) -> tuple[int, int]:
    """(FLOPs, bytes) of one fused route + NCO + first resample stage over
    N demods: per output the FMAs of its phase's nonzero taps on both
    planes, plus the complex modulation of each input sample of each
    demod; each referenced channel (with its history) read once, each
    output written once, the per-demod controls and the taps read once."""
    n_out = chan_len // Q * P
    total = hist_len + chan_len
    nnz = int(np.count_nonzero(ker))
    nbytes = (8 * n_channels_read * total + 8 * N * n_out + 12 * N
              + 4 * ker.size)
    flops = 4 * N * (n_out // P) * nnz + 6 * N * chan_len
    return flops, nbytes


def least_ms(flops: float, nbytes: float) -> float:
    """The least time, in ms, the card needs for the work: the larger of
    bytes over the HBM rate and FLOPs over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def block_kernel_work(ref_pipeline, controls) -> dict:
    """Per-block work of each kernel the deployment's step runs, counted
    on the reference's copy of the plan (same shapes and filter designs):
    ``{"pfb": [(flops, bytes)], "route": [(flops, bytes), ...]}`` with one
    route entry per fused group."""
    import torch
    rx = ref_pipeline
    L = rx.block_len
    out = {"pfb": [], "route": []}
    if rx.chan_mode == "pfbch2":
        ch = rx.channelizer
        out["pfb"].append(pfb_counts(rx.M, ch.J, L // (rx.M // 2)))
    chan_len = L // rx.decim
    for gi, fe in enumerate(rx.frontends):
        if not rx.fused_route[gi]:
            continue
        freqs = torch.as_tensor(controls[gi]["frequency"],
                                dtype=torch.float32)
        centers = rx.centers.detach().cpu()
        chan_idx = (freqs[:, None] - centers[None, :]).abs().argmin(-1)
        rs = fe._stage1
        out["route"].append(route_counts(
            rs.P, rs.Q, len(freqs), chan_len, rs.hist_len,
            len(set(chan_idx.tolist())), rs.ker_np))
    return out
