"""PFBCH2 analyzer: the CUDA kernel's wrapper (``csrc/pfb.cu``) and its
plain PyTorch version.

Counterpart of ``cubicsdr_tpu/ops/pallas/pfb.py:pfbch2_planar_pallas``,
without that kernel's TPU layout (no sublane/lane padding, no host
transpose): any even M, any step count, and the carried step parity, so
odd step counts stream correctly. ``pfb_transform_consts`` is the host
layout of the kernel's register-form constants and ``pfb_plan`` its tile
and shared memory.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.planar import PC, pc_idft_m, pc_mul
from cubicsdr_tpu_torch.ops.kernels import build

def pfbch2_planar_plain(z_re, z_im, h_poly, w_re, w_im, c_re, c_im, parity):
    """z planes [(2J-1)*D + L] -> channel planes [M, L//D] (D = M/2).

    h_poly [M, J] prototype branches; (w_re, w_im) the [M, M] planar
    M*IDFT matrix; (c_re, c_im) [M] the per-channel phase c_k; parity the
    int32 scalar step parity of the first step. The JAX package's XLA
    formulation: reversed stride-D frames -> shifted-FMA FIR -> IDFT ->
    c_k -> (-1)^{k*(s+parity)}."""
    M, J = h_poly.shape
    D = M // 2
    n_steps = (z_re.shape[-1] - (2 * J - 1) * D) // D
    n_total = n_steps + 2 * J - 2

    def fir(p):
        # G[rho, s] = p[s*D + M-1-rho]: two adjacent D-rows, reversed.
        A = p[: (n_total + 1) * D].reshape(n_total + 1, D)
        G = torch.cat([A[:-1], A[1:]], dim=-1).flip(-1).T   # [M, n_total]
        acc = None
        for j in range(J):
            s0 = 2 * (J - 1 - j)
            term = G[:, s0: s0 + n_steps] * h_poly[:, j:j + 1]
            acc = term if acc is None else acc + term
        return acc

    y = pc_idft_m(PC(fir(z_re), fir(z_im)), w_re, w_im)
    y = pc_mul(y, PC(c_re[:, None], c_im[:, None]))
    dev = z_re.device
    s = (torch.arange(n_steps, device=dev) + parity) % 2
    k = torch.arange(M, device=dev) % 2
    sign = (1 - 2 * (k[:, None] * s[None, :])).to(torch.float32)
    return y.re * sign, y.im * sign


# csrc/pfb.cu: the FIR's compiled tap count, the largest M with the
# register FFT and with the register DFT, and the dynamic shared memory an
# sm_90 block may opt into (half of it, less the per-block reserve, leaves
# two per SM).
FAST_J, MAX_FFT_M, MAX_DFT_M, SMEM_MAX = 8, 64, 16, 232448
_SMEM_TWO_PER_SM = 115200
# The kernel's transform forms, in the order of the live loop's
# ``pfb.form`` counter.
PFB_FORMS = ("fft", "dft", "product")


def pfb_form(M: int, J: int = FAST_J) -> str:
    """The kernel's transform for (M, J): "fft" (radix-2 in registers,
    power-of-two M up to 64), "dft" (in registers, other even M up to 16),
    both with J = 8; else "product" (F = c_k W folded into shared
    memory, runtime M and J)."""
    if J == FAST_J and 0 < M <= MAX_FFT_M and M & (M - 1) == 0:
        return "fft"
    if J == FAST_J and M <= MAX_DFT_M:
        return "dft"
    return "product"


@functools.lru_cache(maxsize=None)
def pfb_transform_consts(M: int) -> np.ndarray:
    """The register forms' folded constants, float32, interleaved (re, im),
    computed in float64 from M alone (D = M/2):

    - power-of-two M: the FFT's twiddles e^{+2πi j/M} for j < M/2, then
      c_k = e^{-2πi k(D-1)/M} for k < M (3M floats);
    - other even M: F[k, ρ] = c_k e^{+2πi kρ/M}, row-major [M, M].

    The same function of M as the channelizer's (w, c) buffers, which the
    plain version takes."""
    D = M // 2
    k = np.arange(M)
    c = np.exp(-2j * np.pi * k * (D - 1) / M)
    if M & (M - 1) == 0:
        v = np.concatenate([np.exp(2j * np.pi * np.arange(M // 2) / M), c])
    else:
        v = (c[:, None] * np.exp(2j * np.pi * np.outer(k, k) / M)).ravel()
    return np.stack([v.real, v.imag], -1).astype(np.float32).ravel()


def pfb_plan(M: int, J: int) -> tuple[int, int, int, int]:
    """The kernel's steps per tile T, its shared memory in bytes, its
    staged windows and the rows KB of F it holds at once: (T, bytes,
    stages, KB). First the largest T in (128, 64, 32) that leaves two
    blocks per SM, else the largest that fits one, with two staged
    windows and F whole (KB = M). Where none fits (the product form at
    M >= 134), one staged window and F tiled over blocks of KB output
    channels: F whole at the largest T that holds it, else the largest T
    with KB >= 32, else any KB >= 4 (a multiple of the kernel's 4 outputs
    per warp item). The byte count is the kernel's own layout (the staged
    windows of both planes, the [T][M+1] branch-sum tile, KB rows of F
    for the product form, the taps)."""
    D = M // 2
    product = pfb_form(M, J) == "product"
    fits = []
    for T in (128, 64, 32):
        win = ((T + 2 * J - 1) * D + 3) // 4 * 4
        f = 2 * M * M if product else 0
        nbytes = 4 * (4 * win + 2 * T * (M + 1) + f + M * J)
        if nbytes <= _SMEM_TWO_PER_SM:
            return T, nbytes, 2, M
        if nbytes <= SMEM_MAX:
            fits.append((T, nbytes, 2, M))
    if fits:
        return fits[0]
    blocks = []
    for T in (128, 64, 32):
        win = ((T + 2 * J - 1) * D + 3) // 4 * 4
        base = 4 * (2 * win + 2 * T * (M + 1) + M * J)
        kb = min(M, (SMEM_MAX - base) // (8 * M) // 4 * 4) if product else M
        if kb >= 4 or kb == M:
            blocks.append((T, base + 8 * kb * M * product, 1, kb))
    for least in (M, 32, 4):
        for plan in blocks:
            if plan[3] >= min(least, M):
                return plan
    raise ValueError(f"PFBCH2 with M={M}, J={J} does not fit the "
                     f"kernel's shared memory")


def pfbch2_planar(z_re, z_im, h_poly, w_re, w_im, c_re, c_im, parity):
    """PFBCH2 analyzer (arguments as ``pfbch2_planar_plain``; w and c must
    be the channelizer's, ``idft_mats_np(M)`` and c_k). CPU tensors run the
    plain version; CUDA tensors launch ``csrc/pfb.cu``, which takes the
    register forms' constants from ``pfb_transform_consts(M)`` and folds
    F = c_k W from (w, c) in the product form."""
    if z_re.device.type == "cpu":
        return pfbch2_planar_plain(z_re, z_im, h_poly, w_re, w_im, c_re,
                                   c_im, parity)
    lib = build.load_library()
    dev = z_re.device
    M, J = h_poly.shape
    if M % 2:
        raise ValueError(f"PFBCH2 needs an even channel count, got {M}")
    D = M // 2
    z_len = z_re.shape[-1]
    hist = (2 * J - 1) * D
    if z_re.dim() != 1 or (z_len - hist) % D:
        raise ValueError(f"z must be [hist + k*D] with hist={hist}, D={D}; "
                         f"got {tuple(z_re.shape)}")
    n_steps = (z_len - hist) // D
    f32 = torch.float32
    build.require(z_re, "z_re", dev, f32, align=16)
    build.require(z_im, "z_im", dev, f32, z_re.shape, align=16)
    build.require(h_poly, "h_poly", dev, f32)
    build.require(w_re, "w_re", dev, f32, (M, M))
    build.require(w_im, "w_im", dev, f32, (M, M))
    build.require(c_re, "c_re", dev, f32, (M,))
    build.require(c_im, "c_im", dev, f32, (M,))
    build.require(parity, "parity", dev, torch.int32, ())
    out_re = torch.empty((M, n_steps), dtype=f32, device=dev)
    out_im = torch.empty((M, n_steps), dtype=f32, device=dev)
    if n_steps == 0:
        return out_re, out_im
    consts = (np.zeros(0, np.float32) if pfb_form(M, J) == "product"
              else pfb_transform_consts(M))
    T, _, stages, kb = pfb_plan(M, J)
    code = lib.pfbch2_planar_launch(
        z_re.data_ptr(), z_im.data_ptr(), z_len, h_poly.data_ptr(),
        w_re.data_ptr(), w_im.data_ptr(), c_re.data_ptr(), c_im.data_ptr(),
        consts.ctypes.data, consts.size, parity.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), M, J, n_steps, T, stages, kb,
        build.stream_ptr(z_re))
    build.check_launch(lib, code, "pfbch2_planar_launch")
    if torch.cuda.is_current_stream_capturing():
        pfbch2_planar.captured += 1    # a replay counts it
    else:
        pfbch2_planar.launches += 1
    return out_re, out_im


pfbch2_planar.launches = 0
pfbch2_planar.captured = 0
