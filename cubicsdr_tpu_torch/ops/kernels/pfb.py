"""PFBCH2 analyzer: the CUDA kernel's wrapper (``csrc/pfb.cu``) and its
plain PyTorch version.

Counterpart of ``cubicsdr_tpu/ops/pallas/pfb.py:pfbch2_planar_pallas``,
without that kernel's TPU layout (no sublane/lane padding, no 128-step
tiles, no host transpose): any even M, any step count, and the carried
step parity, so odd step counts stream correctly.
"""

from __future__ import annotations

import torch

from cubicsdr_tpu_torch.ops.planar import PC, pc_idft_m, pc_mul
from cubicsdr_tpu_torch.ops.kernels import build

# Output steps per CUDA block; shrunk for large M to keep shared memory
# within the default 48 KB per block.
STEP_TILE = 128


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


def pfbch2_planar(z_re, z_im, h_poly, w_re, w_im, c_re, c_im, parity):
    """PFBCH2 analyzer (arguments as ``pfbch2_planar_plain``). CPU tensors
    run the plain version; CUDA tensors launch ``csrc/pfb.cu``."""
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
    build.require(z_re, "z_re", dev, f32)
    build.require(z_im, "z_im", dev, f32, z_re.shape)
    build.require(h_poly, "h_poly", dev, f32)
    build.require(w_re, "w_re", dev, f32, (M, M))
    build.require(w_im, "w_im", dev, f32, (M, M))
    build.require(c_re, "c_re", dev, f32, (M,))
    build.require(c_im, "c_im", dev, f32, (M,))
    build.require(parity, "parity", dev, torch.int32, ())
    T = STEP_TILE
    while T > 32 and lib.pfbch2_smem_bytes(M, J, T) > 48 * 1024:
        T //= 2
    out_re = torch.empty((M, n_steps), dtype=f32, device=dev)
    out_im = torch.empty((M, n_steps), dtype=f32, device=dev)
    if n_steps == 0:
        return out_re, out_im
    code = lib.pfbch2_planar_launch(
        z_re.data_ptr(), z_im.data_ptr(), z_len, h_poly.data_ptr(),
        w_re.data_ptr(), w_im.data_ptr(), c_re.data_ptr(), c_im.data_ptr(),
        parity.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        M, J, n_steps, T, build.stream_ptr(z_re))
    build.check_launch(lib, code, "pfbch2_planar_launch")
    pfbch2_planar.launches += 1
    return out_re, out_im


pfbch2_planar.launches = 0
