"""PFBCH2 analyzer, plain PyTorch (a frozen copy of the port's
``ops/kernels/pfb.py`` plain version; the reference never launches a
kernel, so ``pfbch2_planar`` is the plain version on every device)."""

from __future__ import annotations

import torch

from benchmark.reference.ops.planar import PC, pc_idft_m, pc_mul


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


pfbch2_planar = pfbch2_planar_plain
