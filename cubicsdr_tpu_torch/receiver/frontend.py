"""Per-demodulator channel frontend: NCO shift + rational resample
(``cubicsdr_tpu/receiver/frontend.py``; ref: src/demod/
DemodulatorPreThread.cpp:153-220).

Planar data takes the folded path: the NCO is folded into the first
resampler stage (``ops.resample.planar_shifted_resample_matmul``) so no
full-rate phasor is generated. ``RoutedChannelFrontend`` goes further and
routes each demod to its channel inside the fused CUDA kernel
(``ops/kernels/route.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cubicsdr_tpu_torch.ops.kernels.route import (
    choose_fused_tile, routed_shifted_resample)
from cubicsdr_tpu_torch.ops.nco import NCOMixer
from cubicsdr_tpu_torch.ops.planar import (
    PC, PLANAR, dtype_zeros, xcat, xtail)
from cubicsdr_tpu_torch.ops.resample import (
    RationalResampler, ResamplerChain, design_ratio, make_resampler,
    planar_rational_resample, planar_shifted_resample_matmul)
from cubicsdr_tpu_torch.stream.op import StreamOp
from cubicsdr_tpu_torch.utils.tree import tree_map

TWO_PI = 6.283185307179586


class ChannelFrontend(StreamOp):
    """(state, (x PC [..., N, L], omega [N])) -> (state, y PC [..., N, Lout]).

    ``omega`` = 2*pi*(channelCenter - demodFreq)/channelRate per demod:
    the mix-down that shifts the wanted carrier to DC."""

    def __init__(self, channel_rate: float, bandwidth: float,
                 n_demods: int, batch_shape: tuple = (), dtype=PLANAR):
        super().__init__()
        if dtype != PLANAR:
            raise ValueError("the port carries IQ in planar form only")
        self.channel_rate = float(channel_rate)
        self.bandwidth = float(bandwidth)
        bs = (*batch_shape, n_demods)
        self.bs = bs
        self.nco = NCOMixer(bs)
        P, Q = design_ratio(bandwidth / channel_rate, max_denominator=500)
        self.P, self.Q = P, Q
        self.dtype = dtype
        self.resampler = make_resampler(P, Q, batch_shape=bs, dtype=dtype)
        chain = isinstance(self.resampler, ResamplerChain)
        self._stage1 = (self.resampler.stages[0] if chain
                        else self.resampler)
        self._rest = nn.ModuleList(self.resampler.stages[1:] if chain
                                   else [])
        self.folded = isinstance(self._stage1, RationalResampler)

    def out_len(self, in_len: int) -> int:
        return in_len // self.Q * self.P

    def init_state(self):
        if self.folded:
            return (self.nco.init_state(),          # phase at fresh x[0]
                    self._stage1.init_state(),      # RAW input tail
                    tuple(s.init_state() for s in self._rest))
        return (self.nco.init_state(), self.resampler.init_state())

    def state_row_mask(self):
        """Nest matching ``init_state()``: True where a leaf's leading dim
        is the per-demod row axis (every leaf of the batched frontend)."""
        return tree_map(lambda _: True, self.init_state())

    def _folded_core(self, z: PC, omega, phase0):
        """Folded mix+resample on a hist-prefixed RAW stream ``z``; phase0
        is the phase at the first FRESH sample (z[hist_len]). Falls back to
        mix-then-conv when no output tile divides (small blocks)."""
        rs = self._stage1
        start_off = rs.Q - rs.KK                   # window start - hist_len
        phase_w0 = torch.remainder(phase0 + omega * start_off, TWO_PI)
        y = planar_shifted_resample_matmul(z, rs, omega, phase_w0)
        if y is None:
            k = (torch.arange(z.shape[-1], dtype=torch.float32,
                              device=z.re.device) - float(rs.hist_len))
            th = torch.remainder(phase0[..., None] + omega[..., None] * k,
                                 TWO_PI)
            c, s = torch.cos(th), torch.sin(th)
            zm = PC(z.re * c - z.im * s, z.im * c + z.re * s)
            y = planar_rational_resample(zm, rs)
        return y

    def _rest_apply(self, rest, y):
        new_rest = []
        for s_i, st_i in zip(self._rest, rest):
            st_i, y = s_i.apply(st_i, y)
            new_rest.append(st_i)
        return tuple(new_rest), y

    def apply(self, state, inputs):
        x, omega = inputs
        if self.folded:
            phase0, hist, rest = state
            omega = torch.as_tensor(omega, dtype=torch.float32,
                                    device=phase0.device)
            z = xcat([hist, x])
            y = self._folded_core(z, omega, phase0)
            new_hist = xtail(z, self._stage1.hist_len)
            new_phase = torch.remainder(phase0 + omega * x.shape[-1], TWO_PI)
            new_rest, y = self._rest_apply(rest, y)
            return (new_phase, new_hist, new_rest), y
        s_n, s_r = state
        s_n, y = self.nco.apply(s_n, (x, omega))
        s_r, y = self.resampler.apply(s_r, y)
        return (s_n, s_r), y


class RoutedChannelFrontend(ChannelFrontend):
    """Fused route + NCO + resample: consumes the CHANNEL matrix [M, Lc]
    directly — no per-demod gather, no per-demod full-rate stream in
    memory (``ops/kernels/route.py``). State keeps ONE raw tail per
    CHANNEL instead of per demod: exact across retunes (a demod that hops
    channels picks up the new channel's true history,
    ref: src/sdr/SDRPostThread.cpp:128-139).

    apply(state, (chans PC [M, Lc], chan_idx int32 [N], omega [N])).
    """

    def __init__(self, channel_rate: float, bandwidth: float,
                 n_demods: int, num_channels: int, chan_len: int,
                 dtype=PLANAR):
        super().__init__(channel_rate, bandwidth, n_demods, (), dtype=dtype)
        if not self.folded:
            raise ValueError("fused routing needs the planar folded path")
        self.M = int(num_channels)
        rs = self._stage1
        O = choose_fused_tile(chan_len // rs.Q * rs.P, rs.P, rs.Q)
        if O is None:
            raise ValueError(f"no fused tile for chan_len={chan_len}")
        self.tile = O
        rs.toeplitz(O)                 # registers the stage's tile matrix

    @classmethod
    def upgrade(cls, fe: ChannelFrontend, num_channels: int, chan_len: int):
        """A fused twin of ``fe``, or None when the fused tile rule does not
        hold for this (stage1, chan_len) — the JAX package's rule, kept so
        the state layout matches the reference's."""
        if not fe.folded or len(fe.bs) != 1:
            return None
        rs = fe._stage1
        if chan_len % rs.Q:
            return None
        if choose_fused_tile(chan_len // rs.Q * rs.P, rs.P, rs.Q) is None:
            return None
        return cls(fe.channel_rate, fe.bandwidth, fe.bs[0], num_channels,
                   chan_len, dtype=fe.dtype)

    def init_state(self):
        return (self.nco.init_state(),                 # per-demod phase
                dtype_zeros((self.M, self._stage1.hist_len), PLANAR,
                            self.device),
                tuple(s.init_state() for s in self._rest))

    def state_row_mask(self):
        """The raw tail is per CHANNEL ([M, hist]), not a per-demod row
        leaf, even when a group has exactly M demods."""
        mask = tree_map(lambda _: True, self.init_state())
        return (mask[0], tree_map(lambda _: False, mask[1]), mask[2])

    def apply(self, state, inputs):
        chans, chan_idx, omega = inputs
        phase0, hist, rest = state
        omega = torch.as_tensor(omega, dtype=torch.float32,
                                device=phase0.device)
        rs = self._stage1
        z = xcat([hist, chans])                        # [M, hist + Lc]
        phase_w0 = torch.remainder(phase0 + omega * (rs.Q - rs.KK), TWO_PI)
        y = PC(*routed_shifted_resample(
            z.re, z.im, chan_idx.to(torch.int32), omega, phase_w0, rs,
            rs.toeplitz(self.tile)[0]))
        new_hist = xtail(z, rs.hist_len)
        new_phase = torch.remainder(phase0 + omega * chans.shape[-1], TWO_PI)
        new_rest, y = self._rest_apply(rest, y)
        return (new_phase, new_hist, new_rest), y


def shift_omegas(demod_freqs, channel_centers, channel_rate):
    """omega[i] = 2*pi*(center_i - freq_i)/rate — mix the offset down to DC
    (ref: DemodulatorPreThread.cpp:153-195)."""
    df = (torch.as_tensor(channel_centers, dtype=torch.float32)
          - torch.as_tensor(demod_freqs, dtype=torch.float32))
    return 2.0 * math.pi * df / channel_rate
