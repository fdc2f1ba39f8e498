"""ShardedReceiver: the multi-device receive step
(``cubicsdr_tpu/parallel/sharded.py``) on ``torch.distributed``.

The unified chain (wideband PFBCH2 channelizer -> routed mixed-modem
demod farm -> squelch -> mix), planar, sharded over a ('time', 'chan')
mesh with one process per rank and one device per process:

  * 'time': each rank holds a contiguous span of the IQ block. Every
    FIR-like stage consumes (history, samples); the history is the
    previous rank's tail, one cyclic permute per stage per block
    (``halo.py`` and the StreamOp protocol). NCO phase continuity is
    closed form: a carried per-demod base plus omega * t * L_local.
    Block-statistic stages (AGC, carrier EMAs, squelch meters) keep
    replicated state through collectives over 'time'; the channel-0 DC
    blocker composes its recurrence exactly across shards.
  * 'chan': demodulator rows are split across ranks; the mix is a sum
    over 'chan'.

The demod math is the same module objects ``ReceiverPipeline`` runs, with
both CUDA kernels on every rank by default: the PFB analyzer once per
block, and the route kernel once per fused group, fed one per-channel
halo.

State and outputs on a rank are its own shard. ``place_state`` cuts it
from the JAX package's global layout (a leading [nt] axis, 'chan' rows in
global order) and ``gather_state`` assembles that layout again, so state
and checkpoints move between the packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from cubicsdr_tpu_torch.modems import make_modem
from cubicsdr_tpu_torch.ops.channelizer import (
    ChannelizerPFB2, channel_centers)
from cubicsdr_tpu_torch.ops.iir import DCBlocker
from cubicsdr_tpu_torch.ops.planar import PC
from cubicsdr_tpu_torch.ops.resample import design_ratio
from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
from cubicsdr_tpu_torch.receiver.frontend import (
    ChannelFrontend, RoutedChannelFrontend, shift_omegas)
from cubicsdr_tpu_torch.receiver.pipeline import DemodGroupSpec
from cubicsdr_tpu_torch.receiver.squelch import SquelchGate
from cubicsdr_tpu_torch.utils.tree import tree_map

TIME, TIME_CHAN = "time", "time,chan"


class ShardedReceiver(nn.Module):
    """Fixed-plan mixed-modem farm: M-channel PFBCH2 + demod groups,
    planar, squelch and controls in the step, on this rank's shard.

    groups: list[DemodGroupSpec]; every group's count must divide the
    mesh's 'chan' extent. ``block_len`` is GLOBAL samples per step (it
    splits into n_time equal spans, each a multiple of the per-shard block
    multiple). ``mesh`` defaults to ``make_receiver_mesh(device_type=device)``.
    ``spectrum_fft``: each time shard takes |FFT| of its newest
    2*spectrum_fft samples, gathered over 'time' in shard order.
    Defaults are the card and both kernels (``use_kernels=True``, the JAX
    package's ``use_pallas=True``); ``device="cuda"`` raises where there
    is no CUDA device."""

    def __init__(self, sample_rate: float, num_channels: int,
                 groups: list[DemodGroupSpec], mesh=None,
                 audio_rate: int = 48_000, block_len: int | None = None,
                 use_kernels: bool = True, spectrum_fft: int | None = None,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ShardedReceiver runs on the card by default and this host "
                "has no CUDA device; pass device='cpu' to run on the host")
        self.spectrum_fft = spectrum_fft
        self.mesh = (mesh if mesh is not None
                     else make_receiver_mesh(device_type=device.type))
        self.nt, self.nc = self.mesh.nt, self.mesh.nc
        time_axis = self.mesh.time
        self.groups = list(groups)
        self.n_demods = sum(g.count for g in self.groups)
        self.sample_rate = float(sample_rate)
        self.M = int(num_channels)
        self.audio_rate = audio_rate
        self.use_kernels = bool(use_kernels)

        self.chan = ChannelizerPFB2(self.M, use_kernels=use_kernels)
        self.D = self.M // 2
        self.chan_rate = 2.0 * sample_rate / self.M
        self.dc = DCBlocker(0.0005)
        self.register_buffer("centers", torch.from_numpy(
            channel_centers(self.M, sample_rate).astype(np.float32)))

        # Per-group ops: the classes ReceiverPipeline builds, with this
        # rank's rows and collectives over 'time'.
        self._modems, self.is_digital, self.n_locals = [], [], []
        frontends, kits, gates = [], [], []
        m = 2 * self.D              # even steps per shard (PFBCH2 parity)
        for g in self.groups:
            if g.count % self.nc:
                raise ValueError(
                    f"group {g.modem_name} count {g.count} must divide the "
                    f"'chan' mesh extent {self.nc}")
            n_local = g.count // self.nc
            modem = make_modem(g.modem_name, **g.settings_dict)
            bw = modem.check_sample_rate(g.bandwidth, audio_rate)
            digital = modem.modem_type == "digital"
            fe = ChannelFrontend(self.chan_rate, bw, n_local)
            frontends.append(fe)
            kits.append(modem.build_kit(bw, audio_rate,
                                        batch_shape=(n_local,),
                                        time_axis=time_axis))
            gates.append(
                SquelchGate(bw, n_local, time_axis=time_axis) if digital
                else SquelchGate(audio_rate, n_local,
                                 use_signal_out=[modem.uses_signal_output()]
                                 * n_local, time_axis=time_axis))
            self._modems.append(modem)
            self.is_digital.append(digital)
            self.n_locals.append(n_local)
            b_k = modem.block_multiple(int(bw), audio_rate)
            t = b_k // math.gcd(fe.P, b_k)
            m = math.lcm(m, self.D * fe.Q * t)
        self.kits = nn.ModuleList(kits)
        self.gates = nn.ModuleList(gates)

        if use_kernels:
            # The fused tile's alignment, as ReceiverPipeline
            # .choose_block_len: best effort, capped.
            for fe in frontends:
                cand = math.lcm(m, self.D * fe.Q * 128)
                if cand <= (1 << 21):
                    m = cand
        self.local_multiple = m
        if block_len is None:
            per_shard = max(m, ((1 << 17) // m) * m)
        else:
            if block_len % (self.nt * m):
                raise ValueError(f"block_len {block_len} is not a multiple "
                                 f"of n_time * {m}")
            per_shard = block_len // self.nt
        self.local_len = per_shard
        self.block_len = per_shard * self.nt
        self.local_chan_len = self.local_len // self.D
        # Audio lengths must agree across analog groups (the mix).
        outs = set()
        for gi, fe in enumerate(frontends):
            if self.is_digital[gi]:
                continue
            P2, Q2 = design_ratio(self.audio_rate / fe.bandwidth, 500)
            d_len = fe.out_len(self.local_chan_len)
            outs.add(d_len if self._modems[gi].name == "I/Q"
                     else d_len // Q2 * P2)
        if len(outs) > 1:
            raise ValueError(f"audio length mismatch: {outs}")
        self.local_audio_len = outs.pop() if outs else 0

        # Fused route + frontend: eligible groups read the channel matrix
        # directly (the route kernel), fed ONE per-channel [M, hist] halo.
        self.fused_route = [False] * len(self.groups)
        if use_kernels:
            for gi, fe in enumerate(frontends):
                rfe = RoutedChannelFrontend.upgrade(fe, self.M,
                                                    self.local_chan_len)
                if rfe is not None:
                    frontends[gi] = rfe
                    self.fused_route[gi] = True
        self.frontends = nn.ModuleList(frontends)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.centers.device

    # --- carried state: this rank's shard of the JAX layout ---
    def init_state(self):
        return {
            "chan": self.chan.shard_carry_init(),
            "dc": self.dc.shard_carries(),
            "groups": tuple(
                (fe.shard_carries(), kit.shard_carries(), gate.init_state())
                for fe, kit, gate in
                zip(self.frontends, self.kits, self.gates)),
        }

    def state_specs(self):
        """Nest matching ``init_state()``: "time" where a leaf is the same
        on every 'chan' rank, "time,chan" where its leading axis is the
        group's demod rows, split over 'chan' (the JAX PartitionSpecs)."""
        st = self.init_state()

        def spec(tree, s):
            return tree_map(lambda _: s, tree)

        def fe_spec(gi, fe_c):
            if not self.fused_route[gi]:
                return spec(fe_c, TIME_CHAN)
            base_c, hist_c, rest_c = fe_c     # the [M, hist] tail is shared
            return (spec(base_c, TIME_CHAN), spec(hist_c, TIME),
                    spec(rest_c, TIME_CHAN))

        return {
            "chan": spec(st["chan"], TIME),
            "dc": spec(st["dc"], TIME),
            "groups": tuple(
                (fe_spec(gi, fe_c), spec(kit_c, TIME_CHAN),
                 spec(gate_c, TIME_CHAN))
                for gi, (fe_c, kit_c, gate_c) in enumerate(st["groups"])),
        }

    def place_state(self, state):
        """This rank's shard of a global state (the JAX layout: leaves
        [nt, ...], demod rows in global order), on the device; a state
        that is already a shard (``init_state``'s shapes) passes through,
        moved to the device."""
        like = self.init_state()
        t, c = self.mesh.t, self.mesh.c

        def cut(g, s, ref):
            g = torch.as_tensor(np.asarray(g) if not torch.is_tensor(g)
                                else g)
            if g.dim() == ref.dim() + 1:          # global: cut this shard
                if g.shape[0] != self.nt:
                    raise ValueError(f"state holds {g.shape[0]} time "
                                     f"shards, the mesh {self.nt}")
                g = g[t]
                if s == TIME_CHAN:
                    n = ref.shape[0]
                    g = g[c * n:(c + 1) * n]
            if tuple(g.shape) != tuple(ref.shape):
                raise ValueError(f"state leaf {tuple(g.shape)} does not fit "
                                 f"this plan's {tuple(ref.shape)}")
            return g.to(ref.device, ref.dtype)

        return tree_map(cut, _as_pc(state, like), self.state_specs(), like)

    def gather_state(self, state):
        """The global state (the JAX layout) assembled from every rank's
        shard, on every rank (a collective: all ranks call it), as numpy."""
        def gather(leaf, s):
            x = leaf
            if s == TIME_CHAN:
                g = _gather(self.mesh.chan, x)
                x = g.reshape(-1, *g.shape[2:])
            return _gather(self.mesh.time, x).cpu().numpy()

        return tree_map(gather, state, self.state_specs())

    def control_template(self):
        out = []
        for g in self.groups:
            n = g.count
            out.append({
                "frequency": np.zeros(n, np.float32),
                "squelch_level": np.full(n, -100.0, np.float32),
                "squelch_enabled": np.zeros(n, bool),
                "gain": np.ones(n, np.float32),
                "active": np.ones(n, bool),
            })
        return out

    def place_controls(self, controls):
        """This rank's rows of each group's (global) control vectors, as
        tensors on the device."""
        c, dev = self.mesh.c, self.device
        out = []
        for ctl, n in zip(controls, self.n_locals):
            out.append({k: torch.as_tensor(np.asarray(v)[c * n:(c + 1) * n]
                                           if not torch.is_tensor(v)
                                           else v[c * n:(c + 1) * n],
                                           device=dev)
                        for k, v in ctl.items()})
        return out

    # --- input placement ---
    def shard_iq(self, iq) -> PC:
        """This rank's time span of a global block: iq complex ndarray or
        PC of [block_len] -> PC [local_len] on the device."""
        lo = self.mesh.t * self.local_len
        hi = lo + self.local_len
        if isinstance(iq, PC):
            return PC(*(torch.as_tensor(p[lo:hi], dtype=torch.float32)
                        .to(self.device) for p in iq))
        iq = np.asarray(iq)[lo:hi]
        return self.shard_iq_local(np.stack([iq.real, iq.imag]))

    def shard_iq_local(self, local_planes) -> PC:
        """Multi-host ingest: each rank supplies ONLY its own time span of
        the block, float32 planes [2, local_len] (its local source feeds
        just that span); no rank ever holds the whole block."""
        planes = torch.as_tensor(np.ascontiguousarray(local_planes,
                                                      np.float32))
        if tuple(planes.shape) != (2, self.local_len):
            raise ValueError(f"a rank's span must be [2, {self.local_len}], "
                             f"got {tuple(planes.shape)}")
        planes = planes.to(self.device)
        return PC(planes[0].contiguous(), planes[1].contiguous())

    # --- the step ---
    def step(self, state, iq_local: PC, controls):
        """One block on this rank: (state, iq_local PC [local_len],
        controls placed by ``place_controls``) -> (state, outs). outs: mix
        [2, local_audio_len] (this time span, summed over 'chan'),
        mix_peak, per-group dicts of this rank's rows (analog: audio
        [n, C, La_local], level, floor, ceil, squelched, peak; digital:
        symbols of this span, evm and locked over the whole block, level,
        floor, ceil, squelched; both: the IQ tap ``iq`` of this span), and
        with ``spectrum_fft`` the gathered ``spectrum_mags``
        [nt, 2*spectrum_fft]."""
        ta, ca = self.mesh.time, self.mesh.chan
        c_chan, chans = self.chan.shard_apply(state["chan"], iq_local, ta)
        c_dc, ch0 = self.dc.shard_apply(state["dc"],
                                        PC(chans.re[0], chans.im[0]), ta)
        chans.re[0] = ch0.re
        chans.im[0] = ch0.im

        new_groups, group_outs = [], []
        audio_all, peaks_all, gains_all, act_all = [], [], [], []
        for gi, (fe, kit, gate) in enumerate(
                zip(self.frontends, self.kits, self.gates)):
            c_fe, c_kit, s_gate = state["groups"][gi]
            ctl = controls[gi]
            freqs = torch.as_tensor(ctl["frequency"], dtype=torch.float32,
                                    device=self.device)
            ci = (freqs[:, None] - self.centers[None, :]).abs().argmin(
                dim=-1)
            omega = shift_omegas(freqs, self.centers[ci], self.chan_rate)
            if self.fused_route[gi]:
                c_fe, y = fe.shard_apply(c_fe, (chans, ci, omega), ta)
            else:
                x = PC(chans.re[ci], chans.im[ci])         # [n_local, Lc]
                c_fe, y = fe.shard_apply(c_fe, (x, omega), ta)
            c_kit, ko = kit.shard_apply(c_kit, y, ta)
            if self.is_digital[gi]:
                s_gate, gout = gate.apply(
                    s_gate, (None, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                # evm and locked are per time span: report the block's.
                gout["symbols"] = ko["symbols"]
                gout["evm"] = ta.pmean(ko["evm"])
                gout["locked"] = ta.pmean(
                    ko["locked"].to(torch.float32)) > 0.5
            else:
                s_gate, gout = gate.apply(
                    s_gate, (ko, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                a = gout["audio"]
                if a.shape[-2] == 1:
                    a = torch.cat([a, a], dim=-2)
                audio_all.append(a)
                peaks_all.append(gout["peak"])
                gains_all.append(torch.as_tensor(
                    ctl["gain"], dtype=torch.float32, device=self.device))
                act_all.append(torch.as_tensor(
                    ctl["active"], device=self.device).to(torch.float32))
            gout["iq"] = y          # the per-demod IQ tap, as the pipeline
            new_groups.append((c_fe, c_kit, s_gate))
            group_outs.append(gout)

        # The mix: local weighted sum, summed over 'chan'; the peak as the
        # unsharded mixer's (per-stream max over time, in the gate, then
        # the gain-weighted sum over ALL streams).
        if audio_all:
            a_cat = torch.cat(audio_all, dim=-3)
            g_cat = torch.cat(gains_all, dim=-1) * torch.cat(act_all, dim=-1)
            p_cat = torch.cat(peaks_all, dim=-1)
            mix = ca.psum((a_cat * g_cat[:, None, None]).sum(dim=-3))
            peak = ca.psum((p_cat * g_cat).sum(dim=-1))
            scale = torch.where(peak > 1.0, 1.0 / peak.clamp_min(1e-9),
                                torch.ones_like(peak))
            mix = mix * scale
            mix_peak = peak.clamp_max(1.0)
        else:
            mix = torch.zeros((2, self.local_audio_len), dtype=torch.float32,
                              device=self.device)
            mix_peak = torch.zeros((), dtype=torch.float32,
                                   device=self.device)

        new_state = {"chan": c_chan, "dc": c_dc, "groups": tuple(new_groups)}
        outs = {"mix": mix, "mix_peak": mix_peak, "groups": group_outs}
        if self.spectrum_fft:
            # One |FFT| frame per time shard (its newest fftSizeInternal
            # samples), gathered in shard order.
            n = self.spectrum_fft * 2
            if self.local_len < n:
                raise ValueError(f"a time span of {self.local_len} samples "
                                 f"is shorter than the {n}-point FFT")
            X = torch.fft.fft(torch.complex(iq_local.re[-n:],
                                            iq_local.im[-n:]))
            mag = torch.roll(X.abs(), n // 2, dims=-1)
            outs["spectrum_mags"] = ta.all_gather(mag)
        return new_state, outs

    def make_step(self):
        """The step as a function step(state, iq_local, controls) ->
        (state, outs), the JAX package's ``make_step`` interface."""
        return self.step

    def gather_outputs(self, outs):
        """Global outputs from every rank's shard (a collective): mix
        [2, block audio], each group's per-demod rows in global order with
        their audio and symbols over the whole block, as numpy."""
        ta, ca = self.mesh.time, self.mesh.chan

        def over_time(x):                 # concatenate spans on the last axis
            g = _gather(ta, x)
            return torch.cat(list(g), dim=-1)

        def rows(x):
            g = _gather(ca, x)
            return g.reshape(-1, *g.shape[2:])

        groups = []
        for gout in outs["groups"]:
            d = {}
            for k, v in gout.items():
                if k == "iq":
                    d[k] = PC(*(over_time(rows(p)).cpu().numpy() for p in v))
                    continue
                v = rows(v)
                if k in ("audio", "symbols"):
                    v = over_time(v)
                d[k] = v.cpu().numpy()
            groups.append(d)
        res = {"mix": over_time(outs["mix"]).cpu().numpy(),
               "mix_peak": outs["mix_peak"].cpu().numpy(),
               "groups": groups}
        if "spectrum_mags" in outs:
            res["spectrum_mags"] = outs["spectrum_mags"].cpu().numpy()
        return res


def _gather(axis, x: torch.Tensor) -> torch.Tensor:
    """``axis.all_gather`` for any dtype (booleans travel as bytes)."""
    if x.dtype == torch.bool:
        return axis.all_gather(x.to(torch.uint8)).to(torch.bool)
    return axis.all_gather(x)


def _as_pc(tree, like):
    """``tree`` with every (re, im) pair where ``like`` holds a ``PC``
    rebuilt as a ``PC`` (a JAX state converted to numpy keeps its own
    NamedTuple type)."""
    if isinstance(like, PC):
        return PC(*tree)
    if isinstance(like, dict):
        return {k: _as_pc(tree[k], like[k]) for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_as_pc(t, lk) for t, lk in zip(tree, like))
    return tree
