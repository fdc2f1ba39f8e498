"""ReceiverPipeline — the whole receive step for a fixed plan
(``cubicsdr_tpu/receiver/pipeline.py``; ref: SURVEY.md §3.2, the
SDRPostThread -> PreThread -> DemodulatorThread -> AudioThread chain):

    iq[L] -> PFBCH2 / PFBCH channelizer -> DC blocker on channel 0
          (or 'single': the DC blocker on the whole stream, one channel)
          -> route each demod to its nearest channel
          -> NCO + resample (fused CUDA kernel with use_kernels)
          -> modem kits -> squelch/level -> stereo upmix -> gain/mute/solo mix

Retunes, squelch levels, gains and mutes are per-block control tensors.
The port carries IQ through every channelizer mode of the JAX package,
with every modem of the registry, in either of its representations:
planar (``dtype=PLANAR``, two float32 planes, the default and the CUDA
kernels' representation) or ``dtype=torch.complex64`` (the JAX package's
default; its channelizers run a depthwise convolution and an inverse FFT,
its frontends mix then resample, and no kernel runs). Digital groups
(modem_type == "digital") ride the same chain: their kits emit symbol
streams instead of audio (ref: ModemDigital.cpp:56-83), the signal meter
runs on their channel IQ, and they add nothing to the audio mix (the
reference's digital modems never push to the audio queue,
src/demod/DemodulatorThread.cpp:237-247).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from benchmark.reference.io_sources import optimal_channel_count
from benchmark.reference.modems import make_modem
from benchmark.reference.ops.channelizer import (
    ChannelizerPFB, ChannelizerPFB2, channel_centers)
from benchmark.reference.ops.iir import DCBlocker
from benchmark.reference.ops.planar import PC, PLANAR
from benchmark.reference.ops.resample import design_ratio
from benchmark.reference.receiver.frontend import (
    ChannelFrontend, RoutedChannelFrontend, shift_omegas)
from benchmark.reference.receiver.mixer import mix_audio
from benchmark.reference.receiver.squelch import SquelchGate
from benchmark.reference.stream.op import StreamOp
from benchmark.reference.utils.tree import tree_map


@dataclass(frozen=True)
class DemodGroupSpec:
    """A batch of demodulators sharing one modem type/bandwidth."""
    modem_name: str
    bandwidth: int
    count: int
    settings: tuple = ()          # modem settings as sorted (k, v) pairs

    @property
    def settings_dict(self):
        return dict(self.settings)


class ReceiverPipeline(StreamOp):
    """Fixed-plan receiver on ``device``, the card unless the caller asks
    for the host.

    Constructor arguments are the JAX package's, with ``use_kernels`` for
    ``use_pallas`` (the hand-written CUDA kernels instead of the Pallas
    ones; on CPU data their plain versions run) and ``device``.
    ``device="cuda"`` is the default and raises where there is no CUDA
    device (pass ``device="cpu"`` to run on the host).

    ``dtype``: PLANAR (the default) or torch.complex64. The kernels take
    planar data only, as the JAX package's Pallas kernels do, so
    ``use_kernels=None`` (the default) means True for PLANAR and False for
    complex64, and an explicit ``use_kernels=True`` with complex64 raises
    ValueError. ``use_kernels=False`` is the plain path, the JAX package's
    ``use_pallas=False``.

    chan_mode: 'pfbch' | 'pfbch2' | 'single' (ref modes:
    SDRPostThreadChannelizerType, src/sdr/SDRPostThread.h:25-27; 'single'
    is the numChannels==1 DC-blocked passthrough, ref: SDRPostThread.cpp:
    248-301)."""

    def __init__(self, sample_rate: float, groups: list[DemodGroupSpec],
                 chan_mode: str = "pfbch2", num_channels: int | None = None,
                 audio_rate: int = 48000, block_len: int | None = None,
                 dtype=PLANAR, use_kernels: bool | None = None,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ReceiverPipeline runs on the card by default and this host "
                "has no CUDA device; pass device='cpu' to run on the host")
        if dtype not in (PLANAR, torch.complex64):
            raise ValueError(f"dtype is PLANAR or torch.complex64, not "
                             f"{dtype!r}")
        if use_kernels is None:
            use_kernels = dtype == PLANAR
        elif use_kernels and dtype != PLANAR:
            raise ValueError("the CUDA kernels take planar data: "
                             "use_kernels=True needs dtype=PLANAR")
        if chan_mode not in ("pfbch", "pfbch2", "single"):
            raise ValueError(f"unknown chan_mode {chan_mode!r}")
        self.sample_rate = float(sample_rate)
        self.audio_rate = int(audio_rate)
        self.chan_mode = chan_mode
        self.groups = list(groups)
        self.dtype = dtype
        self.use_kernels = bool(use_kernels)
        # Whether the caller pinned block_len (plan rebuilds forward an
        # explicit choice; a default one is re-derived).
        self.block_len_explicit = block_len is not None
        if chan_mode == "single":
            self.M = 1
            self.chan_rate = self.sample_rate
        else:
            self.M = num_channels or optimal_channel_count(sample_rate)
            self.chan_rate = (self.sample_rate / self.M
                              * (2 if chan_mode == "pfbch2" else 1))

        self._modems = []
        self.is_digital = []
        frontends, kits, gates = [], [], []
        for g in self.groups:
            modem = make_modem(g.modem_name, **g.settings_dict)
            bw = modem.check_sample_rate(g.bandwidth, audio_rate)
            digital = modem.modem_type == "digital"
            frontends.append(ChannelFrontend(self.chan_rate, bw, g.count,
                                             dtype=dtype))
            kits.append(modem.build_kit(bw, audio_rate,
                                        batch_shape=(g.count,), dtype=dtype))
            # A symbol modem's meter runs on the bandwidth-rate IQ, and it
            # has no audio to gate.
            gates.append(SquelchGate(bw, g.count) if digital else SquelchGate(
                audio_rate, g.count,
                use_signal_out=[modem.uses_signal_output()] * g.count))
            self._modems.append(modem)
            self.is_digital.append(digital)
        self.kits = nn.ModuleList(kits)
        self.gates = nn.ModuleList(gates)

        # Channelizer + DC blocker (channel 0 carries the tuner DC spike,
        # ref: SDRPostThread.cpp:364-375).
        if chan_mode == "pfbch":
            self.channelizer = ChannelizerPFB(self.M, dtype=dtype)
            self._decim = self.M
        elif chan_mode == "pfbch2":
            self.channelizer = ChannelizerPFB2(
                self.M, use_kernels=use_kernels, dtype=dtype)
            self._decim = self.M // 2
        else:
            self.channelizer = None
            self._decim = 1
        self.dc = DCBlocker(0.0005, dtype=dtype)
        centers = (channel_centers(self.M, self.sample_rate)
                   if self.channelizer is not None else np.zeros(1))
        self.register_buffer("centers", torch.from_numpy(
            centers.astype(np.float32)))

        self.frontends = nn.ModuleList(frontends)
        self.block_len = block_len or self.choose_block_len()
        self._check_lengths()

        # Fused route+frontend: groups whose first resampler stage admits a
        # fused tile skip the per-demod channel gather entirely.
        self.fused_route = [False] * len(self.groups)
        if use_kernels and self.channelizer is not None:
            for gi, fe in enumerate(self.frontends):
                rfe = RoutedChannelFrontend.upgrade(fe, self.M,
                                                    self._chan_len)
                if rfe is not None:
                    self.frontends[gi] = rfe
                    self.fused_route[gi] = True
        self.to(device)

    # --- static shape bookkeeping ---
    @property
    def decim(self) -> int:
        """Input samples per channel sample (M, M/2 or 1)."""
        return self._decim

    def group_block_multiple(self, gi: int) -> int:
        fe = self.frontends[gi]
        b_k = self._modems[gi].block_multiple(int(fe.bandwidth),
                                              self.audio_rate)
        t = b_k // math.gcd(fe.P, b_k)
        return self._decim * fe.Q * t

    def choose_block_len(self, target_batches_per_sec: int = 60) -> int:
        m = self._decim
        for gi in range(len(self.groups)):
            m = math.lcm(m, self.group_block_multiple(gi))
        if self.use_kernels:
            # Best-effort 128-step alignment, as the JAX package aligns for
            # its kernels: the fused tile rule (S = (O/P)*Q | 128) then
            # holds, capped so pathological Q can't explode the block.
            for fe in self.frontends:
                cand = math.lcm(m, self._decim * fe.Q * 128)
                if cand <= (1 << 21):
                    m = cand
        n = int(self.sample_rate / target_batches_per_sec)
        return max(((n + m - 1) // m) * m, m)

    def _check_lengths(self):
        lc = self.block_len // self._decim
        self._chan_len = lc
        outs = set()
        for gi, fe in enumerate(self.frontends):
            if lc % fe.Q:
                raise ValueError(
                    f"block_len {self.block_len} -> channel len {lc} not "
                    f"divisible by frontend Q={fe.Q}; use choose_block_len()")
            if not self.is_digital[gi]:
                outs.add(self._kit_out_len(gi, fe.out_len(lc)))
        # Audio lengths must agree across analog groups for mixing.
        if len(outs) > 1:
            raise ValueError(f"groups produce different audio lengths "
                             f"{outs}: bandwidth/audio ratios must be exact "
                             f"rationals")
        self.audio_len = outs.pop() if outs else 0

    def _kit_out_len(self, gi, in_len):
        # Analog kits resample bandwidth -> audio rate by exact rationals;
        # I/Q passes its input through.
        if self._modems[gi].name == "I/Q":
            return in_len
        fe = self.frontends[gi]
        P, Q = design_ratio(self.audio_rate / fe.bandwidth,
                            max_denominator=500)
        return in_len // Q * P

    # --- state ---
    def init_state(self):
        return {
            "chan": (self.channelizer.init_state()
                     if self.channelizer is not None else ()),
            "dc": self.dc.init_state(),
            "groups": tuple(
                (fe.init_state(), kit.init_state(), gate.init_state())
                for fe, kit, gate in
                zip(self.frontends, self.kits, self.gates)),
        }

    def group_state_row_mask(self, gi: int):
        """Bool nest matching ``init_state()["groups"][gi]``: True on
        leaves whose leading dim is the per-demod ROW axis (portable
        row-wise across plan rebuilds), False on shared per-channel leaves
        (the fused frontend's [M, hist] channel tail). Kit and gate state
        is per-demod throughout."""
        fe, kit, gate = self.frontends[gi], self.kits[gi], self.gates[gi]
        return (fe.state_row_mask(),
                tree_map(lambda _: True, kit.init_state()),
                tree_map(lambda _: True, gate.init_state()))

    # --- control vector layout: per-demod parameters, grouped ---
    def control_template(self):
        """Per-group dicts of arrays the caller fills each step (numpy or
        tensors on the pipeline's device)."""
        out = []
        for g in self.groups:
            n = g.count
            out.append({
                "frequency": np.zeros(n, np.float32),   # offset from center Hz
                "squelch_level": np.full(n, -100.0, np.float32),
                "squelch_enabled": np.zeros(n, bool),
                "gain": np.ones(n, np.float32),
                "active": np.ones(n, bool),             # mute/solo resolved
            })
        return out

    def apply(self, state, inputs, taps=None):
        """inputs = (iq [L] in the pipeline's representation, a PC or a
        complex64 tensor; controls list-of-dicts). ``taps`` (the
        benchmark's addition to this copy): per group, the IQ its modem
        kit and squelch gate take instead of the frontend's output, so
        that each stage is judged from the program's input to it; each
        group's ``iq`` output stays the frontend's own and ``kit_in``
        is what the kit took. Returns (state,
        outputs): mix [2, La], mix_peak, per-group dicts (analog: audio,
        level, floor, ceil, peak, squelched, iq; digital: symbols, evm,
        locked, level, floor, ceil, squelched, iq) and the iq
        passthrough."""
        iq, controls = inputs
        dev = self.device
        planar = isinstance(iq, PC)
        if self.channelizer is not None:
            st_chan, chans = self.channelizer.apply(state["chan"], iq)
            # DC-block channel 0 (tuner spike), written in place into the
            # channelizer's fresh output.
            if planar:
                st_dc, ch0 = self.dc.apply(state["dc"],
                                           PC(chans.re[0], chans.im[0]))
                chans.re[0] = ch0.re
                chans.im[0] = ch0.im
            else:
                st_dc, ch0 = self.dc.apply(state["dc"], chans[0])
                chans[0] = ch0
        else:
            # 'single': the whole DC-blocked stream is the one channel.
            st_chan = ()
            st_dc, dcq = self.dc.apply(state["dc"], iq)
            chans = PC(dcq.re[None], dcq.im[None]) if planar else dcq[None]

        group_states, group_outs = [], []
        audio_all, peaks_all, gains_all, active_all = [], [], [], []
        for gi, (fe, kit, gate) in enumerate(
                zip(self.frontends, self.kits, self.gates)):
            s_fe, s_kit, s_gate = state["groups"][gi]
            ctl = controls[gi]
            freqs = torch.as_tensor(ctl["frequency"], dtype=torch.float32,
                                    device=dev)
            # Route each demod to its nearest channel (first on ties, as
            # jnp.argmin; ref: SDRPostThread::getChannelAt,
            # src/sdr/SDRPostThread.cpp:128-139).
            dist = (freqs[:, None] - self.centers[None, :]).abs()
            chan_idx = dist.argmin(dim=-1)
            omega = shift_omegas(freqs, self.centers[chan_idx],
                                 self.chan_rate)
            if self.fused_route[gi]:
                s_fe, y = fe.apply(s_fe, (chans, chan_idx, omega))
            else:
                x = (PC(chans.re[chan_idx], chans.im[chan_idx]) if planar
                     else chans[chan_idx])                   # [N, Lc]
                s_fe, y = fe.apply(s_fe, (x, omega))
            own = y
            if taps is not None:
                y = taps[gi]
            s_kit, ko = kit.apply(s_kit, y)
            if self.is_digital[gi]:
                # Symbol modem: no audio; the meter reads the channel IQ
                # (ref: DemodulatorThread.cpp:142-196).
                s_gate, gout = gate.apply(
                    s_gate, (None, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                gout.update(ko)              # symbols / evm / locked
            else:
                s_gate, gout = gate.apply(
                    s_gate, (ko, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                a = gout["audio"]
                if a.shape[-2] == 1:                    # mono -> stereo
                    a = torch.cat([a, a], dim=-2)
                audio_all.append(a)
                peaks_all.append(gout["peak"])
                gains_all.append(torch.as_tensor(
                    ctl["gain"], dtype=torch.float32, device=dev))
                active_all.append(torch.as_tensor(ctl["active"], device=dev)
                                  .to(torch.float32))
            # Per-demod IQ tap for the demod spectrum/scope views
            # (ref: SDRPostThread.cpp:233-245).
            gout["iq"] = own
            gout["kit_in"] = y
            group_states.append((s_fe, s_kit, s_gate))
            group_outs.append(gout)

        if audio_all:
            mix, mix_peak = mix_audio(torch.cat(audio_all, dim=-3),
                                      torch.cat(gains_all, dim=-1),
                                      torch.cat(active_all, dim=-1),
                                      torch.cat(peaks_all, dim=-1))
        else:
            mix = torch.zeros((2, self.audio_len), dtype=torch.float32,
                              device=dev)
            mix_peak = torch.zeros((), dtype=torch.float32, device=dev)

        new_state = {"chan": st_chan, "dc": st_dc,
                     "groups": tuple(group_states)}
        return new_state, {"mix": mix, "mix_peak": mix_peak,
                           "groups": group_outs, "iq": iq}


def plan_from_manager(mgr, audio_rate: int = 48000
                      ) -> tuple[list[DemodGroupSpec], dict]:
    """Group a DemodulatorMgr's demods into batched specs (type+bandwidth+
    settings share one row-set); returns (specs in mgr order of groups,
    {group key: its demods}) — the JAX package's host-side planner."""
    keyed: dict = {}
    for d in mgr.get_demodulators():
        key = (d.demod_type, int(d.bandwidth),
               tuple(sorted(d.read_modem_settings().items())))
        keyed.setdefault(key, []).append(d)
    return [DemodGroupSpec(k[0], k[1], len(v), k[2])
            for k, v in keyed.items()], keyed


def controls_from_manager(mgr, pipeline: ReceiverPipeline, keyed: dict,
                          center_freq: float):
    """Fill the pipeline's control vectors from live instance properties
    (solo/mute resolution per ref: DemodulatorThread solo squelch-lock +
    AudioThread mute semantics)."""
    any_solo = any(d.solo for d in mgr.get_demodulators())
    half = pipeline.sample_rate / 2
    controls = []
    for (key, demods), g in zip(keyed.items(), pipeline.groups):
        n = len(demods)
        # Range (de)activation: demods outside the captured band go silent
        # (ref: SDRPostThread::updateActiveDemodulators,
        # src/sdr/SDRPostThread.cpp:66-89).
        in_range = [abs(d.frequency - center_freq) <= half for d in demods]
        ctl = {
            "frequency": np.asarray(
                [d.frequency - center_freq for d in demods], np.float32),
            "squelch_level": np.asarray(
                [d.squelch_level for d in demods], np.float32),
            "squelch_enabled": np.asarray(
                [d.squelch_enabled for d in demods], bool),
            "gain": np.asarray([d.gain for d in demods], np.float32),
            "active": np.asarray(
                [ir and not d.muted and (d.solo or not any_solo)
                 for d, ir in zip(demods, in_range)], bool),
        }
        controls.append(ctl)
    return controls
