"""Signal-level estimation and squelch gating, batched per demod
(``cubicsdr_tpu/receiver/squelch.py``; ref: src/demod/
DemodulatorThread.cpp:142-233).

  - level = 20*log10(mean(|samples|)) over audio (signal-output modems)
    or IQ
  - adaptive floor/ceil: ceil decays toward level+2 at 0.05/s, floor rises
    toward level-5 at 0.15/s (scaled by block duration)
  - smoothed level: attack 0.5, decay 0.05 * sampleTime * 30
  - squelched = enabled && smoothed < squelchLevel
  - audio peak = max(|audio|)
"""

from __future__ import annotations

import torch

from cubicsdr_tpu_torch.ops.planar import planes_of
from cubicsdr_tpu_torch.stream.op import StreamOp

SMALL = 1e-20


def linear_to_db(x):
    return 20.0 * torch.log10(x.clamp_min(SMALL))


class SquelchGate(StreamOp):
    """apply(state, (audio [..., N, C, L] | None, iq PC [..., N, L],
    squelch_level [N], squelch_enabled [N])) ->
    (state, dict(audio, squelched, level, floor, ceil, peak)).

    ``use_signal_out`` (bool per demod) selects audio-vs-IQ level source.
    Digital groups pass ``audio=None`` (symbol modems emit no audio; the
    meter still runs on IQ, ref: DemodulatorThread.cpp:142-196): the level
    comes from the IQ magnitude measured at ``sample_rate`` = the IQ rate,
    and the output has no ``peak`` or ``audio``."""

    def __init__(self, sample_rate: float, n_demods: int,
                 use_signal_out=None):
        super().__init__()
        self.sample_rate = float(sample_rate)
        self.bs = (n_demods,)
        self.register_buffer(
            "use_signal_out",
            torch.zeros(n_demods, dtype=torch.bool) if use_signal_out is None
            else torch.as_tensor(use_signal_out, dtype=torch.bool))

    def init_state(self):
        kw = dict(device=self.device)
        return {
            "level": torch.zeros(self.bs, dtype=torch.float32, **kw),
            "floor": torch.full(self.bs, -100.0, dtype=torch.float32, **kw),
            "ceil": torch.zeros(self.bs, dtype=torch.float32, **kw),
            "squelch_break": torch.zeros(self.bs, dtype=torch.bool, **kw),
        }

    def apply(self, state, inputs):
        audio, iq, squelch_level, squelch_enabled = inputs
        dev = iq.re.device
        # Reference sampleTime = len(iq)/iqRate; the audio block spans the
        # same duration, so measure it on whichever signal the gate's rate
        # belongs to.
        sample_time = (iq if audio is None else audio).shape[-1] \
            / self.sample_rate
        re, im = planes_of(iq)
        current = linear_to_db(torch.sqrt(re * re + im * im).mean(dim=-1))
        if audio is not None:
            lvl_audio = linear_to_db(audio.abs().mean(dim=(-2, -1)))
            current = torch.where(self.use_signal_out, lvl_audio, current)

        sf, sc = state["floor"], state["ceil"]
        sl = torch.as_tensor(squelch_level, dtype=torch.float32, device=dev)
        sc = torch.maximum(sc, current)
        sf = torch.minimum(sf, current)
        sc = torch.maximum(sc, sl + 1.0)
        sc = torch.maximum(sc, sf + 2.0)
        sc = sc - (sc - (current + 2.0)) * sample_time * 0.05
        sf = sf + ((current - 5.0) - sf) * sample_time * 0.15

        lvl = state["level"]
        attack = lvl + (current - lvl) * 0.5
        decay = lvl + (current - lvl) * 0.05 * sample_time * 30.0
        lvl = torch.where(current > lvl, attack, decay)

        enabled = torch.as_tensor(squelch_enabled, dtype=torch.bool,
                                  device=dev)
        squelched = enabled & (lvl < sl)
        # Squelch break: open this block (drives the UI flash,
        # ref: DemodulatorThread.cpp:198-220).
        sq_break = enabled & ~squelched

        new_state = {"level": lvl, "floor": sf, "ceil": sc,
                     "squelch_break": sq_break}
        out = {"squelched": squelched, "level": lvl, "floor": sf,
               "ceil": sc}
        if audio is not None:
            out["peak"] = audio.abs().amax(dim=(-2, -1))
            out["audio"] = torch.where(squelched[..., None, None],
                                       torch.zeros_like(audio), audio)
        return new_state, out
