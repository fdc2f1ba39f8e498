"""Analog modems (``cubicsdr_tpu/modems/analog.py``): FM and NBFM so far
(freqdem kf=0.5, ref: src/modules/modem/analog/ModemFM.cpp:7,36;
ModemNBFM.cpp). The rest of the bank is not ported yet.

Each kit is a StreamOp: (state, iq PC [..., L]) -> (state, audio
[..., 1, Lout]).
"""

from __future__ import annotations

import torch

from cubicsdr_tpu_torch.modems.base import (
    DEFAULT_AUDIO_RATE, Modem, register_modem)
from cubicsdr_tpu_torch.ops.freqdem import FreqDem
from cubicsdr_tpu_torch.ops.planar import PLANAR
from cubicsdr_tpu_torch.ops.resample import design_ratio, make_resampler
from cubicsdr_tpu_torch.stream.op import StreamOp


def _audio_ratio(sample_rate: int, audio_rate: int):
    return design_ratio(audio_rate / sample_rate, max_denominator=500)


class AnalogKit(StreamOp):
    """Shared analog plumbing: demod -> audio resample
    (ref: ModemAnalog.cpp:21-33, 67-93). State is (demod, agc, resampler,
    post), leaf for leaf the JAX kit's; the FM kits have no AGC or post
    stage, so those entries are empty."""

    def __init__(self, demod: StreamOp, sample_rate: int, audio_rate: int,
                 batch_shape: tuple = ()):
        super().__init__()
        self.demod = demod
        P, Q = _audio_ratio(sample_rate, audio_rate)
        self.P, self.Q = P, Q
        self.resampler = make_resampler(P, Q, batch_shape=batch_shape,
                                        dtype=torch.float32)
        self.audio_rate = audio_rate

    def init_state(self):
        return (self.demod.init_state(), (), self.resampler.init_state(), ())

    def apply(self, state, x):
        sd, sa, sr, sp = state
        sd, a = self.demod.apply(sd, x)
        sr, a = self.resampler.apply(sr, a)
        return (sd, sa, sr, sp), a[..., None, :]   # mono channel axis


class _AnalogModem(Modem):
    def block_multiple(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE):
        _, Q = _audio_ratio(sample_rate, audio_rate)
        return Q

    def _demod_op(self, batch_shape, dtype):
        raise NotImplementedError

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=PLANAR):
        return AnalogKit(self._demod_op(batch_shape, dtype), sample_rate,
                         audio_rate, batch_shape)


@register_modem
class ModemFM(_AnalogModem):
    name = "FM"
    default_sample_rate = 200000

    def _demod_op(self, batch_shape, dtype):
        return FreqDem(kf=0.5, batch_shape=batch_shape, dtype=dtype)


@register_modem
class ModemNBFM(ModemFM):
    name = "NBFM"
    default_sample_rate = 12500
