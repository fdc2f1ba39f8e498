"""Analog modem bank (``cubicsdr_tpu/modems/analog.py``): FM, NBFM, AM,
DSB, USB, LSB, CW, I/Q and FM-stereo (all ref paths under
src/modules/modem/analog/):

  FM / NBFM : freqdem kf=0.5 (ModemFM.cpp:7,36; ModemNBFM.cpp)
  AM        : envelope + 51-tap FIR DC blocker, autoGain (ModemAM.cpp:7-48)
  DSB       : suppressed-carrier product detect with block-level squaring
              carrier recovery in place of liquid ampmodem's PLL
  USB / LSB : one-sided complex FIR bandpass + Re{.} in place of the
              quarter-rate shift + IIR halfband + firhilbf chain
              (ModemUSB.cpp:7-60)
  CW        : resample to the audio rate, beep NCO offset + Re{.},
              gain/autoGain (ModemCW.cpp:110-190)
  I/Q       : stereo passthrough (imag, real) (ModemIQ.cpp:31-57)
  FMS       : freqdem + pilot squaring (an analytic 19 kHz pilot whose
              normalised square is the 38 kHz reference) + 0.568*(M +/- S)
              + optional de-emphasis + 16 kHz LPF (ModemFMStereo.cpp:100-300)

Each kit is a StreamOp: (state, iq PC [..., L]) -> (state, audio
[..., C, Lout]), with the JAX kits' arithmetic: DSB's carrier angle is a
true atan2, FM's discriminator the polynomial one. State is leaf for leaf
the JAX kits' planar state.
"""

from __future__ import annotations

import numpy as np
import torch

from cubicsdr_tpu_torch.modems.base import (
    DEFAULT_AUDIO_RATE, MIN_BANDWIDTH, Modem, ModemArg, register_modem)
from cubicsdr_tpu_torch.ops import design
from cubicsdr_tpu_torch.ops.agc import AutoGain
from cubicsdr_tpu_torch.ops.fir import DelayLine, FirFilter, fir_block
from cubicsdr_tpu_torch.ops.freqdem import FreqDem
from cubicsdr_tpu_torch.ops.iir import FirstOrderIIR
from cubicsdr_tpu_torch.ops.nco import NCOMixer
from cubicsdr_tpu_torch.ops.planar import PLANAR, planes_of
from cubicsdr_tpu_torch.ops.resample import design_ratio, make_resampler
from cubicsdr_tpu_torch.stream.op import StreamOp

F32 = torch.float32


def _audio_ratio(sample_rate: int, audio_rate: int):
    return design_ratio(audio_rate / sample_rate, max_denominator=500)


class AnalogKit(StreamOp):
    """Shared analog plumbing: demod -> (autoGain) -> audio resample
    (ref: ModemAnalog.cpp:21-33, 67-93). State is (demod, agc, resampler,
    post), leaf for leaf the JAX kit's: an empty tuple for AGC where a
    kit has none, and for the post stage, which no kit has."""

    def __init__(self, demod: StreamOp, sample_rate: int, audio_rate: int,
                 auto_gain: bool, batch_shape: tuple = ()):
        super().__init__()
        self.demod = demod
        P, Q = _audio_ratio(sample_rate, audio_rate)
        self.P, self.Q = P, Q
        self.resampler = make_resampler(P, Q, batch_shape=batch_shape,
                                        dtype=F32)
        self.agc = AutoGain(batch_shape=batch_shape) if auto_gain else None
        self.audio_rate = audio_rate

    def init_state(self):
        return (self.demod.init_state(),
                self.agc.init_state() if self.agc else (),
                self.resampler.init_state(), ())

    def apply(self, state, x):
        sd, sa, sr, sp = state
        sd, a = self.demod.apply(sd, x)
        if self.agc:
            sa, a = self.agc.apply(sa, a)
        sr, a = self.resampler.apply(sr, a)
        return (sd, sa, sr, sp), a[..., None, :]   # mono channel axis


class _AnalogModem(Modem):
    auto_gain = False

    def block_multiple(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE):
        _, Q = _audio_ratio(sample_rate, audio_rate)
        return Q

    def _demod_op(self, sample_rate, batch_shape, dtype):
        raise NotImplementedError

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=PLANAR):
        return AnalogKit(self._demod_op(sample_rate, batch_shape, dtype),
                         sample_rate, audio_rate, self.auto_gain,
                         batch_shape)


@register_modem
class ModemFM(_AnalogModem):
    name = "FM"
    default_sample_rate = 200000

    def _demod_op(self, sample_rate, batch_shape, dtype):
        return FreqDem(kf=0.5, batch_shape=batch_shape, dtype=dtype)


@register_modem
class ModemNBFM(_AnalogModem):
    name = "NBFM"
    default_sample_rate = 12500

    def _demod_op(self, sample_rate, batch_shape, dtype):
        return FreqDem(kf=0.5, batch_shape=batch_shape, dtype=dtype)


class _EnvelopeDC(StreamOp):
    """|IQ| envelope -> FIR DC blocker (delta minus a narrow lowpass), the
    AM detector (ref: ModemAM.cpp:7-10,40-48: 25-wide dc blocker, 30 dB)."""

    def __init__(self, batch_shape=()):
        super().__init__()
        n = 51
        lp = design.kaiser_lowpass(n, 0.004, 30.0)
        lp = lp / lp.sum()
        h = -lp
        h[(n - 1) // 2] += 1.0
        self.fir = FirFilter(h, batch_shape, dtype=F32)

    def init_state(self):
        return self.fir.init_state()

    def apply(self, state, x):
        re, im = planes_of(x)
        return self.fir.apply(state, torch.sqrt(re * re + im * im))


@register_modem
class ModemAM(_AnalogModem):
    name = "AM"
    default_sample_rate = 6000
    auto_gain = True

    def uses_signal_output(self):
        return True

    def _demod_op(self, sample_rate, batch_shape, dtype):
        return _EnvelopeDC(batch_shape)


class _DSBDemod(StreamOp):
    """Suppressed-carrier coherent detect with block squaring carrier
    recovery: phi2 = EMA of arg(mean(x^2)); y = Re{x * exp(-j*phi2/2)}."""

    def __init__(self, batch_shape=(), rate=0.2):
        super().__init__()
        self.batch_shape = tuple(batch_shape)
        self.rate = rate

    def init_state(self):
        return torch.zeros((*self.batch_shape, 2), device=self.device)

    def apply(self, c2, x):
        re, im = planes_of(x)
        vec = torch.stack([(re * re - im * im).mean(dim=-1),
                           (2.0 * re * im).mean(dim=-1)], dim=-1)
        c2 = c2 + (vec - c2) * self.rate
        phi2 = torch.atan2(c2[..., 1], c2[..., 0])
        cr = torch.cos(-0.5 * phi2)[..., None]
        ci = torch.sin(-0.5 * phi2)[..., None]
        return c2, re * cr - im * ci


@register_modem
class ModemDSB(_AnalogModem):
    name = "DSB"
    default_sample_rate = 5400
    auto_gain = True

    def uses_signal_output(self):
        return True

    def _demod_op(self, sample_rate, batch_shape, dtype):
        return _DSBDemod(batch_shape)


class _SSBDemod(StreamOp):
    """One-sided complex-tap FIR -> Re{.}: Re{conv(x, h)} = conv(re, h.re)
    - conv(im, h.im), two real convolutions."""

    def __init__(self, sample_rate, upper: bool, batch_shape=()):
        super().__init__()
        taps_len = min(257, design.kaiser_filter_len(
            max(200.0 / sample_rate, 0.002), 60.0) | 1)
        h = np.asarray(design.ssb_bandpass(taps_len, sample_rate,
                                           sample_rate, upper=upper))
        self.register_buffer("h_re", torch.from_numpy(
            h.real.astype(np.float32)))
        self.register_buffer("h_im", torch.from_numpy(
            h.imag.astype(np.float32)))
        self.k = len(h)
        self.batch_shape = tuple(batch_shape)

    def init_state(self):
        shape = (*self.batch_shape, self.k - 1)
        return (torch.zeros(shape, device=self.device),
                torch.zeros(shape, device=self.device))

    def apply(self, state, x):
        hr, hi = state
        re, im = planes_of(x)
        hr, yr = fir_block(hr, re, self.h_re)
        hi, yi = fir_block(hi, im, self.h_im)
        return (hr, hi), yr - yi


def _even_rate(sample_rate, audio_rate):
    r = max(int(sample_rate), MIN_BANDWIDTH)
    return r if r % 2 == 0 else r + 1


class _SSBModem(_AnalogModem):
    default_sample_rate = 5400
    auto_gain = True
    upper = True

    @classmethod
    def check_sample_rate(cls, sample_rate, audio_rate):
        return _even_rate(sample_rate, audio_rate)

    def uses_signal_output(self):
        return True

    def _demod_op(self, sample_rate, batch_shape, dtype):
        return _SSBDemod(sample_rate, upper=self.upper,
                         batch_shape=batch_shape)


@register_modem
class ModemUSB(_SSBModem):
    name = "USB"


@register_modem
class ModemLSB(_SSBModem):
    name = "LSB"
    upper = False


class _CWKit(StreamOp):
    """CW: interpolate the narrow IQ segment up to the audio rate, offset by
    the beep frequency, take the real part and apply gain/autoGain, the
    reference's order (ref: ModemCW.cpp:110-190: a 500 Hz-wide stream
    cannot carry a 650 Hz beep before it is resampled)."""

    def __init__(self, sample_rate, audio_rate, beep_hz=650.0, gain=15.0,
                 auto=True, batch_shape=(), dtype=PLANAR):
        super().__init__()
        P, Q = _audio_ratio(sample_rate, audio_rate)
        self.up = make_resampler(P, Q, batch_shape=batch_shape, dtype=dtype)
        self.omega = 2 * np.pi * beep_hz / audio_rate
        self.gain = gain
        self.nco = NCOMixer(batch_shape)
        self.agc = AutoGain(batch_shape=batch_shape) if auto else None

    def init_state(self):
        return (self.up.init_state(), self.nco.init_state(),
                self.agc.init_state() if self.agc else ())

    def apply(self, state, x):
        s_up, s_n, s_a = state
        s_up, y = self.up.apply(s_up, x)
        s_n, y = self.nco.apply(s_n, (y, self.omega))
        a = y.re * self.gain
        if self.agc:
            s_a, a = self.agc.apply(s_a, a)
        return (s_up, s_n, s_a), a[..., None, :]


@register_modem
class ModemCW(_AnalogModem):
    name = "CW"
    default_sample_rate = MIN_BANDWIDTH
    auto_gain = True

    def get_settings(self):
        return [
            ModemArg("offset", "Frequency Offset", 650.0, "float", "Hz",
                     "Frequency Offset / Beep frequency (200-1000Hz)",
                     200.0, 1000.0),
            ModemArg("auto", "Auto Gain", "on", "string",
                     options=["on", "off"]),
            ModemArg("gain", "Gain", 15.0, "float", low=1.0, high=100.0),
        ]

    def uses_signal_output(self):
        return True

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=PLANAR):
        return _CWKit(sample_rate, audio_rate,
                      float(self.settings["offset"]),
                      float(self.settings["gain"]),
                      str(self.settings["auto"]) == "on", batch_shape, dtype)


class _IQKit(StreamOp):
    """Stereo passthrough: (left, right) = (imag, real)
    (ref: ModemIQ.cpp:39-57)."""

    def apply(self, state, x):
        re, im = planes_of(x)
        return state, torch.stack([im, re], dim=-2)


@register_modem
class ModemIQ(Modem):
    name = "I/Q"
    default_sample_rate = 48000

    @classmethod
    def check_sample_rate(cls, sample_rate, audio_rate):
        # Bandwidth pinned to the audio rate (ref: ModemIQ.cpp:31-33).
        return int(audio_rate)

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=PLANAR):
        return _IQKit()


class _FMStereoKit(StreamOp):
    """FM stereo decoder by pilot squaring (module docstring).

    freqdem -> { mono M ; analytic pilot p by a one-sided 19 kHz FIR
    bandpass ; S = Im[LPF(m * conj(p^2/|p|^2))] } -> resample M, S ->
    L, R = 0.568*(M +/- S) -> optional de-emphasis -> 16 kHz kaiser LPF
    pair (ref: ModemFMStereo.cpp:100-121 for the LPF, 271-299 for the
    matrix). Everything after the discriminator is real: the analytic
    pilot is two real FIRs, and since the S LPF has real taps only the
    imaginary plane of the down-mixed subcarrier is filtered."""

    def __init__(self, sample_rate, audio_rate, demph_us, batch_shape=(),
                 dtype=PLANAR):
        super().__init__()
        bs = tuple(batch_shape)
        self.freqdem = FreqDem(0.5, bs, dtype=dtype)
        # Analytic pilot bandpass centred at +19 kHz, +-500 Hz (ref pilot:
        # cheby2 bandpass 19000..19500, ModemFMStereo.cpp:126-135).
        n = min(design.kaiser_filter_len(1000.0 / sample_rate, 60.0) | 1,
                1023)
        lp = design.kaiser_lowpass(n, 500.0 / sample_rate, 60.0)
        t = np.arange(n) - (n - 1) / 2
        hp = 2.0 * lp * np.exp(2j * np.pi * 19000.0 / sample_rate * t)
        self.register_buffer("hp_re", torch.from_numpy(
            hp.real.astype(np.float32)))
        self.register_buffer("hp_im", torch.from_numpy(
            hp.imag.astype(np.float32)))
        self.n_pilot = n
        self.bs = bs
        # Real LPF extracting the down-mixed S plane (15 kHz wide).
        ns = design.kaiser_filter_len(4000.0 / sample_rate, 60.0) | 1
        self.s_fir = FirFilter(
            design.kaiser_lowpass(ns, 16000.0 / sample_rate, 60.0), bs,
            dtype=F32)
        # Composite delayed by the pilot filter's group delay before the
        # mix with the squared pilot (else the 38 kHz reference rotates by
        # 2*w_p*delay and separation collapses); the mono path also gets
        # the S LPF's delay.
        self.pre_delay = DelayLine((n - 1) // 2, bs, F32)
        self.mono_delay = DelayLine((ns - 1) // 2, bs, F32)
        P, Q = _audio_ratio(sample_rate, audio_rate)
        self.Q = Q
        self.rs_mono = make_resampler(P, Q, batch_shape=bs, dtype=F32)
        self.rs_st = make_resampler(P, Q, batch_shape=bs, dtype=F32)
        # Audio-rate stereo post chain (batch gains a channel axis of 2).
        self.demph = None
        if demph_us:
            b, a = design.deemphasis_coeffs(demph_us, audio_rate)
            self.demph = FirstOrderIIR(b, a, batch_shape=(*bs, 2))
        fc = min(max(16000.0 / audio_rate, 0.0), 0.5)
        na = design.kaiser_filter_len(1000.0 / audio_rate, 60.0) | 1
        self.audio_fir = FirFilter(design.kaiser_lowpass(na, fc, 60.0),
                                   (*bs, 2), dtype=F32)

    def init_state(self):
        hist = (*self.bs, self.n_pilot - 1)
        return (self.freqdem.init_state(),
                (torch.zeros(hist, device=self.device),
                 torch.zeros(hist, device=self.device)),  # pilot re/im hists
                self.pre_delay.init_state(), self.s_fir.init_state(),
                self.mono_delay.init_state(),
                self.rs_mono.init_state(), self.rs_st.init_state(),
                self.demph.init_state() if self.demph else (),
                self.audio_fir.init_state())

    def apply(self, state, x):
        s_fd, (s_pr, s_pi), s_pd, s_s, s_md, s_rm, s_rs, s_de, s_af = state
        s_fd, m = self.freqdem.apply(s_fd, x)
        # Analytic pilot (two real FIRs) and the 38 kHz reference by
        # squaring.
        s_pr, pr = fir_block(s_pr, m, self.hp_re)
        s_pi, pi = fir_block(s_pi, m, self.hp_im)
        p2r = pr * pr - pi * pi
        p2i = 2.0 * pr * pi
        mag = torch.sqrt(p2r * p2r + p2i * p2i) + 1e-12
        ref_i = p2i / mag
        s_pd, m_al = self.pre_delay.apply(s_pd, m)
        # S = Im after the real-tap LPF = LPF(Im{m_al * conj(ref)})
        #   = LPF(-m_al * ref_i).
        s_s, z_im = self.s_fir.apply(s_s, -m_al * ref_i)
        s_md, m_d = self.mono_delay.apply(s_md, m_al)
        s_rm, mono = self.rs_mono.apply(s_rm, m_d)
        s_rs, ster = self.rs_st.apply(s_rs, 2.0 * z_im)
        # Pilot squaring recovers S with positive sign, so left is mono+S
        # (the reference's PLL lands on the opposite sign, hence its
        # mono-minus form at ModemFMStereo.cpp:283-293).
        lr = torch.stack([0.568 * (mono + ster), 0.568 * (mono - ster)],
                         dim=-2)
        if self.demph:
            s_de, lr = self.demph.apply(s_de, lr)
        s_af, lr = self.audio_fir.apply(s_af, lr)
        return (s_fd, (s_pr, s_pi), s_pd, s_s, s_md, s_rm, s_rs, s_de,
                s_af), lr


@register_modem
class ModemFMStereo(Modem):
    name = "FMS"
    # Carson bandwidth of a 75 kHz-deviation stereo multiplex (53 kHz top
    # edge) is ~256 kHz: 200 kHz truncates the FM sidebands and caps
    # separation near 27 dB; 250 kHz gives broadcast-grade separation.
    default_sample_rate = 250000

    def get_settings(self):
        return [ModemArg("demph", "De-emphasis", 75, "int", "us",
                         "De-emphasis time constant",
                         options=[0, 10, 25, 50, 75])]

    @classmethod
    def check_sample_rate(cls, sample_rate, audio_rate):
        # Needs the 38 kHz subcarrier: force >= 100 kHz
        # (ref: ModemFMStereo.cpp:27-34).
        return max(int(sample_rate), 100000)

    def block_multiple(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE):
        _, Q = _audio_ratio(sample_rate, audio_rate)
        return Q

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=PLANAR):
        return _FMStereoKit(sample_rate, audio_rate,
                            int(self.settings["demph"]), batch_shape, dtype)
