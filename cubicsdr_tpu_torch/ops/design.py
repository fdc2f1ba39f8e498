"""Host-side filter design (numpy/scipy) — runs once at pipeline build time.

Re-homed from ``cubicsdr_tpu/ops/design.py`` (that package's ``ops``
namespace imports jax). Each design must equal the JAX package's output
exactly (tests/test_torch_constants.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as sps


def kaiser_beta(as_db: float) -> float:
    """Kaiser beta from stop-band attenuation (Kaiser's empirical formula)."""
    if as_db > 50.0:
        return 0.1102 * (as_db - 8.7)
    if as_db >= 21.0:
        return 0.5842 * (as_db - 21.0) ** 0.4 + 0.07886 * (as_db - 21.0)
    return 0.0


def kaiser_filter_len(df: float, as_db: float) -> int:
    """Estimated FIR length for transition width df (normalized,
    cycles/sample) and stop-band attenuation (liquid's
    estimate_req_filter_len role)."""
    n = int(np.ceil((as_db - 7.95) / (14.26 * df)))
    return max(n, 5)


def kaiser_lowpass(num_taps: int, fc: float, as_db: float = 60.0,
                   gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc lowpass, cutoff fc in cycles/sample (0..0.5), unity DC
    gain scaled by ``gain``. float32."""
    h = sps.firwin(num_taps, 2 * fc, window=("kaiser", kaiser_beta(as_db)),
                   scale=True)
    return (h * gain).astype(np.float32)


def lowpass_for_transition(fc: float, df: float, as_db: float = 60.0,
                           gain: float = 1.0) -> np.ndarray:
    return kaiser_lowpass(kaiser_filter_len(df, as_db) | 1, fc, as_db, gain)


@lru_cache(maxsize=None)
def pfb_prototype(num_channels: int, taps_per_channel: int = 8,
                  as_db: float = 60.0) -> np.ndarray:
    """Prototype lowpass for the polyphase analyzer: length
    M*taps_per_channel, cutoff at half the channel spacing, normalised so
    sum(h) == 1 (unity gain through the M-point IDFT stage)
    (ref: src/sdr/SDRPostThread.cpp:406,463)."""
    M = num_channels
    L = M * taps_per_channel
    h = sps.firwin(L, 1.0 / M, window=("kaiser", kaiser_beta(as_db)),
                   scale=True).astype(np.float64)
    h = h / h.sum()
    return h.astype(np.float32)


@lru_cache(maxsize=None)
def halfband_sos(order: int = 6, fc: float = 0.25) -> np.ndarray:
    """Butterworth IIR lowpass as second-order sections, float32 (the JAX
    package's stand-in for the reference's IIR halfband in the SSB chain,
    ref: src/modules/modem/analog/ModemUSB.cpp:10)."""
    return sps.butter(order, 2 * fc, output="sos").astype(np.float32)


@lru_cache(maxsize=None)
def deemphasis_coeffs(tau_us: float, sample_rate: float) -> tuple:
    """Single-pole FM de-emphasis by the bilinear transform (ref: src/
    modules/modem/analog/ModemFMStereo.cpp:146-160). Returns (b, a),
    length-2 float32 arrays."""
    tau = tau_us * 1e-6
    w = 1.0 / tau
    wa = 2.0 * sample_rate * np.tan(w / (2.0 * sample_rate))
    k = wa / (2.0 * sample_rate)
    b = np.array([k / (1 + k), k / (1 + k)], np.float32)
    a = np.array([1.0, -(1 - k) / (1 + k)], np.float32)
    return b, a


def ssb_bandpass(num_taps: int, bandwidth: float, sample_rate: float,
                 upper: bool, as_db: float = 60.0) -> np.ndarray:
    """Complex one-sided bandpass passing [0, +bw/2] (USB) or [-bw/2, 0]
    (LSB) in one FIR, in place of the reference's quarter-rate shift + IIR
    halfband + firhilbf chain (ref: src/modules/modem/analog/
    ModemUSB.cpp:7-60); the audio is 2*Re{x * h}."""
    half = bandwidth / 2.0
    fc = half / 2.0 / sample_rate          # lowpass cutoff (cycles/sample)
    shift = (half / 2.0) / sample_rate     # center of the sideband
    if not upper:
        shift = -shift
    lp = sps.firwin(num_taps, 2 * fc, window=("kaiser", kaiser_beta(as_db)),
                    scale=True)
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = lp * np.exp(2j * np.pi * shift * n)
    return (2.0 * h).astype(np.complex64)


def hilbert_fir(num_taps: int = 63, as_db: float = 60.0) -> np.ndarray:
    """Type-III FIR Hilbert transformer (odd length, Kaiser window)."""
    if num_taps % 2 != 1:
        raise ValueError(f"a type-III Hilbert FIR needs an odd length, got "
                         f"{num_taps}")
    n = np.arange(num_taps) - (num_taps - 1) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(np.abs(n) < 1e-9, 0.0,
                     (1 - np.cos(np.pi * n)) / (np.pi * n))
    h *= np.kaiser(num_taps, kaiser_beta(as_db))
    return h.astype(np.float32)
