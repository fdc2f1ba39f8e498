"""Host-side filter design (numpy/scipy) — runs once at pipeline build time.

Re-homed from ``cubicsdr_tpu/ops/design.py`` (that package's ``ops``
namespace imports jax). Only the designs the ported receive step uses are
here; each must equal the JAX package's output exactly (tests).
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


def kaiser_lowpass(num_taps: int, fc: float, as_db: float = 60.0,
                   gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc lowpass, cutoff fc in cycles/sample (0..0.5), unity DC
    gain scaled by ``gain``. float32."""
    h = sps.firwin(num_taps, 2 * fc, window=("kaiser", kaiser_beta(as_db)),
                   scale=True)
    return (h * gain).astype(np.float32)


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
