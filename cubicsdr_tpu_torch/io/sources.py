"""IQ source policy re-homed from ``cubicsdr_tpu/io/sources.py``: the
channel count rule the receive step sizes its channelizer with."""

from __future__ import annotations

import numpy as np

CHANNELIZER_RATE_MAX = 500_000       # ref: src/CubicSDRDefs.h:63


def optimal_channel_count(sample_rate: float) -> int:
    """ceil(rate/500k), forced even, min 2
    (ref: src/sdr/SoapySDRThread.cpp:676-693)."""
    n = int(np.ceil(sample_rate / CHANNELIZER_RATE_MAX))
    if n % 2:
        n += 1
    return max(n, 2)
