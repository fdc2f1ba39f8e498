"""Recording policy: squelch handling + time-limited rotation (the
port's copy of ``cubicsdr_tpu/io/recorder.py``).

Mirrors AudioSinkFileThread (ref: src/audio/AudioSinkFileThread.cpp:20-76):
  - SQUELCH_RECORD_SILENCE : squelched audio is written as zeros
  - SQUELCH_SKIP_SILENCE   : squelched audio is dropped
  - SQUELCH_RECORD_ALWAYS  : write regardless
  - fileTimeLimit seconds  : rotate to '<base>_YYYY-MM-DD_HH-MM-SS'
"""

from __future__ import annotations

import enum
import time
from datetime import datetime

import numpy as np

from cubicsdr_tpu_torch.io.wav import WavWriter


class SquelchOption(enum.IntEnum):
    RECORD_SILENCE = 0
    SKIP_SILENCE = 1
    RECORD_ALWAYS = 2


class RecordingSink:
    """Feeds demodulated audio blocks into a WavWriter under policy."""

    def __init__(self, base_path: str, sample_rate: int, channels: int = 1,
                 squelch_option: SquelchOption = SquelchOption.RECORD_SILENCE,
                 time_limit_s: float = 0.0, clock=time.monotonic,
                 timestamp_fn=None):
        self.base = base_path
        self.writer = WavWriter(base_path, sample_rate, channels)
        self.squelch_option = SquelchOption(squelch_option)
        self.time_limit_s = float(time_limit_s)
        self._clock = clock
        self._t0 = clock()
        self._timestamp_fn = timestamp_fn or (
            lambda: datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
        self._rotate_counts: dict[str, int] = {}

    def write(self, audio: np.ndarray, squelched: bool = False):
        audio = np.asarray(audio)
        if squelched:
            if self.squelch_option == SquelchOption.SKIP_SILENCE:
                return
            if self.squelch_option == SquelchOption.RECORD_SILENCE:
                audio = np.zeros_like(audio)
        if self.time_limit_s > 0 and (
                self._clock() - self._t0) > self.time_limit_s:
            name = f"{self.base}_{self._timestamp_fn()}"
            # Timestamps have 1 s resolution; a short time limit can
            # rotate twice within a second — disambiguate instead of
            # silently overwriting the previous rotation.
            n = self._rotate_counts.get(name, 0)
            self._rotate_counts[name] = n + 1
            self.writer.rotate_to(name if n == 0 else f"{name}_{n}")
            self._t0 = self._clock()
        self.writer.write(audio)

    def close(self):
        self.writer.close()
