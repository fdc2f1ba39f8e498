"""IQ sources (the port's copy of ``cubicsdr_tpu/io/sources.py``): the
channel count and block size policies the receive step is sized by, and
the numpy producers that stand in for SDR hardware.

The reference reads CF32 from SoapySDR hardware in display-frame batches
(numElems = rate/60 rounded to a channel multiple,
ref: src/sdr/SoapySDRThread.cpp:405-433,668-674) and computes the channel
count as ceil(rate/500k) forced even, min 2 (ref: :676-693). Here the same
batching/channel policy feeds the receive step from files or synthetic
generators.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

CHANNELIZER_RATE_MAX = 500_000       # ref: src/CubicSDRDefs.h:63
TARGET_BATCHES_PER_SEC = 60          # ref: src/sdr/SoapySDRThread.cpp:12


def optimal_channel_count(sample_rate: float) -> int:
    """ceil(rate/500k), forced even, min 2
    (ref: src/sdr/SoapySDRThread.cpp:676-693)."""
    n = int(np.ceil(sample_rate / CHANNELIZER_RATE_MAX))
    if n % 2:
        n += 1
    return max(n, 2)


def optimal_block_len(sample_rate: float, multiple: int = 1,
                      batches_per_sec: int = TARGET_BATCHES_PER_SEC) -> int:
    """~one display frame of samples, rounded up to ``multiple``
    (ref: src/sdr/SoapySDRThread.cpp:668-674)."""
    n = int(sample_rate / batches_per_sec)
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


class FileIQSource:
    """Streams fixed-size complex64 blocks from a recorded capture.

    Formats: '.cf32'/'.raw' (interleaved float32 IQ), '.cs16' (interleaved
    int16), '.cs8'/'.cu8' (int8/offset uint8, rtl-sdr style), '.npy'
    (complex64 array). Ragged tails carry into the next read (the reference's
    overflow-carry buffer, ref: src/sdr/SoapySDRThread.cpp:223-243); the
    final partial block is zero-padded with its valid length reported.
    """

    def __init__(self, path: str, sample_rate: float, block_len: int,
                 frequency: float = 0.0, loop: bool = False):
        self.path = str(path)
        self.sample_rate = float(sample_rate)
        self.block_len = int(block_len)
        self.frequency = float(frequency)
        self.loop = loop
        self._data = self._load(self.path)
        self._pos = 0

    @staticmethod
    def _load(path: str) -> np.ndarray:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".npy":
            return np.load(path).astype(np.complex64)
        raw = np.fromfile(path, dtype=np.uint8)
        if ext in (".cf32", ".raw", ".iq", ""):
            f = raw.view(np.float32)
            return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
        if ext == ".cs16":
            s = raw.view(np.int16).astype(np.float32) / 32768.0
            return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
        if ext == ".cs8":
            s = raw.view(np.int8).astype(np.float32) / 128.0
            return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
        if ext == ".cu8":
            s = (raw.astype(np.float32) - 127.5) / 127.5
            return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
        raise ValueError(f"unknown IQ format: {ext}")

    @property
    def n_samples(self) -> int:
        return len(self._data)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._pos >= len(self._data):
            if not self.loop:
                raise StopIteration
            self._pos = 0
        end = self._pos + self.block_len
        blk = self._data[self._pos:end]
        self._pos = end
        if len(blk) < self.block_len:
            blk = np.pad(blk, (0, self.block_len - len(blk)))
        return blk

    def read_all_blocks(self) -> np.ndarray:
        """[n_blocks, block_len] of the whole capture (tail dropped)."""
        n = len(self._data) // self.block_len
        return self._data[: n * self.block_len].reshape(n, self.block_len)


@dataclass
class Station:
    """One synthetic transmitter inside a wideband capture."""
    frequency: float                  # offset from capture center, Hz
    kind: str = "fm"                  # fm | am | tone | noise
    audio_freq: float = 1000.0
    deviation: float = 75000.0        # FM deviation
    mod_index: float = 0.8            # AM depth
    amplitude: float = 1.0


class SyntheticSource:
    """Deterministic wideband IQ synthesizer (multi-station) for tests and
    benchmarks; phase-continuous across blocks."""

    def __init__(self, sample_rate: float, block_len: int,
                 stations: list[Station], noise: float = 0.0, seed: int = 0):
        self.sample_rate = float(sample_rate)
        self.block_len = int(block_len)
        self.stations = stations
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        self._n0 = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        n = np.arange(self._n0, self._n0 + self.block_len)
        t = n / self.sample_rate
        out = np.zeros(self.block_len, np.complex64)
        for s in self.stations:
            if s.kind == "tone":
                base = np.ones_like(t)
                ph = 0.0
            elif s.kind == "fm":
                msg = np.sin(2 * np.pi * s.audio_freq * t)
                # closed-form integral of sin keeps phase continuity
                ph = (2 * np.pi * s.deviation
                      * (1 - np.cos(2 * np.pi * s.audio_freq * t))
                      / (2 * np.pi * s.audio_freq))
                base = np.ones_like(t)
            elif s.kind == "am":
                base = 1.0 + s.mod_index * np.sin(2 * np.pi * s.audio_freq * t)
                ph = 0.0
            elif s.kind == "noise":
                base = (self._rng.standard_normal(self.block_len)
                        + 1j * self._rng.standard_normal(self.block_len))
                ph = 0.0
            else:
                raise ValueError(s.kind)
            out += (s.amplitude * base
                    * np.exp(1j * (2 * np.pi * s.frequency * t + ph))
                    ).astype(np.complex64)
        if self.noise:
            out += (self.noise / np.sqrt(2)
                    * (self._rng.standard_normal(self.block_len)
                       + 1j * self._rng.standard_normal(self.block_len))
                    ).astype(np.complex64)
        self._n0 += self.block_len
        return out
