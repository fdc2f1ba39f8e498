"""Streaming WAV writer (the port's copy of ``cubicsdr_tpu/io/wav.py``).

Mirrors the reference's recorder: 16-bit PCM, streaming header fixup on
close, 2 GB per-file cap with sequence-numbered rollover
(ref: src/audio/AudioFileWAV.cpp:8,66-123).
"""

from __future__ import annotations

import wave

import numpy as np

MAX_WAV_BYTES = (1 << 31) - (1 << 20)   # ~2 GB cap (ref: AudioFileWAV.cpp:8)


def _to_int16(data: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    return (x * 32767.0).astype(np.int16)


class WavWriter:
    """Incremental WAV writer with size-capped rollover.

    ``write(frames)`` takes float32 [channels, n] or [n]; files are named
    ``<base>.wav``, ``<base>-1.wav``, ... when the 2 GB cap is hit
    (ref sequence naming: src/audio/AudioFileWAV.cpp:getSequencedFileName).
    """

    def __init__(self, base_path: str, sample_rate: int, channels: int = 1,
                 max_bytes: int = MAX_WAV_BYTES):
        self.base_path = str(base_path)
        if self.base_path.endswith(".wav"):
            self.base_path = self.base_path[:-4]
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.max_bytes = max_bytes
        self.seq = 0
        self._wf = None
        self._bytes = 0

    @property
    def current_path(self) -> str:
        suffix = f"-{self.seq}" if self.seq else ""
        return f"{self.base_path}{suffix}.wav"

    def _open(self):
        self._wf = wave.open(self.current_path, "wb")
        self._wf.setnchannels(self.channels)
        self._wf.setsampwidth(2)
        self._wf.setframerate(self.sample_rate)
        self._bytes = 0

    def write(self, frames: np.ndarray):
        frames = np.asarray(frames)
        if frames.ndim == 1:
            frames = frames[None, :]
        assert frames.shape[0] == self.channels
        pcm = _to_int16(frames).T.reshape(-1)   # interleave
        if self._wf is None:
            self._open()
        nbytes = pcm.nbytes
        if self._bytes + nbytes > self.max_bytes:
            self.close_current()
            self.seq += 1
            self._open()
        self._wf.writeframes(pcm.tobytes())
        self._bytes += nbytes

    def close_current(self):
        if self._wf is not None:
            self._wf.close()          # wave fixes up the header lengths
            self._wf = None

    def close(self):
        self.close_current()

    def rotate_to(self, new_base: str):
        """Close the current file and start a new one under a new base name
        (time-limited rotation, ref: AudioSinkFileThread.cpp:47-73)."""
        self.close_current()
        self.base_path = new_base
        self.seq = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_wav(path: str, data: np.ndarray, sample_rate: int):
    """One-shot helper: data [n] or [channels, n] float32 in [-1, 1]."""
    data = np.asarray(data)
    ch = 1 if data.ndim == 1 else data.shape[0]
    w = WavWriter(path, sample_rate, ch)
    w.write(data)
    w.close()


def read_wav(path: str):
    """Returns (data [channels, n] float32, sample_rate)."""
    with wave.open(path, "rb") as wf:
        n = wf.getnframes()
        raw = wf.readframes(n)
        ch = wf.getnchannels()
        width = wf.getsampwidth()
        rate = wf.getframerate()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483647.0
    else:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 127.0
    return x.reshape(-1, ch).T.copy(), rate
