"""Host audio playback sink — the RtAudio role (the port's copy of
``cubicsdr_tpu/io/audio_out.py``).

The reference mixes into RtAudio device streams (ref: src/audio/
AudioThread.cpp:88-243). On a datacenter host there is usually no audio
device; this sink auto-detects an available backend (sounddevice, then
pyaudio), and otherwise degrades to a WAV spool or a null sink, so the same
application code runs everywhere.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def enumerate_output_devices() -> list[dict]:
    """AudioThread::enumerateDevices analog; empty on headless hosts."""
    try:
        import sounddevice as sd  # type: ignore
        return [dict(index=i, name=d["name"],
                     channels=d["max_output_channels"],
                     rate=int(d["default_samplerate"]))
                for i, d in enumerate(sd.query_devices())
                if d["max_output_channels"] > 0]
    except Exception:
        return []


class AudioOutput:
    """Plays float32 [channels, n] blocks; silently degrades when headless.

    backend: 'auto' | 'sounddevice' | 'wav:<path>' | 'null'
    """

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 backend: str = "auto", device: Optional[int] = None):
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.backend = "null"
        self._stream = None
        self._wav = None
        if backend.startswith("wav:"):
            from cubicsdr_tpu_torch.io.wav import WavWriter
            self._wav = WavWriter(backend[4:], sample_rate, channels)
            self.backend = "wav"
            return
        if backend in ("auto", "sounddevice"):
            try:
                import sounddevice as sd  # type: ignore
                self._stream = sd.OutputStream(
                    samplerate=sample_rate, channels=channels,
                    dtype="float32", device=device)
                self._stream.start()
                self.backend = "sounddevice"
                return
            except Exception:
                if backend == "sounddevice":
                    raise

    def write(self, frames: np.ndarray):
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 1:
            frames = frames[None, :]
        if self.backend == "sounddevice":
            self._stream.write(np.ascontiguousarray(frames.T))
        elif self.backend == "wav":
            self._wav.write(frames)
        # null: drop

    def close(self):
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
        if self._wav is not None:
            self._wav.close()


class HostResampler:
    """Streaming rational P/Q audio resampler (pure numpy polyphase).

    The reference lets every demod's output device negotiate its OWN
    sample rate, switching at runtime (ref: src/audio/AudioThread.cpp:
    493-506 sample-rate command + AppFrame per-demod audio-rate menu).
    Here a sink whose hardware wants e.g. 44.1 kHz against a 48 kHz
    pipeline resamples host-side — numpy only, because in a process
    attached to the card a torch call on device data would pay a
    round-trip per audio chunk.

    Polyphase form: output m taps subfilter p_m = (m*Q) % P at base
    input index i_m = (m*Q) // P:  y[m] = sum_j h[p_m + j*P] x[i_m - j].
    State = the input backlog needed by future outputs; streaming output
    equals the one-shot filter bit-exactly (tested).
    """

    def __init__(self, rate_in: int, rate_out: int,
                 taps_per_phase: int = 24, channels: int = 2):
        from math import gcd
        from scipy.signal import firwin
        g = gcd(int(rate_in), int(rate_out))
        self.P, self.Q = int(rate_out) // g, int(rate_in) // g
        self.rate_in, self.rate_out = int(rate_in), int(rate_out)
        mx = max(self.P, self.Q)
        H = taps_per_phase * mx
        H += (-H) % self.P                  # whole polyphase rows
        h = firwin(H, 0.9 / mx) * self.P    # gain P: zero-stuffing loss
        self.J = H // self.P
        # h_sub[p, j] = h[p + j*P]
        self.h_sub = np.asarray(
            [h[p::self.P] for p in range(self.P)], np.float32)
        self.channels = channels
        self._buf = np.zeros((channels, self.J), np.float32)  # i<0 zeros
        self._i0 = -self.J                  # global index of _buf[:, 0]
        self._m = 0                         # next output index

    def process(self, x: np.ndarray) -> np.ndarray:
        """x [C, n] (or [n]) -> resampled [C, m_new] (possibly empty)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] != self._buf.shape[0]:
            # Channel-count change (mono tap vs stereo mix): restart.
            self._buf = np.zeros((x.shape[0], self.J), np.float32)
            self._i0, self._m = -self.J, 0
        self._buf = np.concatenate([self._buf, x], axis=1)
        n_avail = self._i0 + self._buf.shape[1]      # inputs < n_avail
        # Outputs whose base index i_m <= n_avail-1.
        m_hi = ((n_avail - 1) * self.P + self.P - 1) // self.Q + 1
        m_hi = max(m_hi, self._m)
        ms = np.arange(self._m, m_hi)
        if ms.size == 0:
            return np.zeros((x.shape[0], 0), np.float32)
        vq = ms * self.Q
        i_m = vq // self.P                           # base input index
        keep = i_m <= n_avail - 1
        ms, vq, i_m = ms[keep], vq[keep], i_m[keep]
        if ms.size == 0:
            return np.zeros((x.shape[0], 0), np.float32)
        p_m = (vq % self.P).astype(np.int64)
        idx = (i_m[:, None] - np.arange(self.J)[None, :]) - self._i0
        taps = self.h_sub[p_m]                       # [m, J]
        y = np.einsum("cmj,mj->cm", self._buf[:, idx], taps)
        self._m = int(ms[-1]) + 1
        # Trim backlog: oldest input any FUTURE output needs.
        need0 = (self._m * self.Q) // self.P - (self.J - 1)
        cut = max(0, need0 - self._i0)
        if cut:
            self._buf = self._buf[:, cut:]
            self._i0 += cut
        return y.astype(np.float32)
