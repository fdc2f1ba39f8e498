"""Scope processor: audio waveform traces + audio spectrum
(``cubicsdr_tpu/visual/scope.py``; ref: src/process/
ScopeVisualProcessor.cpp:45-216): waveform modes Y (mono), 2Y (stereo
split), XY (I/Q lissajous); audio FFT with the main spectrum's double-EMA
and floor/ceil mapping.
"""

from __future__ import annotations

import torch

from cubicsdr_tpu_torch.stream.op import StreamOp
from cubicsdr_tpu_torch.visual.spectrum import SpectrumProcessor


def scope_trace(audio: torch.Tensor, mode: str = "Y") -> torch.Tensor:
    """audio: [C, L] float. Returns plot-ready traces:
      Y  -> [1, L] mono (channel mean)
      2Y -> [2, L] stereo pair
      XY -> [2, L] (x=left, y=right) lissajous pairs
    """
    if mode == "Y":
        return audio.mean(dim=-2, keepdim=True)
    if mode in ("2Y", "XY"):
        return audio if audio.shape[-2] == 2 else torch.cat(
            [audio, audio], dim=-2)
    raise ValueError(mode)


class ScopeProcessor(StreamOp):
    """Audio spectrum via the shared spectrum core (the reference reuses the
    same EMA math for the audio FFT, ref: ScopeVisualProcessor.cpp:121-215).
    """

    def __init__(self, fft_size: int = 1024, fft_average_rate: float = 0.65):
        super().__init__()
        self.core = SpectrumProcessor(fft_size, fft_average_rate)
        self.n = self.core.n

    def init_state(self):
        return self.core.init_state()

    def apply(self, state, audio: torch.Tensor):
        """audio: [C, L] -> spectrum of the mono mix; frames from
        non-overlapping windows of the block."""
        mono = audio.mean(dim=-2)
        n_frames = mono.shape[-1] // self.n
        if n_frames == 0:
            frames = torch.nn.functional.pad(
                mono, (0, self.n - mono.shape[-1]))[None, :]
        else:
            frames = mono[: n_frames * self.n].reshape(n_frames, self.n)
        return self.core.apply(state, frames.to(torch.complex64))
