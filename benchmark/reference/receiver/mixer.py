"""Audio mixing with per-source gain and peak normalisation
(``cubicsdr_tpu/receiver/mixer.py``; ref: src/audio/AudioThread.cpp:
88-243): sum active streams with per-source gain; if the summed peak
exceeds 1.0, scale the mix by 1/peak."""

from __future__ import annotations

import torch


def mix_audio(audio, gains, active=None, peaks=None):
    """audio: [..., N, C, L]; gains: [N]; active: bool [N] (mute/solo
    already resolved); peaks: [..., N] per-stream peaks (default
    max|audio|). Returns (mix [..., C, L], mix_peak [...])."""
    g = torch.as_tensor(gains, dtype=torch.float32, device=audio.device)
    if active is not None:
        g = g * torch.as_tensor(active, device=audio.device).to(torch.float32)
    if peaks is None:
        peaks = audio.abs().amax(dim=(-2, -1))
    mix = (audio * g[..., :, None, None]).sum(dim=-3)
    peak = (peaks * g).sum(dim=-1)
    scale = torch.where(peak > 1.0, 1.0 / peak.clamp_min(1e-9),
                        torch.ones_like(peak))
    return mix * scale[..., None, None], peak.clamp_max(1.0)
