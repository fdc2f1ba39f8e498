"""A configuration's capture, made on its device from the seed.

The station kinds are those of the port's ``utils/synth.py`` (a frozen
copy of ``_baseband``, rewritten so that every random number comes from
one ``torch.Generator`` on the device): FM and NBFM tones, AM, CW
carriers, symbol streams and FM-stereo multiplexes, plus complex
Gaussian noise. A capture is one loop of ``loop_seconds`` at the
configuration's sample rate; with whole-Hz offsets and tones it repeats
seamlessly. ``wire`` quantises it to the configuration's wire format on
the device and returns host planes, which the traffic generator cycles.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2 * math.pi


def _baseband(st: dict, t: torch.Tensor, fs: float, gen):
    """(phase, amplitude) float64 tensors of one station's complex
    baseband A e^{j phase} on ``t``'s device."""
    kind, amp = st["kind"], float(st.get("amplitude", 0.5))
    tone_hz = float(st.get("tone", 1000.0))
    zero = torch.zeros_like(t)
    tone = torch.sin(TWO_PI * tone_hz * t)
    if kind in ("fm", "nbfm"):
        dev = float(st.get("deviation") or (75e3 if kind == "fm" else 2.5e3))
        # Closed-form integral of the tone: phase-continuous everywhere.
        return dev * (1 - torch.cos(TWO_PI * tone_hz * t)) / tone_hz, \
            amp + zero
    if kind == "am":
        return zero, amp * (1 + 0.8 * tone)
    if kind == "cw":
        return zero, amp + zero
    if kind == "fms":
        left = tone
        right = 0.5 * torch.sin(TWO_PI * 2.5 * tone_hz * t)
        msg = (0.45 * (left + right) + 0.1 * torch.sin(TWO_PI * 19e3 * t)
               + 0.45 * (left - right) * torch.sin(TWO_PI * 38e3 * t))
        return TWO_PI * 75e3 * torch.cumsum(msg, 0) / fs, amp + zero
    if kind == "symbols":
        rate = float(st.get("rate", 2500.0))
        idx = torch.floor(t * rate).long()
        n_sym = int(idx[-1]) + 1
        pts = torch.tensor(st["points"], dtype=torch.float64,
                           device=t.device)                  # [K, 2]
        pick = torch.randint(0, pts.shape[0], (n_sym,), generator=gen,
                             device=t.device)
        re, im = pts[pick, 0][idx], pts[pick, 1][idx]
        return torch.atan2(im, re), amp * torch.sqrt(re * re + im * im)
    raise ValueError(f"unknown station kind {kind!r}")


def capture(cfg: dict, seed: int, device, n: int | None = None
            ) -> torch.Tensor:
    """Planes [2, n] float32 of the configuration's stations plus complex
    Gaussian noise, computed in float64 on ``device`` from ``seed``; ``n``
    defaults to ``loop_seconds`` of samples."""
    cap = cfg["capture"]
    fs = float(cfg["sample_rate"])
    if n is None:
        n = int(round(float(cap["loop_seconds"]) * fs))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    noise = float(cap["noise"])
    z = noise * torch.randn((2, n), generator=gen, dtype=torch.float64,
                            device=device)
    for st in cap["stations"]:
        ph, amp = _baseband(st, t, fs, gen)
        ph = ph + TWO_PI * float(st["frequency"]) * t
        z[0] += amp * torch.cos(ph)
        z[1] += amp * torch.sin(ph)
    return z.float()


WIRE = {"cs16": np.int16, "cs8": np.int8}


def wire(planes: torch.Tensor, fmt: str, peak: float) -> np.ndarray:
    """Float planes scaled so their largest magnitude is ``peak`` of full
    scale, rounded to the wire format on their device; host planes
    ``(2, n)`` of int16 (cs16) or int8 (cs8)."""
    dt = WIRE[fmt]
    full = float(np.iinfo(dt).max)
    k = peak * full / max(float(planes.abs().max()), 1e-12)
    q = torch.clamp(torch.round(planes * k), -full, full)
    return q.to(getattr(torch, np.dtype(dt).name)).cpu().numpy()


def stream_block(loop: np.ndarray, L: int, k: int,
                 out: np.ndarray | None = None) -> np.ndarray:
    """Block ``k`` of the cycled loop: samples ``[k L, (k + 1) L)`` of it,
    wrapped."""
    n = loop.shape[1]
    if out is None:
        out = np.empty((2, L), loop.dtype)
    pos, done = (k * L) % n, 0
    while done < L:
        take = min(L - done, n - pos)
        out[:, done:done + take] = loop[:, pos:pos + take]
        done += take
        pos = 0
    return out
