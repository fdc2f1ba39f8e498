"""Spectrum display processor (``cubicsdr_tpu/visual/spectrum.py``; ref:
src/process/SpectrumVisualProcessor.cpp:212-640).

Per frame (fftSizeInternal = fft_size * SPECTRUM_VZM(=2),
ref: CubicSDRDefs.h:44-46):
    FFT -> |.| with fftshift -> double EMA (ma/maa at fft_average_rate)
    -> frame ceil/floor -> EMA'd ceil/floor (0.05 twice)
    -> optional peak hold
    -> accumulate fftSizeInternal bins down to fft_size output points
    -> log-normalize into [0,1] against (floor-0.75, ceil+0.25) * scale
    -> optional DC-spike hide (neighbor mirror over +-2 kHz)

The FFT of all frames of a block is one batched ``torch.fft`` call; the
EMA is sequential per frame (each frame sees the previous frame's
averages), a loop over frames that skips masked frames with
``torch.where`` — the reference's ``lax.scan``.

A frozen copy of the port's module, without the zoom views (the
benchmark's deployments open none).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops.fftops import fftshift_mag
from benchmark.reference.ops.planar import PC, PLANAR
from benchmark.reference.stream.op import StreamOp

SPECTRUM_VZM = 2                 # ref: src/CubicSDRDefs.h:46
DEFAULT_FFT_SIZE = 2048          # ref: src/CubicSDRDefs.h:44


def frame_update(core: "SpectrumProcessor", st, mag):
    """One frame's EMA/floor-ceil/peak update given the (shifted)
    magnitude. The first frame seeds the averages (the reference's NaN
    self-heal, ref: SpectrumVisualProcessor.cpp:494-499)."""
    primed = st["primed"][..., None]
    ma = torch.where(primed, st["ma"], mag)
    maa = torch.where(primed, st["maa"], mag)
    maa = maa + (ma - maa) * core.rate
    ma = ma + (mag - ma) * core.rate
    fr_ceil = maa.amax(dim=-1)
    fr_floor = maa.amin(dim=-1)
    peak = torch.maximum(st["peak"], maa) if core.peak_hold else st["peak"]

    def ema2(prev_ma, prev_maa, v, primed1):
        pma = torch.where(primed1, prev_ma, v)
        pmaa = torch.where(primed1, prev_maa, v)
        pma = pma + (v - pma) * 0.05
        pmaa = pmaa + (pma - pmaa) * 0.05
        return pma, pmaa

    p1 = st["primed"]
    ceil_ma, ceil_maa = ema2(st["ceil_ma"], st["ceil_maa"], fr_ceil, p1)
    floor_ma, floor_maa = ema2(st["floor_ma"], st["floor_maa"], fr_floor, p1)
    ceil_peak = torch.maximum(st["ceil_peak"], ceil_maa) \
        if core.peak_hold else st["ceil_peak"]
    floor_peak = torch.minimum(st["floor_peak"], floor_maa) \
        if core.peak_hold else st["floor_peak"]
    return {"ma": ma, "maa": maa, "peak": peak,
            "ceil_ma": ceil_ma, "ceil_maa": ceil_maa,
            "floor_ma": floor_ma, "floor_maa": floor_maa,
            "ceil_peak": ceil_peak, "floor_peak": floor_peak,
            "primed": torch.ones_like(st["primed"])}


class SpectrumProcessor(StreamOp):
    def __init__(self, fft_size: int = DEFAULT_FFT_SIZE,
                 fft_average_rate: float = 0.65, scale_factor: float = 1.0,
                 peak_hold: bool = False, hide_dc: bool = False,
                 batch_shape: tuple = ()):
        super().__init__()
        self.fft_size = int(fft_size)
        self.n = self.fft_size * SPECTRUM_VZM
        self.rate = float(fft_average_rate)
        self.sf = float(scale_factor)
        self.peak_hold = peak_hold
        self.hide_dc = hide_dc
        self.bs = tuple(batch_shape)

    def init_state(self):
        kw = dict(dtype=torch.float32, device=self.device)

        def z():
            return torch.zeros((*self.bs, self.n), **kw)

        def s():
            return torch.zeros(self.bs, **kw)

        return {
            "ma": z(), "maa": z(), "peak": z(),
            "ceil_ma": s(), "ceil_maa": s(), "floor_ma": s(),
            "floor_maa": s(), "ceil_peak": s(), "floor_peak": s(),
            "primed": torch.zeros(self.bs, dtype=torch.bool,
                                  device=self.device),
        }

    def ema(self, state, mags, valid=None):
        """Run the per-frame EMA over mags [..., n_frames, n] (already
        |FFT| and fftshifted), skipping frames where ``valid`` [n_frames]
        is False without a shape change."""
        for f in range(mags.shape[-2]):
            st2 = frame_update(self, state, mags[..., f, :])
            if valid is not None:
                v = valid[f]
                st2 = {k: torch.where(v, a, state[k])
                       for k, a in st2.items()}
            state = st2
        return state

    def _points(self, st, dc_offset_bins=None):
        """Map smoothed bins -> fft_size normalized display points."""
        maa, peak = st["maa"], st["peak"]
        if self.peak_hold:
            p_ceil, p_floor = st["ceil_peak"], st["floor_peak"]
        else:
            p_ceil, p_floor = st["ceil_maa"], st["floor_maa"]
        # VZM accumulation: average each pair of internal bins
        # (visualRatio==1 path of ref :534-576).
        acc = maa.reshape(*maa.shape[:-1], self.fft_size,
                          SPECTRUM_VZM).mean(dim=-1)
        denom = torch.log10((p_ceil + 0.25) - (p_floor - 0.75))[..., None]
        pts = (torch.log10(acc + 0.25 - (p_floor[..., None] - 0.75))
               / denom) * self.sf
        out = {"spectrum_points": pts.to(torch.float32),
               "fft_ceiling": p_ceil / self.sf, "fft_floor": p_floor}
        if self.peak_hold:
            accp = peak.reshape(*peak.shape[:-1], self.fft_size,
                                SPECTRUM_VZM).mean(dim=-1)
            hold = (torch.log10(accp + 0.25 - (p_floor[..., None] - 0.75))
                    / denom) * self.sf
            out["spectrum_hold_points"] = hold.to(torch.float32)
        if self.hide_dc and dc_offset_bins is not None:
            out["spectrum_points"] = _hide_dc(
                out["spectrum_points"], dc_offset_bins, self.fft_size)
        return out

    def apply(self, state, frames, dc_offset_bins=None, valid=None):
        """frames: complex [..., n_frames, fftSizeInternal]. Returns
        (state, display dict) for the final frame's smoothed view.
        ``valid`` ([n_frames] bool, optional) skips masked frames — the
        distributor's fixed-capacity frames feed straight in (ref pacing:
        src/process/FFTDataDistributor.cpp:85-128)."""
        mags = fftshift_mag(torch.fft.fft(frames, dim=-1)).to(torch.float32)
        state = self.ema(state, mags, valid)
        return state, self._points(state, dc_offset_bins)


def mags_to_display(core: SpectrumProcessor, st, mags):
    """Feed raw (already fftshifted) |FFT| frames into the display EMA and
    return (state, display points as numpy) — the host-side consumer of a
    sharded receiver's gathered ``spectrum_mags`` (SURVEY §2.11)."""
    dev = st["ma"].device
    for mag in np.atleast_2d(np.asarray(mags, np.float32)):
        st = frame_update(core, st, torch.as_tensor(mag, device=dev))
    return st, core._points(st)["spectrum_points"].cpu().numpy()


def _hide_dc(points, offset_bins, fft_size, width_bins=None):
    """Mirror neighbors over the DC spike (ref :578-624): bins within
    ``width_bins`` of ``offset_bins`` (position of the device center in the
    display) are replaced by their outward neighbors."""
    if width_bins is None:
        width_bins = max(fft_size // 256, 2)
    idx = torch.arange(fft_size, device=points.device)
    center = torch.as_tensor(offset_bins, device=points.device)
    d = idx - center
    # Reflect across the region edges (c-w on the left, c+w on the right).
    left = 2 * (center - width_bins) - idx - 1
    right = 2 * (center + width_bins) - idx + 1
    src = torch.where(d < 0, left, right).clamp(0, fft_size - 1).long()
    mirrored = points.index_select(-1, src)
    mask = d.abs() <= width_bins
    return torch.where(mask, mirrored, points)
