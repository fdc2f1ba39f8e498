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

View mode (zoomed spectrum): NCO shift to the view center + rational
resample to the view bandwidth before framing — ``SpectrumView`` and the
managed ``ZoomSpectrumView``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.fftops import fftshift_mag
from cubicsdr_tpu_torch.ops.nco import NCOMixer
from cubicsdr_tpu_torch.ops.planar import PC, PLANAR
from cubicsdr_tpu_torch.ops.resample import (
    RationalResampler, design_ratio, make_resampler)
from cubicsdr_tpu_torch.stream.op import StreamOp

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


def shift_display_state(st, k: int):
    """Retune continuity: displace the smoothed averages (ma/maa, display
    order) by ``k`` bins so the waterfall stays seamless across a view
    retune instead of re-converging (ref: SpectrumVisualProcessor.cpp:
    304-336). ``k > 0`` = view center moved up = bins shift left. Vacated
    edge bins keep their stale values, exactly the reference's memmove
    without memset. Runs on the state's own device."""
    k = int(k)
    if k == 0:
        return st
    st = dict(st)
    for key in ("ma", "maa"):
        a = st[key]
        b = a.clone()
        if k > 0:
            b[..., :-k] = a[..., k:]
        else:
            b[..., -k:] = a[..., :k]
        st[key] = b
    return st


def rescale_display_state(st, zoom_in: bool):
    """×2 bandwidth-change continuity (ref: SpectrumVisualProcessor.cpp:
    454-492): zooming IN expands the middle half of the old averages to the
    full display (new[i] = old[n/4 + i//2]); zooming OUT compresses the old
    display into the middle half (new[i] = old[(i - n/4)*2]) and zeroes the
    newly revealed edges."""
    st = dict(st)
    for key in ("ma", "maa"):
        a = st[key]
        n = a.shape[-1]
        i = torch.arange(n, device=a.device)
        if zoom_in:
            b = a.index_select(-1, n // 4 + i // 2)
        else:
            src = ((i - n // 4) * 2).clamp(0, n - 1)
            keep = (i >= n // 4) & (i < n - n // 4)
            b = torch.where(keep, a.index_select(-1, src),
                            torch.zeros((), dtype=a.dtype, device=a.device))
        st[key] = b.to(torch.float32)
    return st


class SpectrumView(StreamOp):
    """Zoomed-spectrum front stage: shift the stream to the view center and
    resample to the view bandwidth, then frame for the core processor
    (ref view path: SpectrumVisualProcessor.cpp:283-386). Planar in, PC
    frames [n_frames, fftSizeInternal] out."""

    def __init__(self, input_rate: float, view_offset: float,
                 view_bandwidth: float, fft_size: int = DEFAULT_FFT_SIZE):
        super().__init__()
        self.input_rate = float(input_rate)
        self.view_offset = float(view_offset)
        # Reference halves input rate by VZM until <= bandwidth.
        bw = float(input_rate)
        while bw / SPECTRUM_VZM >= view_bandwidth:
            bw /= SPECTRUM_VZM
        self.resample_bw = bw
        self.nco = NCOMixer()
        P, Q = design_ratio(bw / input_rate, max_denominator=256)
        self.P, self.Q = P, Q
        self.resampler = RationalResampler(P, Q)
        self.fft_size = fft_size
        self.n = fft_size * SPECTRUM_VZM

    def init_state(self):
        return (self.nco.init_state(), self.resampler.init_state())

    def apply(self, state, x: PC):
        s_n, s_r = state
        omega = -2.0 * np.pi * self.view_offset / self.input_rate
        s_n, y = self.nco.apply(s_n, (x, omega))
        s_r, y = self.resampler.apply(s_r, y)
        # Whole fftSizeInternal frames; the ragged tail is dropped.
        n_frames = y.shape[-1] // self.n
        frames = PC(*(p[..., : n_frames * self.n].reshape(
            *p.shape[:-1], n_frames, self.n) for p in y))
        return (s_n, s_r), frames


class ZoomSpectrumView:
    """Managed zoomed-spectrum view — the ``is_view`` path of the
    reference's SpectrumVisualProcessor (ref: src/process/
    SpectrumVisualProcessor.cpp:283-386) with display CONTINUITY across
    view changes:

      * retune shifts the smoothed averages by the bin displacement
        (ref :304-336) via ``shift_display_state`` — the waterfall pans
        instead of blanking;
      * a ×2 bandwidth (zoom) change rescales the history (ref :454-492)
        via ``rescale_display_state``;
      * partial-input priming (ref :401-421) is absorbed by the line
        pacer's sample history.

    One front (NCO, resampler, pacer, step) per (P, Q, chunk), cached, so
    a revisited zoom level reuses its built front; the view offset rides
    in as a device scalar. Host code buffers arbitrary block lengths into
    fixed Q-divisible chunks. ``dtype`` is the receive step's
    representation (PLANAR or torch.complex64), which the device-resident
    feed takes as it comes. On ``device``: the card unless the caller asks
    for the host (``device="cpu"``); without a CUDA device the default
    raises, as ``ReceiverPipeline``'s does.
    """

    def __init__(self, input_rate: float, block_len: int,
                 fft_size: int = DEFAULT_FFT_SIZE,
                 lines_per_second: float = 30.0,
                 fft_average_rate: float = 0.65, device="cuda",
                 dtype=PLANAR):
        from cubicsdr_tpu_torch.visual.planar_spectrum import (
            PlanarSpectrumProcessor)
        self.dtype = dtype
        self.planar = dtype == PLANAR
        self.input_rate = float(input_rate)
        self.block_len = int(block_len)
        self.fft_size = int(fft_size)
        self.n = self.fft_size * SPECTRUM_VZM
        self.lps = float(lines_per_second)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ZoomSpectrumView runs on the card by default and this host "
                "has no CUDA device; pass device='cpu' to run on the host")
        core_cls = (PlanarSpectrumProcessor if self.planar
                    else SpectrumProcessor)
        self.core = core_cls(fft_size, fft_average_rate).to(self.device)
        self.view_offset = 0.0
        self.view_bandwidth = float(input_rate)
        self.st_core = self.core.init_state()
        self._front_cache: dict = {}
        self._front_lock = threading.Lock()
        self.front_cache_hits = 0
        self._warmed: set = set()        # steps already run once
        self._set_omega()
        self._build_front()

    def _set_omega(self):
        # A device scalar, set on view change: the per-block step then
        # uploads nothing.
        self._omega = torch.tensor(
            np.float32(-2.0 * np.pi * self.view_offset / self.input_rate),
            device=self.device)

    def _snap_bw(self, bandwidth: float) -> float:
        """Reference halves the input rate by VZM until <= bandwidth
        (ref :289-291) — view bandwidths are input_rate / 2^k."""
        if not (float(bandwidth) > 0.0):      # also rejects NaN
            raise ValueError(
                f"view bandwidth must be > 0, got {bandwidth}")
        bw = self.input_rate
        while bw / SPECTRUM_VZM >= bandwidth:
            bw /= SPECTRUM_VZM
        return bw

    def _make_front(self, resample_bw: float):
        """Front for one snapped view bandwidth, cached per (P, Q, chunk)
        so a revisited zoom level reuses it."""
        from cubicsdr_tpu_torch.visual.distributor import FFTDataDistributor
        P, Q = design_ratio(resample_bw / self.input_rate,
                            max_denominator=1 << 16)
        chunk = Q * max(1, round(self.block_len / Q))
        key = (P, Q, chunk)
        with self._front_lock:
            ent = self._front_cache.get(key)
            if ent is not None:
                self.front_cache_hits += 1
                return ent
        nco = NCOMixer().to(self.device)
        res = make_resampler(P, Q, dtype=self.dtype).to(self.device)
        dist = FFTDataDistributor(self.n, resample_bw,
                                  lines_per_second=self.lps,
                                  block_len=chunk // Q * P,
                                  dtype=self.dtype).to(self.device)
        core = self.core

        def _step(st_front, st_core, x, omega):
            s_n, s_r, s_d = st_front
            s_n, y = nco.apply(s_n, (x, omega))
            s_r, y = res.apply(s_r, y)
            s_d, (frames, valid) = dist.apply(s_d, y)
            st_core, disp = core.apply(st_core, frames, valid=valid)
            return ((s_n, s_r, s_d), st_core, disp["spectrum_points"],
                    valid.sum())

        ent = (nco, res, dist, chunk, _step)
        with self._front_lock:
            ent = self._front_cache.setdefault(key, ent)
        return ent

    def _build_front(self):
        self.resample_bw = self._snap_bw(self.view_bandwidth)
        (self.nco, self.res, self.dist, self.chunk,
         self._step) = self._make_front(self.resample_bw)
        self._st_front = (self.nco.init_state(), self.res.init_state(),
                          self.dist.init_state())
        self._buf = np.zeros((2, 0), np.float32)
        self.points: np.ndarray | None = None

    def _warm_one(self, bw: float):
        """Build (or reuse) the front for ``bw`` and run it once on a zero
        chunk with fresh states, so a broken level fails here and not in
        the stream. Failures propagate."""
        nco, res, dist, chunk, step = self._make_front(bw)
        if id(step) in self._warmed:
            return
        z = torch.zeros(chunk, dtype=torch.float32, device=self.device)
        step((nco.init_state(), res.init_state(), dist.init_state()),
             self.core.init_state(), self._iq(z, z),
             torch.zeros((), dtype=torch.float32, device=self.device))
        self._warmed.add(id(step))

    def prewarm_level(self, bandwidth: float):
        """Build the view front for ``bandwidth`` (snapped) before making
        it current; callers run this outside any streaming lock."""
        self._warm_one(self._snap_bw(float(bandwidth)))

    def prewarm_adjacent(self):
        """Build the +-1 zoom-step fronts (the zoom levels one wheel-click
        away), so the next zoom finds them built. Eager torch builds a
        front in milliseconds, so this runs on the caller's thread (the
        JAX package compiles them on a background thread)."""
        for bw in (self.resample_bw / SPECTRUM_VZM,
                   self.resample_bw * SPECTRUM_VZM):
            if self.input_rate / (1 << 14) <= bw <= self.input_rate:
                self._warm_one(bw)

    # ---- view control (host events, continuity-preserving) --------------
    def set_view(self, offset: float, bandwidth: float):
        new_bw = self._snap_bw(float(bandwidth))
        if new_bw != self.resample_bw:
            old = self.resample_bw
            steps = int(round(abs(np.log2(new_bw / old))))
            for _ in range(steps):
                self.st_core = rescale_display_state(
                    self.st_core, zoom_in=new_bw < old)
            self.view_bandwidth = float(bandwidth)
            self._build_front()        # new resampler/pacer, fresh fronts
        freq_diff = float(offset) - self.view_offset
        if freq_diff:
            bin_per_hz = self.resample_bw / self.n
            k = int(np.floor(abs(freq_diff) / bin_per_hz))
            if 0 < k < self.n // 2:
                self.st_core = shift_display_state(
                    self.st_core, k if freq_diff > 0 else -k)
            self.view_offset = float(offset)
            self._set_omega()

    def _iq(self, re, im):
        """Host-fed planes in the view's representation."""
        return PC(re, im) if self.planar else torch.complex(re, im)

    # ---- streaming -------------------------------------------------------
    def feed_device(self, x):
        """Device-resident feed: ``x`` is the step's full-band block
        already on the device — no host->device re-upload. Requires the
        view chunk to equal the block length; returns (points, n_valid)
        DEVICE tensors for the caller's deferred pull, or None when the
        chunk doesn't line up (caller falls back to ``feed``)."""
        if self.chunk != self.block_len:
            return None
        self._st_front, self.st_core, pts, nv = self._step(
            self._st_front, self.st_core, x, self._omega)
        return pts, nv

    def feed(self, planes: np.ndarray) -> np.ndarray | None:
        """planes: float32 [2, L] (re, im) host block. Buffers to the fixed
        chunk, runs the view step, returns the newest display points (or
        the previous ones if no full chunk yet)."""
        self._buf = np.concatenate([self._buf, planes], axis=-1)
        while self._buf.shape[-1] >= self.chunk:
            cur, self._buf = (self._buf[:, :self.chunk],
                              self._buf[:, self.chunk:])
            x = torch.from_numpy(np.ascontiguousarray(cur)).to(self.device)
            self._st_front, self.st_core, pts, nv = self._step(
                self._st_front, self.st_core, self._iq(x[0], x[1]),
                self._omega)
            if int(nv):
                self.points = pts.cpu().numpy()
        return self.points
