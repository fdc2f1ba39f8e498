"""Synthetic captures made on the device, for tests, smoke tests and
profiling: the JAX bench's demod layout and FM stations carrying one tone
each; mixed captures of every station kind the modem bank receives (AM,
NBFM, SSB and DSB tones, CW carriers, PSK/QAM symbol streams, FSK/GMSK
bit streams, FM-stereo multiplexes with a pilot), with the random symbols
drawn from a numpy seed; the scan58 plan and the coverage plans built on
them; and the back-pressured cycling source of the live-loop rows, with
the live row built on it."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


def demod_freqs(n: int, spread: int = 16) -> np.ndarray:
    """Offsets (Hz) of n demods at 500 kHz spacing plus 20 kHz, wrapping
    every ``spread`` demods. ``spread`` = 16 is the JAX bench's layout
    (``bench.py:75-77``: one demod per 8 MS/s channel); 15 keeps every
    station clear of the +-fs/2 wrap edge."""
    return np.asarray([((i % spread) - spread // 2) * 500e3 + 20e3
                       for i in range(n)], np.float32)


def synth_fm(freqs, n: int, fs: float, device, seed: int,
             noise: float = 0.02) -> torch.Tensor:
    """Planes [2, n] float32: FM stations at ``freqs`` (station k carries
    a 700 + 90k Hz tone at 75 kHz deviation, amplitude 0.5) plus complex
    Gaussian noise, built in float64 on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    re = noise * torch.randn(n, generator=g, device=device,
                             dtype=torch.float64)
    im = noise * torch.randn(n, generator=g, device=device,
                             dtype=torch.float64)
    for k, f0 in enumerate(freqs):
        msg = torch.sin(2 * np.pi * (700.0 + 90.0 * k) * t)
        ph = 2 * np.pi * float(f0) * t + 2 * np.pi * 75e3 * torch.cumsum(
            msg, 0) / fs
        re += 0.5 * torch.cos(ph)
        im += 0.5 * torch.sin(ph)
    return torch.stack([re, im]).float()


def noise_blocks(block_len: int, dtype=np.float32, n: int = 4,
                 seed: int = 1) -> list:
    """``n`` host blocks of Gaussian planes [2, block_len] in the ring's
    sample format (the JAX bench's live-row input, ``bench.py:192-200``):
    unit variance for float32, a quarter of half full scale for integer
    wire formats."""
    rng = np.random.default_rng(seed)
    shape = (2, block_len)
    if np.dtype(dtype) == np.float32:
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in range(n)]
    k = float(np.iinfo(dtype).max // 2)
    return [(rng.standard_normal(shape) * 0.25 * k).astype(dtype)
            for _ in range(n)]


class CycleSource:
    """Unthrottled host source that cycles ``blocks`` with back-pressure:
    it waits for ring space instead of shedding, so a live-loop rate is
    the loop's own and ring drops stay a real health signal
    (``bench.py:202-222``). Set ``ring`` to the receiver's ring."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.ring = None
        self.stop_flag = False

    def __iter__(self):
        i = 0
        n = self.blocks[0].shape[-1]
        while not self.stop_flag:
            while (self.ring is not None and not self.stop_flag
                   and self.ring.fill + n > self.ring.capacity):
                time.sleep(0.0002)
            yield self.blocks[i % len(self.blocks)]
            i += 1

    def stop(self):
        self.stop_flag = True


def live_row(rx, ingest_dtype, n_warm: int = 8, compiled: bool = True):
    """The live16 row of the JAX package's ``bench.py:175-258`` on
    pipeline ``rx``: its demods at the bench layout, a cycling noise
    source in ring format ``ingest_dtype``, a 1024-point 64-line waterfall
    and a 1 s ring; ``compiled`` is the receiver's. Returns the running
    receiver after ``n_warm`` blocks; the caller stops it."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    controls = rx.control_template()
    controls[0]["frequency"] = demod_freqs(rx.groups[0].count)
    src = CycleSource(noise_blocks(rx.block_len, ingest_dtype))
    lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                      waterfall_lines=64, ring_seconds=1.0,
                      ingest_dtype=ingest_dtype, compiled=compiled)
    src.ring = lr.ring
    lr.start_producer()
    lr.run_blocks(max_blocks=n_warm)
    return lr


@dataclass(frozen=True)
class Station:
    """One transmitter in a synthetic capture, at ``frequency`` Hz from the
    capture centre. ``kind``: fm (75 kHz deviation) | nbfm (2.5 kHz) |
    am (depth 0.8) | dsb | usb | lsb (a tone) | cw (a carrier) | fms (a
    stereo multiplex) | symbols (``points`` at ``rate`` symbols/s) |
    fsk | gmsk (bits at ``rate``, tones at +-``deviation`` Hz).
    ``tone`` is the audio tone in Hz (left channel for fms)."""
    kind: str
    frequency: float
    tone: float = 1000.0
    amplitude: float = 0.5
    rate: float = 2500.0
    deviation: float = 0.0
    points: tuple = (1.0, -1.0)


def _baseband(st: Station, t: torch.Tensor, fs: float, rng):
    """(phase, amplitude) float64 tensors of one station's complex
    baseband A e^{j phase} on ``t``'s device."""
    two_pi = 2 * np.pi
    zero = torch.zeros_like(t)
    tone = torch.sin(two_pi * st.tone * t)
    if st.kind in ("fm", "nbfm"):
        dev = st.deviation or (75e3 if st.kind == "fm" else 2.5e3)
        # Closed-form integral of the tone: phase-continuous everywhere.
        ph = dev * (1 - torch.cos(two_pi * st.tone * t)) / st.tone
        return ph, st.amplitude + zero
    if st.kind == "am":
        return zero, st.amplitude * (1 + 0.8 * tone)
    if st.kind == "dsb":
        return zero, st.amplitude * tone
    if st.kind in ("usb", "lsb"):
        sign = 1.0 if st.kind == "usb" else -1.0
        return sign * two_pi * st.tone * t, st.amplitude + zero
    if st.kind == "cw":
        return zero, st.amplitude + zero
    if st.kind == "fms":
        left = tone
        right = 0.5 * torch.sin(two_pi * 2.5 * st.tone * t)
        msg = (0.45 * (left + right) + 0.1 * torch.sin(two_pi * 19e3 * t)
               + 0.45 * (left - right) * torch.sin(two_pi * 38e3 * t))
        return two_pi * 75e3 * torch.cumsum(msg, 0) / fs, \
            st.amplitude + zero
    idx = torch.floor(t * st.rate).long()
    n_sym = int(idx[-1]) + 1
    if st.kind == "symbols":
        pts = np.asarray(st.points, np.complex128)
        sym = pts[rng.integers(0, len(pts), n_sym)]
        re = torch.from_numpy(sym.real.copy()).to(t.device)[idx]
        im = torch.from_numpy(sym.imag.copy()).to(t.device)[idx]
        return torch.atan2(im, re), st.amplitude * torch.sqrt(
            re * re + im * im)
    if st.kind in ("fsk", "gmsk"):
        bits = torch.from_numpy(rng.integers(0, 2, n_sym) * 2.0 - 1.0
                                ).to(t.device)[idx]
        return (two_pi * st.deviation * torch.cumsum(bits, 0) / fs,
                st.amplitude + zero)
    raise ValueError(f"unknown station kind {st.kind!r}")


def synth_capture(stations, n: int, fs: float, device, seed: int,
                  noise: float = 0.01) -> torch.Tensor:
    """Planes [2, n] float32 of ``stations`` plus complex Gaussian noise
    (``noise`` per plane), built in float64 on ``device``; symbols, bits
    and noise come from numpy's generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    re = torch.from_numpy(noise * rng.standard_normal(n)).to(device)
    im = torch.from_numpy(noise * rng.standard_normal(n)).to(device)
    for st in stations:
        ph, amp = _baseband(st, t, fs, rng)
        ph = ph + 2 * np.pi * st.frequency * t
        re += amp * torch.cos(ph)
        im += amp * torch.sin(ph)
    return torch.stack([re, im]).float()


@dataclass(frozen=True)
class Plan:
    """A receiver plan with a capture to run it on: ``specs`` build the
    ReceiverPipeline at ``fs`` with ``num_channels`` channels, ``freqs``
    are each group's demod offsets (Hz, the controls' "frequency"), and
    ``stations`` the transmitters of its synthetic capture."""
    name: str
    fs: float
    num_channels: int
    specs: tuple
    freqs: tuple
    stations: tuple

    def pipeline(self, **kw):
        from cubicsdr_tpu_torch.receiver import ReceiverPipeline
        return ReceiverPipeline(self.fs, list(self.specs),
                                num_channels=self.num_channels, **kw)

    def controls(self, rx):
        controls = rx.control_template()
        for ctl, f in zip(controls, self.freqs):
            ctl["frequency"] = np.asarray(f, np.float32)
        return controls

    def capture(self, n: int, device, seed: int = 5,
                noise: float = 0.01) -> torch.Tensor:
        return synth_capture(self.stations, n, self.fs, device, seed, noise)

    def manager(self, center: float):
        """A DemodulatorMgr holding the plan's demods, group by group, at
        ``center`` + each offset: what a saved session of this plan
        loads (its groups are the plan's specs, in order)."""
        from cubicsdr_tpu_torch.receiver import DemodulatorMgr
        mgr = DemodulatorMgr()
        for spec, freqs in zip(self.specs, self.freqs):
            for f in freqs:
                d = mgr.new_demodulator(center + float(f), spec.modem_name,
                                        spec.bandwidth)
                d.write_modem_settings(spec.settings_dict)
        return mgr


def _slots(offset: float, channels, n: int) -> list:
    """n demod offsets at ``offset`` Hz from the centres of ``channels``
    (channel k is centred at k * 500 kHz), cycling through them."""
    return [channels[i % len(channels)] * 500e3 + offset for i in range(n)]


def scan58() -> Plan:
    """A busy 8 MS/s band, M = 16 PFBCH2 channels (500 kHz apart), 58
    demods in the six groups every one of which fuses the route kernel:
    16 broadcast FM (+20 kHz in channels -7..5), 16 NBFM voice (-100 kHz
    in those channels, three at +140 kHz), 16 AM voice (-125 kHz, three
    at +165 kHz), 4 CW carriers (-150 kHz), 4 BPSK data carriers (2,500
    symbols/s, +150 kHz in channels -3..0) and 2 FM-stereo stations
    (channels 6 and 7, which carry nothing else). Every demod has a
    station: the FM, NBFM and AM ones each carry their own tone (FM
    700 + 90 i Hz, NBFM 1000 + 37 i Hz, AM 400 + 50 i Hz)."""
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    ch = list(range(-7, 6))
    fm = _slots(20e3, ch, 16)
    nbfm = _slots(-100e3, ch, 13) + _slots(140e3, ch, 3)
    am = _slots(-125e3, ch, 13) + _slots(165e3, ch, 3)
    cw = _slots(-150e3, [-7, -6, -5, -4], 4)
    bpsk = _slots(150e3, [-3, -2, -1, 0], 4)
    fms = _slots(10e3, [6, 7], 2)
    stations = (
        [Station("fm", f, 700.0 + 90.0 * i) for i, f in enumerate(fm[:13])]
        + [Station("nbfm", f, 1000.0 + 37.0 * i)
           for i, f in enumerate(nbfm)]
        + [Station("am", f, 400.0 + 50.0 * i) for i, f in enumerate(am)]
        + [Station("cw", f, amplitude=0.2) for f in cw]
        + [Station("symbols", f) for f in bpsk]
        + [Station("fms", f) for f in fms])
    specs = (DemodGroupSpec("FM", 200000, 16),
             DemodGroupSpec("NBFM", 12500, 16),
             DemodGroupSpec("AM", 6000, 16),
             DemodGroupSpec("CW", 500, 4),
             DemodGroupSpec("BPSK", 20000, 4),
             DemodGroupSpec("FMS", 250000, 2))
    return Plan("scan58", 8_000_000, 16, specs,
                (fm, nbfm, am, cw, bpsk, fms), tuple(stations))


# The constellation modems of the coverage plan.
_CONSTELLATIONS = ("QPSK", "PSK", "DPSK", "ASK", "QAM", "APSK", "OOK", "ST",
                   "SQAM")


def coverage_plans() -> list[Plan]:
    """Small 8 MS/s, M = 16 plans (2 demods per group, choose_block_len)
    that run every modem scan58 does not: I/Q (fused at 6/125, O = 768)
    with the nine constellation modems (fused at 1/5); DSB, USB and LSB
    (first stage 27/50: no fused tile exists, so the gather path); FSK
    and GMSK (first stage 9/67: the gather path). Every demod listens to
    a station of its own kind."""
    from cubicsdr_tpu_torch.modems import make_modem
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    ch = list(range(-7, 8))
    plans = []
    specs = [DemodGroupSpec("I/Q", 48000, 2)]
    freqs = [_slots(30e3, ch[9:11], 2)]
    stations = [Station("usb", f, 3000.0) for f in freqs[0]]
    for i, name in enumerate(_CONSTELLATIONS):
        # Both demods of a group on its channel's one station.
        specs.append(DemodGroupSpec(name, 200000, 2))
        freqs.append(_slots(20e3, ch[i:i + 1], 2))
        kit = make_modem(name).build_kit(200000)
        pts = tuple(complex(r, m) for r, m in zip(kit.pts_re.tolist(),
                                                   kit.pts_im.tolist()))
        stations.append(Station("symbols", freqs[-1][0], points=pts,
                                rate=20e3, amplitude=0.3))
    plans.append(Plan("cov_iq_constellations", 8_000_000, 16,
                      tuple(specs), tuple(freqs), tuple(stations)))
    specs, freqs, stations = [], [], []
    for i, (name, kind) in enumerate((("DSB", "dsb"), ("USB", "usb"),
                                      ("LSB", "lsb"))):
        specs.append(DemodGroupSpec(name, 5400, 2))
        freqs.append(_slots(-40e3 * (i + 1), ch[5:7], 2))
        stations += [Station(kind, f, 600.0 + 200.0 * i) for f in freqs[-1]]
    plans.append(Plan("cov_dsb_ssb", 8_000_000, 16, tuple(specs),
                      tuple(freqs), tuple(stations)))
    specs = (DemodGroupSpec("FSK", 19200, 2, (("bps", 1), ("sps", 1200))),
             DemodGroupSpec("GMSK", 19200, 2, (("sps", 4),)))
    freqs = (_slots(-60e3, ch[3:5], 2), _slots(60e3, ch[3:5], 2))
    # FSK: bit rate 1200/s on tones at +-0.45/2 of 19.2 kHz; GMSK: 4
    # samples per bit at 19.2 kHz, +-0.25/4 cycles per sample.
    stations = ([Station("fsk", f, rate=1200.0, deviation=4320.0)
                 for f in freqs[0]]
                + [Station("gmsk", f, rate=4800.0, deviation=1200.0)
                   for f in freqs[1]])
    plans.append(Plan("cov_fsk_gmsk", 8_000_000, 16, specs, freqs,
                      tuple(stations)))
    return plans
