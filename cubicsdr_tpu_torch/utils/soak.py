"""Endurance and numerics evidence for the live receiver on one card
(``scripts/tpu_evidence_r05.py``'s on-chip modes on the port).

    python -m cubicsdr_tpu_torch.utils.soak soak [--rate 4800000]
        [--minutes 3] [--format cs8] [--ring 4]
    python -m cubicsdr_tpu_torch.utils.soak churn_soak [--minutes 5]
        [--format cs16] [--plan serve|scan58]
    python -m cubicsdr_tpu_torch.utils.soak digital_check [--blocks 8]

Every mode takes ``--device`` (default ``cuda``; without a CUDA device
the mode raises unless ``--device cpu`` is given) and prints one JSON
line whose ``ok`` says whether it met its criteria; the exit code is 0
only then.

soak — a real-time-paced live loop: FM x4 at ``--rate`` through cs16 or
    cs8 ingest with a ``--ring`` seconds ring, blocks of the smallest
    multiple of the default plan's block length above 2^20 (both kernels
    on the path). Passes with 0 ring drops and at least 0.98x real
    time.

churn_soak — the live loop at the capture rate while the REST control
    plane (``app/webview.py``) runs plan-edit cycles. ``--plan serve`` is
    the production ``serve`` shape: 2.4 MS/s, the M=6 channelizer, an FM
    survivor at +200 kHz carrying a 1 kHz tone, each cycle 15 control ops
    plus a checkpoint and a restore. ``--plan scan58`` is scan58 at 8 MS/s
    (``utils/synth.py``), each cycle adding, retyping and removing a
    demod per kind (FM -> NBFM, AM, BPSK) with the same view, solo,
    display and recording ops. The block length is pinned to a common
    multiple over every plan the cycle visits, so no edit changes the
    ring's format. WARM_CYCLES warm cycles (the first with each op
    followed by two finished blocks, so it builds every step and
    post-step; the second as measured) and a wait until the loop's audio
    tap holds its 64 blocks, then the measured cycles (0.3 s between
    ops) run for ``--minutes``, at least one, sampling process RSS (as
    the process holds it: no forced collection), the caching allocator,
    the compiled-step caches, the zoom levels, drops and the longest gap
    between two finished blocks once a minute (or six times in a shorter
    run); each cycle's builds and RSS at its end are kept too. Passes
    with no consumer exception, 0 drops, at least 0.98x real time, the
    survivor's tone in all but one 250 ms window of its audio, an RSS
    least-squares slope under 0.5 MiB/min and no higher
    ``memory_reserved`` peak in the last third of the run than in the
    first.

digital_check — FM plus QPSK, QAM-16, QAM-256, APSK-16 and GMSK at
    8 MS/s, each station in its own channel: the calibration, the tx
    accuracy and the reference symbols on the CPU (the unfused chain),
    then the same capture through the device's pipeline with its kernels.
    Passes with agreement >= 0.999 on the reference's decision-stable
    samples, an EVM delta under 0.02 and a stable fraction over 0.5 per
    modem, and the FM tone within 5 Hz of 1 kHz.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import wave
from pathlib import Path

import numpy as np
import torch

from cubicsdr_tpu_torch.bench import card_name, wire_probe

FS = 8_000_000
BW = 20000
HOLD = 32                     # slicer samples per coherent data symbol
SYM_LEN = HOLD * (FS // BW)   # capture samples per coherent data symbol
GHOLD = 8                     # integrate-and-dump frames per GMSK bit
GMSK_SPS = 4                  # slicer frames per GMSK symbol

# Station offsets: +20 kHz off distinct channel centres (500 kHz grid).
ST_FREQ = {"FM": 1_020_000.0, "QPSK": -1_480_000.0, "QAM16": 2_020_000.0,
           "QAM256": -2_480_000.0, "APSK16": 3_020_000.0,
           "GMSK": -3_480_000.0}
COHERENT = ("QPSK", "QAM16", "QAM256", "APSK16")
NAMES = ("QPSK", "QAM16", "QAM256", "APSK16", "GMSK")

# The pass criteria.
REALTIME = 0.98               # sustained rate over the capture rate
RSS_SLOPE_MIB_PER_MIN = 0.5
AGREEMENT = 0.999
EVM_DELTA = 0.02
STABLE_FRAC = 0.5
FM_TONE_HZ = 5.0

CENTER = 100e6
OP_GAP_S = 0.3                # between two REST ops of a churn cycle
SAMPLE_S = 60.0               # the churn soak's sampling period
WARM_CYCLES = 2               # churn cycles before the measured window


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the soak runs on the card by default and this "
                           "host has no CUDA device; pass --device cpu to "
                           "run on the host")
    return dev


# ------------------------------------------------- the digital capture ----

def _tables() -> dict:
    from cubicsdr_tpu_torch.modems.digital import (
        apsk_constellation, psk_constellation, qam_constellation)
    return {"QPSK": psk_constellation(4),
            "QAM16": qam_constellation(16),
            "QAM256": qam_constellation(256),
            "APSK16": apsk_constellation(16)}


def _capture(L: int, n_blocks: int, cal: dict | None = None,
             seed: int = 11):
    """Six co-channel stations, each at unit amplitude in its own channel:
    an FM station with a 1 kHz tone, four coherent constellations held
    for SYM_LEN capture samples per symbol and a GMSK-style frequency
    keying held GHOLD frames per bit. ``cal`` maps a coherent modem's name
    to the chain's complex gain for its station (the chain has no carrier
    recovery); its baseband is divided by it, so the slicer sees the true
    constellation. Returns (complex64 capture, transmitted symbols)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * L
    t = np.arange(n) / FS

    msg = np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * ST_FREQ["FM"] * t
                      + 2 * np.pi * 75e3 * np.cumsum(msg) / FS))

    tx = {}
    n_sym = n // SYM_LEN + 1
    for name, pts in _tables().items():
        tx[name] = rng.integers(0, len(pts), n_sym)
        g = (cal or {}).get(name, 1.0)
        bb = np.repeat(pts[tx[name]] / g, SYM_LEN)[:n]
        iq = iq + bb * np.exp(2j * np.pi * ST_FREQ[name] * t)

    bit_caps = GHOLD * GMSK_SPS * (FS // BW)  # capture samples per bit
    n_bits = n // bit_caps + 1
    tx["GMSK"] = rng.integers(0, 2, n_bits)
    dev = 0.25 / GMSK_SPS * BW                # Hz
    f_t = ST_FREQ["GMSK"] + (tx["GMSK"] * 2.0 - 1.0).repeat(bit_caps)[:n] \
        * dev
    iq = iq + np.exp(1j * 2 * np.pi * np.cumsum(f_t) / FS)

    return iq.astype(np.complex64), tx


def _stable_mask(ref_syms: np.ndarray, k: int = 2) -> np.ndarray:
    """True where the reference decision is locally constant (+-k)."""
    m = np.ones(ref_syms.shape, bool)
    for d in range(1, k + 1):
        m[d:] &= ref_syms[d:] == ref_syms[:-d]
        m[:-d] &= ref_syms[:-d] == ref_syms[d:]
    return m


def _est_gain(tap: np.ndarray, txs: np.ndarray, pts: np.ndarray) -> complex:
    """Best-delay complex least-squares gain of a received constellation."""
    rep = np.repeat(pts[txs], HOLD)[:tap.size]
    best = None
    for d in range(3 * HOLD):
        a = tap[d:]
        b = rep[:a.size]
        g = np.vdot(b, a) / np.vdot(b, b)
        err = float(np.mean(np.abs(a - g * b) ** 2))
        if best is None or err < best[0]:
            best = (err, g)
    return complex(best[1])


def _tx_accuracy(dec, txs, hold: int, lo: int, hi: int,
                 maxd: int = 3 * HOLD) -> float:
    """Best-delay accuracy on the interior samples of each hold
    (transition samples ring through the channel filters)."""
    rep = np.repeat(txs, hold)
    best = 0.0
    for d in range(maxd):
        n = min(len(dec) - d, len(rep))
        pos = np.arange(n) % hold
        mask = (pos >= lo) & (pos < hi)
        best = max(best, float((dec[d:d + n][mask] == rep[:n][mask]).mean()))
    return round(best, 4)


def digital_specs() -> list:
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    return [DemodGroupSpec("FM", 200000, 1),
            DemodGroupSpec("QPSK", BW, 1),
            DemodGroupSpec("QAM", BW, 1, settings=(("cons", 16),)),
            DemodGroupSpec("QAM", BW, 1, settings=(("cons", 256),)),
            DemodGroupSpec("APSK", BW, 1, settings=(("cons", 16),)),
            DemodGroupSpec("GMSK", BW, 1, settings=(("sps", GMSK_SPS),))]


def digital_block_len(specs) -> int:
    """The JAX mode's block: a common multiple of every group's block
    multiple and the 128-step kernel tile, near 2^19 samples."""
    from cubicsdr_tpu_torch.receiver import ReceiverPipeline
    rx0 = ReceiverPipeline(FS, specs, device="cpu", use_kernels=False)
    m = 1
    for gi in range(len(specs)):
        m = math.lcm(m, rx0.group_block_multiple(gi))
    m = math.lcm(m, rx0.decim * 128)
    return max(m, (1 << 19) // m * m)


def _run_digital(rx, iq_all, n_blocks: int, L: int, taps_for=()):
    """(symbols, mean EVM past the first block, FM audio blocks, iq taps)
    of ``n_blocks`` blocks of ``iq_all`` through ``rx``'s step."""
    from cubicsdr_tpu_torch.ops.planar import PC
    controls = rx.control_template()
    controls[0]["frequency"] = np.asarray([ST_FREQ["FM"]], np.float32)
    for gi, name in enumerate(NAMES, start=1):
        controls[gi]["frequency"] = np.asarray([ST_FREQ[name]], np.float32)
    dev = rx.centers.device
    st = rx.init_state()
    syms = {k: [] for k in NAMES}
    evm = {k: [] for k in NAMES}
    audio, taps = [], {k: [] for k in taps_for}
    with torch.no_grad():
        for b in range(n_blocks):
            blk = iq_all[b * L:(b + 1) * L]
            iq = PC(torch.from_numpy(np.ascontiguousarray(blk.real)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(blk.imag)).to(dev))
            st, out = rx.apply(st, (iq, controls))
            for gi, name in enumerate(NAMES, start=1):
                g = out["groups"][gi]
                syms[name].append(g["symbols"][0].cpu().numpy())
                evm[name].append(float(g["evm"][0]))
                if name in taps:
                    y = g["iq"]
                    taps[name].append(y.re[0].cpu().numpy()
                                      + 1j * y.im[0].cpu().numpy())
            audio.append(out["groups"][0]["audio"][0, 0].cpu().numpy())
    return ({k: np.concatenate(v) for k, v in syms.items()},
            {k: float(np.mean(v[1:] if len(v) > 1 else v))
             for k, v in evm.items()},
            audio,
            {k: np.concatenate(v) for k, v in taps.items()})


def fm_tone(audio: list, rate: float) -> tuple[float, float]:
    """(peak frequency, SNR dB) of the FM audio's second half."""
    a = np.concatenate(audio)[len(audio[0]) // 2:]
    X = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    f = np.fft.rfftfreq(len(a), 1.0 / rate)
    k = int(np.argmax(X))
    sig = X[max(0, k - 3): k + 4].sum()
    return float(f[k]), float(10 * np.log10(sig / max(X.sum() - sig,
                                                       1e-30)))


def digital_check(args) -> dict:
    from cubicsdr_tpu_torch.receiver import ReceiverPipeline
    from cubicsdr_tpu_torch.utils.compiled import launch_counts
    dev = _device(args.device)
    specs = digital_specs()
    L = digital_block_len(specs)
    n_blocks = int(args.blocks)
    tables = _tables()
    t0 = time.perf_counter()
    ref_rx = ReceiverPipeline(FS, specs, block_len=L, device="cpu",
                              use_kernels=False)
    # Calibration on the CPU reference: each coherent station's chain
    # gain from an uncompensated 2-block run.
    iq_cal, tx_cal = _capture(L, 2)
    _, _, _, taps = _run_digital(ref_rx, iq_cal, 2, L, taps_for=COHERENT)
    cal = {n: _est_gain(taps[n], tx_cal[n], tables[n]) for n in COHERENT}
    iq_all, tx = _capture(L, n_blocks, cal=cal)
    ref_syms, ref_evm, _, _ = _run_digital(ref_rx, iq_all, n_blocks, L)
    acc = {n: _tx_accuracy(ref_syms[n], tx[n], HOLD, HOLD // 4,
                           3 * HOLD // 4) for n in COHERENT}
    acc["GMSK"] = _tx_accuracy(ref_syms["GMSK"], tx["GMSK"], GHOLD, 2, 6)
    ref_s = time.perf_counter() - t0

    rx = ReceiverPipeline(FS, specs, block_len=L, device=dev)
    before = launch_counts()
    t0 = time.perf_counter()
    syms, evm, audio, _ = _run_digital(rx, iq_all, n_blocks, L)
    dev_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}

    res = {"tag": "digital_check", "device": str(dev), "card": card_name()
           if dev.type == "cuda" else None, "M": rx.M, "block_len": L,
           "blocks": n_blocks, "fused_route": rx.fused_route,
           "launches": launches,
           "cal": {k: [round(abs(v), 4), round(float(np.degrees(
               np.angle(v))), 2)] for k, v in cal.items()},
           "tx_accuracy_interior": acc, "reference_s": round(ref_s, 3),
           "device_s": round(dev_s, 3)}
    ok = True
    for name in NAMES:
        a, b = ref_syms[name], syms[name]
        n = min(a.size, b.size)
        a, b = a[:n], b[:n]
        mask = _stable_mask(a)
        agree = float((a[mask] == b[mask]).mean())
        d_evm = abs(ref_evm[name] - evm[name])
        res[name] = {"stable_samples": int(mask.sum()),
                     "stable_frac": round(float(mask.mean()), 4),
                     "agreement": agree,
                     "agreement_raw": float((a == b).mean()),
                     "evm_reference": ref_evm[name], "evm_device": evm[name],
                     "evm_delta": d_evm}
        ok = ok and agree >= AGREEMENT and d_evm < EVM_DELTA \
            and float(mask.mean()) > STABLE_FRAC
    f, snr = fm_tone(audio, rx.audio_rate)
    res["fm_tone_hz"] = round(f, 2)
    res["fm_snr_db"] = round(snr, 2)
    res["ok"] = bool(ok and abs(f - 1000.0) < FM_TONE_HZ)
    return res


# ------------------------------------------------------ the live soaks ----

class PacedSource:
    """Whole planar ``(2, L)`` integer blocks of a looped capture at their
    real-time deadlines (the SDR's role). ``loop`` is a planar ``(2, n)``
    int16 or int8 array; block i holds samples ``[i L, (i + 1) L)`` of it,
    wrapped. ``reset()`` re-bases the schedule to now: a warm-up's backlog
    must not spray through the measured window as false drops. ``late_s``
    is how far the producer fell behind its schedule since the last
    reset."""

    def __init__(self, loop: np.ndarray, L: int, rate: float):
        if loop.ndim != 2 or loop.shape[0] != 2:
            raise ValueError(f"a planar (2, n) loop, not {loop.shape}")
        self.loop, self.L, self.rate = loop, int(L), float(rate)
        self.stopping = False
        self.late_s = 0.0
        self._t0 = None
        self._i = 0

    def reset(self):
        self._t0 = time.perf_counter()
        self._i = 0
        self.late_s = 0.0

    def block(self, i: int, out: np.ndarray | None = None) -> np.ndarray:
        """Block ``i``, written into ``out`` when given."""
        n = self.loop.shape[1]
        if out is None:
            out = np.empty((2, self.L), self.loop.dtype)
        pos, k = (i * self.L) % n, 0
        while k < self.L:
            take = min(self.L - k, n - pos)
            out[:, k:k + take] = self.loop[:, pos:pos + take]
            k += take
            pos = 0
        return out

    def __iter__(self):
        # Two buffers, filled in turn: the consumer of a block (the live
        # loop's producer, which copies it into the ring) is done with it
        # before the next is asked for.
        bufs = [np.empty((2, self.L), self.loop.dtype) for _ in range(2)]
        self.reset()
        k = 0
        while not self.stopping:
            due = self._t0 + (self._i + 1) * self.L / self.rate
            ahead = due - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)
            else:
                self.late_s = max(self.late_s, -ahead)
            yield self.block(k, bufs[k % 2])
            self._i += 1
            k += 1

    def stop(self):
        self.stopping = True


def quantize(planes: np.ndarray, fmt: str, peak: float = 0.5) -> np.ndarray:
    """Float planes scaled so their largest magnitude is ``peak`` of full
    scale, as cs16 or cs8 wire samples."""
    dt = {"cs16": np.int16, "cs8": np.int8}[fmt]
    full = float(np.iinfo(dt).max)
    k = peak * full / max(float(np.abs(planes).max()), 1e-12)
    return np.clip(np.rint(planes * k), -full, full).astype(dt)


def fm_loop(rate: float, offset: float, tone: float) -> np.ndarray:
    """One second of an FM station (75 kHz deviation) at ``offset`` Hz
    carrying ``tone``: whole cycles of both, so the loop is seamless."""
    n = int(rate)
    if n != rate or offset != int(offset) or tone != int(tone):
        raise ValueError("a seamless 1 s loop needs whole-Hz rates")
    t = np.arange(n) / rate
    msg = np.sin(2 * np.pi * tone * t)
    ph = 2 * np.pi * offset * t + 2 * np.pi * 75e3 * np.cumsum(msg) / rate
    return np.stack([np.cos(ph), np.sin(ph)])


def rss_bytes() -> int | None:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def memory_verdict(samples: list) -> dict:
    """The churn soak's memory criteria over its samples (each with
    ``minute``, ``rss_bytes`` and ``memory_reserved``, None off the card):
    the least-squares slope of RSS in MiB per minute under
    RSS_SLOPE_MIB_PER_MIN, and the highest ``memory_reserved`` in the last
    third of the run no higher than in the first third."""
    t = np.array([s["minute"] for s in samples], np.float64)
    out = {"rss_slope_mib_per_min": None, "rss_ok": True,
           "reserved_first_third_peak": None,
           "reserved_last_third_peak": None, "reserved_ok": True}
    rss = [s["rss_bytes"] for s in samples]
    if len(t) >= 2 and None not in rss and t[-1] > t[0]:
        slope = float(np.polyfit(t, np.asarray(rss, np.float64) / 2**20,
                                 1)[0])
        out["rss_slope_mib_per_min"] = slope
        out["rss_ok"] = slope < RSS_SLOPE_MIB_PER_MIN
    res = [s["memory_reserved"] for s in samples]
    if len(t) >= 2 and None not in res:
        span = t[-1] - t[0]
        first = [r for tt, r in zip(t, res) if tt - t[0] <= span / 3]
        last = [r for tt, r in zip(t, res) if tt - t[0] >= 2 * span / 3]
        out["reserved_first_third_peak"] = max(first)
        out["reserved_last_third_peak"] = max(last)
        out["reserved_ok"] = max(last) <= max(first)
    return out


class ToneWindows:
    """Counts the 250 ms windows of a PCM16 WAV whose peak above 100 Hz
    lies within 40 Hz of ``tone`` (tests/test_churn.py's test), reading
    the file a window at a time."""

    def __init__(self, tone: float):
        self.tone = float(tone)
        self.good = 0
        self.windows = 0

    def add_file(self, path: Path) -> None:
        if not path.exists():            # a sink closed before any block
            return
        with wave.open(str(path)) as w:
            rate, ch = w.getframerate(), w.getnchannels()
            win = rate // 4
            f = np.fft.rfftfreq(win, 1.0 / rate)
            han = np.hanning(win)
            while True:
                raw = w.readframes(win)
                if len(raw) < win * ch * 2:
                    break
                a = np.frombuffer(raw, "<i2").reshape(-1, ch).mean(axis=1)
                x = np.abs(np.fft.rfft(a * han))
                self.good += bool(abs(f[int(np.argmax(x * (f > 100.0)))]
                                      - self.tone) < 40.0)
                self.windows += 1


def http(port: int, path: str, body=None) -> bytes:
    """A GET (no ``body``) or a JSON POST to the local WebViewer, never
    through a proxy."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=120) as r:
        return r.read()


def join_prewarms(timeout: float = 120.0) -> None:
    """Wait for the zoom views' background level builds to end: a
    device-wide synchronisation would invalidate a capture in progress
    on their thread (``utils/compiled.py``). Raises if one hangs."""
    for th in threading.enumerate():
        if th.name == "cs-zoom-prewarm":
            th.join(timeout)
            if th.is_alive():
                raise AssertionError("a background zoom build hung")


def _prewarm_running() -> bool:
    return any(th.name == "cs-zoom-prewarm" for th in threading.enumerate())


def soak_specs() -> list:
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    return [DemodGroupSpec("FM", 200000, 4)]


def soak_block_len(rate: float, specs) -> int:
    """The least multiple above 2^20 of the default plan's block, which
    is 128-step aligned: the group stays on the fused route kernel."""
    from cubicsdr_tpu_torch.receiver import ReceiverPipeline
    m = ReceiverPipeline(rate, specs, device="cpu").block_len
    return ((1 << 20) // m + 1) * m


def soak(args) -> dict:
    """The real-time-paced live soak through cs16 or cs8 ingest."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.receiver import ReceiverPipeline
    dev = _device(args.device)
    rate = float(args.rate)
    specs = soak_specs()
    L = soak_block_len(rate, specs)
    rx = ReceiverPipeline(rate, specs, block_len=L, device=dev)
    controls = rx.control_template()
    controls[0]["frequency"] = np.asarray(
        [100e3, 300e3, -200e3, -400e3], np.float32)
    rng = np.random.default_rng(3)
    loop = quantize(rng.standard_normal((2, 4 * L)), args.format, 1.0)
    src = PacedSource(loop, L, rate)
    dt = {"cs16": np.int16, "cs8": np.int8}[args.format]
    lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                      waterfall_lines=64, ring_seconds=args.ring,
                      ingest_dtype=dt)
    lr.start_producer()
    try:
        lr.run_blocks(max_blocks=4)          # build + warm
        # Re-base the source's schedule: the warm-up's backlog must not
        # spray through the measured window as false drops.
        src.reset()
        time.sleep(2 * L / rate)
        lr.metrics = type(lr.metrics)()
        t0 = time.perf_counter()
        deadline = t0 + 60.0 * args.minutes
        n = 0
        while time.perf_counter() < deadline:
            n += lr.run_blocks(max_blocks=8)
        wall = time.perf_counter() - t0
        snap = lr.metrics.snapshot()
    finally:
        src.stop()
        lr.stop()
    msps = n * L / wall / 1e6
    drops = int(snap.get("ingest", {}).get("dropped", 0))
    return {"tag": "soak", "device": str(dev),
            "card": card_name() if dev.type == "cuda" else None,
            "format": args.format, "M": rx.M, "block_len": L,
            "fused_route": rx.fused_route, "ring_seconds": args.ring,
            "minutes": wall / 60.0, "rate_msps": rate / 1e6, "blocks": n,
            "sustained_msps": msps, "realtime_factor": msps * 1e6 / rate,
            "ring_dropped_samples": drops, "producer_late_s": src.late_s,
            "ok": bool(drops == 0 and msps * 1e6 >= REALTIME * rate)}


# --- the churn cycles ---

def serve_cycle(tmp: str) -> list:
    """The production shape's cycle: the JAX mode's 15 control ops (a
    checkpoint and a restore follow every cycle)."""
    return [
        ("/api/control", {"action": "add", "freq": CENTER - 300e3,
                          "type": "AM", "bandwidth": 10000}),
        ("/api/control", {"action": "set", "index": 1, "key": "type",
                          "value": "NBFM"}),
        ("/api/control", {"action": "set", "index": 1, "key": "bandwidth",
                          "value": 10000}),
        ("/api/control", {"action": "set", "index": 1, "key": "frequency",
                          "value": CENTER - 280e3}),
        ("/api/control", {"action": "set", "index": 0, "key": "recording",
                          "value": True, "path": f"{tmp}/rec"}),
        ("/api/control", {"action": "set", "index": 0, "key": "recording",
                          "value": False}),
        ("/api/control", {"action": "zoom", "offset": 200e3,
                          "bandwidth": 300e3}),
        ("/api/control", {"action": "view", "index": 0}),
        ("/api/control", {"action": "audio_solo", "index": 0}),
        ("/api/control", {"action": "display", "lps": 20.0}),
        ("/api/control", {"action": "audio_solo", "index": None}),
        ("/api/control", {"action": "view", "index": None}),
        ("/api/control", {"action": "zoom", "offset": None}),
        ("/api/control", {"action": "display", "lps": 30.0}),
        ("/api/control", {"action": "remove", "index": 1}),
    ]


def scan58_cycle(tmp: str, n0: int, f0: float) -> list:
    """scan58's cycle: per kind, chip_smoke.py phase 27's plan edits (add
    at -300 kHz; FM retyped to NBFM, AM's bandwidth to 12.5 kHz; a retune
    of the new demod and of the survivor by 0-2 Hz, its gain, a recording
    on and off) with the serve cycle's zoom, view, solo and display ops,
    then the new demod removed. ``n0`` demods stand before each add, so
    the new one is index ``n0``; the survivor is index 0 at ``f0``."""
    ops = []
    for it, (kind, bw) in enumerate((("FM", 200000), ("AM", 10000),
                                     ("BPSK", 20000))):
        ops.append(("/api/control", {"action": "add",
                                     "freq": CENTER - 300e3, "type": kind,
                                     "bandwidth": bw}))
        if kind == "FM":
            ops.append(("/api/control", {"action": "set", "index": n0,
                                         "key": "type", "value": "NBFM"}))
        if kind == "AM":
            ops.append(("/api/control", {"action": "set", "index": n0,
                                         "key": "bandwidth",
                                         "value": 12500}))
        ops += [
            ("/api/control", {"action": "set", "index": n0,
                              "key": "frequency", "value": CENTER - 280e3}),
            ("/api/control", {"action": "set", "index": 0,
                              "key": "frequency", "value": f0 + it}),
            ("/api/control", {"action": "set", "index": n0, "key": "gain",
                              "value": 0.5})]
        if kind != "BPSK":
            ops += [("/api/control", {"action": "set", "index": n0,
                                      "key": "recording", "value": True,
                                      "path": f"{tmp}/rec"}),
                    ("/api/control", {"action": "set", "index": n0,
                                      "key": "recording", "value": False})]
        ops += [
            ("/api/control", {"action": "zoom", "offset": 200e3,
                              "bandwidth": 250e3}),
            ("/api/control", {"action": "view", "index": 0}),
            ("/api/control", {"action": "audio_solo", "index": 0}),
            ("/api/control", {"action": "display", "lps": 20.0 + it}),
            ("/api/control", {"action": "audio_solo", "index": None}),
            ("/api/control", {"action": "view", "index": None}),
            ("/api/control", {"action": "zoom", "offset": None}),
            ("/api/control", {"action": "display", "lps": 30.0}),
            ("/api/control", {"action": "remove", "index": n0})]
    return ops


def apply_plan_op(mgr, body: dict) -> bool:
    """Apply a control op's effect on the demod set to ``mgr`` as the web
    control plane does; True when it can change the plan."""
    action = body.get("action")
    if action == "add":
        mgr.new_demodulator(float(body["freq"]), str(body["type"]),
                            float(body["bandwidth"]))
        return True
    if action == "remove":
        mgr.delete_demodulator(mgr.get_demodulators()[int(body["index"])])
        return True
    if action == "set" and body["key"] in ("type", "bandwidth"):
        d = mgr.get_demodulators()[int(body["index"])]
        if body["key"] == "type":
            d.set_demod_type(str(body["value"]))
        else:
            d.set_bandwidth(float(body["value"]))
        return True
    return False


def pinned_block_len(rate: float, plans: list, num_channels=None,
                     cap: int = 1 << 23) -> int | None:
    """The least multiple above 2^20 of every visited plan's group block
    multiples and 128-step tiles (each frontend's first stage's too, so
    every fused group stays fused), or None past ``cap``."""
    from cubicsdr_tpu_torch.receiver import ReceiverPipeline
    m = 1
    for specs in plans:
        r0 = ReceiverPipeline(rate, specs, num_channels=num_channels,
                              device="cpu", use_kernels=False)
        for gi in range(len(specs)):
            m = math.lcm(m, r0.group_block_multiple(gi))
        m = math.lcm(m, r0.decim * 128)
        for fe in r0.frontends:
            m = math.lcm(m, r0.decim * fe.Q * 128)
    L = ((1 << 20) // m + 1) * m
    return L if L <= cap else None


def visited_plans(mgr, ops: list) -> list:
    """Every distinct plan ``ops`` take ``mgr``'s demods through, the
    starting one first (``mgr`` is left edited)."""
    from cubicsdr_tpu_torch.receiver import plan_from_manager
    plans = [plan_from_manager(mgr)[0]]
    for path, body in ops:
        if path == "/api/control" and apply_plan_op(mgr, body):
            specs = plan_from_manager(mgr)[0]
            if specs not in plans:
                plans.append(specs)
    return plans


class ChurnSetup:
    """What a churn plan needs: its rate, channel count, manager factory,
    survivor (offset and tone) and cycle."""

    def __init__(self, name: str, rate: float | None = None):
        self.name = name
        if name == "serve":
            from cubicsdr_tpu_torch.receiver import DemodulatorMgr
            self.rate = float(rate or 2_400_000.0)
            self.num_channels = None
            self.offset, self.tone = 200e3, 1000.0

            def manager():
                mgr = DemodulatorMgr()
                mgr.new_demodulator(CENTER + self.offset, "FM", 200000)
                return mgr
            self.manager = manager
            self.cycle = serve_cycle
        elif name == "scan58":
            from cubicsdr_tpu_torch.utils.synth import scan58
            plan = scan58()
            self.plan = plan
            self.rate = float(rate or plan.fs)
            if self.rate != plan.fs:
                raise ValueError("scan58 runs at its own 8 MS/s")
            self.num_channels = plan.num_channels
            self.offset = float(plan.freqs[0][0])
            self.tone = float(plan.stations[0].tone)
            self.manager = lambda: plan.manager(CENTER)
            n0 = sum(len(f) for f in plan.freqs)
            self.cycle = (lambda tmp: scan58_cycle(
                tmp, n0, CENTER + self.offset))
        else:
            raise ValueError(f"unknown churn plan {name!r}")

    def loop(self, fmt: str, device) -> np.ndarray:
        """One second of the capture as cs16/cs8 planes."""
        if self.name == "serve":
            return quantize(fm_loop(self.rate, self.offset, self.tone), fmt)
        planes = self.plan.capture(int(self.rate), device).cpu().numpy()
        return quantize(planes, fmt, 0.9)


def churn_soak(args) -> dict:
    """The live loop at the capture rate under REST plan-edit cycles."""
    from cubicsdr_tpu_torch.app.runner import POST_CACHE, LiveReceiver
    from cubicsdr_tpu_torch.app.webview import WebViewer
    from cubicsdr_tpu_torch.receiver import (
        ReceiverPipeline, controls_from_manager, plan_from_manager)
    dev = _device(args.device)
    on_card = dev.type == "cuda"
    setup = ChurnSetup(args.plan, args.rate)
    rate = setup.rate
    tmp = tempfile.mkdtemp(prefix="cs-churn-")
    plans = visited_plans(setup.manager(), setup.cycle(tmp))
    L = pinned_block_len(rate, plans, setup.num_channels)
    if L is None:
        raise ValueError(f"no common block length under 2^23 for the "
                         f"{len(plans)} plans of {setup.name}'s cycle")
    mgr = setup.manager()
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(rate, specs, num_channels=setup.num_channels,
                          block_len=L, device=dev)
    fmt = args.format
    dt = {"cs16": np.int16, "cs8": np.int8}[fmt]
    src = PacedSource(setup.loop(fmt, dev), L, rate)

    # The consumer's block gaps: per sampling period and while a
    # background zoom build runs.
    gaps = {"last": None, "period_max": 0.0, "zoom_build_max": 0.0,
            "backlog_max": 0.0, "finished": 0}

    def on_block(out):
        now = time.perf_counter()
        gaps["finished"] += 1
        if gaps["last"] is not None:
            g = now - gaps["last"]
            gaps["period_max"] = max(gaps["period_max"], g)
            if _prewarm_running():
                gaps["zoom_build_max"] = max(gaps["zoom_build_max"], g)
        gaps["last"] = now
        gaps["backlog_max"] = max(gaps["backlog_max"],
                                  lr.ring.readable / rate)

    lr = LiveReceiver(rx, controls_from_manager(mgr, rx, keyed, CENTER), src,
                      center_freq=CENTER, waterfall_fft=1024,
                      waterfall_lines=64, ring_seconds=8.0,
                      ingest_dtype=dt, on_block=on_block)
    wire = None
    if on_card:
        wire = wire_probe(dev, src.block(0))
    viewer = WebViewer(lr, mgr, keyed, port=0).start()
    port = viewer.port
    tones = ToneWindows(setup.tone)
    sink = {"k": 0, "path": None}

    def post(path, body):
        r = json.loads(http(port, path, body))
        if not r.get("ok"):
            raise AssertionError(f"churn {path} {body}: {r}")
        if lr.pipeline.block_len != L:
            raise AssertionError(f"churn {body}: block_len "
                                 f"{lr.pipeline.block_len} != pinned {L}")
        return r

    def attach_survivor(op=post):
        """Point a subset sink at the survivor (index 0): a restore makes
        new instances, so it is re-pointed after each, into a new file;
        the closed file's windows are counted and it is removed."""
        old = sink["path"]
        sink["k"] += 1
        sink["path"] = Path(tmp) / f"survivor_{sink['k']}.wav"
        op("/api/control", {"action": "audio_output", "name": "surv",
                            "backend": f"wav:{sink['path']}",
                            "demods": [0]})
        if old is not None:
            tones.add_file(old)
            old.unlink()

    consumer_exc = []
    stop = threading.Event()

    def consume():
        try:
            while not stop.is_set():
                lr.run_blocks(max_blocks=4)
        except Exception as e:               # noqa: BLE001 — the verdict
            consumer_exc.append(repr(e))

    # The first zoom-on builds its level on the POST's thread: its ms
    # with the level's build inside (the rest is host set-up).
    zoom_cold = {}

    def churn_cycle(warm=False):
        """One cycle. With ``warm`` it waits after each op for two
        finished blocks, so that a block is dispatched in every state the
        cycle passes through and builds its post-step (the 0.3 s op gap
        is shorter than a block at 2.4 MS/s)."""
        def op(path, body):
            t, n = time.perf_counter(), gaps["finished"]
            post(path, body)
            if (not zoom_cold and body.get("action") == "zoom"
                    and body["offset"] is not None):
                ms, split = lr.zoom.level_build_ms
                zoom_cold.update(
                    post_ms=(time.perf_counter() - t) * 1e3,
                    build_ms=ms, build_split_ms=split)
            while warm and gaps["finished"] < n + 2 and not consumer_exc:
                time.sleep(0.002)

        for path, body in setup.cycle(tmp):
            op(path, body)
            time.sleep(OP_GAP_S)
        op("/api/session", {"op": "checkpoint", "path": f"{tmp}/ck.json"})
        op("/api/session", {"op": "restore", "path": f"{tmp}/ck.json"})
        attach_survivor(op)

    def allocator():
        st = torch.cuda.memory_stats(dev) if on_card else {}
        return {k: st.get(f"{k}.all.current") for k in (
            "segment", "inactive_split_bytes")}

    def audio_tap():
        """Blocks in the live loop's audio tap, the host bytes they keep
        (a mix that is a view keeps its base) and the mixes' own bytes."""
        tap = list(lr.audio_tap)
        held = {id(m if m.base is None else m.base):
                (m if m.base is None else m.base).nbytes for m in tap}
        return {"audio_tap_blocks": len(tap),
                "audio_tap_bytes": sum(held.values()),
                "audio_mix_bytes": sum(m.nbytes for m in tap)}

    def caches():
        return {**lr.cache_stats(), "plan_cache": viewer.plan_cache_size}

    t_start = time.perf_counter()
    lr.start_producer()
    th = threading.Thread(target=consume, daemon=True, name="cs-consume")
    th.start()
    attach_survivor()
    samples, cycle_marks = [], []
    warm_s = 0.0
    try:
        # Warm: build every step, post-step and zoom level the cycle
        # reaches (drops here are expected and not counted).
        # The first warm cycle waits for blocks after each op, to build
        # every post-step; the others run as the measured cycles do.
        for c in range(WARM_CYCLES):
            churn_cycle(warm=c == 0)
            if consumer_exc:
                break
        # The loop's audio tap keeps its last 64 blocks' mixes: the
        # measured window starts once it is full, as every cache is.
        while (WARM_CYCLES and not consumer_exc
               and len(lr.audio_tap) < lr.audio_tap.maxlen):
            time.sleep(0.05)
        warm_s = time.perf_counter() - t_start
        warm_gap = {"longest_block_gap_s": gaps["period_max"],
                    "longest_gap_during_zoom_build_s":
                        gaps["zoom_build_max"]}
        builds_warm = caches()
        # Measure: re-base the source, reset the counters, churn.
        src.reset()
        time.sleep(2 * L / rate)
        lr.metrics = type(lr.metrics)()
        gaps.update(period_max=0.0, zoom_build_max=0.0, backlog_max=0.0)
        t0 = time.perf_counter()
        total = 60.0 * args.minutes
        period = min(SAMPLE_S, max(total / 6.0, 1.0))
        deadline = t0 + total
        next_sample = t0

        # RSS is read as the process holds it: a forced collection
        # returns the heap's free top to the system, and the next
        # minute's ordinary work maps it back in.
        def sample():
            snap = lr.metrics.snapshot()
            s = {"minute": (time.perf_counter() - t0) / 60.0,
                 "rss_bytes": rss_bytes(),
                 "memory_reserved": (torch.cuda.memory_reserved(dev)
                                     if on_card else None),
                 "memory_allocated": (torch.cuda.memory_allocated(dev)
                                      if on_card else None),
                 **allocator(),
                 **caches(), **audio_tap(),
                 "ring_dropped": int(snap.get("ingest", {}).get(
                     "dropped", 0)),
                 "pipeline_dropped": int(snap.get("pipeline", {}).get(
                     "dropped", 0)),
                 "longest_block_gap_s": gaps["period_max"],
                 "backlog_peak_s": gaps["backlog_max"],
                 "producer_late_s": src.late_s}
            gaps.update(period_max=0.0, backlog_max=0.0)
            samples.append(s)

        sample()
        next_sample += period
        cycles = 0
        while not consumer_exc:          # at least one cycle
            churn_cycle()
            cycles += 1
            cycle_marks.append({"cycle": cycles, "minute": (
                time.perf_counter() - t0) / 60.0, "rss_bytes": rss_bytes(),
                **caches()})
            if time.perf_counter() >= next_sample:
                sample()
                while next_sample <= time.perf_counter():
                    next_sample += period
            if time.perf_counter() >= deadline:
                break
        wall = time.perf_counter() - t0
        snap = lr.metrics.snapshot()
        sample()
    finally:
        stop.set()
        src.stop()                       # the consumer's run_blocks ends
        th.join(timeout=60)
        lr.stop()
        viewer.stop()
        join_prewarms()
    tones.add_file(sink["path"])
    shutil.rmtree(tmp, ignore_errors=True)

    blocks_n = int(snap.get("pipeline", {}).get("blocks", 0))
    samples_n = int(snap.get("pipeline", {}).get("samples", 0))
    msps = samples_n / wall / 1e6
    drops = {"ingest": int(snap.get("ingest", {}).get("dropped", 0)),
             "pipeline": int(snap.get("pipeline", {}).get("dropped", 0))}
    mem = memory_verdict(samples)
    per_cycle = [{"cycle": m["cycle"], "minute": m["minute"],
                  "rss_bytes": m["rss_bytes"],
                  "steps_built": m["step_builds"] - p["step_builds"],
                  "post_steps_built": m["post_builds"] - p["post_builds"]}
                 for p, m in zip([builds_warm] + cycle_marks, cycle_marks)]
    tone_ok = tones.windows >= 8 and tones.good >= tones.windows - 1
    res = {"tag": "churn_soak", "plan": setup.name, "device": str(dev),
           "card": card_name() if on_card else None, "format": fmt,
           "rate_msps": rate / 1e6, "M": rx.M, "block_len": L,
           "plans_visited": len(plans),
           "fused_route": rx.fused_route, "post_cache_bound": POST_CACHE,
           "wire_mb_per_s": wire, "warm_cycles": WARM_CYCLES,
           "warmup_s": warm_s, **{f"warm_{k}": v for k, v in warm_gap.items()},
           "builds_after_warm": builds_warm, "zoom_cold_level": zoom_cold,
           "minutes": wall / 60.0,
           "churn_cycles": cycles,
           "rest_ops": cycles * (len(setup.cycle(tmp)) + 3),
           "blocks": blocks_n, "sustained_msps": msps,
           "realtime_factor": msps * 1e6 / rate,
           "ring_dropped_samples": drops["ingest"],
           "pipeline_dropped_samples": drops["pipeline"],
           "producer_late_s_max": max(s["producer_late_s"]
                                      for s in samples),
           "survivor_tone_windows": [tones.good, tones.windows],
           "builds_per_cycle": per_cycle,
           "steps_built_after_warm": sum(c["steps_built"]
                                         for c in per_cycle),
           "post_steps_built_after_warm": sum(c["post_steps_built"]
                                              for c in per_cycle),
           **mem,
           "samples": samples, "consumer_exceptions": consumer_exc}
    res["ok"] = bool(not consumer_exc and not any(drops.values())
                     and msps * 1e6 >= REALTIME * rate and tone_ok
                     and mem["rss_ok"] and mem["reserved_ok"])
    return res


MODES = {"soak": soak, "churn_soak": churn_soak,
         "digital_check": digital_check}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    d = sub.add_parser("digital_check")
    d.add_argument("--blocks", type=int, default=8)
    c = sub.add_parser("churn_soak")
    c.add_argument("--minutes", type=float, default=5.0)
    c.add_argument("--format", choices=["cs16", "cs8"], default="cs16")
    c.add_argument("--plan", choices=["serve", "scan58"], default="serve")
    c.add_argument("--rate", type=float, default=None,
                   help="capture rate (default: the plan's own)")
    s = sub.add_parser("soak")
    s.add_argument("--rate", type=float, default=4_800_000.0)
    s.add_argument("--minutes", type=float, default=3.0)
    s.add_argument("--format", choices=["cs16", "cs8"], default="cs8")
    s.add_argument("--ring", type=float, default=4.0,
                   help="ring depth in seconds (deeper rings ride longer "
                        "transients)")
    for p in (d, c, s):
        p.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    res = MODES[args.mode](args)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
