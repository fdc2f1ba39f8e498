"""Digital modem bank (``cubicsdr_tpu/modems/digital.py``; reference:
src/modules/modem/digital/**).

The reference slices EVERY sample against a liquid modemcf constellation
(no timing recovery; e.g. ModemBPSK.cpp:22-32), tracks an EVM-based lock
(ModemDigital.cpp:52-54, threshold 0.005), and streams symbol text to the
digital console. Here hard-decision slicing is an argmax over
constellation scores 2*Re{x conj(c_k)} - |c_k|^2, elementwise in float32
as the JAX package computes them (argmax takes the first maximum, as
``jnp.argmax`` does); FSK is a matched tone-filter bank over symbol
frames (a plain product, TF32 off); GMSK is the FM discriminator (a true
atan2) with integrate-and-dump.

Kits return dicts: {"symbols": int32 [..., L_sym], "evm": f32 [...],
"locked": bool [...]}.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.modems.base import (
    DEFAULT_AUDIO_RATE, Modem, ModemArg, register_modem)
from benchmark.reference.ops.planar import PLANAR, dtype_ones, planes_of
from benchmark.reference.stream.op import StreamOp

LOCK_EVM = 0.005      # ref: ModemDigital.cpp:52-54


# ------------------------------------------------------------ tables ----

def psk_constellation(m: int) -> np.ndarray:
    k = np.arange(m)
    return np.exp(2j * np.pi * k / m + 1j * (np.pi / 4 if m == 4 else 0))


def dpsk_constellation(m: int) -> np.ndarray:
    """Differential-phase table: increments at exactly 2*pi*k/m (no QPSK
    rotation: the data rides on the phase difference)."""
    return np.exp(2j * np.pi * np.arange(m) / m)


def ask_constellation(m: int) -> np.ndarray:
    lv = (2 * np.arange(m) - (m - 1)) / (m - 1 if m > 1 else 1)
    return lv.astype(np.complex128)


def qam_constellation(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    if side * side == m:
        re, im = np.meshgrid(np.arange(side), np.arange(side))
        pts = ((2 * re - (side - 1)) + 1j * (2 * im - (side - 1))).ravel()
    else:  # cross constellation (8, 32, 128...)
        side2 = int(np.sqrt(m * 2))
        re, im = np.meshgrid(np.arange(side2), np.arange(side2 // 2))
        pts = ((2 * re - (side2 - 1)) + 1j * (2 * im - (side2 // 2 - 1))
               ).ravel()
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def apsk_constellation(m: int) -> np.ndarray:
    rings = {4: [1, 3], 8: [1, 7], 16: [4, 12], 32: [4, 12, 16],
             64: [4, 14, 20, 26], 128: [8, 24, 40, 56],
             256: [6, 18, 32, 36, 46, 52, 66]}[m]
    pts = []
    for ri, cnt in enumerate(rings):
        r = ri + 1.0
        pts.extend(r * np.exp(2j * np.pi * (np.arange(cnt) + 0.5 * ri) / cnt))
    pts = np.asarray(pts)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def ook_constellation() -> np.ndarray:
    return np.asarray([0.0 + 0j, np.sqrt(2.0)])


def star32_constellation() -> np.ndarray:
    """'ST' 32-point star (liquid LIQUID_MODEM_ARB32OPT stand-in): two
    amplitude rings of 16-PSK."""
    inner = 0.6 * np.exp(2j * np.pi * np.arange(16) / 16)
    outer = 1.2 * np.exp(2j * np.pi * (np.arange(16) + 0.5) / 16)
    pts = np.concatenate([inner, outer])
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def sqam32_constellation() -> np.ndarray:
    """'SQAM' square-ish 32 (cross) constellation."""
    return qam_constellation(32)


# ------------------------------------------------------------- kits ----

def _top2_gap(scores):
    top = scores.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


class ConstellationKit(StreamOp):
    """Per-sample hard-decision slicer + EVM lock, batched. Differential
    slicing carries the previous sample as two real planes (1+0j at the
    start of the stream)."""

    def __init__(self, points: np.ndarray, differential: bool = False,
                 batch_shape: tuple = (), dtype=PLANAR):
        super().__init__()
        self.dtype = dtype
        pts = np.asarray(points, np.complex128)
        self.register_buffer("pts_re", torch.from_numpy(
            pts.real.astype(np.float32)))
        self.register_buffer("pts_im", torch.from_numpy(
            pts.imag.astype(np.float32)))
        self.register_buffer("pts2", torch.from_numpy(
            (np.abs(pts) ** 2).astype(np.float32)))
        self.differential = differential
        self.batch_shape = tuple(batch_shape)
        # Time-sharding: differential slicing carries the previous sample.
        self.shard_kind = "tail" if differential else "stateless"

    def state_from_tail(self, tail):
        re, im = planes_of(tail)
        return (re[..., 0], im[..., 0])

    def init_state(self):
        if self.differential:
            return (torch.ones(self.batch_shape, device=self.device),
                    torch.zeros(self.batch_shape, device=self.device))
        return ()

    def sliced(self, state, x):
        """(new state, (sr, si)): the samples the slicer scores, after the
        differential phase step when there is one."""
        xr, xi = planes_of(x)
        if not self.differential:
            return state, (xr, xi)
        pr, pi = state
        zr = torch.cat([pr[..., None], xr], dim=-1)
        zi = torch.cat([pi[..., None], xi], dim=-1)
        # z[1:] * conj(z[:-1]) / |z[:-1]|: the phase-difference slice.
        br, bi = zr[..., :-1], zi[..., :-1]
        mag = torch.sqrt(br * br + bi * bi).clamp_min(1e-9)
        sr = (zr[..., 1:] * br + zi[..., 1:] * bi) / mag
        si = (zi[..., 1:] * br - zr[..., 1:] * bi) / mag
        return (xr[..., -1], xi[..., -1]), (sr, si)

    def scores(self, sr, si):
        """[..., L, K] = 2*(sr*c_re + si*c_im) - |c|^2, elementwise
        float32 in the JAX package's order."""
        return (2.0 * (sr[..., None] * self.pts_re
                       + si[..., None] * self.pts_im) - self.pts2)

    def decision_margin(self, state, x):
        """[..., L]: the gap between the two best scores of each decision
        ``apply(state, x)`` makes (where rounding can flip a symbol)."""
        return _top2_gap(self.scores(*self.sliced(state, x)[1]))

    def apply(self, state, x):
        new_state, (sr, si) = self.sliced(state, x)
        syms = self.scores(sr, si).argmax(dim=-1).to(torch.int32)
        idx = syms.long()
        evm = ((sr - self.pts_re[idx]) ** 2
               + (si - self.pts_im[idx]) ** 2).mean(dim=-1)
        return new_state, {"symbols": syms, "evm": evm,
                           "locked": evm < LOCK_EVM}


class FSKKit(StreamOp):
    """Incoherent M-FSK: matched tone bank over symbol frames (product +
    argmax), fskdem semantics (m bits, k = rate/sps samples per symbol,
    normalized bandwidth bw; ref: ModemFSK.cpp:102-150)."""

    shard_kind = "stateless"

    def __init__(self, m_bits: int, k: int, bw: float,
                 batch_shape: tuple = ()):
        super().__init__()
        self.m = 1 << m_bits
        self.k = int(k)
        n = np.arange(self.k)
        # Tone frequencies span +-bw (normalized to the sample rate).
        f = (np.arange(self.m) - (self.m - 1) / 2) * (2.0 * bw / self.m)
        bank = np.exp(-2j * np.pi * np.outer(f, n))          # [M, k]
        self.register_buffer("bank_re", torch.from_numpy(
            bank.real.astype(np.float32)))
        self.register_buffer("bank_im", torch.from_numpy(
            bank.imag.astype(np.float32)))
        self.batch_shape = tuple(batch_shape)

    def energies(self, x):
        """Tone-bank energy [..., n_sym, M] per symbol frame."""
        assert x.shape[-1] % self.k == 0
        xr, xi = planes_of(x)
        fr_r = xr.reshape(*xr.shape[:-1], -1, self.k)
        fr_i = xi.reshape(*xi.shape[:-1], -1, self.k)
        cr = fr_r @ self.bank_re.T - fr_i @ self.bank_im.T
        ci = fr_r @ self.bank_im.T + fr_i @ self.bank_re.T
        return cr * cr + ci * ci

    def decision_margin(self, state, x):
        return _top2_gap(self.energies(x))

    def apply(self, state, x):
        energy = self.energies(x)
        syms = energy.argmax(dim=-1).to(torch.int32)
        best = energy.amax(dim=-1)
        tot = energy.sum(dim=-1)
        quality = (best / tot.clamp_min(1e-12)).mean(dim=-1)
        return state, {"symbols": syms, "evm": 1.0 - quality,
                       "locked": quality > 0.8}


class GMSKKit(StreamOp):
    """GMSK via discriminator + integrate-and-dump at sps samples/symbol
    (gmskdem stand-in; ref: ModemGMSK.cpp:95-134)."""

    shard_kind = "tail"

    def __init__(self, sps: int, batch_shape: tuple = (), dtype=PLANAR):
        super().__init__()
        self.sps = int(sps)
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype

    def state_from_tail(self, tail):
        re, im = planes_of(tail)
        return (re[..., 0], im[..., 0])

    def init_state(self):
        return (torch.ones(self.batch_shape, device=self.device),
                torch.zeros(self.batch_shape, device=self.device))

    def soft(self, prev, x):
        """(new prev, per-symbol mean discriminator output [..., n_sym])."""
        assert x.shape[-1] % self.sps == 0
        xr, xi = planes_of(x)
        pr, pi = prev
        zr = torch.cat([pr[..., None], xr], dim=-1)
        zi = torch.cat([pi[..., None], xi], dim=-1)
        dr = zr[..., 1:] * zr[..., :-1] + zi[..., 1:] * zi[..., :-1]
        di = zi[..., 1:] * zr[..., :-1] - zr[..., 1:] * zi[..., :-1]
        d = torch.atan2(di, dr) * float(np.float32(1.0 / np.pi))  # kf = 0.5
        fr = d.reshape(*d.shape[:-1], -1, self.sps)
        return (xr[..., -1], xi[..., -1]), fr.mean(dim=-1)

    def decision_margin(self, prev, x):
        return self.soft(prev, x)[1].abs()

    def apply(self, prev, x):
        prev, soft = self.soft(prev, x)
        syms = (soft > 0).to(torch.int32)
        mag = soft.abs()
        quality = torch.minimum(
            mag / mag.mean(dim=-1, keepdim=True).clamp_min(1e-9),
            torch.ones_like(mag)).mean(dim=-1)
        return prev, {"symbols": syms, "evm": 1.0 - quality,
                      "locked": quality > 0.7}


# ------------------------------------------------------ modem classes ----

class _DigitalModem(Modem):
    modem_type = "digital"
    default_sample_rate = 200000

    def bits_per_symbol(self) -> int:
        return 1


def _const_modem(name_, points_fn, orders=None, default_order=None,
                 differential=False):
    """Constellation modem, with an optional constellation-order setting
    choosing among the tables (ref: ModemPSK.cpp:7-14)."""

    class _M(_DigitalModem):
        name = name_

        def get_settings(self):
            if orders:
                return [ModemArg("cons", "Constellation", default_order,
                                 "int", options=list(orders))]
            return []

        def bits_per_symbol(self):
            m = int(self.settings.get("cons", default_order or 2))
            if not orders:
                m = len(np.atleast_1d(points_fn()))
            return max(1, int(np.log2(m)))

        def points(self) -> np.ndarray:
            if orders:
                return points_fn(int(self.settings.get("cons",
                                                       default_order)))
            return points_fn()

        def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                      batch_shape=(), dtype=PLANAR, time_axis=None):
            return ConstellationKit(self.points(), differential,
                                    batch_shape, dtype=dtype)

    _M.__name__ = _M.__qualname__ = f"Modem{name_}"
    return register_modem(_M)


ModemBPSK = _const_modem("BPSK", lambda: psk_constellation(2))
ModemQPSK = _const_modem("QPSK", lambda: psk_constellation(4))
ModemOOK = _const_modem("OOK", ook_constellation)
ModemST = _const_modem("ST", star32_constellation)
ModemSQAM = _const_modem("SQAM", sqam32_constellation)
ModemPSK = _const_modem("PSK", psk_constellation,
                        orders=[2, 4, 8, 16, 32, 64, 128, 256],
                        default_order=2)
ModemDPSK = _const_modem("DPSK", dpsk_constellation,
                         orders=[2, 4, 8, 16, 32, 64, 128, 256],
                         default_order=2, differential=True)
ModemASK = _const_modem("ASK", ask_constellation,
                        orders=[2, 4, 8, 16, 32, 64, 128, 256],
                        default_order=2)
ModemQAM = _const_modem("QAM", qam_constellation,
                        orders=[4, 8, 16, 32, 64, 128, 256],
                        default_order=4)
ModemAPSK = _const_modem("APSK", apsk_constellation,
                         orders=[4, 8, 16, 32, 64, 128, 256],
                         default_order=4)


@register_modem
class ModemFSK(_DigitalModem):
    name = "FSK"
    default_sample_rate = 19200     # ref: ModemFSK.cpp:29-30

    def get_settings(self):
        return [
            ModemArg("bps", "Bits per symbol", 1, "int", low=1, high=8),
            ModemArg("sps", "Symbols per second", 9600, "int",
                     low=1, high=921600),
            ModemArg("bw", "Signal bandwidth", 0.45, "float",
                     low=0.1, high=0.49),
        ]

    def bits_per_symbol(self):
        return int(self.settings["bps"])

    def block_multiple(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE):
        return max(int(sample_rate) // int(self.settings["sps"]), 1)

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=PLANAR, time_axis=None):
        return FSKKit(int(self.settings["bps"]),
                      self.block_multiple(sample_rate),
                      float(self.settings["bw"]), batch_shape)


@register_modem
class ModemGMSK(_DigitalModem):
    name = "GMSK"
    default_sample_rate = 19200     # ref: ModemGMSK.cpp:31-33

    def get_settings(self):
        return [ModemArg("sps", "Samples per symbol", 4, "int",
                         low=2, high=32)]

    def block_multiple(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE):
        return int(self.settings["sps"])

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=PLANAR, time_axis=None):
        return GMSKKit(int(self.settings["sps"]), batch_shape, dtype=dtype)


def symbols_to_bits(symbols: np.ndarray, bits_per_symbol: int) -> str:
    """Digital console text: symbol stream -> bit string
    (ref: ModemDigital::digitalOut path, DigitalConsole)."""
    return "".join(format(int(s), f"0{bits_per_symbol}b")
                   for s in np.asarray(symbols).ravel())
