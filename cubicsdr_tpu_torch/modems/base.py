"""Modem base class, factory registry and settings introspection
(``cubicsdr_tpu/modems/base.py``; ref: src/modules/modem/Modem.h:65-153,
Modem.cpp:40-73).

A modem *builds* a kit: a StreamOp that turns IQ blocks at the modem
bandwidth into audio blocks at the audio rate (analog), or into symbol
dicts (digital). Settings are typed ``ModemArg``s (ModemArgInfo) and
default from ``get_settings()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from cubicsdr_tpu_torch.ops.planar import PLANAR
from cubicsdr_tpu_torch.stream.op import StreamOp

MIN_BANDWIDTH = 500           # ref: src/modules/modem/Modem.h:13
DEFAULT_AUDIO_RATE = 48000


@dataclasses.dataclass
class ModemArg:
    """Typed, introspectable modem setting (ModemArgInfo analog)."""
    key: str
    name: str
    value: Any
    arg_type: str = "float"           # float | int | string
    units: str = ""
    description: str = ""
    low: Optional[float] = None
    high: Optional[float] = None
    options: Optional[list] = None


_MODEM_REGISTRY: dict[str, type] = {}


def register_modem(cls):
    """Class decorator: Modem::addModemFactory analog."""
    _MODEM_REGISTRY[cls.name] = cls
    return cls


def make_modem(name: str, **settings) -> "Modem":
    """Modem::makeModem analog."""
    m = _MODEM_REGISTRY[name]()
    for k, v in settings.items():
        m.write_setting(k, v)
    return m


def modem_names(modem_type: str | None = None) -> list[str]:
    """Registered modem names in registration order, optionally of one
    ``modem_type`` ("analog" or "digital")."""
    return [n for n, c in _MODEM_REGISTRY.items()
            if modem_type is None or c.modem_type == modem_type]


class Modem:
    """Host-side modem object: holds settings, builds kits."""

    name: str = "?"
    modem_type: str = "analog"
    default_sample_rate: int = 200000

    def __init__(self):
        self.settings: dict[str, Any] = {
            a.key: a.value for a in self.get_settings()}

    def get_settings(self) -> list[ModemArg]:
        return []

    def read_setting(self, key: str):
        return self.settings.get(key)

    def write_setting(self, key: str, value):
        self.settings[key] = value

    @classmethod
    def check_sample_rate(cls, sample_rate: int, audio_rate: int) -> int:
        return max(int(sample_rate), MIN_BANDWIDTH)

    def block_multiple(self, sample_rate: int, audio_rate: int) -> int:
        """Input block length must be a multiple of this."""
        return 1

    def build_kit(self, sample_rate: int,
                  audio_rate: int = DEFAULT_AUDIO_RATE,
                  batch_shape: tuple = (), dtype=PLANAR) -> StreamOp:
        raise NotImplementedError

    def uses_signal_output(self) -> bool:
        """Whether squelch level is computed from demodulated audio instead
        of IQ magnitude (ref: DemodulatorThread.cpp:149)."""
        return False
