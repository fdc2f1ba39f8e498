"""Digital-lab console: collects demodulated symbol streams as text (the
port's copy of ``cubicsdr_tpu/app/digital_console.py``).

DigitalConsole/ModemDigitalOutput analog (ref: src/forms/DigitalConsole/*,
src/modules/modem/ModemDigital.cpp:56-83): each digital demodulator can
attach a console that accumulates its bit/symbol text with optional
hex/ascii views.
"""

from __future__ import annotations

import numpy as np

from cubicsdr_tpu_torch.modems.digital import symbols_to_bits


class DigitalConsole:
    def __init__(self, bits_per_symbol: int = 1, max_chars: int = 1 << 20):
        self.bits_per_symbol = bits_per_symbol
        self.max_chars = max_chars
        self._text: list[str] = []
        self._len = 0

    def write_symbols(self, symbols: np.ndarray):
        s = symbols_to_bits(symbols, self.bits_per_symbol)
        self._text.append(s)
        self._len += len(s)
        while self._len > self.max_chars and len(self._text) > 1:
            self._len -= len(self._text.pop(0))

    @property
    def text(self) -> str:
        return "".join(self._text)

    def hex_view(self) -> str:
        bits = self.text
        out = []
        for i in range(0, len(bits) - 7, 8):
            out.append(f"{int(bits[i:i+8], 2):02x}")
        return " ".join(out)

    def ascii_view(self) -> str:
        bits = self.text
        out = []
        for i in range(0, len(bits) - 7, 8):
            v = int(bits[i:i + 8], 2)
            out.append(chr(v) if 32 <= v < 127 else ".")
        return "".join(out)

    def clear(self):
        self._text.clear()
        self._len = 0
