"""Piecewise-linear color gradients + named themes (numpy only; re-homed
from ``cubicsdr_tpu/visual/gradient.py``, whose package imports jax).

Role of util/Gradient + visual/ColorTheme in the reference (ref:
src/util/Gradient.h:19-40, src/visual/ColorTheme.h:13-21: 8 named themes
default/jet/bw/sharp/rad/touch/hd/radar). Palettes here are original
definitions in the same spirit (the exact reference colors are GPL'd
artwork; capability parity is the named-theme selection mechanism).
"""

from __future__ import annotations

import numpy as np


class Gradient:
    """Piecewise-linear RGB palette: generate(n) -> [n, 3] float in [0,1]."""

    def __init__(self, stops):
        """stops: list of (position 0..1, (r, g, b))."""
        self.stops = sorted(stops, key=lambda s: s[0])

    def generate(self, n: int = 256) -> np.ndarray:
        pos = np.array([s[0] for s in self.stops])
        cols = np.array([s[1] for s in self.stops], np.float32)
        x = np.linspace(0.0, 1.0, n)
        out = np.empty((n, 3), np.float32)
        for c in range(3):
            out[:, c] = np.interp(x, pos, cols[:, c])
        return out


THEMES: dict[str, Gradient] = {
    # deep blue -> cyan -> yellow -> white (the classic SDR waterfall look)
    "default": Gradient([(0.0, (0, 0, 0.2)), (0.35, (0, 0, 1)),
                         (0.60, (0, 1, 1)), (0.80, (1, 1, 0)),
                         (1.0, (1, 1, 1))]),
    "jet": Gradient([(0.0, (0, 0, 0.5)), (0.25, (0, 0.5, 1)),
                     (0.5, (0.5, 1, 0.5)), (0.75, (1, 0.5, 0)),
                     (1.0, (0.5, 0, 0))]),
    "bw": Gradient([(0.0, (0, 0, 0)), (1.0, (1, 1, 1))]),
    "sharp": Gradient([(0.0, (0, 0, 0)), (0.5, (0, 0, 1)),
                       (0.75, (1, 0, 1)), (1.0, (1, 1, 1))]),
    "rad": Gradient([(0.0, (0, 0.1, 0)), (0.5, (0, 0.8, 0)),
                     (0.8, (1, 1, 0)), (1.0, (1, 0.2, 0.2))]),
    "touch": Gradient([(0.0, (0.05, 0, 0.1)), (0.5, (0.6, 0, 0.8)),
                       (1.0, (1, 0.9, 1))]),
    "hd": Gradient([(0.0, (0, 0, 0)), (0.4, (0.1, 0.1, 0.6)),
                    (0.7, (0.9, 0.35, 0.05)), (1.0, (1, 1, 0.9))]),
    "radar": Gradient([(0.0, (0, 0.05, 0)), (0.7, (0, 0.9, 0.1)),
                       (1.0, (0.8, 1, 0.8))]),
}
