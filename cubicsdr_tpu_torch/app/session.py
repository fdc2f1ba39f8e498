"""SessionMgr — full receiver state save/load (the port's copy of
``cubicsdr_tpu/app/session.py``; both read and write the same files).

Schema parity with src/SessionMgr.cpp:7-196: center frequency, device sample
rate, solo mode, spectrum/waterfall view state, and every demodulator
instance (via DemodulatorMgr.save_instances, the loadInstance path
re-creates demods and clamps the device rate to capabilities).
"""

from __future__ import annotations

import json
import os
from typing import Optional


class SessionMgr:
    def __init__(self, mgr=None):
        self.mgr = mgr                      # DemodulatorMgr
        self.center_freq = 100_000_000
        self.sample_rate = 2_500_000
        self.solo_mode = False
        self.view_state = {                 # spectrum/waterfall view
            "view_enabled": False, "view_freq": 0, "view_bw": 0,
            "waterfall_lps": 30, "spectrum_avg": 0.65,
        }

    def save_session(self, path: str):
        doc = {
            "version": 1,
            "center_freq": self.center_freq,
            "sample_rate": self.sample_rate,
            "solo_mode": self.solo_mode,
            "view_state": self.view_state,
            "demodulators": self.mgr.save_instances() if self.mgr else [],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        return path

    def load_session(self, path: str,
                     supported_rates: Optional[list[int]] = None) -> bool:
        if not os.path.exists(path):
            return False
        with open(path) as f:
            doc = json.load(f)
        self.center_freq = int(doc.get("center_freq", self.center_freq))
        rate = int(doc.get("sample_rate", self.sample_rate))
        if supported_rates:
            # Clamp to the nearest capability (ref: SessionMgr.cpp rate
            # renegotiation on load).
            rate = min(supported_rates, key=lambda r: abs(r - rate))
        self.sample_rate = rate
        self.solo_mode = bool(doc.get("solo_mode", False))
        self.view_state.update(doc.get("view_state", {}))
        if self.mgr is not None:
            self.mgr.load_instances(doc.get("demodulators", []))
        return True
