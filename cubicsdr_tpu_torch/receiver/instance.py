"""DemodulatorInstance — host-side receiver-channel object
(``cubicsdr_tpu/receiver/instance.py``; numpy-free host code, built on the
port's modem registry).

Property-parity with the reference's DemodulatorInstance
(ref: src/demod/DemodulatorInstance.h / .cpp:426-655): label/user label,
frequency, bandwidth, modem type + settings, squelch, gain, mute, solo,
follow/tracking, delta-lock, recording. The 3-thread pipeline it owned in
the reference is here a *row index* in the receiver's batched compiled
program; instances are pure state + metadata.
"""

from __future__ import annotations

import itertools
from typing import Optional

from cubicsdr_tpu_torch.modems import make_modem, Modem
from cubicsdr_tpu_torch.modems.base import DEFAULT_AUDIO_RATE

_ids = itertools.count(1)


class DemodulatorInstance:
    def __init__(self, frequency: float = 0.0, bandwidth: float = 200000,
                 demod_type: str = "FM", label: Optional[str] = None):
        self._id = next(_ids)
        self.frequency = float(frequency)
        self.bandwidth = float(bandwidth)
        self._type = demod_type
        self.modem: Modem = make_modem(demod_type)
        self.label = label or f"{self._id}"
        self.user_label = ""
        self.squelch_level = -100.0
        self.squelch_enabled = False
        self.gain = 1.0
        self.muted = False
        self.solo = False
        self.follow = False
        self.tracking = False
        self.delta_lock = False
        self.delta_lock_ofs = 0
        self.active = False
        self.recording = False
        self.audio_rate = DEFAULT_AUDIO_RATE
        self.output_device = -1          # host audio device id (UI concern)

    # --- type / settings ---
    @property
    def demod_type(self) -> str:
        return self._type

    def set_demod_type(self, name: str):
        if name != self._type:
            self._type = name
            self.modem = make_modem(name)
            self.bandwidth = float(self.modem.check_sample_rate(
                self.modem.default_sample_rate, self.audio_rate))

    def write_modem_settings(self, settings: dict):
        for k, v in settings.items():
            self.modem.write_setting(k, v)

    def read_modem_settings(self) -> dict:
        return dict(self.modem.settings)

    # --- bandwidth respects the modem's rate contract ---
    def set_bandwidth(self, bw: float):
        self.bandwidth = float(self.modem.check_sample_rate(
            int(bw), self.audio_rate))

    def halfband_offset(self) -> float:
        """USB/LSB render/hit-test one-sided (ref: DemodulatorMgr.cpp:170-188):
        effective band is [f, f+bw/2] for USB, [f-bw/2, f] for LSB."""
        if self._type == "USB":
            return self.bandwidth / 4
        if self._type == "LSB":
            return -self.bandwidth / 4
        return 0.0

    # --- persistence (ref: DemodulatorMgr::saveInstance/loadInstance,
    #     src/demod/DemodulatorMgr.cpp:417-560) ---
    def save(self) -> dict:
        return {
            "bandwidth": self.bandwidth,
            "frequency": self.frequency,
            "type": self._type,
            "user_label": self.user_label,
            "squelch_level": self.squelch_level,
            "squelch_enabled": self.squelch_enabled,
            "output_device": self.output_device,
            "gain": self.gain,
            "muted": self.muted,
            "delta_lock": self.delta_lock,
            "delta_ofs": self.delta_lock_ofs,
            "settings": self.read_modem_settings(),
        }

    @staticmethod
    def load(d: dict) -> "DemodulatorInstance":
        inst = DemodulatorInstance(
            frequency=d.get("frequency", 0.0),
            bandwidth=d.get("bandwidth", 200000),
            demod_type=d.get("type", "FM"))
        inst.user_label = d.get("user_label", "")
        inst.squelch_level = d.get("squelch_level", -100.0)
        inst.squelch_enabled = d.get("squelch_enabled", False)
        inst.output_device = d.get("output_device", -1)
        inst.gain = d.get("gain", 1.0)
        inst.muted = d.get("muted", False)
        inst.delta_lock = d.get("delta_lock", False)
        inst.delta_lock_ofs = d.get("delta_ofs", 0)
        inst.write_modem_settings(d.get("settings", {}))
        return inst

    def __repr__(self):
        return (f"<Demod #{self._id} {self._type} f={self.frequency/1e6:.4f}M"
                f" bw={self.bandwidth/1e3:.1f}k>")
