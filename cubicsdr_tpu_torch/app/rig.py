"""Rig (transceiver CAT) control (the port's copy of
``cubicsdr_tpu/app/rig.py``).

RigThread analog (ref: src/rig/RigThread.cpp): 150 ms poll cadence, four
interaction modes — control (app drives rig frequency), follow (rig drives
app), center lock, follow-modem (rig tracks the active demodulator) — and
error-code surfacing. The hamlib backend is optional; a SimulatedRig backs
tests and hamlib-less datacenter hosts.
"""

from __future__ import annotations

import enum
import time
from typing import Callable, Optional

POLL_INTERVAL_S = 0.15      # ref: src/rig/RigThread.cpp:133-134


class RigError(enum.IntEnum):
    OK = 0
    TIMEOUT = 1
    IO = 2
    NOT_SUPPORTED = 3
    BUSY = 4

    def message(self) -> str:
        return {                      # ref error mapping RigThread.cpp:47-104
            RigError.OK: "OK",
            RigError.TIMEOUT: "Rig communication timed out",
            RigError.IO: "Rig I/O error",
            RigError.NOT_SUPPORTED: "Operation not supported by rig",
            RigError.BUSY: "Rig busy",
        }[self]


class SimulatedRig:
    """In-memory rig for tests and demo mode."""

    def __init__(self, frequency: float = 14.074e6):
        self.frequency = frequency
        self.fail_with: Optional[RigError] = None

    def get_frequency(self) -> float:
        if self.fail_with:
            raise RigIOError(self.fail_with)
        return self.frequency

    def set_frequency(self, f: float):
        if self.fail_with:
            raise RigIOError(self.fail_with)
        self.frequency = f


class RigIOError(Exception):
    def __init__(self, code: RigError):
        super().__init__(code.message())
        self.code = code


class RigController:
    """Mode logic decoupled from any thread: call ``poll()`` at the poll
    cadence with the app's current state; it returns actions."""

    def __init__(self, rig, get_app_freq: Optional[Callable[[], float]] = None,
                 set_app_freq: Optional[Callable[[float], None]] = None):
        self.rig = rig
        self.get_app_freq = get_app_freq
        self.set_app_freq = set_app_freq
        self.control_mode = True       # app -> rig
        self.follow_mode = True        # rig -> app
        self.center_lock = False
        self.follow_modem = False
        self.last_error = RigError.OK
        self._last_rig = None
        self._last_app = None

    def poll(self, modem_freq: Optional[float] = None):
        try:
            rig_f = self.rig.get_frequency()
            app_f = self.get_app_freq()
            if self._last_rig is None:
                self._last_rig, self._last_app = rig_f, app_f
            rig_moved = rig_f != self._last_rig
            app_moved = app_f != self._last_app
            if self.follow_modem and modem_freq is not None \
                    and modem_freq != rig_f:
                self.rig.set_frequency(modem_freq)
                rig_f = modem_freq
            elif rig_moved and self.follow_mode and not self.center_lock:
                self.set_app_freq(rig_f)
            elif app_moved and self.control_mode:
                self.rig.set_frequency(app_f)
                rig_f = app_f
            self._last_rig = rig_f
            self._last_app = self.get_app_freq()
            self.last_error = RigError.OK
        except RigIOError as e:
            self.last_error = e.code
        return self.last_error


def open_hamlib_rig(model: int, port: str, baud: int = 9600):
    """Real-hardware backend when the hamlib python bindings exist."""
    try:
        import Hamlib  # type: ignore
    except ImportError as e:
        raise RuntimeError("hamlib python bindings not installed") from e
    Hamlib.rig_set_debug(Hamlib.RIG_DEBUG_NONE)
    rig = Hamlib.Rig(model)
    rig.set_conf("rig_pathname", port)
    rig.set_conf("serial_speed", str(baud))
    rig.open()

    class _HamlibRig:
        def get_frequency(self):
            return rig.get_freq()

        def set_frequency(self, f):
            rig.set_freq(Hamlib.RIG_VFO_CURR, f)

    return _HamlibRig()
