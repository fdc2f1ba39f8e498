"""Modem library — factory registry and the ported analog modems
(``cubicsdr_tpu/modems``; ref: src/modules/modem/Modem.h:129-153)."""

from cubicsdr_tpu_torch.modems.base import (  # noqa: F401
    MIN_BANDWIDTH, Modem, make_modem, register_modem)
from cubicsdr_tpu_torch.modems import analog  # noqa: F401
