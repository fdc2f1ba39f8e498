"""Modem library: factory registry, the analog bank and the digital bank
(``cubicsdr_tpu/modems``; ref: src/modules/modem/Modem.h:129-153)."""

from cubicsdr_tpu_torch.modems.base import (  # noqa: F401
    MIN_BANDWIDTH, Modem, ModemArg, make_modem, modem_names, register_modem)
from cubicsdr_tpu_torch.modems import analog  # noqa: F401
from cubicsdr_tpu_torch.modems import digital  # noqa: F401
