"""DSP ops of the receive step (planar or complex64 IQ, float32), with
the JAX package's ``cubicsdr_tpu.ops`` exports: ``design``, ``NCOMixer``,
``FirFilter``, ``FirDecimator``, ``DCBlocker``, ``SOSFilter``,
``FreqDem``, ``RationalResampler`` and ``design_ratio``.

The exports are resolved at first access: ``utils/convolve.py`` imports
``ops.planar``, which runs this file, and ``ops.fir`` imports
``utils/convolve.py``, so importing them here eagerly would be a cycle.
"""

import importlib

_EXPORTS = {
    "NCOMixer": "nco", "FirFilter": "fir", "FirDecimator": "fir",
    "DCBlocker": "iir", "SOSFilter": "iir", "FreqDem": "freqdem",
    "RationalResampler": "resample", "design_ratio": "resample",
}

__all__ = ["design", *_EXPORTS]


def __getattr__(name):
    if name == "design":
        return importlib.import_module(f"{__name__}.design")
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
