"""The body of the step's layer readers (``chan_device_ms``,
``route_device_ms``, ``kits_device_ms``): the mean device ms per block of
one layer of the receive step's graph replay (between the timing events
the program marks at the layer's start and end) over the traced run's
unprofiled window blocks, from the program's spans
(``cubicsdr_tpu_torch/app/runner.py`` ``block_spans``); none on the CPU,
or where the program records no such span."""

import numpy as np


def layer_ms(rec, span: str):
    """The mean ms of the span ``span`` (module docstring), or None."""
    try:
        from benchmark.run import N_WARM
        from cubicsdr_tpu_torch.app.runner import block_spans
        from cubicsdr_tpu_torch.utils.metrics import SPANS
    except ImportError:                  # a program without the spans
        return None
    log, n = SPANS.latest(), rec.get("host_blocks")
    if log is None or not n:
        return None
    ms = block_spans(log, N_WARM, N_WARM + n).get(span)
    if ms is None:                       # a program without this span
        return None
    ms = ms[np.isfinite(ms)]
    return float(np.mean(ms)) if len(ms) else None
