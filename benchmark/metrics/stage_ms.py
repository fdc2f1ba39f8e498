"""Mean ms per block of the staging worker's ``stage`` (from the ring
holding the block: the ring read, the pinned-slot fill and the
host->device copy's enqueue) over the traced run's unprofiled window
blocks, from the program's spans (``cubicsdr_tpu_torch/app/runner.py``
``block_spans``)."""

import numpy as np


def read(rec):
    try:
        from benchmark.run import N_WARM
        from cubicsdr_tpu_torch.app.runner import block_spans
        from cubicsdr_tpu_torch.utils.metrics import SPANS
    except ImportError:                  # a program without the spans
        return None
    log, n = SPANS.latest(), rec.get("host_blocks")
    if log is None or not n:
        return None
    a, e = block_spans(log, N_WARM, N_WARM + n)["stage"]
    ms = (e - a)[a > 0] / 1e6
    return float(np.mean(ms)) if len(ms) else None
