"""Mean device ms per block of the packed post-step's graph replay
(re-block, spectrum EMA, demod view, packing; between the timing events
at the graph's start and end) over the traced run's unprofiled window
blocks, from the program's spans (``cubicsdr_tpu_torch/app/runner.py``
``block_spans``); none on the CPU."""

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
    ms = block_spans(log, N_WARM, N_WARM + n)["device.post"]
    ms = ms[np.isfinite(ms)]
    return float(np.mean(ms)) if len(ms) else None
