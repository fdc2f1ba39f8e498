"""Median ms, over the traced run's unprofiled window blocks, from a
block's ready time (the end of the ring write that holds its last
sample) to the start of its ``step.dispatch``: the consumer's poll, the
hops to and from the staging worker and the stage itself, from the
program's spans (``cubicsdr_tpu_torch/app/runner.py``
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
    b = block_spans(log, N_WARM, N_WARM + n)
    ready, start = b["ready"], b["step.dispatch"][0]
    ms = (start - ready)[(ready > 0) & (start > 0)] / 1e6
    return float(np.median(ms)) if len(ms) else None
