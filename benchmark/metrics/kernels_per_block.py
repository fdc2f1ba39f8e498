"""Device kernels and copies per block in the profiled part of the traced
run: the most common count over its complete blocks (an exact count)."""

import statistics


def read(rec):
    blocks = rec.get("blocks")
    if not blocks:
        return None
    return float(statistics.mode(b["kernels"] for b in blocks))
