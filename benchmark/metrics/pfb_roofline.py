"""The channelizer's share of its roofline, in %: the least time one
H100 needs for a block's PFBCH2 analysis (``roofline.py``, from the
configuration's shapes) over the measured device time of the kernels
named ``pfbch2_kernel`` per block."""

from benchmark.roofline import least_ms

KERNEL = "pfbch2_kernel"


def read(rec):
    blocks, work = rec.get("blocks"), rec.get("work")
    if not blocks or not work or not work["pfb"]:
        return None
    ns = sum(t for b in blocks for name, t in b["ns_by_name"].items()
             if KERNEL in name) / len(blocks)
    if ns <= 0:
        return None
    return 100.0 * sum(least_ms(f, n) for f, n in work["pfb"]) / (ns / 1e6)
