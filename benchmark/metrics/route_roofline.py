"""The fused route + NCO + first resample stage's share of its roofline,
in %: the least time one H100 needs for a block's route work summed over
the fused groups (``roofline.py``, from the configuration's shapes and
the reference's filter designs) over the measured device time of the
kernels named ``route_kernel`` per block."""

from benchmark.roofline import least_ms

KERNEL = "route_kernel"


def read(rec):
    blocks, work = rec.get("blocks"), rec.get("work")
    if not blocks or not work or not work["route"]:
        return None
    ns = sum(t for b in blocks for name, t in b["ns_by_name"].items()
             if KERNEL in name) / len(blocks)
    if ns <= 0:
        return None
    return 100.0 * sum(least_ms(f, n) for f, n in work["route"]) / (ns / 1e6)
