"""Device ms per block: the union of the kernel and copy intervals of one
block's device work (from one PFB launch to the next) in the profiled
part of the traced run, averaged over its complete blocks."""


def read(rec):
    blocks = rec.get("blocks")
    if not blocks:
        return None
    return sum(b["busy_ns"] for b in blocks) / len(blocks) / 1e6
