"""Seconds of set-up spent building compiled steps: the sum of the
``compiled.build`` spans (on the card each step's warm-ups and graph
captures, on the CPU its first call) that end after the live loop's
metrics were made and before the first window block's
``step.dispatch``, from the program's spans (``cubicsdr_tpu_torch/
utils/compiled.py``, ``app/runner.py`` ``block_spans``)."""


def read(rec):
    try:
        from benchmark.run import N_WARM
        from cubicsdr_tpu_torch.app.runner import block_spans
        from cubicsdr_tpu_torch.utils.metrics import SPANS
    except ImportError:                  # a program without the spans
        return None
    log = SPANS.latest()
    if log is None or not rec.get("host_blocks"):
        return None
    first = block_spans(log, N_WARM, N_WARM + 1)["step.dispatch"][0]
    if not len(first) or not first[0]:
        return None
    b = SPANS.process.rows(("compiled.build",))
    top = (b["end"] > log.opened_ns) & (b["end"] < first[0])
    if not top.any():
        return None
    return float((b["end"] - b["start"])[top].sum()) / 1e9
