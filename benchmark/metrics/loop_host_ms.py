"""Host ms per block on the live loop's consumer thread in the step
dispatch, the post-step dispatch and the fan-out's finish
(``app/runner.py`` ``LiveReceiver``): the harness's spans around those
calls over the traced run's unprofiled part."""


def read(rec):
    if not rec.get("host_blocks"):
        return None
    return sum(rec["host_ms_per_block"].values())
