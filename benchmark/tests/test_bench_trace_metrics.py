"""The readers of the program's spans on a traced run at a size a CPU
test holds: the four host readers find what the live loop recorded, and
the two device readers, which read CUDA events, find nothing there."""

from __future__ import annotations

from benchmark import run

HOST = ("program_delay_ms", "ready_to_dispatch_ms", "stage_ms",
        "graph_build_s")
DEVICE = ("step_device_ms", "post_device_ms")


def test_the_span_readers_on_a_traced_cpu_run(fm_small):
    root, spec = fm_small
    rc, res = run.run_cell("small.realtime", 2**31 + 17, 1.0, True,
                           spec=spec, device="cpu", root=root,
                           log=lambda s: None)
    assert rc == 0 and res["correct"], res["checks"]
    got = res["metrics"]
    for name in HOST:
        assert name in got and got[name]["value"] > 0, (name, got)
    for name in DEVICE:
        assert name not in got, (name, got)
    # The chain's parts: ready to dispatch lies inside the whole delay.
    assert got["ready_to_dispatch_ms"]["value"] \
        < got["program_delay_ms"]["value"]
