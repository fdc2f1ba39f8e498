"""The reduction of a traced window (trace.py) and the per-layer readers
on a synthetic trace: blocks cut at each PFB launch, busy time as the
union of device intervals, idle gaps labelled by the open host span."""

from __future__ import annotations

import pytest

from benchmark import registry, roofline, trace

MS = 1_000_000          # ns


def synthetic():
    """Three blocks, 10 ms apart: a PFB kernel (1 ms), a route kernel
    (2 ms) overlapping a copy (1 ms), then a 0.5 ms kernel."""
    dev, host = [], []
    for i in range(3):
        t = i * 10 * MS
        dev += [("void pfbch2_kernel<16>(float)", t, t + MS),
                ("void route_kernel<5, 5>(float)", t + MS, t + 3 * MS),
                ("Memcpy HtoD (Pinned -> Device)", t + 2 * MS, t + 4 * MS),
                ("void at::add_kernel", t + 5 * MS, t + 5 * MS + MS // 2)]
        host += [("bench.step_dispatch", t - 2 * MS, t),
                 ("bench.fanout_finish", t + 6 * MS, t + 9 * MS)]
    return dev, host


def test_blocks_are_cut_at_each_pfb_launch():
    dev, _ = synthetic()
    blocks = trace.blocks(dev)
    assert len(blocks) == 2                   # complete blocks only
    for b in blocks:
        assert b["kernels"] == 4
        assert b["busy_ns"] == 4 * MS + MS // 2
        assert b["ns_by_name"]["void route_kernel<5, 5>(float)"] == 2 * MS


def test_breakdown_labels_idle_gaps_by_host_span():
    dev, host = synthetic()
    bd = trace.breakdown(dev, host)
    assert bd["device_ops"][0][0].startswith("void route_kernel")
    gaps = dict((round(s * 1e3, 3), label) for label, s in bd["idle_gaps"])
    assert gaps[4.5] == "idle during fanout_finish"
    assert gaps[1.0] == "idle during staging_wait_or_other"
    assert trace.busy_seconds(dev) == pytest.approx(3 * 4.5e-3)


def test_readers_on_the_synthetic_trace():
    dev, _ = synthetic()
    work = {"pfb": [(0.0, 3.35e12 * 0.5e-3)],     # 0.5 ms at the HBM rate
            "route": [(67e12 * 0.2e-3, 0.0)]}      # 0.2 ms at the f32 peak
    rec = {"blocks": trace.blocks(dev), "work": work,
           "host_ms_per_block": {"a": 1.0, "b": 0.5}, "host_blocks": 10}

    def read(name):
        return registry.metric_reader(name)(rec)

    assert read("device_busy_ms") == pytest.approx(4.5)
    assert read("kernels_per_block") == 4.0
    assert read("pfb_roofline") == pytest.approx(50.0)
    assert read("route_roofline") == pytest.approx(10.0)
    assert read("loop_host_ms") == pytest.approx(1.5)
    # Nothing to read: no value, never a share of 0.
    empty = {}
    for name in ("device_busy_ms", "kernels_per_block", "pfb_roofline",
                 "route_roofline", "loop_host_ms"):
        assert registry.metric_reader(name)(empty) is None
    assert roofline.least_ms(*work["pfb"][0]) == pytest.approx(0.5)
