"""The counts of roofline.py reproduce chip_smoke.py's, which PERF.md's
kernel table lists: the PFB at M = 16 over 128,000 steps, 0.119 GFLOP and
24.6 MB; the route 1/5 at N = 16 over 128,000-sample channels, 0.209
GFLOP and 19.7 MB."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import roofline
from benchmark.reference.ops.resample import RationalResampler

ROOT = Path(__file__).resolve().parents[2]


def test_pfb_counts():
    flops, nbytes = roofline.pfb_counts(16, 8, 128_000)
    assert flops == pytest.approx(0.119e9, rel=5e-3)
    assert nbytes == pytest.approx(24.6e6, rel=5e-3)
    assert nbytes == 4 * (2 * (120 + 128_000 * 8) + 2 * 16 * 128_000
                          + 16 * 8)


def test_route_counts():
    rs = RationalResampler(1, 5, batch_shape=(16,))
    ci = np.arange(16) * 7 % 16
    flops, nbytes = roofline.route_counts(1, 5, 16, 128_000, rs.hist_len,
                                          len(set(ci.tolist())), rs.ker_np)
    assert flops == pytest.approx(0.209e9, rel=5e-3)
    assert nbytes == pytest.approx(19.7e6, rel=5e-3)


def test_least_time_takes_the_larger_bound():
    assert roofline.least_ms(0, 3.35e9) == pytest.approx(1.0)
    assert roofline.least_ms(67e9, 0) == pytest.approx(1.0)
    assert roofline.least_ms(67e9, 3.35e6) == pytest.approx(1.0)


def test_block_work_of_each_config():
    from benchmark.reference.step import RefDeployment
    for name, n_route in (("scan58", 6), ("fm16", 1)):
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json"
                          ).read_text())
        ref = RefDeployment(cfg, "cpu")
        work = roofline.block_kernel_work(ref.rx, ref.controls)
        assert len(work["pfb"]) == 1 and len(work["route"]) == n_route
        f, b = work["pfb"][0]
        assert (f, b) == roofline.pfb_counts(16, 8, cfg["block_len"] // 8)
        assert all(f > 0 and b > 0 for f, b in work["route"])
