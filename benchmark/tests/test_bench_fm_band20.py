"""The ``fm_band20`` configuration (the whole FM band from one 20 MS/s
HackRF) as the benchmark finds it: its file loads, its block is the one
the program chooses, one FM station sits under each demod on the band's
200 kHz grid, and its cell reports the receive step's three device
layers."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from benchmark import registry

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LAYERS = {"chan_device_ms", "route_device_ms", "kits_device_ms"}


def test_the_configuration_loads_with_the_program_s_block():
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    cfg = registry.config(SPEC, "fm_band20", ROOT)
    assert (cfg["sample_rate"], cfg["num_channels"], cfg["wire"]) == (
        20_000_000, 40, "cs8")
    assert cfg["reduced"] == []
    (g,) = cfg["groups"]
    rx = ReceiverPipeline(
        float(cfg["sample_rate"]),
        [DemodGroupSpec(g["modem"], int(g["bandwidth"]), int(g["count"]))],
        num_channels=int(cfg["num_channels"]), device="cpu")
    assert cfg["block_len"] == rx.choose_block_len() == 640_000
    assert rx.pfb_form == "product" and rx.fused_route == [True]


def test_one_station_under_each_demod_on_the_200_khz_grid():
    cfg = registry.config(SPEC, "fm_band20", ROOT)
    (g,) = cfg["groups"]
    offs = np.asarray(g["offsets"])
    assert (g["modem"], g["bandwidth"], g["count"]) == ("FM", 200000, 100)
    np.testing.assert_array_equal(offs, -9.9e6 + 0.2e6 * np.arange(100))
    st = cfg["capture"]["stations"]
    assert [s["frequency"] for s in st] == g["offsets"]
    assert {s["kind"] for s in st} == {"fm"}
    assert [s["tone"] for s in st] == [700.0 + 90.0 * i for i in range(100)]
    # 98 MHz plus the offsets: channels 201-300, 88.1 to 107.9 MHz.
    rf = 98e6 + offs
    assert rf[0] == 88.1e6 and rf[-1] == 107.9e6


def test_its_cell_reports_the_step_s_device_layers():
    (w,) = [w for w in SPEC["workloads"] if w["config"] == "fm_band20"]
    assert (w["name"], w["traffic"], w["chips"]) == (
        "fm_band20.realtime", "realtime", 1)
    traced = {m["name"] for m in
              registry.cell_metrics(SPEC, w["name"], True)}
    assert traced == LAYERS
    e2e = {m["name"] for m in registry.cell_metrics(SPEC, w["name"], False)}
    assert e2e == {"latency_p50_ms", "setup_s"}
    for cell in ("scan58.realtime", "fm16.realtime"):
        assert LAYERS <= {m["name"] for m in
                          registry.cell_metrics(SPEC, cell, True)}
