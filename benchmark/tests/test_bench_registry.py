"""Every configuration, traffic mix and per-layer metric that
BENCHMARK.json names is found by its name, and new ones are found by
adding files alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark import registry

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_named_part_is_found():
    for c in SPEC["configs"]:
        cfg = registry.config(SPEC, c["name"], ROOT)
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("benchmark/configs/")
    for w in SPEC["workloads"]:
        assert registry.cell(SPEC, w["name"]) is w
        assert registry.traffic(w["traffic"])["loop"] in ("closed", "open")
        for trace in (False, True):
            assert registry.cell_metrics(SPEC, w["name"], trace)
    for m in SPEC["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_each_cell_reports_setup_and_another_end_to_end_metric():
    for w in SPEC["workloads"]:
        names = {m["name"] for m in
                 registry.cell_metrics(SPEC, w["name"], False)}
        assert "setup_s" in names and len(names) >= 2, w["name"]


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path):
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, bench / d)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "fm16.json").read_text())
    cfg["name"] = "fm8"
    cfg["groups"][0].update(count=8, offsets=cfg["groups"][0]["offsets"][:8])
    (bench / "configs" / "fm8.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "half_rate.json").write_text(
        json.dumps({"loop": "open", "rate_factor": 0.5}))
    (bench / "metrics" / "blocks_traced.py").write_text(
        "def read(rec):\n    b = rec.get('blocks')\n"
        "    return float(len(b)) if b else None\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "fm8", "source": "a test",
                            "file": "benchmark/configs/fm8.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "fm8.half_rate", "config": "fm8",
                              "traffic": "half_rate", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "blocks_traced", "unit": "blocks",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "setup_s"})
    assert registry.config(spec, "fm8", tmp_path)["groups"][0]["count"] == 8
    assert registry.traffic("half_rate", bench)["rate_factor"] == 0.5
    read = registry.metric_reader("blocks_traced", bench)
    assert read({"blocks": [{}, {}]}) == 2.0 and read({}) is None
    # Without a workloads list the new metric belongs to every cell that
    # reports the metric it moves (setup_s: all of them).
    names = {m["name"] for m in
             registry.cell_metrics(spec, "fm8.half_rate", True)}
    assert "blocks_traced" in names
    assert {p: p.read_bytes() for p in before} == before


def test_an_unknown_name_is_refused():
    with pytest.raises(KeyError):
        registry.traffic("no_such_mix")
    with pytest.raises(KeyError):
        registry.metric_reader("no_such_metric")
    with pytest.raises(KeyError):
        registry.cell(SPEC, "no.such_cell")
