"""Finds a benchmark's parts by the names ``BENCHMARK.json`` gives them,
so that a later change adds a configuration, a traffic mix, a cell or a
per-layer metric by adding files and entries, and edits none:

- ``configs/<config>.json``: a deployment (its file is the entry's
  ``file``);
- ``traffic/<mix>.json``: a traffic mix's parameters, read by
  ``generator.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader, a module with
  ``read(rec) -> float | None``.

``root`` is the benchmark's folder; tests pass a temporary one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_spec(repo_root: Path) -> dict:
    with open(Path(repo_root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, repo_root: Path) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(Path(repo_root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = HERE) -> dict:
    path = Path(root) / "traffic" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic mix {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reader for metric {name!r} ({path})")
    mod_name = "benchmark_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    (``--trace 0``) or its per-layer metrics (``--trace 1``); a metric
    with a ``workloads`` list belongs to the cells it names, one without
    to every cell that reports the end-to-end metric it moves."""
    def mine(m):
        return workload in m["workloads"] if "workloads" in m else True
    e2e = [m for m in spec["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
