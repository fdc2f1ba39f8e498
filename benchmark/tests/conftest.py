"""Helpers of the benchmark's own tests: the repository root on the
import path, and a throwaway benchmark root holding a small copy of a
configuration that a test run on the CPU can hold."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_root(tmp: Path, base: str, block_len: int,
               loop_seconds: float = 0.05) -> tuple[Path, dict]:
    """A benchmark root under ``tmp`` whose one configuration ``small``
    is ``base`` at ``block_len`` with a short loop and a small display,
    and whose cells ``small.max_rate`` and ``small.realtime`` run it;
    returns (root, spec)."""
    bench = tmp / "benchmark"
    for d in ("traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, bench / d,
                        dirs_exist_ok=True)
    (bench / "configs").mkdir(parents=True, exist_ok=True)
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{base}.json"
                      ).read_text())
    cfg.update(name="small", block_len=int(block_len))
    cfg["capture"]["loop_seconds"] = float(loop_seconds)
    cfg["display"].update(fft=256, lines=16)
    (bench / "configs" / "small.json").write_text(json.dumps(cfg))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(spec["configs"][0], name="small",
                            file="benchmark/configs/small.json")]
    spec["workloads"] = [
        {"name": f"small.{m}", "config": "small", "traffic": m, "chips": 1,
         "why": "a test"} for m in ("max_rate", "realtime")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["small.max_rate", "small.realtime"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp, spec


@pytest.fixture
def fm_small(tmp_path):
    return small_root(tmp_path, "fm16", 64_000)
