"""On the card: a short run of each cell with its control (the
comparison's lower and upper readings at the cell's own size). Run with
``python -m pytest benchmark/tests -m card`` on a machine with a GPU."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_and_its_control_fails(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    rc, res = run.run_cell(workload, 2**31 + 101, 3.0, False, control=True)
    assert rc == 0
    assert res["correct"], res["checks"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert any(v > limits[k] for k, v in res["control"].items())
