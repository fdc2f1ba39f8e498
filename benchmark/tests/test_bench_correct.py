"""The harness's decision on a whole run, at a size a CPU test holds:
a sound run is correct; the comparison's control (the reference in
bfloat16 in the program's place) fails it; and a run with the timed path
broken underneath comes out not correct, once for each fault a cell of
this benchmark can have. The exchange between chips is not among them:
every cell runs on one card."""

from __future__ import annotations

import pytest
import torch

from benchmark import run


def _run(root, spec, workload="small.max_rate", control=False):
    rc, res = run.run_cell(workload, 2**31 + 5, 1.0, False, spec=spec,
                           device="cpu", control=control, root=root,
                           log=lambda s: None)
    assert rc == 0 and res is not None
    return res


def test_a_sound_run_is_correct_and_its_control_is_not(fm_small):
    root, spec = fm_small
    res = _run(root, spec, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    over = [k for k, v in res["control"].items() if v > limits[k]]
    assert over, res["control"]
    assert list(res)[-1] == "checks"


def test_the_paced_mix_is_correct(fm_small):
    root, spec = fm_small
    res = _run(root, spec, workload="small.realtime")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"latency_p50_ms", "setup_s"}


def _state_unchanged(orig):
    def apply(self, state, inputs):
        _, out = orig(self, state, inputs)
        return state, out
    return apply


def _half_the_batch(orig):
    def apply(self, state, inputs):
        state, out = orig(self, state, inputs)
        for g in out["groups"]:
            n = g["level"].shape[0]
            g["level"] = torch.cat([g["level"][:n // 2],
                                    torch.zeros_like(g["level"][n // 2:])])
            iq = g["iq"]
            g["iq"] = type(iq)(*(torch.cat([p[:n // 2],
                                            torch.zeros_like(p[n // 2:])])
                                 for p in iq))
        return state, out
    return apply


def _one_answer_altered(orig):
    def apply(self, state, inputs):
        state, out = orig(self, state, inputs)
        mix = out["mix"].clone()
        mix[0, 7] += 0.25
        return state, dict(out, mix=mix)
    return apply


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _one_answer_altered])
def test_a_broken_timed_path_is_not_correct(fm_small, monkeypatch, fault):
    from cubicsdr_tpu_torch.receiver.pipeline import ReceiverPipeline
    root, spec = fm_small
    monkeypatch.setattr(ReceiverPipeline, "apply",
                        fault(ReceiverPipeline.apply))
    res = _run(root, spec)
    assert not res["correct"], res["checks"]


def test_a_lost_block_is_not_correct(fm_small, monkeypatch):
    from benchmark.generator import TrafficSource
    root, spec = fm_small
    orig = TrafficSource._mark_drop

    def drop_one(self):
        orig(self)
        if len(self.offered) == 8:
            self.offered[-1][2] = True       # as if the ring shed it
    monkeypatch.setattr(TrafficSource, "_mark_drop", drop_one)
    res = _run(root, spec, workload="small.realtime")
    assert not res["correct"] and res["failed"] >= 1
