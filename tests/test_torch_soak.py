"""The port's evidence modes (``cubicsdr_tpu_torch/utils/soak.py``) on the
CPU, against ``scripts/tpu_evidence_r05.py`` where the two compute the
same thing: the churn soak's pinned block length (from the JAX package's
own pipelines for the same plans), the digital check's capture and
decision-stable mask (the script's functions, loaded by path), the pass
criteria on synthetic memory series, one REST churn cycle at a rate the
CPU sustains, and the digital check end to end on two blocks."""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cubicsdr_tpu_torch.utils import soak  # noqa: E402

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "tpu_evidence_r05.py"


@pytest.fixture(scope="module")
def r05():
    spec = importlib.util.spec_from_file_location("tpu_evidence_r05", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_pinned_block_len(rate, plans, num_channels=None):
    """tpu_evidence_r05.py churn_soak's block length, on the JAX package's
    pipelines for ``plans`` (the port's specs, rebuilt as the JAX
    package's)."""
    from cubicsdr_tpu.ops.planar import PLANAR
    from cubicsdr_tpu.receiver import DemodGroupSpec, ReceiverPipeline
    m = 1
    for specs in plans:
        jspecs = [DemodGroupSpec(g.modem_name, g.bandwidth, g.count,
                                 settings=g.settings) for g in specs]
        r0 = ReceiverPipeline(rate, jspecs, dtype=PLANAR,
                              num_channels=num_channels)
        for gi in range(len(jspecs)):
            m = int(np.lcm(m, r0.group_block_multiple(gi)))
        m = int(np.lcm(m, r0._decim * 128))
        for fe in r0.frontends:
            m = int(np.lcm(m, r0._decim * fe.Q * 128))
    return ((1 << 20) // m + 1) * m


@pytest.mark.parametrize("plan", ["serve", "scan58"])
def test_pinned_block_len_matches_jax(plan, tmp_path):
    setup = soak.ChurnSetup(plan)
    plans = soak.visited_plans(setup.manager(), setup.cycle(str(tmp_path)))
    L = soak.pinned_block_len(setup.rate, plans, setup.num_channels)
    assert L == _jax_pinned_block_len(setup.rate, plans, setup.num_channels)
    assert L <= 1 << 23
    if plan == "serve":
        # The JAX mode's four plans, in its order.
        assert [[(g.modem_name, g.bandwidth) for g in p] for p in plans] \
            == [[("FM", 200000)], [("FM", 200000), ("AM", 10000)],
                [("FM", 200000), ("NBFM", 12500)],
                [("FM", 200000), ("NBFM", 10000)]]
    else:
        # Each kind's add and edit, scan58 itself first.
        assert len(plans) == 6
        assert [(g.modem_name, g.bandwidth, g.count) for g in plans[0]] \
            == [(g.modem_name, g.bandwidth, g.count)
                for g in setup.plan.specs]


@pytest.mark.parametrize("rate", [2_400_000.0, 4_800_000.0])
def test_soak_block_keeps_both_kernels(rate):
    """The soak's block, the least multiple above 2^20 of the default
    plan's, keeps the FM group on the fused route kernel."""
    from cubicsdr_tpu_torch.receiver import ReceiverPipeline
    L = soak.soak_block_len(rate, soak.soak_specs())
    assert (1 << 20) < L <= 2 * (1 << 20)
    rx = ReceiverPipeline(rate, soak.soak_specs(), block_len=L,
                          device="cpu")
    assert rx.fused_route == [True] and rx.M in (6, 10)


def test_capture_and_stable_mask_match_the_script(r05):
    L, n_blocks = soak.SYM_LEN * 4, 2
    cal = {"QPSK": 0.9 - 0.8j, "QAM16": 1.1 + 0.2j,
           "QAM256": 0.7 + 0.7j, "APSK16": -1.0 + 0.1j}
    for c in (None, cal):
        iq, tx = soak._capture(L, n_blocks, cal=c)
        iq_r, tx_r = r05._capture(L, n_blocks, cal=c)
        assert iq.dtype == iq_r.dtype == np.complex64
        np.testing.assert_array_equal(iq, iq_r)
        assert sorted(tx) == sorted(tx_r)
        for k in tx:
            np.testing.assert_array_equal(tx[k], tx_r[k])
    for k, pts in soak._tables().items():
        np.testing.assert_array_equal(pts, r05._tables()[k])
    syms = np.random.default_rng(4).integers(0, 3, 5000).repeat(3)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(soak._stable_mask(syms, k),
                                      r05._stable_mask(syms, k))


def _series(rss_mib_per_min=0.0, reserved=None, minutes=60):
    t = np.arange(minutes + 1, dtype=float)
    res = reserved if reserved is not None else [2**30] * len(t)
    return [{"minute": float(m), "rss_bytes": int(2**30 + r * 2**20),
             "memory_reserved": v}
            for m, r, v in zip(t, rss_mib_per_min * t, res)]


def test_memory_criteria():
    flat = soak.memory_verdict(_series())
    assert flat["rss_ok"] and flat["reserved_ok"]
    assert abs(flat["rss_slope_mib_per_min"]) < 1e-9
    slow = soak.memory_verdict(_series(0.4))
    assert slow["rss_ok"]
    leak = soak.memory_verdict(_series(1.0))
    assert not leak["rss_ok"]
    assert math.isclose(leak["rss_slope_mib_per_min"], 1.0, rel_tol=1e-6)
    grow = [2**30] * 40 + [2**30 + 2**21] * 21      # grows into the last third
    v = soak.memory_verdict(_series(reserved=grow))
    assert v["rss_ok"] and not v["reserved_ok"]
    # A first-third peak that later stays below it passes.
    early = [2**30 + 2**21] * 5 + [2**30] * 56
    assert soak.memory_verdict(_series(reserved=early))["reserved_ok"]
    # Off the card memory_reserved is None: only RSS decides.
    cpu = soak.memory_verdict(_series(reserved=[None] * 61))
    assert cpu["reserved_ok"] and cpu["reserved_last_third_peak"] is None


def test_paced_source_wraps_and_rebases():
    loop = np.arange(20, dtype=np.int16).reshape(2, 10)
    src = soak.PacedSource(loop, 4, 1e6)
    np.testing.assert_array_equal(src.block(2), loop[:, [8, 9, 0, 1]])
    it = iter(src)
    for k in range(5):              # yielded from two reused buffers
        blk = next(it)
        assert blk.shape == (2, 4) and blk.dtype == np.int16
        np.testing.assert_array_equal(blk, src.block(k))
    src.reset()
    assert src.late_s == 0.0
    src.stop()


def test_soak_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        soak.main(["soak", "--minutes", "0.01"])


def test_churn_cycle_on_the_cpu(capsys, monkeypatch):
    """One measured cycle of the serve shape's REST churn at 1 MS/s (no
    warm cycles): every op answers ok (each checked in the soak) and the
    pinned block length holds through every edit. Drops, real time and
    the tone are the card's to hold (``chip_smoke.py`` phase 29): a CPU
    shared with other test workers does not keep real time."""
    monkeypatch.setattr(soak, "WARM_CYCLES", 0)
    rc = soak.main(["churn_soak", "--device", "cpu", "--rate", "1000000",
                    "--minutes", "0.01"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["tag"] == "churn_soak" and res["churn_cycles"] >= 1
    assert res["consumer_exceptions"] == []
    assert res["rest_ops"] == 18 * res["churn_cycles"]
    assert res["plans_visited"] == 4
    assert res["block_len"] == 1_280_000
    assert res["builds_after_warm"]["step_builds"] == 1
    assert res["steps_built_after_warm"] == 3     # the cycle's other plans
    assert res["samples"][0]["plan_cache"] >= 1
    # The audio tap keeps its mixes and nothing else (A14).
    assert all(x["audio_tap_bytes"] == x["audio_mix_bytes"]
               for x in res["samples"])
    assert res["samples"][-1]["audio_tap_blocks"] > 0
    assert rc == (0 if res["ok"] else 1)


def test_digital_check_on_the_cpu(capsys):
    rc = soak.main(["digital_check", "--blocks", "2", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["ok"] and res["tag"] == "digital_check"
    assert res["M"] == 16 and all(res["fused_route"])
    for name in soak.NAMES:
        assert res[name]["agreement"] >= soak.AGREEMENT
        assert res["tx_accuracy_interior"][name] == 1.0
    assert abs(res["fm_tone_hz"] - 1000.0) < soak.FM_TONE_HZ
