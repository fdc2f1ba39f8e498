"""The port's weak-scaling harness (``parallel/scaling.py``) and its
multi-rank dry run (``parallel/dryrun.py``) on gloo CPU ranks, at the
JAX package's tests/test_scaling.py and tests/test_parallel.py shapes.
Only the machinery is asserted (rows, devices, efficiency of the first
row, rates above zero, output shapes): the ranks share one host's
cores, so a wall-clock ratio between rows says nothing about the
receiver and is not a stable bound."""

import pytest

torch = pytest.importorskip("torch")

from cubicsdr_tpu_torch.parallel import multihost  # noqa: E402
from cubicsdr_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa
from cubicsdr_tpu_torch.parallel.scaling import measure_scaling  # noqa


def test_scaling_harness_one_and_two_ranks():
    rep = measure_scaling(sample_rate=2_000_000, num_channels=8,
                          demods_per_chip=8, device_counts=[1, 2],
                          n_iters=2, warmup=1, device="cpu")
    rows = rep["rows"]
    assert rep["metric"] == "sharded_fm_farm_weak_scaling"
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["msps"] > 0 and r["efficiency"] > 0 for r in rows)
    # Weak scaling: the per-rank block is fixed, the global one grows.
    assert rows[1]["block_len"] == 2 * rows[0]["block_len"]
    assert {r["backend"] for r in rows} == {"gloo"}
    assert not any(r["host_collectives"] for r in rows)
    assert all(r["compiled"] for r in rows)      # make_step() on CPU ranks


def test_dryrun_multichip_two_ranks(capfd):
    rep = dryrun_multichip(2, "cpu")
    # Two ranks: one time shard, chan = 2 (the JAX dry run's rule).
    assert (rep["ranks"], rep["time"], rep["chan"]) == (2, 1, 2)
    la = rep["mix"][1]
    assert rep["mix"] == [2, la] and la > 0
    assert rep["fm_audio"] == [4, 1, la]
    assert rep["bpsk_symbols"][0] == 2
    assert "dryrun_multichip: 2 ranks" in capfd.readouterr().out


def test_card_worlds_need_a_card():
    """On a host without CUDA the card's worlds are refused before any
    process starts, as ``multihost`` refuses them."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_scaling(device_counts=[1], device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(1, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.spawn_collect(print, 1, device="cuda")
