"""The port's benchmark (``cubicsdr_tpu_torch/bench.py``) against the JAX
package's root ``bench.py`` on the CPU: the same pipelines and controls,
the K-block step against the JAX ``jit(lax.scan)`` form, and the rows
that ``python -m cubicsdr_tpu_torch bench`` prints. The CUDA graph of the
K-block step runs on the card only (``chip_smoke.py``); here it refuses a
CPU pipeline."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench as j_bench  # noqa: E402
import cubicsdr_tpu.ops.pallas.pfb as j_pfb  # noqa: E402
import cubicsdr_tpu.ops.pallas.route as j_route  # noqa: E402
from cubicsdr_tpu.ops.planar import PC as JPC  # noqa: E402

from cubicsdr_tpu_torch import bench  # noqa: E402
from cubicsdr_tpu_torch.app import cli  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.utils.synth import demod_freqs  # noqa: E402
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402

# The smallest block of the bench's plan that keeps the fused route
# (the plan's block multiple and 128 channel steps: 8 x 5 x 25 x 128).
SMALL_BLOCK = 128_000


@pytest.fixture(scope="module")
def interp():
    j_pfb.INTERPRET = j_route.INTERPRET = True
    yield
    j_pfb.INTERPRET = j_route.INTERPRET = False


@pytest.mark.parametrize("n_demods", [16, 256])
def test_build_pipeline_matches_jax(n_demods):
    """Block length, channel count, fused route and control frequencies
    equal the JAX bench's pipeline with its kernels (construction only)."""
    jrx, jctl = j_bench.build_pipeline(n_demods, use_pallas=True)
    rx, ctl = bench.build_pipeline(n_demods, device="cpu")
    assert rx.block_len == jrx.block_len == 1_024_000
    assert rx.M == jrx.M == 16
    assert rx.fused_route == jrx.fused_route == [True]
    assert [g.count for g in rx.groups] == [n_demods]
    np.testing.assert_array_equal(ctl[0]["frequency"], jctl[0]["frequency"])
    for k in jctl[0]:
        np.testing.assert_array_equal(ctl[0][k], jctl[0][k])


def test_multi_step_matches_jax_scan(interp):
    """K = 3 blocks of the bench's seeded Gaussian IQ through the port's
    ``multi_step`` and the JAX bench's ``jax.jit(lax.scan)`` body
    (bench.py:148-154, Pallas interpreted), at 2 demods on SMALL_BLOCK:
    the stacked mix at the pipeline's audio gates (rms < 2e-3, 99.5%
    quantile < 5e-3) and the levels within 0.05. The demods are the
    bench layout's 1 and 2: its demod 0 (-3.98 MHz) routes to the
    -3.5 MHz channel, 480 kHz off centre, into the channel filter's stop
    band, where rounding-level differences of its 1e-4 IQ (the JAX
    package's own Pallas and XLA paths differ by 0.045 rms in its audio)
    set its audio (tests/test_fused_route.py's wrap-edge note). The iq
    tap is not compared: the jitted JAX NCO phase drifts from the eager
    one (ROADMAP queue 3)."""
    K, L = 3, SMALL_BLOCK
    freqs = demod_freqs(3)[1:]
    jrx, jctl = j_bench.build_pipeline(2, L, use_pallas=True)
    jctl[0]["frequency"] = freqs
    rng = np.random.default_rng(0)
    re, im = (rng.standard_normal((K, L)).astype(np.float32)
              for _ in range(2))

    def j_multi_step(state, iqs):
        def body(s, iq):
            s, out = jrx.apply(s, (iq, jctl))
            level = jnp.concatenate([g["level"] for g in out["groups"]],
                                    axis=-1)
            return s, (out["mix"], level)
        return jax.lax.scan(body, state, iqs)

    step = jax.jit(j_multi_step, donate_argnums=(0,))
    _, (j_mix, j_level) = step(jrx.init_state(),
                               JPC(jnp.asarray(re), jnp.asarray(im)))

    rx, ctl = bench.build_pipeline(2, L, device="cpu")
    ctl[0]["frequency"] = freqs
    state, mix, level = bench.multi_step(
        rx, rx.init_state(), PC(torch.from_numpy(re), torch.from_numpy(im)),
        bench.device_controls(ctl, "cpu"))
    assert mix.shape == np.shape(j_mix) == (K, 2, rx.audio_len)
    assert level.shape == np.shape(j_level) == (K, 2)
    d = np.abs(mix.numpy() - np.asarray(j_mix))
    assert np.sqrt(np.mean(d * d)) < 2e-3, np.sqrt(np.mean(d * d))
    assert np.quantile(d, 0.995) < 5e-3
    np.testing.assert_allclose(level.numpy(), np.asarray(j_level),
                               atol=0.05)
    # The final state is the K-th block's: a fresh run of K single steps.
    st = rx.init_state()
    for k in range(K):
        st, _ = rx.apply(st, (PC(torch.from_numpy(re[k]),
                                 torch.from_numpy(im[k])),
                              bench.device_controls(ctl, "cpu")))
    for a, b in zip(tree_leaves(state), tree_leaves(st)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _rows(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_cli_bench_demod16_row(capsys):
    """``bench --device cpu --only demod16 --block SMALL_BLOCK``: one row
    under the JAX metric name, the eager K-step loop timed in 5 windows
    of 15 dispatches of 8 blocks, no graph, no kernel launch (the plain
    versions run on the CPU)."""
    assert cli.main(["bench", "--device", "cpu", "--only", "demod16",
                     "--block", str(SMALL_BLOCK)]) == 0
    rows = _rows(capsys)
    assert len(rows) == 1
    r = rows[0]
    assert r["metric"] == "iq_msamples_per_sec_per_chip_channelize_demod16"
    assert r["unit"] == "Msamples/s" and r["device"] == "cpu"
    assert "vs_baseline" not in r
    assert r["graphed"] is False and r["value"] == r["eager_msps"] > 0
    assert (r["blocks_per_dispatch"], r["dispatches_per_window"],
            r["windows"]) == (8, 15, 5)
    assert len(r["eager_msps_windows"]) == 5 and r["eager_spread"] >= 0
    assert r["block_len"] == SMALL_BLOCK and r["demods"] == 16
    assert r["eager_ms_per_block"] > 0
    assert r["eager_launches_per_block"] == {"pfbch2_planar": 0.0,
                                             "routed_shifted_resample": 0.0}


def test_cli_bench_live16_row(capsys):
    """``bench --device cpu --only live16 --live-blocks 4``: one live row
    over 4 blocks with no ring drop."""
    assert cli.main(["bench", "--device", "cpu", "--only", "live16",
                     "--live-blocks", "4", "--block",
                     str(SMALL_BLOCK)]) == 0
    rows = _rows(capsys)
    assert len(rows) == 1
    r = rows[0]
    assert r["metric"] == "iq_msamples_per_sec_per_chip_live_loop_demod16"
    assert r["blocks"] == 4 and r["ring_dropped_samples"] == 0
    assert r["value"] > 0 and r["ingest"] == "float32"
    assert r["device"] == "cpu" and "wire_mbps_probe" not in r


def test_bench_on_the_card_without_cuda_raises(monkeypatch):
    """``--device`` defaults to the card: without CUDA the bench raises
    before it builds anything, through the CLI and when called."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--only", "demod16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda", "--only", "live16"])


def test_graphed_scan_refuses_a_cpu_pipeline():
    rx, ctl = bench.build_pipeline(2, SMALL_BLOCK, device="cpu")
    iqs = PC(torch.zeros(2, SMALL_BLOCK), torch.zeros(2, SMALL_BLOCK))
    with pytest.raises(ValueError, match="CUDA device"):
        bench.GraphedScan(rx, rx.init_state(), iqs, ctl)


def test_bench_help_lists_the_jax_flags(capsys):
    with pytest.raises(SystemExit):
        cli.main(["bench", "--help"])
    out = capsys.readouterr().out
    for flag in ("--only", "--demods", "--block", "--no-kernels",
                 "--live-blocks", "--device"):
        assert flag in out
    for row in bench.ROWS:
        assert row in out
