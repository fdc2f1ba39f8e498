"""Checkpoints of the port (``cubicsdr_tpu_torch/app/checkpoint.py``):
bit-continuous resume within the port, and checkpoints exchanged with the
JAX package in both directions (same ``.npz`` layout and leaf order).

Tolerances: a resume within one package equals the uninterrupted run to
atol 1e-6 (tests/test_checkpoint.py:50); a stream resumed in the other
package is held to the pipeline tolerances (audio rms < 2e-3, 99.5%
quantile < 5e-3, tests/test_fused_route.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.app import checkpoint as jck  # noqa: E402
from cubicsdr_tpu.io.sources import Station, SyntheticSource  # noqa: E402
from cubicsdr_tpu.ops.planar import PC as JPC, PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.receiver import (  # noqa: E402
    DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)

from cubicsdr_tpu_torch.app.checkpoint import (  # noqa: E402
    load_state, save_state)
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodGroupSpec, DemodulatorMgr, ReceiverPipeline, controls_from_manager,
    plan_from_manager)
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402

FS = 1_000_000


@pytest.fixture(scope="module")
def stream():
    """6 blocks of one FM station, the JAX pipeline's uninterrupted audio
    and its state after block 3."""
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, use_kernels=False, device="cpu")
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    rxj = JPipeline(FS, [JSpec("FM", 200000, 1)], dtype=JPLANAR,
                    block_len=rx.block_len)
    src = SyntheticSource(FS, rx.block_len,
                          [Station(200e3, "fm", audio_freq=900.0)],
                          noise=0.02, seed=5)
    blocks = [next(src) for _ in range(6)]
    step = jax.jit(rxj.apply)
    st, ref, st3 = rxj.init_state(), [], None
    for i, b in enumerate(blocks):
        st, out = step(st, (JPC(jnp.asarray(b.real), jnp.asarray(b.imag)),
                            controls))
        ref.append(np.asarray(out["groups"][0]["audio"]))
        if i == 2:
            st3 = st
    return dict(rx=rx, rxj=rxj, step=step, controls=controls,
                blocks=blocks, ref=ref, st3=st3)


def port_audio(rx, st, blocks, controls):
    got = []
    for b in blocks:
        st, out = rx.apply(st, (PC(torch.from_numpy(b.real.copy()),
                                   torch.from_numpy(b.imag.copy())),
                                controls))
        got.append(out["groups"][0]["audio"].numpy())
    return got, st


def assert_pipeline_close(got, ref):
    for g, r in zip(got, ref):
        d = np.abs(g - r)
        assert np.sqrt(np.mean(d * d)) < 2e-3
        assert np.quantile(d, 0.995) < 5e-3


def test_bit_continuous_resume(stream, tmp_path):
    rx, ctl, blocks = stream["rx"], stream["controls"], stream["blocks"]
    ref, _ = port_audio(rx, rx.init_state(), blocks, ctl)
    _, st = port_audio(rx, rx.init_state(), blocks[:3], ctl)
    p = str(tmp_path / "ckpt.npz")
    save_state(p, st, meta={"block": 3})
    st2, meta = load_state(p, rx.init_state())
    assert meta["block"] == 3
    got, _ = port_audio(rx, st2, blocks[3:], ctl)
    for g, r in zip(got, ref[3:]):
        np.testing.assert_allclose(g, r, atol=1e-6)
    assert_pipeline_close(ref, stream["ref"])


def test_leaf_order_matches_jax(stream):
    """tree_leaves walks the port's state in jax.tree_util order: the
    same shapes and dtypes leaf by leaf."""
    ours = tree_leaves(stream["rx"].init_state())
    theirs = jax.tree_util.tree_leaves(stream["rxj"].init_state())
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
        assert a.numpy().dtype == np.asarray(b).dtype


def test_jax_checkpoint_resumes_in_port(stream, tmp_path):
    p = str(tmp_path / "jax.npz")
    jck.save_state(p, stream["st3"], meta={"by": "jax"})
    st, meta = load_state(p, stream["rx"].init_state())
    assert meta == {"by": "jax"}
    got, _ = port_audio(stream["rx"], st, stream["blocks"][3:],
                        stream["controls"])
    assert_pipeline_close(got, stream["ref"][3:])


def test_port_checkpoint_resumes_in_jax(stream, tmp_path):
    rx, ctl, blocks = stream["rx"], stream["controls"], stream["blocks"]
    _, st = port_audio(rx, rx.init_state(), blocks[:3], ctl)
    p = str(tmp_path / "port.npz")
    save_state(p, st, meta={"by": "port"})
    stj, meta = jck.load_state(p, stream["rxj"].init_state())
    assert meta == {"by": "port"}
    got = []
    for b in blocks[3:]:
        stj, out = stream["step"](
            stj, (JPC(jnp.asarray(b.real), jnp.asarray(b.imag)), ctl))
        got.append(np.asarray(out["groups"][0]["audio"]))
    assert_pipeline_close(got, stream["ref"][3:])


def test_checkpoint_shape_mismatch_detected(tmp_path):
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 1)],
                          device="cpu")
    p = str(tmp_path / "c.npz")
    save_state(p, rx.init_state())
    rx2 = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 2)],
                           device="cpu")
    with pytest.raises(ValueError, match="plan changed"):
        load_state(p, rx2.init_state())
