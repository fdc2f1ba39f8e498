"""The port's complex64 ReceiverPipeline (``dtype=torch.complex64``)
against the JAX package's complex64 pipeline (its default), block by
block on the same numpy-seeded captures, the JAX step run eagerly (the
jitted step's NCO phase drifts from the eager one; ROADMAP queue 3):

- the JAX package's tests/test_receiver.py cases (the FM farm in
  'pfbch2' and 'pfbch', a retune, squelch, FM + AM groups), each block
  at the pipeline gates and the port's tones at that file's SNR gates;
- 'pfbch' and 'single';
- the port's planar pipeline against its complex64 one at
  tests/test_unified_pipeline.py's gates;
- ``constants_from_jax``, the state carried JAX -> port -> JAX and
  checkpoints written by either package loaded by the other;
- the ``use_kernels`` rule: complex64 never reaches either kernel.

Gates as tests/torch_complex_common.py states (tests/test_torch_
pipeline.py's). Every modem family and kit: tests/test_torch_complex_
kits.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.app import checkpoint as jck  # noqa: E402
from cubicsdr_tpu.receiver import (  # noqa: E402
    DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)

import cubicsdr_tpu_torch.ops.channelizer as t_ch  # noqa: E402
import cubicsdr_tpu_torch.receiver.frontend as t_fe  # noqa: E402
from cubicsdr_tpu_torch.app.checkpoint import (  # noqa: E402
    load_state, save_state)
from cubicsdr_tpu_torch.ops.planar import PC, PLANAR  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodGroupSpec, ReceiverPipeline)
from cubicsdr_tpu_torch.utils.interop import (  # noqa: E402
    constants_from_jax, state_from_numpy, state_to_numpy)
from cubicsdr_tpu_torch.utils.synth import Station  # noqa: E402
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402
from torch_complex_common import (  # noqa: E402
    C64, FAMILY_PLANS, FS, assert_block_close, audio_close, capture,
    controls_for, group_audio, pair, run_both, tone_snr)


# --- the JAX package's tests/test_receiver.py cases on complex64 -------

@pytest.mark.parametrize("chan_mode", ["pfbch2", "pfbch"])
def test_fm_farm_recovers_both_stations(chan_mode):
    rx, rxj = pair([("FM", 200000, 2)], chan_mode=chan_mode)
    freqs = [300e3, -450e3]
    n = int(0.6 * FS / rx.block_len)
    blocks = capture([Station("fm", freqs[0], 1000.0),
                      Station("fm", freqs[1], 2000.0)], n, rx.block_len)
    outs, _, _ = run_both(rx, rxj, blocks, controls_for(rx, [freqs]))
    assert tone_snr(group_audio(outs, 0, 0)[9600:], 1000.0) > 30
    assert tone_snr(group_audio(outs, 0, 1)[9600:], 2000.0) > 30
    mix = np.concatenate([o["mix"].numpy() for o in outs], axis=-1)
    assert mix.shape[0] == 2 and np.abs(mix).max() <= 1.0 + 1e-3


def test_retune_between_blocks():
    rx, rxj = pair([("FM", 200000, 1)])
    blocks = capture([Station("fm", -450e3, 1500.0)], 31, rx.block_len)
    wrong, right = (controls_for(rx, [[f]]) for f in (300e3, -450e3))
    outs, _, _ = run_both(rx, rxj, blocks, (wrong,) + (right,) * 30)
    assert tone_snr(group_audio(outs[1:], 0, 0)[9600:], 1500.0) > 30


def test_squelch_gates_silence():
    rx, rxj = pair([("FM", 200000, 1)])
    ctl = controls_for(rx, [[300e3]])
    ctl[0]["squelch_enabled"][:] = True
    ctl[0]["squelch_level"][:] = -20.0
    quiet = capture([], 10, rx.block_len, noise=1e-5)
    outs, st, sj = run_both(rx, rxj, quiet, ctl)
    g = outs[-1]["groups"][0]
    assert bool(g["squelched"][0]) and float(g["audio"].abs().max()) == 0.0
    loud = capture([Station("fm", 300e3)], 10, rx.block_len, seed=6)
    stj = jax.tree.map(jnp.asarray, sj[-1])
    outs, _, _ = run_both(rx, rxj, loud, ctl, st, stj)
    assert not bool(outs[-1]["groups"][0]["squelched"][0])


def test_mixed_modem_groups():
    """FM + AM groups in one complex64 pipeline; both recover audio."""
    rx, rxj = pair([("FM", 200000, 1), ("AM", 6000, 1)])
    n = int(0.7 * FS / rx.block_len)
    blocks = capture([Station("fm", 300e3, 1000.0),
                      Station("am", -250e3, 700.0)], n, rx.block_len)
    outs, _, _ = run_both(rx, rxj, blocks,
                          controls_for(rx, [[300e3], [-250e3]]))
    assert tone_snr(group_audio(outs, 0, 0)[9600:], 1000.0) > 30
    assert tone_snr(group_audio(outs, 1, 0)[19200:], 700.0) > 25


# --- channel modes, planar vs complex, the kernel rule ------------------

UNIFIED = [("FM", 200000, 2), ("AM", 6000, 1)]
UNIFIED_FREQS = [[300e3, -450e3], [120e3]]
UNIFIED_STATIONS = [Station("fm", 300e3, 1000.0), Station("fm", -450e3,
                                                          2000.0),
                    Station("am", 120e3, 800.0)]


@pytest.mark.parametrize("mode", ["pfbch", "single"])
def test_channel_modes_match_jax(mode):
    rx, rxj = pair(UNIFIED, chan_mode=mode)
    assert constants_from_jax(rxj, rx)
    blocks = capture(UNIFIED_STATIONS, 3, rx.block_len)
    run_both(rx, rxj, blocks, controls_for(rx, UNIFIED_FREQS))


@pytest.mark.parametrize("kernels", [True, False])
def test_planar_pipeline_matches_complex(kernels):
    """tests/test_unified_pipeline.py:30-60 on the port: the planar
    pipeline (kernels' plain versions or the plain path) against the
    complex64 one, 4 blocks, atol 2e-3 / rtol 2e-3 and level 0.1."""
    specs = [DemodGroupSpec(*s) for s in UNIFIED]
    rx_c = ReceiverPipeline(FS, specs, dtype=C64, device="cpu")
    rx_p = ReceiverPipeline(FS, specs, dtype=PLANAR, use_kernels=kernels,
                            block_len=rx_c.block_len, device="cpu")
    ctl = controls_for(rx_c, UNIFIED_FREQS)
    st_c, st_p = rx_c.init_state(), rx_p.init_state()
    for blk in capture(UNIFIED_STATIONS, 4, rx_c.block_len):
        x = torch.from_numpy(blk)
        st_c, o_c = rx_c.apply(st_c, (x, ctl))
        st_p, o_p = rx_p.apply(st_p, (PC(x.real.contiguous(),
                                         x.imag.contiguous()), ctl))
        np.testing.assert_allclose(o_p["mix"].numpy(), o_c["mix"].numpy(),
                                   atol=2e-3, rtol=2e-3)
        for g_c, g_p in zip(o_c["groups"], o_p["groups"]):
            np.testing.assert_allclose(g_p["audio"].numpy(),
                                       g_c["audio"].numpy(), atol=2e-3,
                                       rtol=2e-3)
            np.testing.assert_allclose(g_p["level"].numpy(),
                                       g_c["level"].numpy(), atol=0.1)


def test_use_kernels_rule_and_no_kernel_call(monkeypatch):
    spec = [DemodGroupSpec("FM", 200000, 2)]
    rx = ReceiverPipeline(FS, spec, dtype=C64, device="cpu")
    rxj = JPipeline(FS, [JSpec("FM", 200000, 2)])
    assert rx.use_kernels is False and rx.block_len == rxj.block_len
    assert ReceiverPipeline(FS, spec, device="cpu").use_kernels is True
    with pytest.raises(ValueError, match="PLANAR"):
        ReceiverPipeline(FS, spec, dtype=C64, use_kernels=True,
                         device="cpu")
    with pytest.raises(ValueError, match="complex64"):
        ReceiverPipeline(FS, spec, dtype=torch.complex128, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ReceiverPipeline(FS, spec, dtype=C64)

    def forbidden(*a, **k):
        raise AssertionError("a kernel wrapper ran on the complex path")
    for mod, name in ((t_ch, "pfbch2_planar"), (t_ch, "pfbch2_planar_plain"),
                      (t_fe, "routed_shifted_resample")):
        monkeypatch.setattr(mod, name, forbidden)
    ctl = controls_for(rx, [[300e3, -450e3]])
    _, out = rx.apply(rx.init_state(),
                      (torch.zeros(rx.block_len, dtype=C64), ctl))
    assert out["mix"].shape == (2, rx.audio_len)


# --- constants, state and checkpoints across the packages ---------------

def test_state_and_checkpoint_carry_both_ways(tmp_path):
    """JAX block 1 -> port block 2 -> JAX block 3 by state; then a port
    checkpoint loads into the JAX pipeline and a JAX checkpoint into the
    port's, each continuing the stream at the gates."""
    groups, stations = FAMILY_PLANS["fm_am_cw_psk_fms"]
    specs = [(m, bw, len(f)) for m, bw, f in groups]
    rx, rxj = pair(specs, num_channels=8)
    ctl = controls_for(rx, [g[2] for g in groups])
    blocks = capture(stations, 3, rx.block_len, noise=0.01)
    ref, _, ref_states = run_both(rx, rxj, blocks, ctl)

    def jax_step(st, blk):
        st, o = rxj.apply(jax.tree.map(jnp.asarray, st),
                          (jnp.asarray(blk), ctl))
        return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, o)

    # By state: JAX's after block 1 runs block 2 in the port.
    st = state_from_numpy(ref_states[0])
    _, out2 = rx.apply(st, (torch.from_numpy(blocks[1]), ctl))
    _, oj2 = jax_step(ref_states[0], blocks[1])
    assert_block_close(rx, out2, oj2, st)
    st2, _ = rx.apply(st, (torch.from_numpy(blocks[1]), ctl))
    _, oj3 = jax_step(state_to_numpy(st2), blocks[2])
    audio_close(oj3["mix"], ref[2]["mix"].numpy())

    # By checkpoint: the port's after block 1 -> JAX; JAX's -> the port.
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    st1, _ = rx.apply(rx.init_state(), (torch.from_numpy(blocks[0]), ctl))
    save_state(p1, st1, meta={"blocks": 1})
    stj, meta = jck.load_state(p1, rxj.init_state())
    assert meta == {"blocks": 1}
    _, oj = jax_step(stj, blocks[1])
    audio_close(oj["mix"], ref[1]["mix"].numpy())
    jck.save_state(p2, ref_states[1], meta={"blocks": 2})
    stp, meta = load_state(p2, rx.init_state())
    assert meta == {"blocks": 2}
    assert any(t.dtype == C64 for t in tree_leaves(stp))
    _, out = rx.apply(stp, (torch.from_numpy(blocks[2]), ctl))
    assert_block_close(rx, out, oj3, stp)
