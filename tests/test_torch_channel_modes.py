"""The 'pfbch' and 'single' channel modes of the port against the JAX
package: the critically sampled analyzer (``ChannelizerPFB``) at M = 2, 6
and 16, streamed and one-shot; the pipeline in both modes over 3 blocks of
an FM + AM + BPSK capture (pfbch with the kernels' plain versions, JAX's
Pallas kernels in interpret mode, and without); state and checkpoints
carried both ways; and the route kernel's plans for every group 'pfbch'
fuses.

Tolerances are the main path's (tests/test_fused_route.py): the analyzer
and the iq tap atol 3e-4 / rtol 1e-3, audio rms < 2e-3 and 99.5%
quantile < 5e-3, level atol 0.05, digital symbols equal wherever the
port slicer's margin between its two best scores is at least 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cubicsdr_tpu.ops.pallas.pfb as j_pfb  # noqa: E402
import cubicsdr_tpu.ops.pallas.route as j_route  # noqa: E402
from cubicsdr_tpu.app import checkpoint as jck  # noqa: E402
from cubicsdr_tpu.ops.channelizer import (  # noqa: E402
    ChannelizerPFB as JChannelizerPFB)
from cubicsdr_tpu.ops.planar import PC as JPC, PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.receiver import (  # noqa: E402
    DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)

from cubicsdr_tpu_torch.app.checkpoint import (  # noqa: E402
    load_state, save_state)
from cubicsdr_tpu_torch.ops.channelizer import ChannelizerPFB  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodGroupSpec, ReceiverPipeline)
from cubicsdr_tpu_torch.utils.interop import (  # noqa: E402
    constants_from_jax, state_from_numpy, state_to_numpy)
from cubicsdr_tpu_torch.utils.synth import Station, synth_capture  # noqa: E402
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402
from tests.test_torch_mixed_pipeline import (  # noqa: E402
    _to_jax_state, assert_block_close, audio_close, run_jax, run_port)
from tests.test_torch_route import _WIDE_Q_PLANS  # noqa: E402

FS = 2_400_000
M = 6
BLOCK = 153_600
# (modem, bandwidth, demod offsets). In 'pfbch' mode (400 kHz channels)
# every group fuses: FM at 1/2, AM at 3/200 (O=384), BPSK at 1/20.
GROUPS = (("FM", 200000, (-790e3, 410e3)), ("AM", 6000, (-420e3, 30e3)),
          ("BPSK", 20000, (-20e3,)))
STATIONS = (Station("fm", -790e3, 700.0), Station("fm", 410e3, 1300.0),
            Station("am", -420e3, 500.0), Station("am", 30e3, 900.0),
            Station("symbols", -20e3))


@pytest.fixture(scope="module")
def interp():
    j_pfb.INTERPRET = j_route.INTERPRET = True
    yield
    j_pfb.INTERPRET = j_route.INTERPRET = False


def _planes(x):
    return PC(torch.from_numpy(np.ascontiguousarray(x[0])),
              torch.from_numpy(np.ascontiguousarray(x[1])))


@pytest.mark.parametrize("nch", [2, 6, 16])
def test_pfb_matches_jax_streamed_and_one_shot(rng, nch):
    """Three blocks through the port's analyzer equal the JAX one's, and
    equal one call on the whole stream."""
    n = nch * 96
    x = rng.standard_normal((2, 3 * n)).astype(np.float32)
    ch, chj = ChannelizerPFB(nch), JChannelizerPFB(nch, dtype=JPLANAR)
    assert ch.J == chj.J
    np.testing.assert_array_equal(ch.h_poly.numpy(), np.asarray(chj.h_poly))
    st, stj, ys = ch.init_state(), chj.init_state(), []
    for b in range(3):
        blk = x[:, b * n:(b + 1) * n]
        st, y = ch.apply(st, _planes(blk))
        stj, yj = chj.apply(stj, JPC(jnp.asarray(blk[0]),
                                     jnp.asarray(blk[1])))
        assert y.shape == (nch, n // nch)
        for p, q in ((y.re, yj.re), (y.im, yj.im)):
            np.testing.assert_allclose(p.numpy(), np.asarray(q),
                                       atol=3e-4, rtol=1e-3)
        for p, q in ((st.re, stj.re), (st.im, stj.im)):
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))
        ys.append(y)
    _, y1 = ch.apply(ch.init_state(), _planes(x))
    for plane in ("re", "im"):
        np.testing.assert_allclose(
            torch.cat([getattr(y, plane) for y in ys], dim=-1).numpy(),
            getattr(y1, plane).numpy(), atol=1e-6)


def test_pfb_rejects_a_ragged_block():
    ch = ChannelizerPFB(6)
    with pytest.raises(ValueError, match="multiple of M=6"):
        ch.apply(ch.init_state(), _planes(np.zeros((2, 100), np.float32)))


def controls_for(rx):
    controls = rx.control_template()
    for ctl, (_, _, f) in zip(controls, GROUPS):
        ctl["frequency"] = np.asarray(f, np.float32)
    return controls


def port_pipeline(mode, kernels):
    return ReceiverPipeline(
        FS, [DemodGroupSpec(n, bw, len(f)) for n, bw, f in GROUPS],
        chan_mode=mode, num_channels=M, use_kernels=kernels,
        block_len=BLOCK, device="cpu")


_CASES = [("pfbch", True), ("pfbch", False), ("single", True)]


@pytest.fixture(scope="module")
def scenario(interp):
    """3 blocks of the capture through the JAX pipeline of each case."""
    iq = synth_capture(STATIONS, 3 * BLOCK, FS, "cpu", seed=4).numpy()
    res = {"blocks": [np.ascontiguousarray(iq[:, b * BLOCK:(b + 1) * BLOCK])
                      for b in range(3)]}
    for mode, kernels in _CASES:
        rx = JPipeline(FS, [JSpec(n, bw, len(f)) for n, bw, f in GROUPS],
                       chan_mode=mode, num_channels=M, dtype=JPLANAR,
                       use_pallas=kernels, block_len=BLOCK)
        controls = controls_for(rx)
        outs, states = run_jax(rx, rx.init_state(), res["blocks"], controls)
        res[mode, kernels] = dict(rx=rx, controls=controls, outs=outs,
                                  states=states)
    return res


@pytest.mark.parametrize("mode,kernels", _CASES)
def test_pipeline_matches_jax(scenario, mode, kernels):
    ref = scenario[mode, kernels]
    rx = port_pipeline(mode, kernels)
    fused = kernels and mode != "single"
    assert rx.fused_route == ref["rx"].fused_route == [fused] * len(GROUPS)
    assert (rx.M, rx.chan_rate, rx._chan_len) == (
        ref["rx"].M, ref["rx"].chan_rate, ref["rx"]._chan_len)
    assert rx.audio_len == ref["rx"].audio_len == 3072
    if fused:
        assert [(fe.P, fe.Q, fe.tile) for fe in rx.frontends] == [
            (1, 2, 128), (3, 200, 384), (1, 20, 128)]
    constants_from_jax(ref["rx"], rx)
    outs, befores, _ = run_port(rx, rx.init_state(), scenario["blocks"],
                                ref["controls"])
    for out, r, st in zip(outs, ref["outs"], befores):
        assert_block_close(rx, out, r, st)


@pytest.mark.parametrize("mode", ["pfbch", "single"])
def test_state_hands_over_to_port_and_back(scenario, mode):
    """Block 1 runs in JAX; its state continues in the port for block 2;
    the port's state goes back to JAX for block 3. 'single' carries an
    empty channelizer state both ways."""
    ref = scenario[mode, True]
    rx = port_pipeline(mode, True)
    st = state_from_numpy(ref["states"][0])
    assert (st["chan"] == ()) == (mode == "single")
    outs, befores, st = run_port(rx, st, scenario["blocks"][1:2],
                                 ref["controls"])
    assert_block_close(rx, outs[0], ref["outs"][1], befores[0])
    st_np = state_to_numpy(st)
    for a, b in zip(tree_leaves(st_np), jax.tree.leaves(ref["states"][1])):
        assert a.shape == b.shape and a.dtype == b.dtype
    (out3,), _ = run_jax(ref["rx"], _to_jax_state(st_np),
                         scenario["blocks"][2:], ref["controls"])
    audio_close(out3["mix"], ref["outs"][2]["mix"])


@pytest.mark.parametrize("mode", ["pfbch", "single"])
def test_checkpoint_round_trip_both_ways(scenario, mode, tmp_path):
    """A JAX checkpoint after block 1 resumes in the port; the port's
    checkpoint after block 2 resumes in JAX (same .npz layout)."""
    ref = scenario[mode, True]
    rx = port_pipeline(mode, True)
    p1 = str(tmp_path / "jax.npz")
    jck.save_state(p1, ref["states"][0], meta={"blocks": 1})
    st, meta = load_state(p1, rx.init_state())
    assert meta == {"blocks": 1}
    outs, befores, st = run_port(rx, st, scenario["blocks"][1:2],
                                 ref["controls"])
    assert_block_close(rx, outs[0], ref["outs"][1], befores[0])
    p2 = str(tmp_path / "port.npz")
    save_state(p2, st, meta={"blocks": 2})
    stj, meta = jck.load_state(p2, ref["rx"].init_state())
    assert meta == {"blocks": 2}
    (out3,), _ = run_jax(ref["rx"], stj, scenario["blocks"][2:],
                         ref["controls"])
    audio_close(out3["mix"], ref["outs"][2]["mix"])


@pytest.mark.parametrize("fs", [2_400_000, 8_000_000, 10_000_000, 20_000_000])
def test_block_len_and_mode_geometry_match_jax(fs):
    """choose_block_len, the channel rate and whether the group fuses,
    per mode and group, as the JAX package derives them."""
    specs = [("FM", 200000, 2), ("NBFM", 12500, 2), ("AM", 6000, 2),
             ("BPSK", 20000, 2), ("FMS", 250000, 1)]
    for mode in ("pfbch", "single"):
        for kernels in (True, False):
            for spec in specs:
                rx = ReceiverPipeline(fs, [DemodGroupSpec(*spec)],
                                      chan_mode=mode, use_kernels=kernels,
                                      device="cpu")
                rxj = JPipeline(fs, [JSpec(*spec)], chan_mode=mode,
                                dtype=JPLANAR, use_pallas=kernels)
                assert not rx.block_len_explicit
                assert not rxj.block_len_explicit
                assert (rx.M, rx.chan_rate, rx._decim, rx.block_len,
                        rx.fused_route) == (rxj.M, rxj.chan_rate, rxj._decim,
                                            rxj.block_len, rxj.fused_route)


def test_block_len_explicit_and_complex64_refused():
    spec = [DemodGroupSpec("FM", 200000, 1)]
    rx = ReceiverPipeline(FS, spec, chan_mode="single", block_len=BLOCK,
                          device="cpu")
    assert rx.block_len_explicit and rx.block_len == BLOCK
    with pytest.raises(ValueError, match="PLANAR"):
        ReceiverPipeline(FS, spec, dtype=torch.complex64, device="cpu")
    with pytest.raises(ValueError, match="chan_mode"):
        ReceiverPipeline(FS, spec, chan_mode="pfbch4", device="cpu")


# The exact plan of each first stage that only 'pfbch' fuses (the rest
# are tests/test_torch_route.py's _WIDE_Q_PLANS or its Q <= 5 rule).
_PFBCH_STAGES = {
    (1, 2, 128): "FMS 250 kHz at 8 MS/s, FM 200 kHz at 2.4 MS/s",
    (1, 25, 128): "BPSK 20 kHz at 8 MS/s",
    (1, 20, 128): "BPSK 20 kHz at 2.4 MS/s",
    (1, 32, 128): "NBFM at 2.4 MS/s",
    (5, 8, 640): "FMS 250 kHz at 2.4 MS/s",
    (3, 25, 384): "I/Q at 2.4 MS/s",
}


def test_route_plan_fits_every_fused_group_in_pfbch_mode():
    """Every group 'pfbch' fuses, for every registered modem at its
    default bandwidth and scan58's, at 2.4, 8, 10 and 20 MS/s, gets a
    shared-memory plan within the 227 KB an sm_90 block may hold: Q <= 5
    keeps 128 threads, every residue and the E table; every wider stage
    has its own exact plan."""
    from cubicsdr_tpu_torch.modems import make_modem, modem_names
    from cubicsdr_tpu_torch.ops.kernels.route import (
        SMEM_MAX, route_plan, route_taps)
    cases = [(n, make_modem(n).default_sample_rate) for n in modem_names()]
    cases += [("NBFM", 12500), ("AM", 6000), ("CW", 500), ("BPSK", 20000),
              ("FMS", 250000)]
    fused = set()
    for fs in (2_400_000, 8_000_000, 10_000_000, 20_000_000):
        for modem, bw in cases:
            rx = ReceiverPipeline(fs, [DemodGroupSpec(modem, bw, 2)],
                                  chan_mode="pfbch", device="cpu")
            if not rx.fused_route[0]:
                continue
            fe = rx.frontends[0]
            rs = fe._stage1
            kp, _ = route_taps(rs.ker_np, rs.Q)
            tb, groups, cq, keep_e, nbytes = route_plan(
                rs.P, rs.Q, fe.tile, rs.KK, kp.shape[-1])
            assert nbytes <= SMEM_MAX and keep_e
            threads = tb * groups * rs.P * -(-fe.tile // rs.P // 8)
            key = (rs.P, rs.Q, fe.tile)
            if key == (1, 2, 128):                 # the whole batch fits
                assert (tb, groups, cq, threads) == (8, 1, 2, 128)
            if rs.Q <= 5:
                assert (groups, cq, threads) == (1, rs.Q, 128), key
            else:
                assert (tb, groups, cq, threads) == _WIDE_Q_PLANS[key], key
            fused.add(key)
    assert set(_PFBCH_STAGES) <= fused, set(_PFBCH_STAGES) - fused
