"""Mixed analog/digital plans through the port's ReceiverPipeline against
the JAX package's, block by block: a small plan (2 MS/s, M = 8; FM, AM,
CW, BPSK and FM-stereo groups, every one fused) with kernels (the CUDA
kernels' plain versions here, JAX's Pallas kernels in interpret mode) and
without, state handed from JAX to the port and back, and a checkpoint
exchanged both ways; the JAX package's unified-pipeline tests
(tests/test_unified_pipeline.py) ported; the live loop carrying digital
symbols to ``on_block``; and the plans ``chip_smoke.py`` runs, built.

Tolerances are tests/test_fused_route.py's: the iq tap atol 3e-4 / rtol
1e-3, audio rms < 2e-3 and 99.5% quantile < 5e-3, level atol 0.05;
digital symbols agree except where the port slicer's margin between its
two best scores is under 1e-5 (tests/test_torch_modems.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cubicsdr_tpu.ops.pallas.pfb as j_pfb  # noqa: E402
import cubicsdr_tpu.ops.pallas.route as j_route  # noqa: E402
from cubicsdr_tpu.app import checkpoint as jck  # noqa: E402
from cubicsdr_tpu.ops.planar import PC as JPC, PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.receiver import (  # noqa: E402
    DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)

from cubicsdr_tpu_torch.app.checkpoint import (  # noqa: E402
    load_state, save_state)
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodGroupSpec, ReceiverPipeline)
from cubicsdr_tpu_torch.utils.interop import (  # noqa: E402
    constants_from_jax, state_from_numpy, state_to_numpy)
from cubicsdr_tpu_torch.utils.synth import (  # noqa: E402
    Station, coverage_plans, scan58, synth_capture)
from cubicsdr_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

FS = 2_000_000
M = 8
BLOCK = 128_000
MARGIN = 1e-5
# (modem, bandwidth, demod offsets): every group fuses at this block.
GROUPS = (("FM", 200000, (-740e3, 260e3)), ("AM", 6000, (-540e3, 460e3)),
          ("CW", 500, (-210e3,)), ("BPSK", 20000, (40e3, -40e3)),
          ("FMS", 250000, (750e3,)))
STATIONS = (Station("fm", -740e3, 700.0), Station("fm", 260e3, 1300.0),
            Station("am", -540e3, 500.0), Station("am", 460e3, 900.0),
            Station("cw", -210e3, amplitude=0.2),
            Station("symbols", 40e3), Station("symbols", -40e3),
            Station("fms", 750e3))


@pytest.fixture(scope="module")
def interp():
    j_pfb.INTERPRET = j_route.INTERPRET = True
    yield
    j_pfb.INTERPRET = j_route.INTERPRET = False


def controls_for(rx):
    controls = rx.control_template()
    for ctl, (_, _, f) in zip(controls, GROUPS):
        ctl["frequency"] = np.asarray(f, np.float32)
    return controls


def run_jax(rx, st, blocks, controls):
    outs, states = [], []
    for blk in blocks:
        st, out = rx.apply(st, (JPC(jnp.asarray(blk[0]),
                                    jnp.asarray(blk[1])), controls))
        outs.append(jax.tree.map(np.asarray, out))
        states.append(jax.tree.map(np.asarray, st))
    return outs, states


def run_port(rx, st, blocks, controls):
    """Outputs per block and the state BEFORE each block (the digital
    kits' decision margins need it)."""
    outs, befores = [], []
    for blk in blocks:
        befores.append(st)
        st, out = rx.apply(st, (PC(torch.from_numpy(blk[0]),
                                   torch.from_numpy(blk[1])), controls))
        outs.append(out)
    return outs, befores, st


def audio_close(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert np.sqrt(np.mean(d * d)) < 2e-3, np.sqrt(np.mean(d * d))
    assert np.quantile(d, 0.995) < 5e-3


def assert_block_close(rx, out, ref, state_before):
    """One block of the port's outputs against the JAX pipeline's."""
    audio_close(out["mix"].numpy(), ref["mix"])
    for gi, (g, gj) in enumerate(zip(out["groups"], ref["groups"])):
        assert set(g) == set(gj), (gi, set(g) ^ set(gj))
        np.testing.assert_allclose(g["iq"].re.numpy(), gj["iq"].re,
                                   atol=3e-4, rtol=1e-3)
        np.testing.assert_allclose(g["iq"].im.numpy(), gj["iq"].im,
                                   atol=3e-4, rtol=1e-3)
        np.testing.assert_allclose(g["level"].numpy(), gj["level"],
                                   atol=0.05)
        if rx.is_digital[gi]:
            kit = rx.kits[gi]
            margin = kit.decision_margin(state_before["groups"][gi][1],
                                         g["iq"]).numpy()
            flip = g["symbols"].numpy() != gj["symbols"]
            assert not (flip & (margin >= MARGIN)).any(), gi
            assert g["symbols"].dtype == torch.int32
        else:
            audio_close(g["audio"].numpy(), gj["audio"])


def port_pipeline(kernels, **kw):
    return ReceiverPipeline(
        FS, [DemodGroupSpec(n, bw, len(f)) for n, bw, f in GROUPS],
        num_channels=M, use_kernels=kernels, block_len=BLOCK, device="cpu",
        **kw)


@pytest.fixture(scope="module")
def scenario(interp):
    """3 blocks of the small mixed capture through both JAX pipelines
    (Pallas under the interpreter, and XLA)."""
    iq = synth_capture(STATIONS, 3 * BLOCK, FS, "cpu", seed=3).numpy()
    blocks = [np.ascontiguousarray(iq[:, b * BLOCK:(b + 1) * BLOCK])
              for b in range(3)]
    res = {"blocks": blocks}
    for kernels in (True, False):
        rx = JPipeline(FS, [JSpec(n, bw, len(f)) for n, bw, f in GROUPS],
                       num_channels=M, dtype=JPLANAR, use_pallas=kernels,
                       block_len=BLOCK)
        assert rx.fused_route == [kernels] * len(GROUPS)
        assert rx.is_digital == [False, False, False, True, False]
        controls = controls_for(rx)
        outs, states = run_jax(rx, rx.init_state(), blocks, controls)
        res[kernels] = dict(rx=rx, controls=controls, outs=outs,
                            states=states)
    return res


@pytest.mark.parametrize("kernels", [True, False])
def test_mixed_pipeline_matches_jax(scenario, kernels):
    ref = scenario[kernels]
    rx = port_pipeline(kernels)
    assert rx.fused_route == [kernels] * len(GROUPS)
    assert rx.is_digital == ref["rx"].is_digital
    assert rx.audio_len == ref["rx"].audio_len == 3072
    outs, befores, _ = run_port(rx, rx.init_state(), scenario["blocks"],
                                ref["controls"])
    names = constants_from_jax(ref["rx"], rx)
    assert any(n.startswith("kits[4].hp_re") for n in names)
    for out, r, st in zip(outs, ref["outs"], befores):
        assert_block_close(rx, out, r, st)


def _to_jax_state(state_np):
    return tree_map(jnp.asarray, state_np,
                    node_map=lambda nt, kids: JPC(*kids))


@pytest.mark.parametrize("kernels", [True, False])
def test_mixed_state_hands_over_to_port_and_back(scenario, kernels):
    """Block 1 runs in JAX; its state continues in the port for block 2;
    the port's state goes back to JAX for block 3."""
    ref = scenario[kernels]
    rx = port_pipeline(kernels)
    st = state_from_numpy(ref["states"][0])
    outs, befores, st = run_port(rx, st, scenario["blocks"][1:2],
                                 ref["controls"])
    assert_block_close(rx, outs[0], ref["outs"][1], befores[0])
    st_np = state_to_numpy(st)
    for a, b in zip(tree_leaves(st_np), jax.tree.leaves(ref["states"][1])):
        assert a.shape == b.shape and a.dtype == b.dtype
    (out3,), _ = run_jax(ref["rx"], _to_jax_state(st_np),
                         scenario["blocks"][2:], ref["controls"])
    audio_close(out3["mix"], ref["outs"][2]["mix"])
    np.testing.assert_array_equal(out3["groups"][3]["symbols"].shape,
                                  ref["outs"][2]["groups"][3]["symbols"]
                                  .shape)


def test_mixed_checkpoint_round_trip_both_ways(scenario, tmp_path):
    """A JAX checkpoint after block 1 resumes in the port; the port's
    checkpoint after block 2 resumes in JAX (same .npz layout)."""
    ref = scenario[True]
    rx = port_pipeline(True)
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


def test_group_state_row_mask_matches_jax(scenario):
    """The row mask tags the fused frontend's per-channel tail shared, and
    every kit and gate leaf per-demod, leaf for leaf as the JAX
    package's."""
    rxj = scenario[True]["rx"]
    rx = port_pipeline(True)
    for gi in range(len(GROUPS)):
        got = tree_leaves(rx.group_state_row_mask(gi))
        want = jax.tree.leaves(rxj.group_state_row_mask(gi))
        assert got == [bool(w) for w in want]
        assert got.count(False) == 2          # the [M, hist] tail planes


# --- ports of tests/test_unified_pipeline.py ------------------------------

FS_U = 2_000_000


def _controls(rx, freqs_by_group):
    controls = rx.control_template()
    for ctl, freqs in zip(controls, freqs_by_group):
        ctl["frequency"] = np.asarray(freqs, np.float32)
    return controls


def _run(rx, iq, ctls, n_blocks):
    st, outs = rx.init_state(), []
    for b in range(n_blocks):
        blk = iq[b * rx.block_len:(b + 1) * rx.block_len]
        st, out = rx.apply(st, (PC(torch.from_numpy(blk.real.copy()),
                                   torch.from_numpy(blk.imag.copy())), ctls))
        outs.append(out)
    return outs


def _best_alignment(decoded, sent):
    """Accuracy of hard decisions at the best chain delay (0..63)."""
    best = 0.0
    for d in range(64):
        m = min(len(decoded) - d, len(sent))
        best = max(best, np.mean(np.sign(decoded[d:d + m])
                                 == np.sign(sent[:m])))
    return best


def test_fsk_decodes_through_pipeline():
    """Phase-continuous binary FSK (bits held 16 symbol frames) decodes
    through channelizer -> frontend -> kit, with no audio in the group."""
    sps, bw = 1200, 19200
    rx = ReceiverPipeline(FS_U, [DemodGroupSpec(
        "FSK", bw, 1, settings=(("bps", 1), ("sps", sps)))], device="cpu")
    assert rx.is_digital == [True]
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 40)
    k = bw // sps
    f_station = 310e3
    f_t = np.repeat(f_station + (bits - 0.5) * 0.45 * bw,
                    int(16 * k * FS_U // bw))
    iq = np.exp(1j * 2 * np.pi * np.cumsum(f_t) / FS_U).astype(np.complex64)
    outs = _run(rx, iq, _controls(rx, [[f_station]]),
                len(iq) // rx.block_len)
    for out in outs:
        g = out["groups"][0]
        assert {"symbols", "evm", "locked"} <= set(g) and "audio" not in g
    decoded = torch.cat([o["groups"][0]["symbols"][0] for o in outs]
                        ).numpy().astype(float) - 0.5
    assert _best_alignment(decoded, np.repeat(bits - 0.5, 16)) > 0.95


def test_gmsk_decodes_through_pipeline():
    """MSK-style capture (bits held 4 symbol frames) through channelizer
    -> frontend -> integrate-and-dump."""
    bw, sps, hold = 20000, 4, 4
    rx = ReceiverPipeline(FS_U, [DemodGroupSpec(
        "GMSK", bw, 1, settings=(("sps", sps),))], device="cpu")
    assert rx.is_digital == [True]
    rng = np.random.default_rng(5)
    f_station, n_blocks = 310e3, 3
    n = n_blocks * rx.block_len
    spb = hold * sps * int(FS_U // bw)
    bits = rng.integers(0, 2, n // spb + 1)
    f_t = np.repeat(f_station + (bits * 2 - 1) * (0.25 / sps) * bw, spb)[:n]
    iq = np.exp(1j * 2 * np.pi * np.cumsum(f_t) / FS_U).astype(np.complex64)
    outs = _run(rx, iq, _controls(rx, [[f_station]]), n_blocks)
    assert all("audio" not in o["groups"][0] for o in outs)
    dec = torch.cat([o["groups"][0]["symbols"][0] for o in outs]
                    ).numpy().astype(float) - 0.5
    assert _best_alignment(dec, np.repeat(bits - 0.5, hold)) > 0.9


def test_mixed_analog_digital_plan():
    """FM + BPSK in one step: the analog group feeds the mix, the digital
    group emits int32 symbols and meters its carrier."""
    rx = ReceiverPipeline(FS_U, [DemodGroupSpec("FM", 200000, 1),
                                 DemodGroupSpec("BPSK", 19200, 1)],
                          device="cpu")
    assert rx.is_digital == [False, True]
    iq = synth_capture([Station("fm", 300e3), Station("cw", -200e3, 1.0)],
                       3 * rx.block_len, FS_U, "cpu", seed=1,
                       noise=1e-4).numpy()
    iq = (iq[0] + 1j * iq[1]).astype(np.complex64)
    out = _run(rx, iq, _controls(rx, [[300e3], [-200e3]]), 3)[-1]
    fm, dig = out["groups"]
    assert fm["audio"].shape[-2] == 1
    assert out["mix"].shape[-2] == 2
    assert dig["symbols"].dtype == torch.int32
    assert "audio" not in dig and "peak" not in dig
    assert float(dig["level"][0]) > -40.0


def test_iq_group_audio_length_is_its_input_length():
    """I/Q's audio is its input stream: the length rule passes it through,
    and it mixes with an FM group at 48 kHz."""
    rx = ReceiverPipeline(8e6, [DemodGroupSpec("I/Q", 48000, 2),
                                DemodGroupSpec("FM", 200000, 1)],
                          device="cpu")
    fe = rx.frontends[0]
    assert rx._kit_out_len(0, 960) == 960
    assert rx.audio_len == fe.out_len(rx._chan_len)


# --- the live loop carries symbols ----------------------------------------

def test_live_loop_delivers_symbols_to_on_block(tmp_path):
    """LiveReceiver on the small mixed plan: on_block gets each digital
    group's symbols (unpacked as int32) equal to the pipeline's own;
    recording everything writes WAVs for the analog rows only, and the
    default sink's solo on a digital row yields no audio."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    rx = port_pipeline(True)
    iq = synth_capture(STATIONS, 3 * BLOCK, FS, "cpu", seed=3).numpy()
    blocks = [np.ascontiguousarray(iq[:, b * BLOCK:(b + 1) * BLOCK])
              for b in range(3)]
    ref, _, _ = run_port(rx, rx.init_state(), blocks, controls_for(rx))
    got = []
    lr = LiveReceiver(rx, controls_for(rx), iter(blocks),
                      record_path=str(tmp_path / "rec"), waterfall_fft=256,
                      waterfall_lines=8, on_block=got.append)
    lr.start_producer()
    assert lr.run_blocks() == 3
    lr.stop()
    for h, r in zip(got, ref):
        syms = h["groups"][3]["symbols"]
        assert syms.dtype == np.int32
        np.testing.assert_array_equal(syms, r["groups"][3]["symbols"])
        assert "audio" not in h["groups"][3]
        assert "symbols" not in h["groups"][0]
    # Flat rows: FM 0-1, AM 2-3, CW 4, BPSK 5-6, FMS 7.
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == sorted(f"rec_demod{k}.wav"
                             for k in (0, 1, 2, 3, 4, 7))
    lr.audio_solo = 5
    assert lr._solo_audio(got[-1]["groups"],
                          list(range(8))) is None
    lr.audio_solo = 7
    assert lr._solo_audio(got[-1]["groups"],
                          list(range(8))).shape == (2, rx.audio_len)


# --- the plans chip_smoke.py runs ------------------------------------------

def test_scan58_and_coverage_plans_build():
    """scan58 fuses all six groups at 2,048,000-sample blocks with the
    first stages the route kernel is checked at on the card (3/50 at
    O=384, 1/50 with 1,249 taps); the coverage plans cover every other
    registered modem, DSB/USB/LSB and FSK/GMSK on the gather path."""
    from cubicsdr_tpu_torch.modems import modem_names
    plan = scan58()
    rx = plan.pipeline(device="cpu")
    assert rx.block_len == 2_048_000 and rx.audio_len == 12288
    assert rx.fused_route == [True] * 6
    assert sum(g.count for g in plan.specs) == 58
    stage1 = [(fe._stage1.P, fe._stage1.Q, fe.tile) for fe in rx.frontends]
    assert stage1 == [(1, 5, 128), (1, 40, 128), (3, 50, 384),
                      (1, 50, 128), (1, 50, 128), (1, 4, 128)]
    assert rx.frontends[3]._stage1.KK == 1249
    covered = {g.modem_name for g in plan.specs}
    for p in coverage_plans():
        rx = p.pipeline(device="cpu")
        for g, fused in zip(p.specs, rx.fused_route):
            covered.add(g.modem_name)
            assert fused == (g.modem_name not in (
                "DSB", "USB", "LSB", "FSK", "GMSK")), g.modem_name
        assert len(p.freqs) == len(p.specs)
    assert covered == set(modem_names())
