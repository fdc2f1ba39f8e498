"""The compiled step (``cubicsdr_tpu_torch/utils/compiled.py``) and the
live loop's compiled step and post-step caches (``app/runner.py``), on
the CPU, where a ``CompiledStep`` runs its function eagerly under the
same buffer rules as its CUDA graphs on the card.

- the compiled live step equals the eager closure (``compiled=False``)
  exactly, a difference of 0.0, over 6 blocks each of a small FM plan, a
  mixed-modem plan (FM, AM, CW, BPSK, FM stereo), int16 ingest and a
  complex64 plan;
- block i-1's outputs survive block i's call, and block i+1's call
  reuses them (the two output slots);
- a swap away and back reuses the same cache entry, which carries the
  state; a control edit takes effect at the next block on the same
  entry; the post-step cache hits when a view is toggled back;
- the compiled live loop's host outputs (mix, levels, symbols, waterfall
  lines) match the JAX package's ``LiveReceiver`` on the same blocks at
  tests/test_torch_runner.py's tolerances (mix rms < 2e-3 and 99.5%
  quantile < 5e-3, levels 0.05, lines 2e-3 but the stream's first two);
  symbols equal wherever the port slicer's two best scores are 1e-5
  apart or more (tests/test_torch_mixed_pipeline.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cubicsdr_tpu.app.runner import LiveReceiver as JLive  # noqa: E402
from cubicsdr_tpu.ops.planar import PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.receiver import (  # noqa: E402
    DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)

from cubicsdr_tpu_torch.app.runner import LiveReceiver  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodGroupSpec, ReceiverPipeline)
from cubicsdr_tpu_torch.utils.compiled import CompiledStep  # noqa: E402
from cubicsdr_tpu_torch.utils.synth import (  # noqa: E402
    Station, synth_capture)
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402

N_BLOCKS = 6
FM_FS, FM_L = 1_000_000, 16750
# The small mixed plan of tests/test_torch_mixed_pipeline.py.
MIX_FS, MIX_M, MIX_L = 2_000_000, 8, 128_000
MIX_GROUPS = (("FM", 200000, (-740e3, 260e3)),
              ("AM", 6000, (-540e3, 460e3)), ("CW", 500, (-210e3,)),
              ("BPSK", 20000, (40e3, -40e3)), ("FMS", 250000, (750e3,)))
MIX_STATIONS = (Station("fm", -740e3, 700.0), Station("fm", 260e3, 1300.0),
                Station("am", -540e3, 500.0), Station("am", 460e3, 900.0),
                Station("cw", -210e3, amplitude=0.2),
                Station("symbols", 40e3), Station("symbols", -40e3),
                Station("fms", 750e3))
MARGIN = 1e-5
PTS_ATOL = 2e-3


def fm_plan(dtype=None, freqs=(200e3,), **kw):
    if dtype is not None:
        kw["dtype"] = dtype
    rx = ReceiverPipeline(FM_FS, [DemodGroupSpec("FM", 200000, len(freqs))],
                          block_len=FM_L, device="cpu", **kw)
    ctl = rx.control_template()
    ctl[0]["frequency"] = np.asarray(freqs, np.float32)
    return rx, ctl


def mixed_plan(kernels=True):
    rx = ReceiverPipeline(
        MIX_FS, [DemodGroupSpec(n, bw, len(f)) for n, bw, f in MIX_GROUPS],
        num_channels=MIX_M, use_kernels=kernels, block_len=MIX_L,
        device="cpu")
    ctl = rx.control_template()
    for c, (_, _, f) in zip(ctl, MIX_GROUPS):
        c["frequency"] = np.asarray(f, np.float32)
    return rx, ctl


def blocks_of(stations, fs, L, n=N_BLOCKS, seed=3, dtype=np.float32):
    iq = synth_capture(stations, n * L, fs, "cpu", seed=seed).numpy()
    out = [np.ascontiguousarray(iq[:, b * L:(b + 1) * L]) for b in range(n)]
    if dtype != np.float32:
        full = float(np.iinfo(dtype).max + 1)
        out = [np.clip(b * full, -full, full - 1).astype(dtype)
               for b in out]
    return out


def fm_blocks(n=N_BLOCKS, dtype=np.float32):
    return blocks_of([Station("fm", 200e3, 1000.0)], FM_FS, FM_L, n,
                     dtype=dtype)


def leaves_equal(a, b) -> float:
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    worst = 0.0
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.numel():
            worst = max(worst, float((x.to(torch.complex128)
                                      - y.to(torch.complex128)).abs().max()))
    return worst


CASES = {
    "fm": lambda: (fm_plan(), fm_blocks(), None),
    "mixed": lambda: (mixed_plan(), blocks_of(MIX_STATIONS, MIX_FS, MIX_L),
                      None),
    "int16": lambda: (fm_plan(), fm_blocks(dtype=np.int16), np.int16),
    "complex64": lambda: (fm_plan(torch.complex64, (200e3, -300e3)),
                          blocks_of([Station("fm", 200e3, 1000.0),
                                     Station("fm", -300e3, 700.0)],
                                    FM_FS, FM_L), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_step_equals_the_eager_closure(case):
    """The live loop's compiled step against its eager closure on the
    same blocks and controls: every output and the state, difference
    0.0, block by block; the entry owns the state buffers."""
    (rx, ctl), blocks, ingest = CASES[case]()
    lrs = [LiveReceiver(rx, ctl, iter(()), ingest_dtype=ingest,
                        waterfall_fft=256, compiled=c) for c in (True, False)]
    comp, eager = lrs
    assert isinstance(comp.step, CompiledStep)
    assert not isinstance(eager.step, CompiledStep)
    for blk in blocks:
        iq = (torch.from_numpy(blk[0]), torch.from_numpy(blk[1]))
        outs = []
        for lr in lrs:
            _, c = lr._device_controls()
            lr.state, out = lr.step(lr.state, (iq, c))
            outs.append(out)
        assert leaves_equal(*outs) == 0.0
        assert leaves_equal(comp.state, eager.state) == 0.0
        assert comp.state is comp.step.state
    for lr in lrs:
        lr.stop()


def test_previous_block_outputs_survive_the_next_call():
    """Block i-1's outputs (the iq passthrough and the group taps
    included) hold their values through block i's call; block i+1's
    call writes the same buffers (two output slots)."""
    (rx, ctl), blocks = fm_plan(), fm_blocks(4)
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    st = rx.init_state()
    outs, refs = [], []
    for blk in blocks:
        iq = (torch.from_numpy(blk[0]), torch.from_numpy(blk[1]))
        _, c = lr._device_controls()
        lr.state, out = lr.step(lr.state, (iq, c))
        st, ref = rx.apply(st, (PC(*iq), c))
        outs.append(out)
        refs.append(ref)
        if len(outs) >= 2:
            # Block i-1 after block i's call.
            assert leaves_equal(outs[-2], refs[-2]) == 0.0
            assert outs[-2] is not outs[-1]
    assert outs[0] is outs[2] and outs[1] is outs[3]
    assert leaves_equal(outs[0], refs[2]) == 0.0
    assert out["iq"].re.data_ptr() != lr.step.inputs[0][0].data_ptr()
    lr.stop()


def test_compiled_step_buffer_rules():
    """A toy step: a leaf that is its buffer is not copied, a state
    swapped between leaves lands right, a wrong shape raises, numpy
    state loads, and one slot reuses its outputs at every call."""
    def fn(state, inputs):
        a, b = state
        return (b, a + inputs), {"sum": a + b, "x": inputs}

    cs = CompiledStep(fn, "cpu")
    st, out = cs((torch.ones(3), torch.zeros(3)), torch.full((3,), 2.0))
    assert st is cs.state and out["x"] is not cs.inputs
    assert torch.equal(st[0], torch.zeros(3))
    assert torch.equal(st[1], torch.full((3,), 3.0))
    x = cs.inputs
    x.fill_(1.0)                       # written in place: not copied
    st, out2 = cs(st, x)
    assert torch.equal(st[0], torch.full((3,), 3.0))
    assert torch.equal(st[1], torch.ones(3))
    assert torch.equal(out["sum"], torch.ones(3))   # slot 0 survives
    with pytest.raises(ValueError, match="shape"):
        cs(st, torch.zeros(4))
    with pytest.raises(ValueError, match="leaves"):
        cs((st[0],), x)
    cs.load_state((np.zeros(3, np.float32), np.ones(3, np.float32)))
    assert torch.equal(cs.state[1], torch.ones(3))
    one = CompiledStep(fn, "cpu", slots=1)
    _, o1 = one((torch.ones(3), torch.zeros(3)), torch.zeros(3))
    _, o2 = one(one.state, one.inputs)
    assert o1 is o2
    with pytest.raises(ValueError, match="slots"):
        CompiledStep(fn, "cpu", slots=0)


def _run(lr, blocks):
    for b in blocks:
        assert lr.ring.write(np.ascontiguousarray(b[0]),
                             np.ascontiguousarray(b[1]))
    return lr.run_blocks(max_blocks=len(blocks), wait=False)


def test_swap_away_and_back_reuses_the_entry_and_carries_state():
    """A returning plan reuses its compiled step: the same object, its
    state buffers holding the state carried in (here a snapshot), no new
    build; a control edit lands at the next block on the same entry."""
    rx_a, ctl_a = fm_plan()
    rx_b, ctl_b = fm_plan(freqs=(200e3, -300e3))
    blocks = fm_blocks(6)
    lr = LiveReceiver(rx_a, ctl_a, iter(()), waterfall_fft=256)
    entry_a = lr.step
    assert _run(lr, blocks[:2]) == 2
    snap = lr.snapshot_state()
    lr.swap_pipeline(rx_b, ctl_b)
    entry_b = lr.step
    assert entry_b is not entry_a and lr.step_builds == 2
    assert _run(lr, blocks[2:3]) == 1
    lr.swap_pipeline(rx_a, ctl_a, state=snap)
    assert lr.step is entry_a and lr.step_builds == 2
    assert lr.state is entry_a.state
    for got, want in zip(tree_leaves(lr.state), tree_leaves(snap)):
        np.testing.assert_array_equal(got.numpy(), want)
    levels = []
    lr.on_block = lambda h: levels.append(h["groups"][0]["level"].copy())
    assert _run(lr, blocks[3:4]) == 1
    ctl_a[0]["gain"][:] = 0.0            # edited in place
    assert _run(lr, blocks[4:5]) == 1
    assert lr.step is entry_a and lr.step_builds == 2
    mix = []
    lr.on_block = lambda h: mix.append(h["mix"].copy())
    assert _run(lr, blocks[5:6]) == 1
    assert not np.abs(mix[0]).any()      # gain 0 silences the mix
    assert torch.equal(entry_a.inputs[1][0]["gain"], torch.zeros(1))
    lr.stop()


def test_post_step_cache_hits_when_a_view_is_toggled_back():
    """Turning the demod view on, off and on again, and moving it to the
    other row of its group, builds two post-steps, not four."""
    rx, ctl = fm_plan(freqs=(200e3, -300e3))
    blocks = fm_blocks(5)
    lr = LiveReceiver(rx, ctl, iter(()), waterfall_fft=256)
    assert _run(lr, blocks[:1]) == 1
    assert lr.post_builds == 1
    lr.set_demod_view(0)
    assert _run(lr, blocks[1:2]) == 1
    lr.set_demod_view(None)
    assert _run(lr, blocks[2:3]) == 1
    lr.set_demod_view(0)
    assert _run(lr, blocks[3:4]) == 1
    lr.set_demod_view(1)                 # the same group: same program
    assert _run(lr, blocks[4:5]) == 1
    assert lr.post_builds == 2
    # (One block into a fresh view: its first frames are 0/0, as in the
    # JAX package, so only the shape is checked.)
    assert lr.demod_spectrum.shape == (256,)
    lr.stop()


def _jax_plan(case):
    """The JAX pipeline and controls of ``case`` (XLA, planar)."""
    if case == "mixed":
        rx = JPipeline(MIX_FS,
                       [JSpec(n, bw, len(f)) for n, bw, f in MIX_GROUPS],
                       num_channels=MIX_M, dtype=JPLANAR, use_pallas=False,
                       block_len=MIX_L)
        freqs = [f for _, _, f in MIX_GROUPS]
    else:
        rx = JPipeline(FM_FS, [JSpec("FM", 200000, 1)], dtype=JPLANAR,
                       block_len=FM_L)
        freqs = [(200e3,)]
    ctl = rx.control_template()
    for c, f in zip(ctl, freqs):
        c["frequency"] = np.asarray(f, np.float32)
    return rx, ctl


@pytest.mark.parametrize("case", ["mixed", "fm"])
def test_compiled_live_loop_matches_jax(case):
    """The port's compiled live loop and the JAX package's on the same
    blocks: mix and levels; on the mixed plan (6 blocks) its symbols, on
    the FM plan (12 blocks, the 4-line waterfall of
    tests/test_torch_runner.py) the waterfall lines. (The mixed plan's
    early lines sit below 0 while the floor settles, where rounding in
    the normalisation moves them by more than the points' tolerance.)"""
    if case == "mixed":
        blocks = blocks_of(MIX_STATIONS, MIX_FS, MIX_L)
        rx, ctl = mixed_plan(kernels=False)
        lines = 8
    else:
        blocks = fm_blocks(12)
        rx, ctl = fm_plan(use_kernels=False)
        lines = 4
    jrx, jctl = _jax_plan(case)
    got = {"port": [], "jax": []}
    lrs = {"port": LiveReceiver(rx, ctl, iter(blocks), waterfall_fft=256,
                                waterfall_lines=lines,
                                on_block=got["port"].append),
           "jax": JLive(jrx, jctl, iter(blocks), waterfall_fft=256,
                        waterfall_lines=lines, on_block=got["jax"].append)}
    for lr in lrs.values():
        lr.start_producer()
        assert lr.run_blocks() == len(blocks)
        lr.stop()
    assert isinstance(lrs["port"].step, CompiledStep)
    # Margins from the eager pipeline, which the compiled step equals.
    st = rx.init_state()
    for b, (hp, hj) in enumerate(zip(got["port"], got["jax"])):
        before = st
        st, ref = rx.apply(st, (PC(torch.from_numpy(blocks[b][0]),
                                   torch.from_numpy(blocks[b][1])), ctl))
        d = np.abs(hp["mix"] - np.asarray(hj["mix"]))
        assert np.sqrt(np.mean(d * d)) < 2e-3
        assert np.quantile(d, 0.995) < 5e-3
        for gi, (gp, gj) in enumerate(zip(hp["groups"], hj["groups"])):
            np.testing.assert_allclose(gp["level"], np.asarray(gj["level"]),
                                       atol=0.05)
            if rx.is_digital[gi]:
                margin = rx.kits[gi].decision_margin(
                    before["groups"][gi][1], ref["groups"][gi]["iq"])
                flip = gp["symbols"] != np.asarray(gj["symbols"])
                assert gp["symbols"].dtype == np.int32
                assert not (flip & (margin.numpy() >= MARGIN)).any()
    assert sum(rx.is_digital) == (case == "mixed")
    if case == "fm":
        # Lines 4-7 of the 7 drawn: the first two are 0/0-conditioned.
        wp, wj = (lr.waterfall.buffer for lr in lrs.values())
        assert wp.max() > 0
        np.testing.assert_allclose(wp, wj, atol=PTS_ATOL)
