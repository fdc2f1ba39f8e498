"""The compiled sharded step (``ShardedReceiver.make_step()``, the JAX
package's ``jax.jit(shard_map(...), donate_argnums=(0,))``) on a
one-rank mesh: a ``utils/compiled.py`` ``CompiledStep`` whose outputs and
state equal the eager step's bit for bit, a retune written into its
control buffers, its refusal of host collectives, a step whose state
leaves go out through the halo and the permute and are then written
over, and the step's shard paths free of what a CUDA graph capture
refuses (a value read back to the host, an upload from the host). The
same step on the 2x1, 2x2 and 4x1 gloo worlds, and against the JAX
sharded step, is in tests/test_torch_sharded.py; ``rx --mesh`` through
it in tests/test_torch_multihost.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_ranks as ranks  # noqa: E402
from cubicsdr_tpu_torch.parallel.mesh import Axis, ReceiverMesh  # noqa
from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver  # noqa
from cubicsdr_tpu_torch.receiver import DemodGroupSpec  # noqa: E402
from cubicsdr_tpu_torch.utils.compiled import CompiledStep  # noqa: E402
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402

FS = 1e6
# Every kind of shard path the step takes: fused FM, NBFM, AM, CW, BPSK
# and USB; FM stereo (whose de-emphasis composes its recurrence across
# shards) and I/Q on the gather path.
SPECS = [DemodGroupSpec("FM", 200000, 2), DemodGroupSpec("NBFM", 12500, 1),
         DemodGroupSpec("AM", 6000, 1), DemodGroupSpec("CW", 500, 1),
         DemodGroupSpec("BPSK", 20000, 1), DemodGroupSpec("FMS", 250000, 1),
         DemodGroupSpec("USB", 6000, 1), DemodGroupSpec("I/Q", 48000, 1)]
FREQS = (1.5e5, 3.1e5, 1.2e5, -3e5, -2.9e5, -1.5e5, 2e5, 4.2e5)


@pytest.fixture(scope="module")
def case():
    """The eager and the compiled step over 3 blocks from the same state;
    at block 2 NBFM is retuned by new placed controls (copied into the
    compiled step's control buffers) and AM by a value written into
    ``step.inputs`` directly, handed back as it is (the eager step gets
    the same controls)."""
    rx = ShardedReceiver(FS, 8, SPECS, device="cpu", spectrum_fft=256)
    assert rx.fused_route == [True] * 5 + [False, True, False]
    controls = rx.control_template()
    for ctl, f in zip(controls, FREQS):
        ctl["frequency"][:] = f
    controls[0]["squelch_enabled"][:] = True
    controls[0]["squelch_level"][:] = -60.0
    rng = np.random.default_rng(5)
    blocks = [rx.shard_iq((rng.standard_normal(rx.block_len) + 1j
                           * rng.standard_normal(rx.block_len))
                          .astype(np.complex64)) for _ in range(3)]
    step, eager = rx.make_step(), rx.make_step(compiled=False)
    placed = rx.place_controls(controls)
    st_c, st_e = rx.init_state(), rx.init_state()
    res = {"step": step, "eager": eager, "runs": [], "held": []}
    held = None
    for b, blk in enumerate(blocks):
        ctl_c = ctl_e = placed
        if b == 2:
            res["buffers"] = buffers = step.inputs[1]
            retuned = [dict(c) for c in controls]
            retuned[1]["frequency"] = np.array([3.3e5], np.float32)
            retuned[2]["frequency"] = np.array([-1.9e5], np.float32)
            ctl_e = rx.place_controls(retuned)
            buffers[2]["frequency"].fill_(-1.9e5)      # in place
            ctl_c = [*placed[:1], ctl_e[1], buffers[2], *placed[3:]]
        st_e, out_e = eager(st_e, (blk, ctl_e))
        st_c, out_c = step(st_c, (blk, ctl_c))
        if held is not None:     # the previous block's slot, as it is now
            res["held"].append(([t.clone() for t in tree_leaves(held[0])],
                                held[1]))
        res["runs"].append({
            "state_is_buffers": st_c is step.state,
            "out_c": [t.clone() for t in tree_leaves(out_c)],
            "out_e": [t.clone() for t in tree_leaves(out_e)],
            "state_c": [t.clone() for t in tree_leaves(st_c)],
            "state_e": [t.clone() for t in tree_leaves(st_e)],
            "keys": sorted(out_c)})
        held = (out_c, res["runs"][-1]["out_e"])
    return rx, controls, blocks, st_e, res


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_one_rank_compiled_step_equals_eager_bit_for_bit(case):
    """On a one-rank mesh ``make_step()`` is a ``CompiledStep`` that
    hands back its state buffers; its outputs (every group's iq, audio,
    levels, flags and symbols, the mix, the spectrum) and state equal the
    eager step's exactly over 2 blocks, and each block's outputs are
    still so after the next block."""
    _, _, _, _, res = case
    assert isinstance(res["step"], CompiledStep)
    assert not isinstance(res["eager"], CompiledStep)
    for run in res["runs"][:2]:
        assert run["state_is_buffers"] and "spectrum_mags" in run["keys"]
        _assert_same(run["out_c"], run["out_e"])
        _assert_same(run["state_c"], run["state_e"])
    for slot, eager in res["held"]:
        _assert_same(slot, eager)


def test_retune_writes_into_the_control_buffers(case):
    """A retune before block 2: new placed controls handed to the
    compiled step are copied into its static control buffers (so a graph
    replays with them), as is a value written into ``step.inputs``
    directly; the outputs and state equal the eager step's given the same
    controls."""
    _, _, _, _, res = case
    buffers = res["buffers"]
    assert res["step"].inputs[1] is buffers
    assert float(buffers[1]["frequency"][0]) == np.float32(3.3e5)
    assert float(buffers[2]["frequency"][0]) == np.float32(-1.9e5)
    run = res["runs"][2]
    _assert_same(run["out_c"], run["out_e"])
    _assert_same(run["state_c"], run["state_e"])


def test_host_collective_mesh_refuses_compilation():
    """A mesh whose collectives run through gloo on host copies cannot
    be captured: ``make_step()`` raises, naming the axes, and does not
    run eagerly behind the caller's back; ``compiled=False`` runs."""
    mesh = ReceiverMesh(Axis(host=True), Axis(host=True))
    rx = ShardedReceiver(1e6, 8, [DemodGroupSpec("FM", 200000, 1)],
                         mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match=r"host collectives.*'time', "
                       r"'chan'.*compiled=False"):
        rx.make_step()
    ctl = rx.control_template()
    ctl[0]["frequency"][:] = 1e5
    x = rx.shard_iq(np.zeros(rx.block_len, np.complex64))
    state, out = rx.make_step(compiled=False)(
        rx.init_state(), (x, rx.place_controls(ctl)))
    assert out["mix"].shape == (2, rx.local_audio_len)


def test_halo_state_leaves_overwritten_after_the_exchange():
    """One rank: a step whose carry is the halo of time shard 0, whose
    accumulator is sent through the permute and then written over in
    place, returned as new state and as an output: compiled = eager, each
    call's outputs intact after the next (``halo_case``)."""
    assert ranks.halo_case(Axis()) == 0


def test_shard_paths_hold_nothing_a_capture_refuses(case, monkeypatch):
    """The eager sharded step on every shard path reads nothing back to
    the host (no ``.item()``, ``.tolist()``, branch on a tensor or shape
    taken from data: ``_local_scalar_dense``, ``nonzero``) and makes no
    tensor from host data (``torch.tensor``, ``torch.as_tensor`` or
    ``torch.from_numpy`` of a Python or numpy value, an upload on the
    card): a CUDA graph capture refuses both. The placed controls are
    tensors already, so ``step``'s ``torch.as_tensor`` calls hand them
    back as they are. The case's blocks ran first: they built the step's
    constants (IIR tiles, tile matrices), as a compiled step's warm-ups
    do before its capture."""
    from torch.utils._python_dispatch import TorchDispatchMode
    rx, controls, blocks, state, _ = case
    placed = rx.place_controls(controls)
    seen = []

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name in ("_local_scalar_dense", "item", "nonzero",
                        "masked_select", "unique"):
                seen.append(name)
            return func(*args, **(kwargs or {}))

    for name in ("tensor", "as_tensor", "from_numpy"):
        make = getattr(torch, name)

        def upload(data, *a, _make=make, _name=name, **k):
            if not isinstance(data, torch.Tensor):
                seen.append(f"torch.{_name}({type(data).__name__})")
            return _make(data, *a, **k)
        monkeypatch.setattr(torch, name, upload)

    with HostReads():
        state, out = rx.step(state, blocks[0], placed)
    assert seen == []
    assert torch.isfinite(out["mix"]).all()
