"""The port's ShardedReceiver on gloo CPU ranks (one process per rank)
against the JAX package's ShardedReceiver(use_pallas=True) on the
virtual 8-device CPU mesh, both Pallas kernels interpreted: the analogs
of tests/test_parallel.py and tests/test_fused_route.py.

Each mesh runs as one world: the JAX receiver runs a block to a nonzero
state, the port's ranks start from that state (``place_state`` cuts each
rank's shard from the JAX layout), and both run two more blocks. Gates:
every group's IQ tap (``_iq_gate``: envelope at atol 3e-4 / rtol 1e-3,
one rotation per time shard); the pipeline's audio gates
for the mix and audio (rms < 2e-3, 99.5% quantile < 5e-3), levels at
0.05, squelch flags equal, digital symbols equal wherever the port's
slicer margin is at least 1e-5; the carried IQ tails (channelizer, DC
blocker, fused-route channel tails) at atol 3e-4 / rtol 1e-3; and the
phase-invariant rest of the gathered state in the JAX layout. The JAX
ShardedReceiver emits no IQ tap, so ``_TappedSharded`` records each
kit's input (the port's ``iq`` output) while its step is traced. The 4x1
world adds CW, USB and I/Q, whose audio follows the carrier's phase. The
closed-form shard phase, base + omega * t * L at up to 1e5 rad, is
rounded to float32 by the jitted JAX step otherwise than by any eager
evaluation (the port rounds it once, as a fused multiply-add, which
matches most shards bit for bit): the taps may differ by one rotation
per time shard (``_iq_gate``), and outputs that follow the carrier's
phase are held by measures that such a rotation leaves as they are."""

import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import cubicsdr_tpu.ops.pallas.pfb as pfb_mod  # noqa: E402
import cubicsdr_tpu.ops.pallas.route as route_mod  # noqa: E402
from cubicsdr_tpu.ops.planar import PC as JPC  # noqa: E402
from cubicsdr_tpu.parallel import make_receiver_mesh  # noqa: E402
from cubicsdr_tpu.parallel.sharded import ShardedReceiver  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from cubicsdr_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402

MESHES = [(2, 1), (2, 2), (4, 1)]
PHASE_MESH = (4, 1)          # the world that adds CW, USB and I/Q
PHASE_AUDIO = ("CW", "USB", "I/Q")


def _omega(gi):
    """Group gi's NCO rate (rad per channel sample): its frequency's
    offset from the nearest channel centre over the 250 kS/s channel
    rate."""
    from cubicsdr_tpu_torch.ops.channelizer import channel_centers
    c = channel_centers(8, ranks.FS)
    f = ranks.FREQS[gi]
    return 2 * np.pi * (c[np.argmin(np.abs(c - f))] - f) / 250e3


class _TappedSharded(ShardedReceiver):
    """The JAX ShardedReceiver with each group's IQ tap (its kit's input,
    sharded as the symbols) among its outputs."""

    def _out_specs(self):
        out = super()._out_specs()
        for g in out["groups"]:
            g["iq"] = JPC(P("chan", "time"), P("chan", "time"))
        return out

    def _shard_body(self, state, iq_local, controls):
        taps = []

        def tap(apply):
            def run(carry, y, axis):
                taps.append(y)
                return apply(carry, y, axis)
            return run

        for kit in self.kits:
            kit.shard_apply = tap(kit.shard_apply)
        try:
            new_state, outs = super()._shard_body(state, iq_local, controls)
        finally:
            for kit in self.kits:
                del kit.shard_apply
        for g, y in zip(outs["groups"], taps):
            g["iq"] = y
        return new_state, outs


def _capture(n):
    """tests/test_parallel.py's band: FM at +150 kHz, AM at +120 kHz, a
    carrier under the BPSK row at -300 kHz, plus a little noise."""
    t = np.arange(n) / ranks.FS
    msg = np.sin(2 * np.pi * 1000.0 * t)
    rng = np.random.default_rng(7)
    return (0.7 * np.exp(1j * (2 * np.pi * 150e3 * t
                               + 2 * np.pi * 75e3 * np.cumsum(msg) / ranks.FS))
            + 0.4 * (1 + 0.5 * np.sin(2 * np.pi * 700.0 * t))
            * np.exp(2j * np.pi * 120e3 * t)
            + 0.5 * np.exp(2j * np.pi * -300e3 * t)
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _np_tree(x):
    """A JAX state as numpy leaves with plain tuples for planar pairs, so
    a rank unpickles it without the JAX package."""
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np_tree(v) for v in x)
    return np.asarray(x)


def _jax_world(nt, nc, tmp):
    """The JAX receiver on an nt x nc mesh: a block to a nonzero state
    (written as the ranks' case), then two more blocks; returns its
    outputs and final state."""
    mesh = make_receiver_mesh(n_time=nt, n_chan=nc,
                              devices=jax.devices()[: nt * nc])
    rx = _TappedSharded(ranks.FS, num_channels=8,
                        groups=ranks.groups(nc, (nt, nc) == PHASE_MESH),
                        mesh=mesh, use_pallas=True)
    controls = rx.control_template()
    for ctl, f in zip(controls, ranks.FREQS):
        ctl["frequency"][:] = f
    controls[0]["squelch_enabled"][:] = True
    controls[0]["squelch_level"][:] = -60.0
    step = rx.make_step()
    iq = _capture(3 * rx.block_len)
    blocks = [iq[b * rx.block_len:(b + 1) * rx.block_len] for b in range(3)]
    st = rx.place_state(rx.init_state())
    st, _ = step(st, rx.shard_iq(blocks[0]), controls)
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump({"state": _np_tree(jax.device_get(st)),
                     "controls": controls, "blocks": blocks[1:],
                     "block_len": rx.block_len}, f)
    outs = []
    for blk in blocks[1:]:
        st, out = step(st, rx.shard_iq(blk), controls)
        outs.append(jax.tree.map(np.asarray, out))
    return {"outs": outs, "final": _np_tree(jax.device_get(st)),
            "fused": list(rx.fused_route), "block_len": rx.block_len,
            "controls": controls}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every mesh through both packages: each world's ranks start as soon
    as the JAX receiver has written its case, and run while the JAX side
    goes on."""
    res, runs = {}, []
    pfb_mod.INTERPRET = route_mod.INTERPRET = True
    with ThreadPoolExecutor(len(MESHES)) as pool:
        try:
            for nt, nc in MESHES:
                tmp = tmp_path_factory.mktemp(f"world{nt}x{nc}")
                res[(nt, nc)] = _jax_world(nt, nc, tmp)
                runs.append((tmp, (nt, nc), pool.submit(
                    spawn_ranks, ranks.run_world, nt * nc,
                    args=(nt, nc, (nt, nc) == PHASE_MESH,
                          str(tmp / "case.pkl"), str(tmp / "out.pkl")),
                    device="cpu", init_method=f"file://{tmp / 'store'}")))
        finally:
            pfb_mod.INTERPRET = route_mod.INTERPRET = False
    for tmp, key, run in runs:
        run.result()
        with open(tmp / "out.pkl", "rb") as f:
            res[key]["port"] = pickle.load(f)
    return res


def _audio_gate(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert np.sqrt(np.mean(d * d)) < 2e-3
    assert np.quantile(d, 0.995) < 5e-3


def _iq_gate(got, want, n_shards):
    """A group's IQ tap: its envelope at atol 3e-4 / rtol 1e-3, and per
    time shard and row one rotation between the two taps, under 0.1 rad,
    the same on the shard's two halves within 1e-2 rad (so no frequency
    error beyond the jitted step's one-ulp omega; measured: 6.6e-2 rad
    and 6.1e-3 rad at most). The rotation is
    the float32 closed-form shard phase, rounded by the jitted JAX step
    other than by any eager evaluation (ROADMAP hazards)."""
    zp, zj = (p.re.astype(np.float64) + 1j * p.im for p in (got, want))
    assert zp.shape == zj.shape
    np.testing.assert_allclose(np.abs(zp), np.abs(zj), atol=3e-4, rtol=1e-3)
    L = zj.shape[-1] // n_shards
    for s in range(n_shards):
        first, second = (np.angle(np.sum(zp[..., h] * np.conj(zj[..., h]),
                                         axis=-1))
                         for h in (slice(s * L, s * L + L // 2),
                                   slice(s * L + L // 2, (s + 1) * L)))
        assert np.abs(first).max() < 0.1
        assert np.abs(np.angle(np.exp(1j * (second - first)))).max() < 1e-2


def _phase_audio_gate(got, want):
    """Audio that follows the carrier's phase (CW, USB, I/Q), under the
    rotation ``_iq_gate`` allows: each row's rms within 1e-3 and its
    magnitude spectrum within 1e-2 of the norm (measured: 3.1e-6 and
    1.2e-3 at most); another pitch, offset or waveform moves both."""
    from cubicsdr_tpu_torch.parallel.multihost import _spectrum_distance
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    p, q = (np.sqrt(np.mean(x * x, axis=(-2, -1))) for x in (got, want))
    assert np.max(np.abs(p - q) / q) < 1e-3
    assert np.max(_spectrum_distance(got, want)) < 1e-2


def _want_mix(o_j, o_p, controls, names):
    """The JAX mix with the phase-following groups' rows (audio and
    peaks) taken from the port, through the port's mixer: what the port's
    mix must be, given its own phase-following audio."""
    from cubicsdr_tpu_torch.receiver.mixer import mix_audio
    audio, gains, active, peaks = [], [], [], []
    for g_j, g_p, ctl, name in zip(o_j["groups"], o_p["groups"], controls,
                                   names):
        if "audio" not in g_j:
            continue
        g = g_p if name in PHASE_AUDIO else g_j
        a = torch.tensor(np.asarray(g["audio"]))
        audio.append(torch.cat([a, a], dim=-2) if a.shape[-2] == 1 else a)
        peaks.append(torch.tensor(np.asarray(g["peak"])))
        gains.append(torch.tensor(ctl["gain"]))
        active.append(torch.tensor(ctl["active"]))
    mix, _ = mix_audio(torch.cat(audio, dim=-3), torch.cat(gains),
                       torch.cat(active), torch.cat(peaks))
    return mix.numpy()


@pytest.mark.parametrize("nt,nc", MESHES)
def test_sharded_outputs_match_jax_sharded(nt, nc, worlds):
    """IQ taps, mix, audio, levels, squelch and symbols of the port's
    ranks against the JAX ShardedReceiver over 2 blocks; every group but
    I/Q fused, as in the JAX receiver, so each rank ran both kernels'
    plain versions. Phase-following audio (CW, USB, I/Q) by
    ``_phase_audio_gate``, and the mix by the audio gates against the
    JAX mix with those rows taken from the port (``_want_mix``)."""
    from cubicsdr_tpu_torch.modems import make_modem
    from cubicsdr_tpu_torch.ops.planar import PC
    w = worlds[(nt, nc)]
    outs, port = w["outs"], w["port"]
    phase = (nt, nc) == PHASE_MESH
    names = [g.modem_name for g in ranks.groups(nc, phase)]
    assert port["fused_route"] == w["fused"] == (
        [True] * 5 + [False] if phase else [True] * 3)
    bpsk = make_modem("BPSK").build_kit(20000, batch_shape=(nc,))
    for o_j, o_p in zip(outs, port["outs"]):
        _audio_gate(o_p["mix"], _want_mix(o_j, o_p, w["controls"], names)
                    if phase else o_j["mix"])
        for gi, (g_j, g_p) in enumerate(zip(o_j["groups"], o_p["groups"])):
            _iq_gate(g_p["iq"], g_j["iq"], nt)
            np.testing.assert_allclose(g_p["level"], g_j["level"], atol=0.05)
            np.testing.assert_array_equal(g_p["squelched"], g_j["squelched"])
            if "audio" in g_j:
                assert g_p["audio"].shape == g_j["audio"].shape
                (_phase_audio_gate if names[gi] in PHASE_AUDIO
                 else _audio_gate)(g_p["audio"], g_j["audio"])
            else:
                iq = PC(*(torch.from_numpy(p) for p in g_p["iq"]))
                margin = bpsk.decision_margin((), iq).numpy()
                firm = margin >= 1e-5
                assert firm.mean() > 0.99
                np.testing.assert_array_equal(g_p["symbols"][firm],
                                              g_j["symbols"][firm])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("nt,nc", MESHES)
def test_gathered_state_equals_jax_state(nt, nc, worlds):
    """The port's state, gathered to the JAX layout (leading [nt] axis,
    'chan' rows in global order), equals the JAX state leaf for leaf: the
    same paths, shapes and dtypes; the carried IQ tails within the iq
    gates; the NCO phase bases within the float32 rounding of the
    block's phase advance (the jit-FMA and omega hazards of the JAX step,
    ROADMAP);
    the squelch and AGC trackers within 0.05."""
    w = worlds[(nt, nc)]
    case_len = w["block_len"]
    j = dict(_leaves(w["final"]))
    p = dict(_leaves(w["port"]["state"]))
    assert j.keys() == p.keys()
    for path, a in j.items():
        b = p[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path[0] in ("chan", "dc") or path[2:4] == (0, 1):
            np.testing.assert_allclose(b, a, atol=3e-4, rtol=1e-3,
                                       err_msg=str(path))
        elif path[2:4] == (0, 0):           # the per-demod phase base
            # base + omega * n_t * L, about 1e5-4e5 rad, where one float32
            # ulp is 2^-7-2^-5 rad. Per block each side rounds the product
            # and the sum (the jitted JAX step may contract them into an
            # FMA), and the jitted step's omega may be one ulp off the
            # port's (ROADMAP hazards: more than two ulps per block on the
            # 4x1 mesh's I/Q row).
            d = np.angle(np.exp(1j * (b.astype(np.float64) - a)))
            omega = _omega(path[1])
            n = case_len // 4                         # n_t * L
            per_block = (2 * np.spacing(np.float32(abs(omega) * n))
                         + n * np.spacing(np.float32(abs(omega))))
            assert np.abs(d).max() <= 2 * per_block, path   # 2 blocks
        elif a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        else:
            np.testing.assert_allclose(b, a, atol=0.05, rtol=1e-3,
                                       err_msg=str(path))


@pytest.mark.parametrize("nt,nc", MESHES)
def test_halo_exchange_and_collectives(nt, nc, worlds):
    """with_halo is cyclic (shard 0 receives the last shard's tail, as
    tests/test_parallel.py::test_halo_exchange_cyclic); streaming_halo
    gives shard 0 its carry and every shard what it received; psum, pmax,
    pmean and all_gather over 'time' and psum over 'chan' (checked on
    rank 0: time 0, chan 0)."""
    port = worlds[(nt, nc)]["port"]
    c = port["collectives"]
    assert port["coord"] == (0, 0)
    last = 8 * nt - 1
    np.testing.assert_array_equal(
        c["with_halo"], np.r_[last - 2:last + 1, np.arange(8)])
    np.testing.assert_array_equal(c["streaming"][0],
                                  np.r_[-1, -1, -1, np.arange(8)])
    np.testing.assert_array_equal(c["streaming"][1],
                                  np.r_[-2, -2, -2, -np.arange(8)])
    np.testing.assert_array_equal(c["received"][0],
                                  np.arange(last - 2, last + 1))
    ranks_t = np.arange(1, nt + 1, dtype=np.float32)
    np.testing.assert_array_equal(c["psum"], [ranks_t.sum(), 0.0])
    np.testing.assert_array_equal(c["pmax"], [float(nt), 0.0])
    np.testing.assert_allclose(c["pmean"], [ranks_t.mean(), 0.0])
    np.testing.assert_array_equal(c["gather"][:, 0], ranks_t)
    np.testing.assert_array_equal(c["chan_psum"],
                                  [float(nc), nc * (nc - 1) / 2])


def test_one_rank_mesh_equals_the_pipeline():
    """On a one-rank mesh (no process group) the sharded step is the
    unsharded pipeline's: demods in channel 0 too, whose DC-blocked
    samples are written over the channelizer's output after the DC
    blocker's halo is taken (the halo must be a copy). iq tap at atol
    3e-4 / rtol 1e-3 over 3 blocks, and each group's carried NCO phase
    equal bit for bit (the base advances per block as the unsharded step
    rounds it)."""
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.parallel.sharded import (
        ShardedReceiver as PortSharded)
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    specs = [DemodGroupSpec("FM", 200000, 2), DemodGroupSpec("AM", 6000, 2)]
    srx = PortSharded(2e6, 8, specs, device="cpu")
    rx = ReceiverPipeline(2e6, specs, num_channels=8,
                          block_len=srx.block_len, device="cpu")
    assert srx.fused_route == rx.fused_route == [True, True]
    controls = rx.control_template()
    controls[0]["frequency"][:] = [30e3, 280e3]
    controls[1]["frequency"][:] = [-40e3, 510e3]
    placed = srx.place_controls(controls)
    rng = np.random.default_rng(1)
    st, ss = rx.init_state(), srx.init_state()
    for _ in range(3):
        x = PC(*(torch.from_numpy(rng.standard_normal(srx.block_len)
                                  .astype(np.float32)) for _ in range(2)))
        st, o = rx.apply(st, (x, controls))
        ss, q = srx.step(ss, x, placed)
        for g, h in zip(o["groups"], q["groups"]):
            for a, b in zip(g["iq"], h["iq"]):
                np.testing.assert_allclose(b.numpy(), a.numpy(), atol=3e-4,
                                           rtol=1e-3)
            _audio_gate(h["audio"].numpy(), g["audio"].numpy())
        for g, h in zip(st["groups"], ss["groups"]):
            assert torch.equal(h[0][0], g[0][0])
