"""The sharded receiver as an application, on gloo CPU ranks: the port's
``rx --mesh`` (the analog of tests/test_sharded_app.py) and its
``multihost`` job (the analog of tests/test_multihost.py).

``rx --mesh "time=2"`` runs a session of two FM and two FM-stereo demods
(FM stereo is time-sharded by the port alone; the JAX package does not
shard it) as two CPU ranks: the WAV mix, the waterfall PNG from the
gathered spectrum and the per-demod recordings are written, each
recording equals the unsharded ``ReceiverPipeline`` at the same block
length within the audio gates and the 16-bit quantum, and a checkpoint
resume is bit-continuous (within 1 LSB, as the JAX test) and loads into
the JAX package's sharded state layout."""

import contextlib
import io
import os
import re
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cubicsdr_tpu_torch.app.cli import main  # noqa: E402

FS = 1_000_000
MESH = "time=2"


def _session(path):
    from cubicsdr_tpu_torch.app.session import SessionMgr
    from cubicsdr_tpu_torch.receiver import DemodulatorMgr
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 150e3, "FM", 200000)
    mgr.new_demodulator(100e6 - 150e3, "FM", 200000)
    mgr.new_demodulator(100e6 + 300e3, "FMS", 250000)
    mgr.new_demodulator(100e6 - 300e3, "FMS", 250000)
    sess = SessionMgr(mgr)
    sess.center_freq = 100_000_000
    sess.sample_rate = FS
    sess.save_session(str(path))
    return str(path), mgr


def _capture(n):
    """FM stations at +150 kHz and -300 kHz (the latter under the second
    FM-stereo demod), a carrier at -150 kHz and a stereo multiplex at
    +300 kHz, over a little noise."""
    rng = np.random.default_rng(11)
    t = np.arange(n) / FS
    msg = np.sin(2 * np.pi * 800.0 * t)
    mpx = (0.4 * np.sin(2 * np.pi * 600.0 * t)
           + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.3 * np.sin(2 * np.pi * 900.0 * t)
           * np.sin(2 * np.pi * 38000.0 * t))
    return (0.8 * np.exp(1j * (2 * np.pi * 150e3 * t
                               + 2 * np.pi * 75e3 * np.cumsum(msg) / FS))
            + 0.4 * np.exp(2j * np.pi * -150e3 * t)
            + 0.5 * np.exp(1j * (2 * np.pi * 300e3 * t
                                 + 2 * np.pi * 75e3 * np.cumsum(mpx) / FS))
            + 0.5 * np.exp(1j * (2 * np.pi * -300e3 * t
                                 + 2 * np.pi * 60e3 * np.cumsum(msg) / FS))
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _pcm(path):
    with wave.open(str(path)) as w:
        return (w.getnchannels(),
                np.frombuffer(w.readframes(w.getnframes()), "<i2"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three CLI runs: two blocks in one go (recording, checkpointed),
    then the first block with a checkpoint and the second resumed; and,
    beside them, a 2-process ``multihost`` job."""
    from cubicsdr_tpu_torch.io.sources import optimal_channel_count
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.receiver import plan_from_manager
    tmp = tmp_path_factory.mktemp("rx_mesh")
    sess, mgr = _session(tmp / "s.json")
    specs, _ = plan_from_manager(mgr)
    L = 2 * ShardedReceiver(FS, optimal_channel_count(FS), specs,
                            device="cpu").local_len
    iq = _capture(2 * L)
    iq.tofile(tmp / "all.cf32")
    iq[:L].tofile(tmp / "b1.cf32")
    iq[L:].tofile(tmp / "b2.cf32")
    base = ["--mesh", MESH, "--device", "cpu", "--fft-size", "256"]

    def whole():
        return main(["rx", sess, str(tmp / "all.cf32"), "-o",
                     str(tmp / "all.wav"), "--record", str(tmp / "rec"),
                     "--checkpoint", str(tmp / "all.npz"), *base])

    def in_parts():
        return [main(["rx", sess, str(tmp / f"{part}.cf32"), "-o",
                      str(tmp / f"{part}.wav"), "--checkpoint",
                      str(tmp / "ck.npz"), *base]) for part in ("b1", "b2")]

    from cubicsdr_tpu_torch.parallel import multihost
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(whole), pool.submit(in_parts),
                pool.submit(multihost.launch_local, num_processes=2,
                            steps=2, device="cpu")]
        rcs = [jobs[0].result(), *jobs[1].result()]
        reports = jobs[2].result()
    return {"tmp": tmp, "rcs": rcs, "iq": iq, "L": L, "specs": specs,
            "mgr": mgr, "reports": reports}


def test_rx_mesh_writes_wav_waterfall_and_recordings(runs):
    tmp = runs["tmp"]
    assert runs["rcs"] == [0, 0, 0]
    ch, a = _pcm(tmp / "all.wav")
    assert ch == 2 and a.size > 0 and np.abs(a).max() > 1000
    with open(tmp / "all_waterfall.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    recs = sorted(p for p in os.listdir(tmp) if p.startswith("rec_demod"))
    assert len(recs) == 4
    assert os.path.exists(tmp / "all.npz")


def test_rx_mesh_recordings_match_unsharded_pipeline(runs):
    """Each demod's recording (FM and the port-sharded FM stereo) equals
    the unsharded ReceiverPipeline at the same block length: rms < 2e-3
    and 99.5% quantile < 5e-3 in full scale, besides the 16-bit
    quantum."""
    from cubicsdr_tpu_torch.io.sources import optimal_channel_count
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.receiver import (
        ReceiverPipeline, controls_from_manager, plan_from_manager)
    specs, keyed = plan_from_manager(runs["mgr"])
    rx = ReceiverPipeline(FS, specs, num_channels=optimal_channel_count(FS),
                          block_len=runs["L"], device="cpu")
    controls = controls_from_manager(runs["mgr"], rx, keyed, 100e6)
    st = rx.init_state()
    audio = {k: [] for k in range(4)}
    for b in range(2):
        blk = runs["iq"][b * runs["L"]:(b + 1) * runs["L"]]
        st, out = rx.apply(st, (PC(torch.from_numpy(blk.real.copy()),
                                   torch.from_numpy(blk.imag.copy())),
                                controls))
        flat = 0
        for g in out["groups"]:
            for ri in range(g["audio"].shape[0]):
                audio[flat + ri].append(g["audio"][ri].numpy())
            flat += g["audio"].shape[0]
    recs = [p for p in os.listdir(runs["tmp"]) if p.startswith("rec_demod")]
    assert len(recs) == 4
    for name in recs:
        ch, pcm = _pcm(runs["tmp"] / name)
        want = np.concatenate(
            audio[int(re.match(r"rec_demod(\d+)", name).group(1))], axis=-1)
        got = pcm.reshape(-1, ch).T.astype(np.float64) / 32767.0
        assert got.shape == want.shape, name
        d = np.abs(got - np.clip(want, -1, 1))
        assert np.sqrt(np.mean(d * d)) < 2e-3 + 1 / 32767, name
        assert np.quantile(d, 0.995) < 5e-3 + 1 / 32767, name


def test_rx_mesh_checkpoint_resume_is_bit_continuous(runs):
    """Stopping after block 1 and resuming from the checkpoint gives the
    SAME audio for block 2 as the uninterrupted run (within 1 LSB of the
    16-bit WAV, as tests/test_sharded_app.py)."""
    tmp = runs["tmp"]
    _, a_all = _pcm(tmp / "all.wav")
    a_resumed = np.concatenate([_pcm(tmp / "b1.wav")[1],
                                _pcm(tmp / "b2.wav")[1]])
    assert a_all.shape == a_resumed.shape
    assert np.max(np.abs(a_all.astype(int) - a_resumed.astype(int))) <= 1


def test_sharded_checkpoint_is_the_jax_layout(tmp_path):
    """A sharded checkpoint is the JAX ShardedReceiver's state layout: the
    port's file loads into the JAX receiver's ``init_state()`` structure
    through the JAX package's ``load_state``, and the JAX file into the
    port's through ``load_sharded_state`` (one FM group, 1x1 mesh)."""
    import jax
    from cubicsdr_tpu.app.checkpoint import load_state as j_load
    from cubicsdr_tpu.app.checkpoint import save_state as j_save
    from cubicsdr_tpu.parallel import make_receiver_mesh
    from cubicsdr_tpu.parallel.sharded import ShardedReceiver as JSharded
    from cubicsdr_tpu.receiver import DemodGroupSpec as JSpec
    from cubicsdr_tpu_torch.app.checkpoint import (
        load_sharded_state, save_sharded_state)
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    jrx = JSharded(FS, 8, [JSpec("FM", 200000, 2)],
                   mesh=make_receiver_mesh(1, 1, jax.devices()[:1]),
                   use_pallas=True)
    prx = ShardedReceiver(FS, 8, [DemodGroupSpec("FM", 200000, 2)],
                          device="cpu")
    assert prx.block_len == jrx.block_len
    assert prx.fused_route == jrx.fused_route == [True]
    save_sharded_state(str(tmp_path / "port.npz"), prx, prx.init_state(),
                       {"blocks": 3})
    state, meta = j_load(str(tmp_path / "port.npz"), jrx.init_state())
    assert meta == {"blocks": 3}
    j_init = jrx.init_state()
    assert jax.tree.structure(state) == jax.tree.structure(j_init)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(j_init)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    j_save(str(tmp_path / "jax.npz"), j_init, {"blocks": 4})
    back, meta = load_sharded_state(str(tmp_path / "jax.npz"), prx)
    assert meta == {"blocks": 4}
    for a, b in zip(jax.tree.leaves(prx.gather_state(back)),
                    jax.tree.leaves(j_init)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_launch_local_two_processes_verify(runs):
    """A real 2-process job: each process feeds only its own span and
    verifies its outputs against the unsharded pipeline."""
    reports = runs["reports"]
    assert len(reports) == 2
    assert sorted(r["process_id"] for r in reports) == [0, 1]
    for rep in reports:
        assert rep["ok"] and rep["verified"]
        assert rep["process_count"] == 2 and rep["global_devices"] == 2
        assert rep["backend"] == "gloo" and rep["device"] == "cpu"
        assert rep["launches"] == {"pfbch2_planar": 0,
                                   "routed_shifted_resample": 0}
    for rep in reports:
        assert rep["worst"]["symbol_agreement"] > 0.999


def test_multihost_help_lists_flags():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(["multihost", "--help"])
    assert e.value.code == 0
    for flag in ("--worker", "--coordinator", "--process-id", "--nprocs",
                 "--steps", "--no-verify", "--timed-steps", "--devices",
                 "--host-collectives"):
        assert flag in buf.getvalue()


def test_ranks_that_outnumber_the_cards_need_host_collectives(monkeypatch):
    """The card is the default: without a CUDA device ``launch_local``
    is refused; on a host with one card, two local ranks under NCCL are
    refused by ``spawn_ranks`` (``rx --mesh``), and by ``launch_local``
    unless the caller asks for host collectives."""
    from cubicsdr_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.launch_local(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="host collectives"):
        multihost.launch_local(2)
    with pytest.raises(ValueError, match="host collectives"):
        multihost.spawn_ranks(print, 2)
    multihost.check_local_ranks(2, "cuda", host_collectives=True)
    multihost.check_local_ranks(1, "cuda", host_collectives=False)


def test_phase_audio_measure_tells_pitch_from_phase():
    """``run_worker``'s measure for audio that follows the carrier's
    phase: a 700 Hz tone turned by 0.02 rad stays within 2% of the
    reference's magnitude spectrum; 2% higher in pitch, or noise of the
    same power, does not (the rms alone passes both)."""
    from cubicsdr_tpu_torch.parallel.multihost import _spectrum_distance
    t = np.arange(6144) / 48000.0
    want = np.sin(2 * np.pi * 700.0 * t)[None, None]
    turned = np.sin(2 * np.pi * 700.0 * t + 0.02)[None, None]
    higher = np.sin(2 * np.pi * 714.0 * t)[None, None]
    noise = np.random.default_rng(3).standard_normal(want.shape)
    noise *= np.sqrt(np.mean(want ** 2) / np.mean(noise ** 2))
    assert _spectrum_distance(turned, want).max() < 0.02
    assert _spectrum_distance(higher, want).max() > 0.5
    assert _spectrum_distance(noise, want).max() > 0.5
