"""The benchmark's ``fm_band20`` deployment (the whole FM band from one
20 MS/s CS8 radio: M = 40 channels, the PFB kernel's product form, one
fused FM group, 640,000-sample blocks) at a size a CPU test holds: 12 of
its 100 demods, three sharing one channel, one at each edge of the band,
over a short capture loop.

- The live loop (``benchmark/run.py`` ``run_cell``, the kernels' plain
  versions on the CPU) against the benchmark's plain reference, judged
  by ``benchmark/compare.py`` under ``benchmark/limits.json``.
- The same plan against the JAX package's pipeline on its plain path
  (``use_pallas=False``), at the main path's tolerances
  (tests/test_fused_route.py): the iq tap atol 3e-4 / rtol 1e-3, audio
  rms < 2e-3 and 99.5% quantile < 5e-3, level atol 0.05.
- One demod's offset moved by 1 kHz in the program's controls only
  comes out not correct.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.ops.planar import PC as JPC, PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.receiver import (  # noqa: E402
    DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)

from benchmark import run, synth  # noqa: E402
from benchmark.tests.conftest import small_root  # noqa: E402
from cubicsdr_tpu_torch.app.runner import LiveReceiver  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodGroupSpec, ReceiverPipeline)
from cubicsdr_tpu_torch.utils.interop import constants_from_jax  # noqa: E402
from tests.test_torch_mixed_pipeline import audio_close  # noqa: E402

# Demods kept of the 100 (their index i: offset -9.9 MHz + 0.2 MHz i):
# both edges of the band (-9.9 MHz routes to the -9.5 MHz channel, 400
# kHz off its centre; +9.9 MHz to the +10 MHz channel), and 0.3, 0.5 and
# 0.7 MHz, which share the 0.5 MHz channel.
KEEP = (0, 13, 24, 36, 49, 50, 51, 52, 53, 69, 87, 99)
SHARED = (51, 52, 53)
BLOCK = 640_000
SEED = 2**31 + 181


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for this file's tests. Six processes running
    this plan's live loop at once on eight threads each took about 7 s a
    block, past the 60 s the harness waits for a late block; on one
    thread, beside five processes of eight busy threads, a whole run
    took 6-7 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_band(tmp_path):
    """(root, spec, cfg): fm_band20 cut to the demods of ``KEEP`` with a
    0.05 s capture loop, as the benchmark root of a test."""
    root, spec = small_root(tmp_path, "fm_band20", BLOCK)
    path = root / "benchmark" / "configs" / "small.json"
    cfg = json.loads(path.read_text())
    g = cfg["groups"][0]
    g["offsets"] = [g["offsets"][i] for i in KEEP]
    g["count"] = len(KEEP)
    st = cfg["capture"]["stations"]
    cfg["capture"]["stations"] = [st[i] for i in KEEP]
    path.write_text(json.dumps(cfg))
    return root, spec, cfg


def _run(root, spec):
    """A run of the cell's own open-loop mix over a 0.5 s window: 15
    blocks due at 20 MS/s, which the 2 s ring holds whole, so a CPU
    slower than real time hands every block over late and never sheds
    one; the blocks compared are drawn by number, not by time."""
    rc, res = run.run_cell("small.realtime", SEED, 0.5, False, spec=spec,
                           device="cpu", root=root, log=lambda s: None)
    assert rc == 0 and res is not None
    return res


def test_the_cut_keeps_the_band_s_shape(tmp_path):
    _, _, cfg = small_band(tmp_path)
    rx = ReceiverPipeline(float(cfg["sample_rate"]),
                          [DemodGroupSpec("FM", 200000, len(KEEP))],
                          num_channels=int(cfg["num_channels"]),
                          device="cpu")
    assert (rx.M, rx.block_len, rx.pfb_form, rx.fused_route) == (
        40, BLOCK, "product", [True])
    offs = np.asarray(cfg["groups"][0]["offsets"], np.float32)
    chan = np.abs(offs[:, None] - rx.centers.numpy()[None]).argmin(-1)
    shared = [KEEP.index(i) for i in SHARED]
    assert len(set(chan[shared])) == 1
    assert np.sum(chan == chan[shared[0]]) == len(SHARED)
    assert offs.min() == -9.9e6 and offs.max() == 9.9e6


def test_the_band_through_the_live_loop_is_correct(tmp_path):
    root, spec, _ = small_band(tmp_path)
    res = _run(root, spec)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_a_demod_moved_by_1_khz_is_not_correct(tmp_path, monkeypatch):
    """The program's controls alone move demod 5 (+0.1 MHz) by 1 kHz;
    the reference keeps the configuration's offset."""
    root, spec, _ = small_band(tmp_path)
    orig = LiveReceiver.__init__

    def moved(self, pipeline, controls, *a, **kw):
        controls[0]["frequency"] = controls[0]["frequency"].copy()
        controls[0]["frequency"][5] += 1000.0
        orig(self, pipeline, controls, *a, **kw)

    monkeypatch.setattr(LiveReceiver, "__init__", moved)
    res = _run(root, spec)
    assert not res["correct"], res["checks"]
    gap = res["checks"]["iq_gap"]
    assert gap["limit"] < gap["value"] < 1e300, gap


def test_the_band_matches_the_jax_pipeline(tmp_path):
    """Two blocks of the cut band's capture, as the CS8 wire carries it,
    through the port (the kernels' plain versions, the fused route) and
    the JAX package's plain path, each from its own initial state; the
    demod at -9.9 MHz, 400 kHz off its channel's centre, included."""
    _, _, cfg = small_band(tmp_path)
    fs = float(cfg["sample_rate"])
    planes = synth.capture(cfg, SEED, "cpu", n=2 * BLOCK)
    wire = synth.wire(planes, cfg["wire"], float(cfg["wire_peak"]))
    iq = wire.astype(np.float32) / 128.0
    offs = np.asarray(cfg["groups"][0]["offsets"], np.float32)
    jrx = JPipeline(fs, [JSpec("FM", 200000, len(KEEP))], num_channels=40,
                    dtype=JPLANAR, use_pallas=False, block_len=BLOCK)
    rx = ReceiverPipeline(fs, [DemodGroupSpec("FM", 200000, len(KEEP))],
                          num_channels=40, block_len=BLOCK, device="cpu")
    assert rx.fused_route == [True] and jrx.fused_route == [False]
    constants_from_jax(jrx, rx)
    jctl, ctl = jrx.control_template(), rx.control_template()
    jctl[0]["frequency"] = ctl[0]["frequency"] = offs
    jst, st = jrx.init_state(), rx.init_state()
    for b in range(2):
        blk = iq[:, b * BLOCK:(b + 1) * BLOCK]
        jst, jout = jrx.apply(jst, (JPC(jnp.asarray(blk[0]),
                                        jnp.asarray(blk[1])), jctl))
        st, out = rx.apply(st, (PC(torch.from_numpy(blk[0].copy()),
                                   torch.from_numpy(blk[1].copy())), ctl))
        g, gj = out["groups"][0], jout["groups"][0]
        for p, q in ((g["iq"].re, gj["iq"].re), (g["iq"].im, gj["iq"].im)):
            np.testing.assert_allclose(p.numpy(), np.asarray(q),
                                       atol=3e-4, rtol=1e-3)
        np.testing.assert_allclose(g["level"].numpy(),
                                   np.asarray(gj["level"]), atol=0.05)
        audio_close(g["audio"].numpy(), np.asarray(gj["audio"]))
        audio_close(out["mix"].numpy(), np.asarray(jout["mix"]))
