"""Shared by the complex64 parity tests (tests/test_torch_complex_*.py):
numpy-seeded captures, the port and JAX complex64 pipelines side by side,
the JAX step run eagerly, and the pipeline gates of
tests/test_torch_pipeline.py — the iq tap atol 3e-4 / rtol 1e-3, audio
and mix rms < 2e-3 and 99.5% quantile < 5e-3, level atol 0.05, symbols
equal where the slicer's two best scores are >= 1e-5 apart."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cubicsdr_tpu.receiver import (
    DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)

from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
from cubicsdr_tpu_torch.utils.synth import Station, synth_capture

C64 = torch.complex64
FS = 2_000_000
MARGIN = 1e-5
SR = 48000


def tone_snr(audio, f0, fs=SR):
    a = audio - audio.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    freqs = np.fft.rfftfreq(len(a), 1 / fs)
    sig = (freqs > f0 - 40) & (freqs < f0 + 40)
    noise = ~sig & (freqs > 50) & (freqs < 15000)
    return 10 * np.log10(spec[sig].sum() / max(spec[noise].sum(), 1e-30))


def capture(stations, n_blocks, L, seed=5, noise=1e-4):
    p = synth_capture(stations, n_blocks * L, FS, "cpu", seed,
                      noise).numpy()
    iq = (p[0] + 1j * p[1]).astype(np.complex64)
    return [iq[b * L:(b + 1) * L] for b in range(n_blocks)]


def pair(specs, **kw):
    """(port pipeline, JAX pipeline), both complex64 on the CPU."""
    rx = ReceiverPipeline(FS, [DemodGroupSpec(*s) for s in specs],
                          dtype=C64, device="cpu", **kw)
    rxj = JPipeline(FS, [JSpec(*s) for s in specs], **kw)
    assert rx.block_len == rxj.block_len and not any(rx.fused_route)
    return rx, rxj


def controls_for(rx, freqs):
    ctl = rx.control_template()
    for c, f in zip(ctl, freqs):
        c["frequency"] = np.asarray(f, np.float32)
    return ctl


def audio_close(a, b):
    assert np.shape(a) == np.shape(b)
    if not np.size(a):                  # a plan without audio groups
        return
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert np.sqrt(np.mean(d * d)) < 2e-3, np.sqrt(np.mean(d * d))
    assert np.quantile(d, 0.995) < 5e-3


def assert_block_close(rx, out, ref, before):
    assert out["iq"].dtype == C64
    audio_close(out["mix"].numpy(), ref["mix"])
    for gi, (g, gj) in enumerate(zip(out["groups"], ref["groups"])):
        assert set(g) == set(gj), (gi, set(g) ^ set(gj))
        assert g["iq"].dtype == C64
        np.testing.assert_allclose(g["iq"].numpy(), gj["iq"], atol=3e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(g["level"].numpy(), gj["level"],
                                   atol=0.05)
        if rx.is_digital[gi]:
            margin = rx.kits[gi].decision_margin(
                before["groups"][gi][1], g["iq"]).numpy()
            flip = g["symbols"].numpy() != gj["symbols"]
            assert not (flip & (margin >= MARGIN)).any(), gi
        else:
            audio_close(g["audio"].numpy(), gj["audio"])


def run_both(rx, rxj, blocks, controls, st=None, stj=None):
    """Every block through both pipelines, compared at the gates; returns
    (port outputs, port state, JAX state as numpy, JAX states after each
    block). ``controls`` is one list for every block or one per block."""
    st = rx.init_state() if st is None else st
    stj = rxj.init_state() if stj is None else stj
    outs, states_j = [], []
    for b, blk in enumerate(blocks):
        ctl = controls[b] if isinstance(controls, tuple) else controls
        before = st
        st, out = rx.apply(st, (torch.from_numpy(blk), ctl))
        stj, oj = rxj.apply(stj, (jnp.asarray(blk), ctl))
        assert_block_close(rx, out, jax.tree.map(np.asarray, oj), before)
        outs.append(out)
        states_j.append(jax.tree.map(np.asarray, stj))
    return outs, st, states_j


def group_audio(outs, gi, row):
    return np.concatenate([o["groups"][gi]["audio"][row, 0].numpy()
                           for o in outs])


# (modem, bandwidth, offsets[, settings]) per group, and the stations:
# one group per modem family in plans whose audio lengths agree.
FAMILY_PLANS = {
    "fm_am_cw_psk_fms": (
        [("FM", 200000, (-740e3, 260e3)), ("AM", 6000, (-540e3, 460e3)),
         ("CW", 500, (-210e3,)), ("BPSK", 20000, (40e3, -40e3)),
         ("FMS", 250000, (750e3,))],
        [Station("fm", -740e3, 700.0), Station("fm", 260e3, 1300.0),
         Station("am", -540e3, 500.0), Station("am", 460e3, 900.0),
         Station("cw", -210e3, amplitude=0.2), Station("symbols", 40e3),
         Station("symbols", -40e3), Station("fms", 750e3)]),
    "dsb_ssb": (
        [("DSB", 5400, (-300e3,)), ("USB", 5400, (120e3,)),
         ("LSB", 5400, (500e3,))],
        [Station("dsb", -300e3, 600.0), Station("usb", 120e3, 800.0),
         Station("lsb", 500e3, 1000.0)]),
    "fsk_gmsk": (
        [("FSK", 19200, (-60e3,), (("bps", 1), ("sps", 1200))),
         ("GMSK", 19200, (60e3,), (("sps", 4),))],
        [Station("fsk", -60e3, rate=1200.0, deviation=4320.0),
         Station("gmsk", 60e3, rate=4800.0, deviation=1200.0)]),
    "nbfm_iq_qpsk_dpsk": (
        [("NBFM", 12500, (-400e3,)), ("I/Q", 48000, (230e3,)),
         ("QPSK", 20000, (-130e3,)), ("DPSK", 20000, (610e3,))],
        [Station("nbfm", -400e3, 1000.0), Station("usb", 230e3, 3000.0),
         Station("symbols", -130e3, points=(1, 1j, -1, -1j)),
         Station("symbols", 610e3)]),
}
