"""The port's ReceiverPipeline vs the JAX package's, block by block, on the
same synthesised FM stations: with kernels (the CUDA kernels' plain
versions here; JAX's Pallas kernels in interpret mode) and without, a
JAX state handed to the port mid-stream and back, a retune across a
channel boundary, and the WBFM tone chain. Tolerances are
tests/test_fused_route.py's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cubicsdr_tpu.ops.pallas.pfb as j_pfb  # noqa: E402
import cubicsdr_tpu.ops.pallas.route as j_route  # noqa: E402
from cubicsdr_tpu.ops.planar import PC as JPC, PLANAR as JPLANAR  # noqa: E402
from cubicsdr_tpu.receiver import (  # noqa: E402
    DemodGroupSpec as JDemodGroupSpec, ReceiverPipeline as JReceiverPipeline)

from cubicsdr_tpu_torch.ops.freqdem import FreqDem  # noqa: E402
from cubicsdr_tpu_torch.ops.nco import NCOMixer  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.ops.resample import RationalResampler  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodGroupSpec, ReceiverPipeline)
from cubicsdr_tpu_torch.stream.op import (  # noqa: E402
    Chain, StreamOp, scan_blocks, split_blocks)
from cubicsdr_tpu_torch.utils.interop import (  # noqa: E402
    constants_from_jax, state_from_numpy, state_to_numpy)
from cubicsdr_tpu_torch.utils.tree import tree_map  # noqa: E402

FS = 8_000_000


@pytest.fixture(scope="module")
def interp():
    j_pfb.INTERPRET = j_route.INTERPRET = True
    yield
    j_pfb.INTERPRET = j_route.INTERPRET = False


def fm_stations(freqs, n, rng, noise=0.02):
    """Complex FM stations (one tone each) plus a little noise."""
    t = np.arange(n) / FS
    iq = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k, f0 in enumerate(freqs):
        msg = np.sin(2 * np.pi * (700.0 + 90.0 * k) * t)
        iq = iq + 0.5 * np.exp(1j * (2 * np.pi * f0 * t + 2 * np.pi * 75e3
                                     * np.cumsum(msg) / FS))
    iq = iq.astype(np.complex64)
    return np.stack([iq.real, iq.imag]).astype(np.float32)


def block_len(n_blocks_of_m):
    rx0 = JReceiverPipeline(FS, [JDemodGroupSpec("FM", 200000, 1)],
                            dtype=JPLANAR)
    return n_blocks_of_m * int(np.lcm(rx0.group_block_multiple(0), 1024))


def run_jax(rx, st, blocks, controls):
    """Outputs and states (numpy leaves) after each block."""
    outs, states = [], []
    for blk in blocks:
        st, out = rx.apply(st, (JPC(jnp.asarray(blk[0]),
                                    jnp.asarray(blk[1])), controls))
        outs.append(jax.tree.map(np.asarray, out))
        states.append(jax.tree.map(np.asarray, st))
    return outs, states


def run_port(rx, st, blocks, controls):
    outs = []
    for blk in blocks:
        st, out = rx.apply(st, (PC(torch.from_numpy(blk[0]),
                                   torch.from_numpy(blk[1])), controls))
        outs.append(out)
    return outs, st


def assert_block_close(out, ref):
    g, gj = out["groups"][0], ref["groups"][0]
    # The frontend tap is linear: compare tightly.
    np.testing.assert_allclose(g["iq"].re.numpy(), gj["iq"].re,
                               atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(g["iq"].im.numpy(), gj["iq"].im,
                               atol=3e-4, rtol=1e-3)
    # Audio: rms/quantile (atan2 is ill-conditioned at deep fades).
    for a, b in ((out["mix"], ref["mix"]), (g["audio"], gj["audio"])):
        d = np.abs(a.numpy() - b)
        assert np.sqrt(np.mean(d * d)) < 2e-3, np.sqrt(np.mean(d * d))
        assert np.quantile(d, 0.995) < 5e-3
    np.testing.assert_allclose(g["level"].numpy(), gj["level"], atol=0.05)


N_DEMODS = 8


@pytest.fixture(scope="module")
def scenario(interp):
    """3 blocks of 256,000 samples, 8 FM demods, through both JAX
    pipelines (Pallas under the interpreter, and XLA)."""
    rng = np.random.default_rng(7)
    L = block_len(2)
    assert L == 256_000
    # Stations clear of the +-fs/2 wrap edge (see test_fused_route.py).
    freqs = np.asarray([((i % 14) - 7) * 500e3 + 20e3
                        for i in range(N_DEMODS)], np.float32)
    iq = fm_stations(freqs, 3 * L, rng)
    blocks = [iq[:, b * L:(b + 1) * L] for b in range(3)]
    specs = [JDemodGroupSpec("FM", 200000, N_DEMODS)]
    res = {"L": L, "blocks": blocks}
    for kernels in (True, False):
        rx = JReceiverPipeline(FS, specs, dtype=JPLANAR, use_pallas=kernels,
                               block_len=L)
        assert rx.fused_route == [kernels]
        controls = rx.control_template()
        controls[0]["frequency"] = freqs
        outs, states = run_jax(rx, rx.init_state(), blocks, controls)
        res[kernels] = dict(rx=rx, controls=controls, outs=outs,
                            states=states)
    return res


def port_pipeline(kernels, L, n=N_DEMODS):
    return ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, n)],
                            use_kernels=kernels, block_len=L, device="cpu")


@pytest.mark.parametrize("kernels", [True, False])
def test_pipeline_matches_jax(scenario, kernels):
    ref = scenario[kernels]
    rx = port_pipeline(kernels, scenario["L"])
    assert rx.fused_route == [kernels]
    assert constants_from_jax(ref["rx"], rx)
    outs, _ = run_port(rx, rx.init_state(), scenario["blocks"],
                       ref["controls"])
    assert rx.audio_len == 1536
    for out, r in zip(outs, ref["outs"]):
        assert out["mix"].shape == (2, rx.audio_len)
        assert_block_close(out, r)


def _to_jax_state(state_np):
    return tree_map(jnp.asarray, state_np,
                    node_map=lambda nt, kids: JPC(*kids))


@pytest.mark.parametrize("kernels", [True, False])
def test_jax_state_hands_over_to_port_and_back(scenario, kernels):
    """Block 1 runs in JAX; its state continues the stream in the port for
    block 2; the port's state goes back to JAX for block 3."""
    ref = scenario[kernels]
    rx = port_pipeline(kernels, scenario["L"])
    st = state_from_numpy(ref["states"][0])
    outs, st = run_port(rx, st, scenario["blocks"][1:2], ref["controls"])
    assert_block_close(outs[0], ref["outs"][1])
    st_np = state_to_numpy(st)
    for a, b in zip(jax.tree.leaves(st_np), jax.tree.leaves(ref["states"][1])):
        assert a.shape == b.shape and a.dtype == b.dtype
    blk = scenario["blocks"][2]
    _, out3 = ref["rx"].apply(
        _to_jax_state(st_np),
        (JPC(jnp.asarray(blk[0]), jnp.asarray(blk[1])), ref["controls"]))
    d = np.abs(np.asarray(out3["mix"]) - ref["outs"][2]["mix"])
    assert np.sqrt(np.mean(d * d)) < 2e-3
    assert np.quantile(d, 0.995) < 5e-3


def test_retune_across_channel_boundary(interp):
    """A demod moved into another channel between blocks: the fused path
    picks up the new channel's own history (per-channel tails) in both
    packages."""
    rng = np.random.default_rng(11)
    L = block_len(1)
    f1 = np.asarray([-1480e3, -480e3, 20e3, 1520e3], np.float32)
    f2 = np.asarray([-1480e3, -480e3, 1020e3, 1520e3], np.float32)
    iq = fm_stations(np.concatenate([f1, f2[2:3]]), 2 * L, rng)
    blocks = [iq[:, :L], iq[:, L:]]
    specs = [JDemodGroupSpec("FM", 200000, 4)]
    rxj = JReceiverPipeline(FS, specs, dtype=JPLANAR, use_pallas=True,
                            block_len=L)
    rx = port_pipeline(True, L, n=4)
    ctl = rxj.control_template()
    stj, st = rxj.init_state(), rx.init_state()
    outs = []
    for blk, f in zip(blocks, (f1, f2)):
        ctl[0]["frequency"] = f
        (rj,), (stj,) = run_jax(rxj, stj, [blk], ctl)
        (out,), st = run_port(rx, st, [blk], ctl)
        assert_block_close(out, rj)
        outs.append(out["groups"][0]["audio"][2].numpy())
    assert not np.allclose(outs[0], outs[1])          # it actually moved


def tone_snr(audio, f0, fs):
    a = audio - audio.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    freqs = np.fft.rfftfreq(len(a), 1 / fs)
    sig = (freqs > f0 - 40) & (freqs < f0 + 40)
    noise = ~sig & (freqs > 50) & (freqs < 15000)
    return 10 * np.log10(spec[sig].sum() / max(spec[noise].sum(), 1e-30))


class _Shift(StreamOp):
    def __init__(self, omega):
        super().__init__()
        self.omega = omega
        self.nco = NCOMixer()

    def init_state(self):
        return self.nco.init_state()

    def apply(self, s, x):
        return self.nco.apply(s, (x, self.omega))


def test_wbfm_tone_snr():
    """shift -> resample 1/12 -> FreqDem -> resample 6/25 through the port,
    built as tests/test_parity.py builds the JAX chain (shorter capture)."""
    fs, f_sta, dev, f_aud = 2.4e6, 300e3, 75e3, 1e3
    n = 25 * 12 * 8192
    rng = np.random.default_rng(42)
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * f_aud * t)
    iq = 0.5 * np.exp(1j * (2 * np.pi * f_sta * t
                            + 2 * np.pi * dev * np.cumsum(msg) / fs))
    iq += 0.002 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = iq.astype(np.complex64)
    chain = Chain(_Shift(-2 * np.pi * f_sta / fs), RationalResampler(1, 12),
                  FreqDem(0.5), RationalResampler(6, 25, dtype=torch.float32))
    x = PC(split_blocks(torch.from_numpy(iq.real.copy()), n // 4),
           split_blocks(torch.from_numpy(iq.imag.copy()), n // 4))
    _, ys = scan_blocks(chain, chain.init_state(), x)
    audio = ys.reshape(-1).numpy()[4800:]
    assert tone_snr(audio, f_aud, 48e3) > 40


def test_default_device_is_the_card():
    """Built without ``device``, the pipeline is on the card with both
    kernels; a host with no CUDA device raises instead of falling back to
    the CPU. Decided here, at run time, not at collection."""
    specs = [DemodGroupSpec("FM", 200000, 2)]
    if torch.cuda.is_available():
        rx = ReceiverPipeline(FS, specs)
        assert rx.device.type == "cuda" and rx.use_kernels
        assert rx.fused_route == [True]
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ReceiverPipeline(FS, specs)


def test_cpu_pipeline_with_default_kernels_matches_explicit(scenario):
    """``device="cpu"`` with the default ``use_kernels`` is the kernel
    path's plain versions, bit for bit the pipeline built with
    ``use_kernels=True`` explicitly (and so the JAX Pallas path's match
    above)."""
    L = scenario["L"]
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, N_DEMODS)],
                          block_len=L, device="cpu")
    assert rx.device.type == "cpu" and rx.fused_route == [True]
    ref = scenario[True]
    outs, _ = run_port(rx, rx.init_state(), scenario["blocks"][:2],
                       ref["controls"])
    exp, _ = run_port(port_pipeline(True, L), rx.init_state(),
                      scenario["blocks"][:2], ref["controls"])
    for a, b in zip(outs, exp):
        assert torch.equal(a["mix"], b["mix"])
        assert torch.equal(a["groups"][0]["iq"].re, b["groups"][0]["iq"].re)
