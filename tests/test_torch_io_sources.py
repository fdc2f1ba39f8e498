"""The port's IQ sources against the JAX package's: ``FileIQSource`` in
every capture format (ragged tail, zero-padded last block, looping),
``SyntheticSource`` sample for sample, the channel-count and block-size
policies, the device layer's constants and enumeration, and the network
transport (the port's ``IQServer`` feeding a ``SocketIQSource`` of either
package over loopback)."""

import numpy as np
import pytest

from cubicsdr_tpu.io import devices as jdevices  # noqa: E402
from cubicsdr_tpu.io import net as jnet  # noqa: E402
from cubicsdr_tpu.io import sources as jsources  # noqa: E402

from cubicsdr_tpu_torch.io import (  # noqa: E402
    FileIQSource, SyntheticSource, optimal_block_len, optimal_channel_count)
from cubicsdr_tpu_torch.io import devices, net  # noqa: E402
from cubicsdr_tpu_torch.io.sources import Station  # noqa: E402


def _capture(rng, n):
    return ((rng.uniform(-0.9, 0.9, n) + 1j * rng.uniform(-0.9, 0.9, n))
            .astype(np.complex64))


def _write(path, x, ext):
    inter = np.empty(2 * len(x), np.float32)
    inter[0::2], inter[1::2] = x.real, x.imag
    if ext == ".npy":
        np.save(path, x)
    elif ext in (".cf32", ".raw", ".iq"):
        inter.tofile(path)
    elif ext == ".cs16":
        (inter * 32767).astype(np.int16).tofile(path)
    elif ext == ".cs8":
        (inter * 127).astype(np.int8).tofile(path)
    else:                                            # .cu8
        np.clip(inter * 127.5 + 127.5, 0, 255).astype(np.uint8).tofile(path)


@pytest.mark.parametrize("ext", [".npy", ".cf32", ".raw", ".iq", ".cs16",
                                 ".cs8", ".cu8"])
@pytest.mark.parametrize("block", [64, 100])
def test_file_source_matches_jax(rng, tmp_path, ext, block):
    """Every block, the ragged tail (zero-padded) and the whole-capture
    view equal the JAX package's; a looping source starts over."""
    x = _capture(rng, 1000)
    p = str(tmp_path / f"cap{ext}")
    _write(p, x, ext)
    a = FileIQSource(p, 1e6, block, frequency=100e6)
    b = jsources.FileIQSource(p, 1e6, block, frequency=100e6)
    assert a.n_samples == b.n_samples == 1000
    got, want = list(a), list(b)
    assert len(got) == len(want) == -(-1000 // block)
    for g, w in zip(got, want):
        assert g.dtype == np.complex64 and g.shape == (block,)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(a.read_all_blocks(), b.read_all_blocks())
    if ext in (".npy", ".cf32"):
        np.testing.assert_allclose(np.concatenate(got)[:1000], x, atol=1e-6)
    loop = FileIQSource(p, 1e6, block, loop=True)
    blocks = [next(loop) for _ in range(len(got) + 2)]
    np.testing.assert_array_equal(blocks[len(got)], got[0])
    np.testing.assert_array_equal(blocks[len(got) + 1], got[1])


def test_file_source_rejects_an_unknown_format(tmp_path):
    p = tmp_path / "cap.wav"
    p.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="unknown IQ format"):
        FileIQSource(str(p), 1e6, 8)


def test_synthetic_source_matches_jax():
    stations = [(150e3, "fm", 1000.0), (-220e3, "am", 600.0),
                (310e3, "tone", 0.0), (40e3, "noise", 0.0)]
    a = SyntheticSource(2e6, 4000, [Station(f, k, audio_freq=t or 1000.0)
                                    for f, k, t in stations],
                        noise=0.05, seed=7)
    b = jsources.SyntheticSource(
        2e6, 4000, [jsources.Station(f, k, audio_freq=t or 1000.0)
                    for f, k, t in stations], noise=0.05, seed=7)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))


def test_synthetic_source_phase_continuity_and_unknown_kind():
    src = SyntheticSource(1e6, 1000, [Station(100e3, "tone")])
    x = np.concatenate([next(src), next(src)])
    y = next(SyntheticSource(1e6, 2000, [Station(100e3, "tone")]))
    np.testing.assert_allclose(x, y, atol=1e-5)
    with pytest.raises(ValueError):
        next(SyntheticSource(1e6, 10, [Station(0.0, "chirp")]))


@pytest.mark.parametrize("rate", [250e3, 1e6, 2.4e6, 2.5e6, 3.2e6, 8e6,
                                  10e6, 20e6])
@pytest.mark.parametrize("multiple", [1, 16, 1000])
def test_channel_count_and_block_len_match_jax(rate, multiple):
    assert optimal_channel_count(rate) == jsources.optimal_channel_count(rate)
    assert optimal_block_len(rate, multiple) == jsources.optimal_block_len(
        rate, multiple)
    assert optimal_block_len(rate, multiple) % multiple == 0


def test_device_constants_and_enumeration_match_jax():
    assert devices.MAX_RATE_LIST == jdevices.MAX_RATE_LIST
    a = devices.SDRDeviceInfo("x", "X", "drv")
    b = jdevices.SDRDeviceInfo("x", "X", "drv")
    assert a.get_sample_rates() == b.get_sample_rates()
    for r in (300e3, 2.3e6, 9e6, 30e6):
        assert a.get_rate_near(r) == b.get_rate_near(r)
    e, je = devices.SDREnumerator(), jdevices.SDREnumerator()
    for en in (e, je):
        en.add_remote("radio.local:55132")
        en.add_remote("radio.local:55132")
        en.set_manuals([{"driver": "rtltcp", "label": "TCP"}])
    ids = [d.device_id for d in e.enumerate_devices()]
    assert ids == [d.device_id for d in je.enumerate_devices()]
    assert ids[0] == "synthetic=0" and "remote=radio.local:55132" in ids
    e.remove_remote("radio.local:55132")
    assert e.remotes == []


@pytest.mark.parametrize("client", [net.SocketIQSource,
                                    jnet.SocketIQSource])
def test_iq_server_to_socket_source_loopback(rng, client):
    blocks = [_capture(rng, n) for n in (256, 100, 512)]
    srv = net.IQServer(iter(blocks), 2.4e6, frequency=98.1e6)
    port = srv.serve_background()
    src = client("127.0.0.1", port)
    got = list(src)
    srv.close()
    srv._thread.join(timeout=10)
    assert not srv._thread.is_alive()
    assert len(got) == 3
    for g, b in zip(got, blocks):
        np.testing.assert_array_equal(g, b)
    assert (src.sample_rate, src.frequency) == (2.4e6, 98.1e6)
