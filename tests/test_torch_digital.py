"""The port's digital modem bank (``cubicsdr_tpu_torch/modems/digital.py``)
and the settings surface of every modem: constellation tables equal to
the JAX package's, slicers recovering clean symbols (the JAX package's
tests/test_digital.py, ported), argmax on ties taking the first maximum
as ``jnp.argmax`` does, and modem settings round-tripping through the
demodulator instances and the plan builder for every registered modem
(tests/test_modem_settings.py's schema test; its validation half lives in
the JAX package's web control plane, which the port does not have yet)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cubicsdr_tpu.modems import digital as j_digital  # noqa: E402
from cubicsdr_tpu.modems import make_modem as j_make_modem  # noqa: E402
from cubicsdr_tpu.modems import modem_names as j_modem_names  # noqa: E402

from cubicsdr_tpu_torch.modems import make_modem, modem_names  # noqa: E402
from cubicsdr_tpu_torch.modems import digital  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PC  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodulatorInstance, DemodulatorMgr, ReceiverPipeline,
    plan_from_manager)


def t_pc(x):
    x = np.asarray(x, np.complex64)
    return PC(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))


@pytest.mark.parametrize("fn,orders", [
    ("psk_constellation", (2, 4, 8, 16, 32, 64, 128, 256)),
    ("dpsk_constellation", (2, 4, 8, 16, 32, 64, 128, 256)),
    ("ask_constellation", (2, 4, 8, 16, 32, 64, 128, 256)),
    ("qam_constellation", (4, 8, 16, 32, 64, 128, 256)),
    ("apsk_constellation", (4, 8, 16, 32, 64, 128, 256)),
    ("ook_constellation", ()), ("star32_constellation", ()),
    ("sqam32_constellation", ())])
def test_constellation_tables_equal_jax(fn, orders):
    for m in orders or (None,):
        args = () if m is None else (m,)
        np.testing.assert_array_equal(getattr(digital, fn)(*args),
                                      getattr(j_digital, fn)(*args))


def test_registry_equals_jax():
    """The same 21 names in the same order, with the same modem_type."""
    assert modem_names() == j_modem_names()
    for kind in ("analog", "digital"):
        assert modem_names(kind) == j_modem_names(kind)


def test_registry_has_all_digital_modems():
    assert modem_names("digital") == [
        "BPSK", "QPSK", "OOK", "ST", "SQAM", "PSK", "DPSK", "ASK", "QAM",
        "APSK", "FSK", "GMSK"]
    assert modem_names("analog") == [
        "FM", "NBFM", "AM", "DSB", "USB", "LSB", "CW", "I/Q", "FMS"]


@pytest.mark.parametrize("name,order", [
    ("BPSK", None), ("QPSK", None), ("OOK", None), ("ST", None),
    ("SQAM", None), ("PSK", 8), ("ASK", 4), ("QAM", 16), ("APSK", 16),
])
def test_slicer_recovers_clean_symbols(name, order, rng):
    m = make_modem(name)
    if order:
        m.write_setting("cons", order)
    kit = m.build_kit(m.default_sample_rate)
    pts = kit.pts_re.numpy() + 1j * kit.pts_im.numpy()
    tx = rng.integers(0, len(pts), 4096)
    _, out = kit.apply(kit.init_state(), t_pc(pts[tx]))
    np.testing.assert_array_equal(out["symbols"].numpy(), tx)
    assert float(out["evm"]) < 1e-6
    assert bool(out["locked"])
    assert m.bits_per_symbol() == j_make_modem(name, **(
        {"cons": order} if order else {})).bits_per_symbol()


def test_slicer_unlocks_on_noise(rng):
    kit = make_modem("QPSK").build_kit(200000)
    x = rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
    _, out = kit.apply(kit.init_state(), t_pc(x))
    assert not bool(out["locked"])


def test_slicer_ties_take_the_first_maximum():
    """A sample equidistant from two points scores them equally: the
    symbol is the lower index, as jnp.argmax decides."""
    kit = make_modem("QPSK").build_kit(200000)
    x = np.asarray([0.0, 1.0, 1j, -1.0, -1j], np.complex64)
    _, out = kit.apply(kit.init_state(), t_pc(x))
    kit_j = j_make_modem("QPSK").build_kit(200000, dtype=jnp.complex64)
    _, out_j = kit_j.apply(kit_j.init_state(), jnp.asarray(x))
    np.testing.assert_array_equal(out["symbols"].numpy(),
                                  np.asarray(out_j["symbols"]))
    assert int(out["symbols"][0]) == 0


def test_dpsk_differential(rng):
    m = make_modem("DPSK")
    m.write_setting("cons", 4)
    kit = m.build_kit(200000)
    tx = rng.integers(0, 4, 1024)
    x = np.exp(1j * np.cumsum(2 * np.pi * tx / 4))
    # Streamed in two halves: the previous sample carries across.
    st = kit.init_state()
    st, a = kit.apply(st, t_pc(x[:500]))
    _, b = kit.apply(st, t_pc(x[500:]))
    got = np.concatenate([a["symbols"].numpy(), b["symbols"].numpy()])
    np.testing.assert_array_equal(got, tx)


def test_fsk_roundtrip(rng):
    m = make_modem("FSK", bps=2, sps=1200)
    kit = m.build_kit(19200)
    k, n_tones, bw = 19200 // 1200, 4, 0.45
    tx = rng.integers(0, n_tones, 256)
    f = (tx - (n_tones - 1) / 2) * (2 * bw / n_tones)
    x = np.exp(1j * np.cumsum(np.repeat(f, k) * 2 * np.pi))
    _, out = kit.apply(kit.init_state(), t_pc(x))
    assert (out["symbols"].numpy() == tx).mean() > 0.98
    assert bool(out["locked"])


def test_gmsk_roundtrip(rng):
    kit = make_modem("GMSK", sps=4).build_kit(19200)
    bits = rng.integers(0, 2, 512)
    f = (bits * 2 - 1) * 0.25 / 4
    x = np.exp(1j * np.cumsum(np.repeat(f, 4) * 2 * np.pi))
    _, out = kit.apply(kit.init_state(), t_pc(x))
    assert (out["symbols"].numpy() == bits).mean() > 0.98


def test_modem_settings_introspection():
    m = make_modem("FSK")
    assert {a.key for a in m.get_settings()} == {"bps", "sps", "bw"}
    m.write_setting("sps", 2400)
    assert m.read_setting("sps") == 2400


def test_settings_schema_and_round_trip():
    """FSK exposes bps/sps/bw as typed args with ranges; every modem's
    settings (constellation order, FSK bps/sps/bw, GMSK sps, FMS demph, CW
    offset/gain/auto) survive the instance's write/read, save/load, and
    group demods into one spec per (type, bandwidth, settings)."""
    keys = {a.key: a for a in make_modem("FSK").get_settings()}
    assert keys["bps"].arg_type == "int" and keys["bps"].low == 1
    assert keys["bw"].arg_type == "float" and keys["bw"].high == 0.49
    edits = {"PSK": {"cons": 8}, "DPSK": {"cons": 16}, "ASK": {"cons": 4},
             "QAM": {"cons": 64}, "APSK": {"cons": 32},
             "FSK": {"bps": 2, "sps": 2400, "bw": 0.3},
             "GMSK": {"sps": 8}, "FMS": {"demph": 50},
             "CW": {"offset": 800.0, "gain": 20.0, "auto": "off"}}
    mgr = DemodulatorMgr()
    for name in modem_names():
        inst = DemodulatorInstance(100e6, 200000, name)
        defaults = {a.key: a.value for a in inst.modem.get_settings()}
        assert inst.read_modem_settings() == defaults
        inst.write_modem_settings(edits.get(name, {}))
        want = {**defaults, **edits.get(name, {})}
        assert inst.read_modem_settings() == want
        assert DemodulatorInstance.load(inst.save()).read_modem_settings() \
            == want
        for settings in ({}, edits.get(name, {})):
            d = mgr.new_demodulator(100e6, name,
                                    make_modem(name).default_sample_rate)
            d.write_modem_settings(settings)
    specs, keyed = plan_from_manager(mgr)
    by_name = {}
    for s in specs:
        by_name.setdefault(s.modem_name, []).append(s.settings_dict)
    for name in modem_names():
        want = 2 if name in edits else 1
        assert len(by_name[name]) == want, name
        if name in edits:
            assert any(all(sd.get(k) == v for k, v in edits[name].items())
                       for sd in by_name[name])
    # The edited settings reach the built kits.
    rx = ReceiverPipeline(2e6, [s for s in specs if s.modem_name == "FSK"],
                          device="cpu")
    assert sorted(k.m for k in rx.kits) == [2, 4]
