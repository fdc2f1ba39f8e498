"""The port's web control plane (``cubicsdr_tpu_torch/app/webview.py``)
on a CPU ``LiveReceiver``: the JAX package's tests/test_webview.py cases
(one live server per module, bound to port 0, per-endpoint tests), the
settings-validation half of tests/test_modem_settings.py, the streaming
state carry across plan rebuilds against the JAX package's function on the
same snapshots, the audio of a rebuilt plan against the JAX harness under
the same control sequence, and regression tests for two faults of the JAX
control plane the port does not copy (the sinks' ``demods`` field, and
/api/ppm?ref=0).

Tolerances where the port meets the JAX package: state leaves exact (the
carry only moves them), mix and audio rms < 2e-3 and 99.5% quantile
< 5e-3 (the port's fused route against the JAX package's XLA path)."""

import json
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cubicsdr_tpu_torch.io.sources import SyntheticSource, Station  # noqa: E402
from cubicsdr_tpu_torch.ops.planar import PLANAR  # noqa: E402
from cubicsdr_tpu_torch.receiver import (  # noqa: E402
    DemodulatorMgr, ReceiverPipeline, plan_from_manager,
    controls_from_manager)

FS = 1_000_000


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


class _Harness:
    def __init__(self):
        from cubicsdr_tpu_torch.app.runner import LiveReceiver
        from cubicsdr_tpu_torch.app.webview import WebViewer
        from cubicsdr_tpu_torch.io.devices import SDRDeviceInfo

        self.mgr = DemodulatorMgr()
        self.mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
        specs, keyed = plan_from_manager(self.mgr)
        # The port's production path (planar, both kernels' wrappers),
        # on the host.
        rx = ReceiverPipeline(FS, specs, dtype=PLANAR, device="cpu")
        controls = controls_from_manager(self.mgr, rx, keyed, 100e6)
        harness = self

        class _Src:
            def __iter__(self):
                src = SyntheticSource(
                    FS, harness.lr.pipeline.block_len,
                    [Station(200e3, "fm", audio_freq=800.0)])
                while not harness.done.is_set():
                    yield next(src)

        self.done = threading.Event()
        self.lr = LiveReceiver(rx, controls, _Src(),
                               center_freq=100e6, waterfall_fft=256,
                               waterfall_lines=32)
        self.dev = SDRDeviceInfo("synthetic=0", "Synth", "synthetic",
                                 gains={"LNA": (0.0, 40.0),
                                        "VGA": (0.0, 20.0)})
        self.viewer = WebViewer(self.lr, self.mgr, keyed, port=0,
                                device_info=self.dev).start()
        self.port = self.viewer.port
        self.lr.start_producer()
        self.lr.run_blocks(max_blocks=3)

    def run(self, n=2):
        self.lr.run_blocks(max_blocks=n)

    def stop(self):
        self.done.set()
        self.lr.stop()
        self.viewer.stop()


@pytest.fixture(scope="module")
def hx():
    h = _Harness()
    yield h
    h.stop()


def test_index_page(hx):
    assert b"cubicsdr_tpu_torch" in _get(hx.port, "/")


def test_state(hx):
    st = json.loads(_get(hx.port, "/api/state"))
    assert st["center_freq"] == 100e6
    assert st["sample_rate"] == FS
    assert st["demods"][0]["type"] == "FM"
    assert st["demods"][0]["level"] != 0.0     # on_block hook ran
    assert "default" in st["themes"]


def test_spectrum_and_waterfall(hx):
    sp = json.loads(_get(hx.port, "/api/spectrum"))
    assert len(sp["points"]) == 256
    png = _get(hx.port, "/api/waterfall.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_control_set_and_tune(hx):
    # Control surface: mute + retune are step inputs (the plan stays).
    assert _post(hx.port, "/api/control",
                 {"action": "set", "index": 0, "key": "mute",
                  "value": True})["ok"]
    assert hx.mgr.get_demodulators()[0].muted
    assert _post(hx.port, "/api/control",
                 {"action": "set", "index": 0, "key": "mute",
                  "value": False})["ok"]
    assert _post(hx.port, "/api/control",
                 {"action": "tune", "freq": 100.1e6})["ok"]
    assert hx.lr.center_freq == 100.1e6
    _post(hx.port, "/api/control", {"action": "tune", "freq": 100e6})


def test_tune_snap_and_nudge(hx):
    # Snap-to-step tuning (ref: AppFrame snap) + digit-bar stepping
    # (ref: src/visual/TuningCanvas.cpp).
    assert _post(hx.port, "/api/control",
                 {"action": "tune", "freq": 100.013e6,
                  "snap": 25e3})["ok"]
    assert hx.lr.center_freq == 100.025e6
    assert _post(hx.port, "/api/control",
                 {"action": "nudge", "index": None,
                  "delta_hz": -25e3})["ok"]
    assert hx.lr.center_freq == 100e6
    f0 = hx.mgr.get_demodulators()[0].frequency
    assert _post(hx.port, "/api/control",
                 {"action": "nudge", "index": 0, "delta_hz": 1e3})["ok"]
    assert hx.mgr.get_demodulators()[0].frequency == f0 + 1e3
    _post(hx.port, "/api/control",
          {"action": "nudge", "index": 0, "delta_hz": -1e3})


def test_theme(hx):
    assert _post(hx.port, "/api/control",
                 {"action": "theme", "name": "jet"})["ok"]
    assert hx.lr.waterfall.theme_name == "jet"


def test_demod_view_spectrum(hx):
    assert _post(hx.port, "/api/control",
                 {"action": "view", "index": 0})["ok"]
    hx.run(2)
    dv = json.loads(_get(hx.port, "/api/demod_spectrum"))
    assert dv["index"] == 0 and len(dv["points"]) == hx.lr.demod_view_fft


def test_zoom_view(hx):
    assert _post(hx.port, "/api/control",
                 {"action": "zoom", "offset": 200e3,
                  "bandwidth": 250e3})["ok"]
    hx.run(6)
    sp = json.loads(_get(hx.port, "/api/spectrum"))
    assert sp["zoom"]["bandwidth"] == 250e3
    assert len(sp["zoom"]["points"]) == 256
    assert _post(hx.port, "/api/control",
                 {"action": "zoom", "offset": None})["ok"]


def test_plan_swap_add_remove(hx):
    # Plan change: add a second demod -> a new plan swaps in and
    # further blocks run (the async worker-thread rebuild analog).
    assert _post(hx.port, "/api/control",
                 {"action": "add", "freq": 100e6 - 200e3,
                  "type": "AM", "bandwidth": 10000})["ok"]
    assert len(hx.mgr.get_demodulators()) == 2
    hx.run(2)
    st = json.loads(_get(hx.port, "/api/state"))
    assert len(st["demods"]) == 2
    assert _post(hx.port, "/api/control",
                 {"action": "remove", "index": 1})["ok"]
    assert len(hx.mgr.get_demodulators()) == 1
    hx.run(1)


def test_unknown_action_is_an_error_not_500(hx):
    r = _post(hx.port, "/api/control", {"action": "bogus"})
    assert not r["ok"]


def test_scope(hx):
    sc = json.loads(_get(hx.port, "/api/scope?mode=2Y"))
    assert sc["mode"] == "2Y" and len(sc["traces"]) == 2


def test_audio_stream(hx):
    t = threading.Thread(target=hx.run, args=(4,), daemon=True)
    t.start()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{hx.port}/api/audio.wav", timeout=15) as rsp:
        head = rsp.read(44 + 9600)
    t.join(timeout=20)
    assert head[:4] == b"RIFF" and head[8:12] == b"WAVE"
    pcm = np.frombuffer(head[44:], "<i2")
    assert np.abs(pcm).max() > 0       # tone present in the mix


def test_session_roundtrip(hx, tmp_path):
    sp_path = str(tmp_path / "sess.json")
    assert _post(hx.port, "/api/session", {"op": "save", "path": sp_path})["ok"]
    assert _post(hx.port, "/api/session", {"op": "load", "path": sp_path})["ok"]
    assert len(hx.mgr.get_demodulators()) == 1


def test_bookmarks_crud_and_recents(hx, tmp_path):
    # New demods land in recents ("add" earlier in the module pushed one).
    b = json.loads(_get(hx.port, "/api/bookmarks"))
    assert any(e["demod_type"] == "AM" for e in b["recents"])
    # Bookmark the live demod, move it across groups, activate a copy.
    assert _post(hx.port, "/api/bookmarks",
                 {"op": "add", "index": 0, "group": "Air"})["ok"]
    assert _post(hx.port, "/api/bookmarks",
                 {"op": "move", "from": "Air", "i": 0, "to": "Marine"})["ok"]
    b = json.loads(_get(hx.port, "/api/bookmarks"))
    assert [e["demod_type"] for e in b["groups"]["Marine"]] == ["FM"]
    assert b["groups"]["Air"] == []
    n0 = len(hx.mgr.get_demodulators())
    assert _post(hx.port, "/api/bookmarks",
                 {"op": "activate", "group": "Marine", "i": 0})["ok"]
    assert len(hx.mgr.get_demodulators()) == n0 + 1
    hx.run(1)
    _post(hx.port, "/api/control",
          {"action": "remove", "index": n0})   # restore plan
    # Ranges.
    assert _post(hx.port, "/api/bookmarks",
                 {"op": "range_add", "label": "2m", "start": 144e6,
                  "end": 148e6})["ok"]
    assert _post(hx.port, "/api/bookmarks", {"op": "range_activate",
                                             "i": 0})["ok"]
    assert hx.lr.center_freq == 146e6
    _post(hx.port, "/api/control", {"action": "tune", "freq": 100e6})
    # Persistence with the .backup chain.
    path = str(tmp_path / "bm.json")
    assert _post(hx.port, "/api/bookmarks", {"op": "save", "path": path})["ok"]
    assert _post(hx.port, "/api/bookmarks", {"op": "load", "path": path})["ok"]
    b = json.loads(_get(hx.port, "/api/bookmarks"))
    assert "Marine" in b["groups"]


def test_gain_stages(hx):
    g = json.loads(_get(hx.port, "/api/gains"))
    assert {s["name"] for s in g["stages"]} == {"LNA", "VGA"}
    assert g["agc"] is True
    # Slider drag: persists to DeviceConfig, clamps to caps, drops AGC.
    r = _post(hx.port, "/api/gains", {"name": "LNA", "value": 99.0})
    assert r["ok"] and r["value"] == 40.0
    g = json.loads(_get(hx.port, "/api/gains"))
    assert g["agc"] is False
    assert {s["name"]: s["value"] for s in g["stages"]}["LNA"] == 40.0
    assert _post(hx.port, "/api/gains", {"agc": True})["agc"] is True


def test_devices_listing(hx):
    d = json.loads(_get(hx.port, "/api/devices"))
    assert d["current"] == "synthetic=0"
    assert any(dev["device_id"] == "synthetic=0" for dev in d["devices"])


def test_digital_console_live_feed(hx):
    """A digital demod in the live plan streams its sliced symbols into the
    per-demod console, readable over /api/console (ref: DemodulatorInstance
    .cpp:658-689, src/forms/DigitalConsole)."""
    assert _post(hx.port, "/api/control",
                 {"action": "add", "freq": 100e6 + 200e3,
                  "type": "BPSK", "bandwidth": 20000})["ok"]
    hx.run(3)
    c = json.loads(_get(hx.port, "/api/console?index=1&view=text"))
    assert len(c["text"]) > 0
    ch = json.loads(_get(hx.port, "/api/console?index=1&view=hex"))
    assert ch["view"] == "hex"
    _post(hx.port, "/api/control", {"action": "remove", "index": 1})
    hx.run(1)


def test_rig_attach_and_rest(hx):
    """Rig wired into the live loop (ref: src/rig/RigThread.cpp:133-207):
    follow mode retunes the app center from rig motion; REST mode toggles."""
    from cubicsdr_tpu_torch.app.rig import RigController, SimulatedRig
    rig = SimulatedRig(100e6)
    hx.viewer.attach_rig(RigController(rig), poll_every_s=0.0)
    st = json.loads(_get(hx.port, "/api/rig"))
    assert st["attached"] and st["error"] == "OK"
    hx.run(1)                                   # baseline poll
    rig.frequency = 101e6                       # rig moved -> app follows
    hx.run(1)
    assert hx.lr.center_freq == 101e6
    # Control mode: app tune pushes to the rig on the next poll.
    _post(hx.port, "/api/control", {"action": "tune", "freq": 100e6})
    hx.run(1)
    assert rig.frequency == 100e6
    # Mode toggles via REST.
    r = _post(hx.port, "/api/rig", {"center_lock": True})
    assert r["ok"] and r["center_lock"]
    rig.frequency = 107e6
    hx.run(1)
    assert hx.lr.center_freq == 100e6           # locked: app stays
    _post(hx.port, "/api/rig", {"center_lock": False,
                                "frequency": 100e6})
    hx.run(1)


def test_follow_and_delta_lock(hx):
    mgr, lr, port = hx.mgr, hx.lr, hx.port
    d0 = mgr.get_demodulators()[0]
    # Delta lock: demod rides the center on tune (ref: SDRPostThread.cpp:
    # 56-63).
    assert _post(port, "/api/control",
                 {"action": "set", "index": 0, "key": "delta_lock",
                  "value": True})["ok"]
    ofs = d0.frequency - lr.center_freq
    _post(port, "/api/control", {"action": "tune", "freq": 108e6})
    assert d0.frequency == 108e6 + ofs
    _post(port, "/api/control",
          {"action": "set", "index": 0, "key": "delta_lock", "value": False})
    # Follow: an out-of-range follow demod retunes the CENTER to itself
    # (ref :77-80).
    _post(port, "/api/control",
          {"action": "set", "index": 0, "key": "follow", "value": True})
    _post(port, "/api/control",
          {"action": "set", "index": 0, "key": "frequency",
           "value": 120e6})                  # way out of the 1 MS/s band
    assert lr.center_freq == 120e6
    assert not d0.follow                     # one-shot
    # In-range demods (re)activate in the sweep.
    assert d0.active
    _post(port, "/api/control", {"action": "tune", "freq": 100e6})
    _post(port, "/api/control",
          {"action": "set", "index": 0, "key": "frequency",
           "value": 100e6 + 200e3})


def test_zoom_invalid_bandwidth_is_rejected_not_hung(hx):
    # A non-positive zoom bandwidth once infinite-looped _snap_bw inside the
    # HTTP handler thread; it must come back as an error response instead.
    import urllib.error
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(hx.port, "/api/control",
              {"action": "zoom", "offset": 0.0, "bandwidth": -1.0})
    assert ei.value.code == 400
    # And the receiver must still answer (no wedged handler state).
    assert json.loads(_get(hx.port, "/api/state"))["center_freq"]


def _step_planes(b):
    return (torch.from_numpy(np.ascontiguousarray(b.real)),
            torch.from_numpy(np.ascontiguousarray(b.imag)))


def test_plan_rebuild_preserves_streaming_state():
    """Adding a demod mid-stream must NOT reset the surviving demods'
    filter/NCO/AGC/squelch state: their audio continues exactly as if no
    rebuild happened (ref: DemodulatorPreThread.cpp:105-151 — other demods
    never glitch on a plan change)."""
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.app.webview import WebViewer
    from cubicsdr_tpu_torch.ops.planar import PC

    fm = (100e6 + 200e3, "FM", 200000)
    am = (100e6 - 300e3, "AM", 10000)

    # Shared block size that satisfies BOTH plans (pinned => forwarded).
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    L = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 1),
                              DemodGroupSpec("AM", 10000, 1)],
                         device="cpu").block_len

    src = SyntheticSource(FS, L, [Station(200e3, "fm", audio_freq=800.0),
                                  Station(-300e3, "am", audio_freq=500.0)])
    blocks = [next(src) for _ in range(6)]

    def fm_audio(out):
        return out["groups"][0]["audio"][0].numpy()

    # --- reference: FM-only pipeline, never rebuilt ---
    mgr_a = DemodulatorMgr()
    mgr_a.new_demodulator(*fm)
    specs, keyed = plan_from_manager(mgr_a)
    rx_a = ReceiverPipeline(FS, specs, block_len=L, device="cpu")
    ctl_a = controls_from_manager(mgr_a, rx_a, keyed, 100e6)
    st = rx_a.init_state()
    ref = []
    for b in blocks:
        st, out = rx_a.apply(st, (PC(*_step_planes(b)), ctl_a))
        ref.append(fm_audio(out))

    # --- rebuild run: same FM demod, AM added after block 3 ---
    mgr_b = DemodulatorMgr()
    mgr_b.new_demodulator(*fm)
    specs, keyed = plan_from_manager(mgr_b)
    rx_b = ReceiverPipeline(FS, specs, block_len=L, device="cpu")
    ctl_b = controls_from_manager(mgr_b, rx_b, keyed, 100e6)
    lr = LiveReceiver(rx_b, ctl_b, iter([]), center_freq=100e6,
                      waterfall_fft=256, waterfall_lines=8)
    viewer = WebViewer(lr, mgr_b, keyed, port=0)     # never started: direct
    got = []
    for i, b in enumerate(blocks):
        if i == 3:
            viewer.control({"action": "add", "freq": am[0],
                            "type": am[1], "bandwidth": am[2]})
            # Pinned block size must survive the rebuild, and so must
            # the device and the kernel choice.
            assert lr.pipeline.block_len == L
            assert len(lr.pipeline.groups) == 2
            assert lr.pipeline.device.type == "cpu"
            assert lr.pipeline.use_kernels and lr.pipeline.fused_route[0]
        lr.state, out = lr.step(lr.state, (_step_planes(b), lr.controls))
        # The step's outputs are its compiled step's buffers, reused two
        # blocks on: keep a copy.
        got.append(fm_audio(out).copy())

    # Post-rebuild blocks: continuous audio (the same arithmetic: exact
    # up to the order of float32 sums).
    for i in (3, 4, 5):
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=5e-4)
    # Sanity: the carried state actually mattered — a cold restart at
    # block 3 diverges from the reference.
    _, out_cold = rx_a.apply(rx_a.init_state(),
                             (PC(*_step_planes(blocks[3])), ctl_a))
    assert not np.allclose(fm_audio(out_cold), ref[3], atol=5e-4)


def test_device_remote_manual_registration_persists(hx):
    # Registrations live on the app-owned enumerator, not a throwaway
    # (ref: CubicSDR.cpp:614-622 remote add/remove persistence).
    assert _post(hx.port, "/api/devices",
                 {"op": "add_remote", "address": "radio.local:55132"})["ok"]
    assert _post(hx.port, "/api/devices",
                 {"op": "set_manuals",
                  "manuals": [{"driver": "rtltcp", "label": "Manual TCP"}]}
                 )["ok"]
    d = json.loads(_get(hx.port, "/api/devices"))
    ids = [e["device_id"] for e in d["devices"]]
    assert "remote=radio.local:55132" in ids
    assert "manual=rtltcp" in ids
    assert d["remotes"] == ["radio.local:55132"]
    assert _post(hx.port, "/api/devices",
                 {"op": "remove_remote", "address": "radio.local:55132"}
                 )["ok"]
    d = json.loads(_get(hx.port, "/api/devices"))
    assert d["remotes"] == []


def test_modem_settings_rest_and_set_type_bandwidth(hx):
    """HTTP surface for the generated-properties panel (ref: src/
    ModemProperties.cpp) + live type/bandwidth edits rebuilding the plan."""
    # FM has an empty (or small) schema; endpoint responds either way.
    sch = json.loads(_get(hx.port, "/api/modem_settings?index=0"))
    assert sch["ok"] and sch["type"] == "FM"

    # Add an FSK demod, flip bps over REST, confirm it's live in the plan.
    assert _post(hx.port, "/api/control",
                 {"action": "add", "freq": 100e6 - 400e3, "type": "FSK",
                  "bandwidth": 19200})["ok"]
    idx = next(i for i, d in enumerate(hx.mgr.get_demodulators())
               if d.demod_type == "FSK")
    r = _post(hx.port, "/api/control",
              {"action": "modem_settings", "index": idx,
               "settings": {"bps": 2}})
    assert r["ok"] and r["settings"]["bps"] == 2
    g = next(g for g in hx.lr.pipeline.groups if g.modem_name == "FSK")
    assert dict(g.settings)["bps"] == 2
    hx.run(2)

    # Live bandwidth edit must reach the compiled plan (group key).
    fm_idx = next(i for i, d in enumerate(hx.mgr.get_demodulators())
                  if d.demod_type == "FM")
    assert _post(hx.port, "/api/control",
                 {"action": "set", "index": fm_idx, "key": "bandwidth",
                  "value": 100000})["ok"]
    assert any(g.modem_name == "FM" and g.bandwidth == 100000
               for g in hx.lr.pipeline.groups)
    hx.run(2)

    # Live type swap (ModeSelector, ref: DemodulatorInstance::
    # setDemodulatorType) — FSK -> AM rebuilds into an analog group.
    assert _post(hx.port, "/api/control",
                 {"action": "set", "index": idx, "key": "type",
                  "value": "AM"})["ok"]
    assert hx.mgr.get_demodulators()[idx].demod_type == "AM"
    assert any(g.modem_name == "AM" for g in hx.lr.pipeline.groups)
    hx.run(2)

    # Restore the fixture's shape for the remaining module tests.
    assert _post(hx.port, "/api/control",
                 {"action": "set", "index": fm_idx, "key": "bandwidth",
                  "value": 200000})["ok"]
    assert _post(hx.port, "/api/control",
                 {"action": "remove", "index": idx})["ok"]
    hx.run(2)


def test_device_stop_start(hx):
    assert _post(hx.port, "/api/devices", {"op": "stop"})["ok"]
    assert not json.loads(_get(hx.port, "/api/devices"))["running"]
    assert _post(hx.port, "/api/devices", {"op": "start"})["ok"]
    assert json.loads(_get(hx.port, "/api/devices"))["running"]


def test_device_stop_start_soapy_source(hx):
    """Round-3 advisor (medium): stop -> start on a SoapySDR source (whose
    stop() latches an event) must actually resume streaming, not leave a
    dead producer reported as running."""
    import time
    from tests.test_soapy import _MockModule
    hx.viewer.soapy_module = _MockModule
    assert _post(hx.port, "/api/devices",
                 {"op": "set_manuals",
                  "manuals": [{"driver": "mock", "label": "Mock SDR",
                               "args": "soapy=0"}]})["ok"]
    r = _post(hx.port, "/api/devices",
              {"op": "select", "device_id": "manual=mock",
               "rate": 2_000_000})
    assert r["ok"], r
    hx.run(2)

    assert _post(hx.port, "/api/devices", {"op": "stop"})["ok"]
    assert not json.loads(_get(hx.port, "/api/devices"))["running"]
    k_stop = hx.viewer.source.device.k          # device sample counter

    assert _post(hx.port, "/api/devices", {"op": "start"})["ok"]
    # The restarted producer must actually READ (the latched-stop bug left
    # a dead thread while reporting running=true).
    deadline = time.time() + 5.0
    while hx.viewer.source.device.k <= k_stop and time.time() < deadline:
        time.sleep(0.01)
    assert hx.viewer.source.device.k > k_stop
    assert json.loads(_get(hx.port, "/api/devices"))["running"]
    hx.run(2)                                   # blocks flow end-to-end

    # Back to synthetic for the remaining module tests.
    r = _post(hx.port, "/api/devices",
              {"op": "select", "device_id": "synthetic=0", "rate": FS})
    assert r["ok"]
    hx.run(2)


def test_device_select_soapy_and_back_mid_session(hx):
    """Runtime device switching (ref: SDRDevices dialog -> CubicSDR::
    setDevice, src/CubicSDR.cpp:797-855): swap synthetic -> mock SoapySDR
    hardware at a DIFFERENT sample rate without restarting the server;
    persisted DeviceConfig (ppm/gains/AGC/settings) reapplies on open."""
    from tests.test_soapy import _MockModule
    hx.viewer.soapy_module = _MockModule

    # Pre-seed the persisted per-device settings (the reference reapplies
    # these on device start, src/CubicSDR.cpp:814-841).
    dc = hx.viewer.config.get_device("manual=mock")
    dc.ppm = 5
    dc.agc_mode = False
    dc.gains["TUNER"] = 21.5
    dc.settings["biastee"] = "true"

    # The enumerator won't list soapy devices (module not installed), so
    # register it as a manual device string the picker can start.
    assert _post(hx.port, "/api/devices",
                 {"op": "set_manuals",
                  "manuals": [{"driver": "mock", "label": "Mock SDR",
                               "args": "soapy=0"}]})["ok"]
    # Select with an explicit different rate: the plan must rebuild at the
    # device-applied rate, mid-session.
    r = _post(hx.port, "/api/devices",
              {"op": "select", "device_id": "manual=mock", "rate": 2_000_000,
               "iq_swap": True})
    assert r["ok"], r
    assert r["rate"] == 2_000_000
    assert hx.lr.pipeline.sample_rate == 2_000_000
    src = hx.viewer.source
    assert src.iq_swap
    assert src.num_elems == hx.lr.pipeline.block_len

    hx.run(3)                 # blocks flow from the mock hardware
    st = json.loads(_get(hx.port, "/api/state"))
    assert st["sample_rate"] == 2_000_000

    # DeviceConfig reapplied on open (visible in the driver call log once
    # the read loop applied the staged settings).
    calls = src.device.calls
    assert ("ppm", 5) in calls
    assert ("agc", False) in calls
    assert ("gain", "TUNER", 21.5) in calls
    assert ("setting", "biastee", "true") in calls

    # Gain slider on the RUNNING device forwards + persists (the device
    # config key follows the selected device).
    hx.viewer.device_info.gains = {"TUNER": (0.0, 49.6)}
    g = _post(hx.port, "/api/gains", {"name": "TUNER", "value": 30.0})
    assert g["ok"]
    assert hx.viewer.config.get_device("manual=mock").gains["TUNER"] == 30.0

    # And back to synthetic at the original rate — still no restart.
    r = _post(hx.port, "/api/devices",
              {"op": "select", "device_id": "synthetic=0", "rate": FS})
    assert r["ok"] and hx.lr.pipeline.sample_rate == FS
    hx.run(2)
    assert json.loads(_get(hx.port, "/api/state"))["sample_rate"] == FS


def test_host_audio_output_and_solo(hx, tmp_path):
    """Host playback wiring (the RtAudio role): the live mix drains to a
    local sink (WAV backend on headless hosts), a single demod can be
    soloed to it, and output devices enumerate over REST."""
    wav_path = str(tmp_path / "live_mix.wav")
    assert _post(hx.port, "/api/control",
                 {"action": "audio_output",
                  "backend": f"wav:{wav_path}"})["ok"]
    hx.run(3)
    ad = json.loads(_get(hx.port, "/api/audio_devices"))
    assert ad["backend"] == "wav" and ad["solo"] is None
    assert isinstance(ad["devices"], list)   # empty on headless hosts

    # Solo one demod to the host sink.
    assert _post(hx.port, "/api/control",
                 {"action": "audio_solo", "index": 0})["ok"]
    hx.run(2)
    assert json.loads(_get(hx.port, "/api/audio_devices"))["solo"] == 0
    assert _post(hx.port, "/api/control",
                 {"action": "audio_solo", "index": None})["ok"]

    # Detach closes the WAV; it must be a playable file with audio in it.
    assert _post(hx.port, "/api/control",
                 {"action": "audio_output", "backend": None})["ok"]
    import wave
    w = wave.open(wav_path)
    assert w.getnchannels() == 2
    assert w.getframerate() == int(hx.lr.pipeline.audio_rate)
    n = w.getnframes()
    pcm = np.frombuffer(w.readframes(n), "<i2")
    assert n > 0 and np.abs(pcm).max() > 0


def test_display_controls_rest(hx):
    """Display-parameter parity (ref: src/AppFrame.cpp:2320-2352 per-canvas
    FFT/averaging/LPS menus + :2207-2215 perf-mode throttle)."""
    st = json.loads(_get(hx.port, "/api/state"))
    assert st["display"]["lps"] == 30.0
    # Waterfall pace + averaging + peak hold + demod-view FFT size.
    assert _post(hx.port, "/api/control",
                 {"action": "display", "lps": 12.0,
                  "fft_average_rate": 0.4, "peak_hold": True,
                  "demod_view_fft": 128})["ok"]
    hx.run(2)
    st = json.loads(_get(hx.port, "/api/state"))["display"]
    assert st["lps"] == 12.0
    assert abs(st["fft_average_rate"] - 0.4) < 1e-9
    assert st["peak_hold"] is True
    assert st["demod_view_fft"] == 128
    # Display still streams after the rebuilds.
    sp = json.loads(_get(hx.port, "/api/spectrum"))
    assert len(sp["points"]) == 256

    # Persistent snap applies to tunes that don't pass one.
    assert _post(hx.port, "/api/control",
                 {"action": "snap", "step": 12500})["ok"]
    assert _post(hx.port, "/api/control",
                 {"action": "tune", "freq": 100.004e6})["ok"]
    assert hx.lr.center_freq == 100.0e6
    _post(hx.port, "/api/control", {"action": "snap", "step": 1})

    # Perf mode LOW throttles the waterfall pace.
    assert _post(hx.port, "/api/control",
                 {"action": "perf_mode", "mode": "low"})["ok"]
    assert json.loads(_get(hx.port, "/api/state"))["display"]["lps"] == 8.0
    assert _post(hx.port, "/api/control",
                 {"action": "perf_mode", "mode": "high"})["ok"]
    _post(hx.port, "/api/control", {"action": "display", "lps": 30.0,
                                    "peak_hold": False,
                                    "fft_average_rate": 0.65})


def test_page_has_waterfall_drag_handlers(hx):
    """The embedded page implements drag-create / drag-move / edge-resize
    on the waterfall (ref: src/visual/WaterfallCanvas.cpp mouse handlers);
    the REST paths they hit (add, set frequency, set bandwidth-with-
    rebuild) are covered by the control tests above."""
    page = _get(hx.port, "/").decode()
    for frag in ("wf.onmousedown", "wf.onmouseup", "'resize'", "'move'",
                 "action: 'add'", "key: 'bandwidth'", "key: 'frequency'"):
        assert frag in page, frag


def test_page_has_hotkey_surface(hx):
    """Global hotkeys (ref: AppFrame::OnGlobalKeyDown): arrows tune,
    brackets step bandwidth, m/r/s/v per-demod verbs — present in the
    page JS (their REST targets are covered by the control tests)."""
    page = _get(hx.port, "/").decode()
    for frag in ("keydown", "ArrowLeft", "key:'bandwidth'",
                 "key:'recording'", "key:'solo'", "editSettings",
                 "pollConsole"):
        assert frag in page, frag


def test_profile_trace_endpoint(hx, tmp_path):
    """Structured tracing: the profile action captures a torch.profiler
    trace of live streaming, written as a Chrome trace."""
    import time
    p = str(tmp_path / "trace")
    r = _post(hx.port, "/api/control",
              {"action": "profile", "path": p, "seconds": 0.5})
    assert r["ok"], r
    # Overlapping start is rejected while the window is open.
    assert not _post(hx.port, "/api/control",
                     {"action": "profile", "path": p})["ok"]
    hx.run(2)                                 # traced blocks
    deadline = time.time() + 10
    import os
    # The window closes after its trace is written; a new one may start.
    while time.time() < deadline and hx.viewer._profile_lock.locked():
        time.sleep(0.05)
    assert not hx.viewer._profile_lock.locked()
    with open(os.path.join(p, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_bookmark_reorder(hx):
    """Within-group ordering (the drag-onto-sibling drop of the
    reference's BookmarkView tree, served as the 'reorder' op)."""
    for _ in range(3):
        assert _post(hx.port, "/api/bookmarks",
                     {"op": "add", "index": 0, "group": "Order"})["ok"]
    bm = json.loads(_get(hx.port, "/api/bookmarks"))
    assert len(bm["groups"]["Order"]) == 3
    # Tag entries by editing labels through the model directly.
    es = hx.viewer.bookmarks.get_bookmarks("Order")
    for i, e in enumerate(es):
        e.label = f"e{i}"
    assert _post(hx.port, "/api/bookmarks",
                 {"op": "reorder", "group": "Order", "i": 0, "to": 2})["ok"]
    labels = [e.label for e in hx.viewer.bookmarks.get_bookmarks("Order")]
    assert labels == ["e1", "e2", "e0"]
    assert _post(hx.port, "/api/bookmarks",
                 {"op": "remove_group", "group": "Order"})["ok"]


# --- the state carry and the rebuilt plan against the JAX package ----------

def _jax_pipeline(specs, L, **kw):
    from cubicsdr_tpu.ops.planar import PLANAR as JPLANAR
    from cubicsdr_tpu.receiver import (
        DemodGroupSpec as JSpec, ReceiverPipeline as JPipeline)
    return JPipeline(FS, [JSpec(*s) for s in specs], dtype=JPLANAR,
                     block_len=L, **kw)


# Group specs of every plan the rebuild tests pass through.
_ALL_SPECS = [("FM", 200000, 2), ("AM", 10000, 1), ("NBFM", 12500, 1),
              ("AM", 6000, 1), ("AM", 12500, 1)]


def _common_block_len():
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    return ReceiverPipeline(FS, [DemodGroupSpec(*s) for s in _ALL_SPECS],
                            device="cpu").block_len


def _edit(mgr, kind):
    """One plan edit of the control plane's: a demod added, removed, its
    bandwidth or its type changed."""
    ds = mgr.get_demodulators()
    if kind == "add":
        mgr.new_demodulator(100e6 - 150e3, "NBFM", 12500)
    elif kind == "remove":
        mgr.delete_demodulator(ds[1])
    elif kind == "bandwidth":
        ds[2].set_bandwidth(6000)
    else:
        ds[2].set_demod_type("NBFM")
        ds[2].set_bandwidth(12500)


@pytest.mark.parametrize("kind", ["add", "remove", "bandwidth", "type"])
def test_carry_streaming_state_matches_jax(kind):
    """On the same snapshots, the port's carry equals the JAX package's
    leaf for leaf, and every surviving row keeps its old state."""
    import jax
    from cubicsdr_tpu.app.webview import _carry_streaming_state as j_carry
    from cubicsdr_tpu.ops.planar import PC as JPC
    from cubicsdr_tpu_torch.app.webview import _carry_streaming_state
    from cubicsdr_tpu_torch.utils.interop import (
        state_from_numpy, state_to_numpy)
    from cubicsdr_tpu_torch.utils.tree import tree_leaves

    L = _common_block_len()
    mgr = DemodulatorMgr()
    for f, t, bw in ((200e3, "FM", 200000), (350e3, "FM", 200000),
                     (-300e3, "AM", 10000)):
        mgr.new_demodulator(100e6 + f, t, bw)
    specs_o, keyed_o = plan_from_manager(mgr)
    rxj_o = _jax_pipeline([(s.modem_name, s.bandwidth, s.count)
                           for s in specs_o], L)
    rx_o = ReceiverPipeline(FS, specs_o, use_kernels=False, block_len=L,
                            device="cpu")
    src = SyntheticSource(FS, L, [Station(200e3, "fm"),
                                  Station(-300e3, "am")], noise=0.01)
    ctl = controls_from_manager(mgr, rx_o, keyed_o, 100e6)
    st = rxj_o.init_state()
    for _ in range(2):
        b = next(src)
        st, _ = rxj_o.apply(st, (JPC(b.real, b.imag), ctl))
    old_j = jax.tree.map(np.asarray, st)
    old = state_to_numpy(state_from_numpy(old_j))

    _edit(mgr, kind)
    specs_n, keyed_n = plan_from_manager(mgr)
    rxj_n = _jax_pipeline([(s.modem_name, s.bandwidth, s.count)
                           for s in specs_n], L)
    rx_n = ReceiverPipeline(FS, specs_n, use_kernels=False, block_len=L,
                            device="cpu")
    want = jax.tree.map(np.asarray, j_carry(
        rxj_o, old_j, keyed_o, rxj_n, keyed_n,
        jax.tree.map(np.asarray, rxj_n.init_state())))
    got = _carry_streaming_state(rx_o, old, keyed_o, rx_n, keyed_n,
                                 state_to_numpy(rx_n.init_state()))
    a, b = tree_leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y)
    # The FM demod at +200 kHz survives every edit with its own row.
    fm_old = tree_leaves(old["groups"][0])
    fm_new = tree_leaves(got["groups"][0])
    row = 0
    for x, y in zip(fm_new, fm_old):
        if np.ndim(x):
            np.testing.assert_array_equal(x[row], y[0])
    assert any(np.abs(y).sum() for y in fm_old if np.ndim(y))


_REBUILDS = [
    ("add", {"action": "add", "freq": 100e6 - 150e3, "type": "NBFM",
             "bandwidth": 12500}),
    ("bandwidth", {"action": "set", "index": 1, "key": "bandwidth",
                   "value": 6000}),
    ("type", {"action": "set", "index": 2, "key": "type", "value": "AM"}),
    ("remove", {"action": "remove", "index": 2}),
]


def _rebuild_run(pkg, blocks, L):
    """The live loop of package ``pkg`` ('port' or 'jax') on the host over
    ``blocks`` (3 before the first edit, then 2 after each of _REBUILDS),
    both on their kernel paths (the JAX package's Pallas kernels
    interpreted), so that every plan keeps one route tail per channel
    alike; a subset sink on demod 0 pulls its own audio. Returns per
    block (mix, demod 0's audio), and each rebuilt plan's groups."""
    if pkg == "port":
        from cubicsdr_tpu_torch.app.runner import LiveReceiver
        from cubicsdr_tpu_torch.app.webview import WebViewer
        mgr = DemodulatorMgr()
        make = lambda specs: ReceiverPipeline(  # noqa: E731
            FS, specs, block_len=L, device="cpu")
        ctl_of = controls_from_manager
    else:
        from cubicsdr_tpu.app.runner import LiveReceiver
        from cubicsdr_tpu.app.webview import WebViewer
        from cubicsdr_tpu.receiver import (
            DemodulatorMgr as JMgr, controls_from_manager as j_ctl)
        mgr = JMgr()
        make = lambda specs: _jax_pipeline(  # noqa: E731
            [(s.modem_name, s.bandwidth, s.count) for s in specs], L,
            use_pallas=True)
        ctl_of = j_ctl
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    mgr.new_demodulator(100e6 - 300e3, "AM", 10000)
    if pkg == "port":
        specs, keyed = plan_from_manager(mgr)
    else:
        from cubicsdr_tpu.receiver import plan_from_manager as j_plan
        specs, keyed = j_plan(mgr)
    rx = make(specs)
    got = []

    def on_block(o):
        g = o["groups"][0]
        got.append((o["mix"].copy(),
                    g["audio"][list(g["audio_rows"]).index(0)].copy()))

    lr = LiveReceiver(rx, ctl_of(mgr, rx, keyed, 100e6), iter([]),
                      center_freq=100e6, waterfall_fft=256,
                      waterfall_lines=8, on_block=on_block)
    viewer = WebViewer(lr, mgr, keyed, port=0)
    assert viewer.control({"action": "audio_output", "name": "fm",
                           "backend": "null", "demods": [0]})["ok"]
    groups = []
    it = iter(blocks)

    def feed(n):
        for _ in range(n):
            b = next(it)
            lr.ring.write(b.real.astype(np.float32),
                          b.imag.astype(np.float32))
        assert lr.run_blocks(max_blocks=n, wait=False) == n

    feed(3)
    for _, cmd in _REBUILDS:
        assert viewer.control(cmd)["ok"]
        assert lr.pipeline.block_len == L
        groups.append([(g.modem_name, g.bandwidth, g.count)
                       for g in lr.pipeline.groups])
        feed(2)
    lr.stop()
    return got, groups


def test_rebuilt_plan_audio_matches_jax_harness(monkeypatch):
    """The same blocks and the same control sequence (add NBFM, set a
    bandwidth, set a type, remove) through the port's live loop and the
    JAX package's: after every rebuild the plans agree, the surviving FM
    demod's own audio and the mix (with the rows that start cold) agree
    at the main path's gates."""
    L = _common_block_len()
    src = SyntheticSource(FS, L, [Station(200e3, "fm", audio_freq=800.0),
                                  Station(-300e3, "am", audio_freq=500.0),
                                  Station(-150e3, "fm", audio_freq=600.0,
                                          deviation=2.5e3)], noise=0.01)
    blocks = [next(src) for _ in range(3 + 2 * len(_REBUILDS))]
    import cubicsdr_tpu.ops.pallas.pfb as j_pfb
    import cubicsdr_tpu.ops.pallas.route as j_route
    monkeypatch.setattr(j_pfb, "INTERPRET", True)
    monkeypatch.setattr(j_route, "INTERPRET", True)
    port, port_groups = _rebuild_run("port", blocks, L)
    ref, ref_groups = _rebuild_run("jax", blocks, L)
    assert port_groups == ref_groups
    assert port_groups[-1] == [("FM", 200000, 1), ("AM", 6000, 1)]
    assert len(port) == len(ref) == len(blocks)
    for (mix, fm), (mix_j, fm_j) in zip(port, ref):
        for a, b in ((mix, mix_j), (fm, fm_j)):
            d = np.abs(a - b)
            assert np.sqrt(np.mean(d * d)) < 2e-3
            assert np.quantile(d, 0.995) < 5e-3
    assert np.abs(port[-1][1]).max() > 0.1          # the FM tone is there


# --- faults of the JAX control plane that the port does not copy ----------

def test_sink_demods_report_manager_indices(hx, tmp_path):
    """GET /api/audio_devices lists a subset sink's demods as manager
    indices, the indices POST audio_output takes — not the instance ids
    the JAX package reports (its webview.py:1579)."""
    d0 = hx.mgr.get_demodulators()[0]
    assert d0._id != 0
    assert _post(hx.port, "/api/control",
                 {"action": "audio_output", "name": "spk",
                  "backend": f"wav:{tmp_path / 'spk'}", "demods": [0]})["ok"]
    hx.run(1)
    ad = json.loads(_get(hx.port, "/api/audio_devices"))
    assert ad["sinks"]["spk"]["demods"] == [0]
    assert _post(hx.port, "/api/control",
                 {"action": "audio_output", "name": "spk"})["ok"]


def test_ppm_reference_zero_is_an_error_not_a_division(hx):
    """/api/ppm?ref=0 answers ok=false (the JAX package divides by the
    reference, webview.py:869), also with the band around 0 Hz; a real
    carrier still measures."""
    _post(hx.port, "/api/control", {"action": "tune", "freq": 0.0})
    try:
        for q in ("ref=0", "ref=-5", "ref="):
            r = json.loads(_get(hx.port, f"/api/ppm?{q}"))
            assert r["ok"] is False and "positive" in r["error"]
    finally:
        _post(hx.port, "/api/control", {"action": "tune", "freq": 100e6})
    hx.run(2)
    r = json.loads(_get(hx.port, f"/api/ppm?ref={100e6 + 200e3}"))
    assert r["ok"], r
    assert abs(r["offset_hz"]) < 4 * r["bin_hz"]


# --- the settings-validation half of tests/test_modem_settings.py ----------

def _viewer(mgr, keyed, rx, controls, center=100e6):
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.app.webview import WebViewer
    lr = LiveReceiver(rx, controls, iter([]), center_freq=center,
                      waterfall_fft=256, waterfall_lines=8)
    return lr, WebViewer(lr, mgr, keyed, port=0)    # never started: direct


def _plan(*demods):
    mgr = DemodulatorMgr()
    insts = [mgr.new_demodulator(*d) for d in demods]
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, device="cpu")
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))
    return mgr, insts, rx, lr, viewer


def test_settings_schema_and_validation():
    mgr, _, _, _, viewer = _plan((100e6 + 200e3, "FM", 200000),
                                 (100e6 - 300e3, "FSK", 19200))
    # Schema surface: FSK exposes bps/sps/bw as typed args with ranges.
    sch = viewer.modem_settings_json(1)
    assert sch["ok"] and sch["type"] == "FSK"
    keys = {a["key"]: a for a in sch["schema"]}
    assert keys["bps"]["type"] == "int" and keys["bps"]["low"] == 1
    assert "sps" in keys and "bw" in keys
    # Validation: unknown key, bad type, out-of-range all rejected.
    for settings in ({"nope": 1}, {"bps": "xyz"}, {"bps": 99}, {}):
        assert not viewer.control({"action": "modem_settings", "index": 1,
                                   "settings": settings})["ok"]
    # Index bounds on the GET surface.
    assert not viewer.modem_settings_json(7)["ok"]


def test_flip_fsk_bps_and_fms_demph_mid_stream():
    """Flip FSK bps and FMS demph on a RUNNING receiver; the untouched FM
    demod's audio continues exactly as if no rebuild happened (state
    carry), and the edited settings are live in the new plan."""
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    fm = (100e6 + 200e3, "FM", 200000)
    fms = (100e6 - 200e3, "FMS", 200000)
    fsk = (100e6 + 400e3, "FSK", 19200)
    L = ReceiverPipeline(
        FS, [DemodGroupSpec("FM", 200000, 1),
             DemodGroupSpec("FMS", 200000, 1),
             DemodGroupSpec("FSK", 19200, 1)], device="cpu").block_len
    src = SyntheticSource(FS, L, [Station(200e3, "fm", audio_freq=800.0),
                                  Station(-200e3, "fm", audio_freq=400.0),
                                  Station(400e3, "tone")])
    blocks = [next(src) for _ in range(6)]

    # --- reference: never-rebuilt FM-only pipeline ---
    mgr_a = DemodulatorMgr()
    mgr_a.new_demodulator(*fm)
    specs, keyed_a = plan_from_manager(mgr_a)
    rx_a = ReceiverPipeline(FS, specs, block_len=L, device="cpu")
    ctl_a = controls_from_manager(mgr_a, rx_a, keyed_a, 100e6)
    st, ref = rx_a.init_state(), []
    for b in blocks:
        st, out = rx_a.apply(st, (PC(*_step_planes(b)), ctl_a))
        ref.append(out["groups"][0]["audio"][0].numpy())

    # --- live run: FM + FMS + FSK, settings flipped after block 3 ---
    mgr = DemodulatorMgr()
    for d in (fm, fms, fsk):
        mgr.new_demodulator(*d)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, block_len=L, device="cpu")
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))

    def group_of(type_name):
        return next(gi for gi, g in enumerate(lr.pipeline.groups)
                    if g.modem_name == type_name)

    got, fsk_before, fsk_after = [], [], []
    for i, b in enumerate(blocks):
        if i == 3:
            r = viewer.control({"action": "modem_settings", "index": 2,
                                "settings": {"bps": 2}})
            assert r["ok"] and r["settings"]["bps"] == 2
            r = viewer.control({"action": "modem_settings", "index": 1,
                                "settings": {"demph": 50}})
            assert r["ok"] and r["settings"]["demph"] == 50
            assert lr.pipeline.block_len == L       # pinned size survives
            assert dict(lr.pipeline.groups[group_of("FSK")]
                        .settings)["bps"] == 2
            assert dict(lr.pipeline.groups[group_of("FMS")]
                        .settings)["demph"] == 50
        lr.state, out = lr.step(lr.state, (_step_planes(b), lr.controls))
        # Copies: the compiled step reuses its output buffers.
        got.append(out["groups"][group_of("FM")]["audio"][0].numpy().copy())
        syms = out["groups"][group_of("FSK")]["symbols"][0].numpy().copy()
        (fsk_after if i >= 3 else fsk_before).append(syms)

    for i in (3, 4, 5):
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=2e-3)
    _, out_cold = rx_a.apply(rx_a.init_state(),
                             (PC(*_step_planes(blocks[3])), ctl_a))
    assert not np.allclose(out_cold["groups"][0]["audio"][0].numpy(),
                           ref[3], atol=2e-3)
    # bps flip is live: 4-ary symbols appear (bps=2 => symbols in 0..3).
    assert max(s.max() for s in fsk_after) > 1
    assert max(s.max() for s in fsk_before) <= 1
    assert np.isfinite(got[-1]).all()


def _stream(lr, src, n):
    for _ in range(n):
        b = next(src)
        lr.ring.write(b.real.astype(np.float32), b.imag.astype(np.float32))
    lr.run_blocks(max_blocks=n, wait=False)


def test_runtime_per_demod_recording(tmp_path):
    """Start recording ONE demod at runtime, stream, change options,
    stop: a valid finalized WAV with time-limit rotation honored; the
    other demod never records (ref: src/demod/DemodulatorInstance.cpp:
    600-655, src/audio/AudioSinkFileThread.cpp:28-73)."""
    import time
    from cubicsdr_tpu_torch.io.wav import read_wav
    mgr, (_, am), rx, lr, viewer = _plan((100e6 + 200e3, "FM", 200000),
                                         (100e6 - 300e3, "AM", 10000))
    src = SyntheticSource(FS, rx.block_len,
                          [Station(200e3, "fm", audio_freq=800.0),
                           Station(-300e3, "am", audio_freq=500.0)])
    _stream(lr, src, 2)                  # not recording yet
    assert not list(tmp_path.iterdir())
    base = str(tmp_path / "rec")
    assert viewer.control({"action": "record_opts", "path": base,
                           "time_limit": 0.05, "squelch": "always"})["ok"]
    assert viewer.control({"action": "set", "index": 1,
                           "key": "recording", "value": True})["ok"]
    st = viewer.state_json()
    assert [d["recording"] for d in st["demods"]] == [False, True]
    assert st["record"]["time_limit"] == 0.05
    t0 = time.time()
    _stream(lr, src, 6)
    while time.time() - t0 < 0.12:       # ensure the rotation clock ticks
        time.sleep(0.01)
    _stream(lr, src, 6)
    assert viewer.control({"action": "set", "index": 1,
                           "key": "recording", "value": False})["ok"]
    assert not viewer.state_json()["demods"][1]["recording"]
    assert not lr._recorders
    wavs = sorted(tmp_path.iterdir())
    assert len(wavs) >= 2                # base + >=1 rotated file
    total = 0
    for w in wavs:
        data, rate = read_wav(str(w))
        assert rate == rx.audio_rate
        total += data.shape[-1]
    assert total == 12 * rx.audio_len    # every recorded block landed
    assert all(f"demod{am._id}" in w.name for w in wavs)
    assert viewer.control({"action": "set", "index": 1,
                           "key": "recording", "value": True})["ok"]
    _stream(lr, src, 2)
    lr.stop()


def test_multi_sink_audio_routing(tmp_path):
    """Two host sinks, each fed a DIFFERENT demod subset mixed host-side
    (ref: src/audio/AudioThread.cpp:370-442)."""
    import os
    from cubicsdr_tpu_torch.io.wav import read_wav
    mgr, _, rx, lr, viewer = _plan((100e6 + 200e3, "FM", 200000),
                                   (100e6 - 300e3, "AM", 10000))
    src = SyntheticSource(FS, rx.block_len,
                          [Station(200e3, "fm", audio_freq=800.0),
                           Station(-300e3, "am", audio_freq=500.0)])
    wav_a, wav_b = str(tmp_path / "a"), str(tmp_path / "b")
    for name, path, idx in (("spkA", wav_a, 0), ("spkB", wav_b, 1)):
        assert viewer.control({"action": "audio_output", "name": name,
                               "backend": f"wav:{path}",
                               "demods": [idx]})["ok"]
    assert set(lr.audio_sinks) == {"spkA", "spkB"}
    _stream(lr, src, 6)
    assert viewer.control({"action": "audio_output", "name": "spkA"})["ok"]
    assert viewer.control({"action": "audio_output", "name": "spkB"})["ok"]
    assert not lr.audio_sinks
    lr.stop()

    def tone_of(path):
        d, rate = read_wav(path)
        x = d.mean(axis=0) if d.ndim == 2 else d
        x = x[len(x) // 2:]
        X = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        return np.fft.rfftfreq(len(x), 1 / rate)[np.argmax(X)]

    fa = wav_a + ("" if os.path.exists(wav_a) else ".wav")
    fb = wav_b + ("" if os.path.exists(wav_b) else ".wav")
    assert abs(tone_of(fa) - 800.0) < 20         # sink A: the FM demod
    assert abs(tone_of(fb) - 500.0) < 20         # sink B: the AM demod


def test_recording_rejected_for_digital_demods(tmp_path):
    """Digital demods emit symbols, not audio: toggling recording is a
    clear error, not a silent always-on flag."""
    _, _, _, lr, viewer = _plan((100e6 + 200e3, "FM", 200000),
                                (100e6 - 300e3, "BPSK", 20000))
    r = viewer.control({"action": "set", "index": 1, "key": "recording",
                        "value": True, "path": str(tmp_path / "never")})
    assert not r["ok"] and "symbols" in r["error"]
    assert not lr.any_recording()


def test_live_checkpoint_restore_is_bit_continuous(tmp_path):
    """REST checkpoint/restore of the RUNNING receiver: restoring the
    saved streaming state and replaying the same block reproduces the
    post-checkpoint audio exactly."""
    _, _, rx, lr, viewer = _plan((100e6 + 200e3, "FM", 200000))
    src = SyntheticSource(FS, rx.block_len,
                          [Station(200e3, "fm", audio_freq=800.0)])
    blocks = [next(src) for _ in range(4)]
    audio = []
    lr.on_block = lambda o: audio.append(o["mix"].copy())

    def stream(blks):
        for b in blks:
            lr.ring.write(b.real.astype(np.float32),
                          b.imag.astype(np.float32))
        lr.run_blocks(max_blocks=len(blks), wait=False)

    stream(blocks[:3])
    p = str(tmp_path / "ckpt.json")
    assert viewer.session_io({"op": "checkpoint", "path": p})["ok"]
    stream(blocks[3:])
    a3 = audio[3]
    audio.clear()
    res = viewer.session_io({"op": "restore", "path": p})
    assert res["ok"], res
    stream(blocks[3:])
    np.testing.assert_allclose(audio[0], a3, rtol=0, atol=1e-6)
