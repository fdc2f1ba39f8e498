"""Command-line shell — the headless CubicSDR application on the port
(``cubicsdr_tpu/app/cli.py``).

    python -m cubicsdr_tpu_torch {demod,waterfall,rx,serve,modems} ...

Replaces the wxApp shell (ref: src/CubicSDR.cpp OnInit/OnExit + cmdline
flags CubicSDR.h:259-268) with subcommands:

  demod      one receiver: IQ capture -> audio WAV
  rx         session file -> every demodulator -> stereo mix WAV
  waterfall  IQ capture -> spectrum/waterfall PNG
  serve      live receiver + web UI
  modems     list registered modem types + settings schemas

The subcommands that run the receiver take ``--device`` (default
``cuda``): they run on the card with both CUDA kernels, and fail where
the host has no CUDA device unless ``--device cpu`` is given (the
kernels' plain versions then run on the host). The arguments and output
files are the JAX package's; its sharded ``rx --mesh`` (with the options
only that mode reads: ``--fft-size``, ``--checkpoint``, ``--record``), the
``multihost`` launcher and ``bench`` are not part of the port yet.

Frequency strings accept the reference's forms ("100.1", "100.1M",
"98700k", raw Hz; ref: CubicSDR.cpp:80-141 frequency parsing).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_frequency(s) -> float:
    """'100.1' (MHz if small), '100.1M', '98700k', '2.4G', else Hz
    (ref: CubicSDR::strToFrequency semantics)."""
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip().lower().replace("hz", "")
    mult = 1.0
    if s.endswith("g"):
        mult, s = 1e9, s[:-1]
    elif s.endswith("m"):
        mult, s = 1e6, s[:-1]
    elif s.endswith("k"):
        mult, s = 1e3, s[:-1]
    v = float(s) * mult
    if mult == 1.0 and v < 3000:        # bare small number = MHz convention
        v *= 1e6
    return v


def format_frequency(f: float) -> str:
    if f >= 1e9:
        return f"{f/1e9:.6f} GHz"
    if f >= 1e6:
        return f"{f/1e6:.6f} MHz"
    if f >= 1e3:
        return f"{f/1e3:.3f} kHz"
    return f"{f:.0f} Hz"


def _device(name: str):
    """The torch device ``name``; a CUDA device on a host without one is
    an error, not a quiet run on the CPU."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this host has no CUDA device; pass --device cpu "
                           "to run on the host")
    return dev


def _planes(blk: np.ndarray, device):
    """A complex64 block as planar (re, im) float32 tensors on ``device``."""
    import torch
    from cubicsdr_tpu_torch.ops.planar import PC
    return PC(torch.from_numpy(np.ascontiguousarray(blk.real)).to(device),
              torch.from_numpy(np.ascontiguousarray(blk.imag)).to(device))


def _device_controls(controls, device):
    """Control vectors as tensors on ``device``, uploaded once."""
    import torch
    return [{k: torch.as_tensor(v, device=device) for k, v in c.items()}
            for c in controls]


def cmd_demod(args):
    from cubicsdr_tpu_torch.io import FileIQSource, WavWriter
    from cubicsdr_tpu_torch.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)

    center = parse_frequency(args.center)
    freq = parse_frequency(args.frequency)
    mgr = DemodulatorMgr()
    d = mgr.new_demodulator(freq, args.modem, args.bandwidth)
    if args.squelch is not None:
        d.squelch_enabled = True
        d.squelch_level = args.squelch
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(args.rate, specs, chan_mode=args.channelizer,
                          device=args.device)
    controls = _device_controls(
        controls_from_manager(mgr, rx, keyed, center), rx.device)
    src = FileIQSource(args.input, args.rate, rx.block_len,
                       frequency=center)
    state = rx.init_state()
    w = WavWriter(args.output, 48000, 1)
    nblocks = 0
    for blk in src:
        state, out = rx.apply(state, (_planes(blk, rx.device), controls))
        w.write(out["groups"][0]["audio"][0].cpu().numpy())
        nblocks += 1
        if args.max_seconds and nblocks * rx.block_len / args.rate \
                >= args.max_seconds:
            break
    w.close()
    lvl = float(out["groups"][0]["level"][0])
    print(f"wrote {w.current_path}: {nblocks} blocks, "
          f"signal {lvl:.1f} dB")


def cmd_waterfall(args):
    from cubicsdr_tpu_torch.io import FileIQSource
    from cubicsdr_tpu_torch.visual import (
        FFTDataDistributor, PlanarSpectrumProcessor, Waterfall)

    dev = _device(args.device)
    src = FileIQSource(args.input, args.rate, block_len=1 << 17)
    dist = FFTDataDistributor(args.fft_size * 2, args.rate,
                              lines_per_second=args.lps,
                              block_len=1 << 17).to(dev)
    sp = PlanarSpectrumProcessor(args.fft_size).to(dev)
    wf = Waterfall(args.fft_size, lines=args.lines, theme=args.theme)

    st_d, st_s = dist.init_state(), sp.init_state()
    n_lines = 0
    for blk in src:
        st_d, (frames, valid) = dist.apply(st_d, _planes(blk, dev))
        st_s, out = sp.apply(st_s, frames, valid=valid)
        nv = int(valid.sum())
        if nv:
            pts = out["spectrum_points"].cpu().numpy()
            wf.add_lines(np.tile(pts, (nv, 1)))
            n_lines += nv
        if n_lines >= args.lines:
            break
    wf.render_png(args.output)
    print(f"wrote {args.output}: {n_lines} lines, fft {args.fft_size}, "
          f"floor {float(out['fft_floor']):.2f}")


def cmd_rx(args):
    from cubicsdr_tpu_torch.app.session import SessionMgr
    from cubicsdr_tpu_torch.io import FileIQSource, WavWriter
    from cubicsdr_tpu_torch.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)

    mgr = DemodulatorMgr()
    sess = SessionMgr(mgr)
    if not sess.load_session(args.session):
        print(f"cannot load session {args.session}", file=sys.stderr)
        return 1
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(sess.sample_rate, specs,
                          chan_mode=args.channelizer, device=args.device)
    controls = _device_controls(
        controls_from_manager(mgr, rx, keyed, sess.center_freq), rx.device)
    src = FileIQSource(args.input, sess.sample_rate, rx.block_len)
    state = rx.init_state()
    mix_w = WavWriter(args.output, 48000, 2)
    player = None
    if args.play:
        from cubicsdr_tpu_torch.io.audio_out import AudioOutput
        player = AudioOutput(48000, 2, backend=args.play)
    for blk in src:
        state, out = rx.apply(state, (_planes(blk, rx.device), controls))
        mix = out["mix"].cpu().numpy()
        mix_w.write(mix)
        if player is not None:
            player.write(mix)
    mix_w.close()
    if player is not None:
        player.close()
    print(f"wrote {mix_w.current_path} "
          f"({len(mgr.get_demodulators())} demods mixed)")


def cmd_serve(args):
    """Live receiver + web UI (the AppFrame analog, served over HTTP)."""
    import signal
    import time
    from cubicsdr_tpu_torch.app.config import AppConfig
    from cubicsdr_tpu_torch.app.runner import LiveReceiver
    from cubicsdr_tpu_torch.app.session import SessionMgr
    from cubicsdr_tpu_torch.app.webview import WebViewer
    from cubicsdr_tpu_torch.io import FileIQSource
    from cubicsdr_tpu_torch.io.devices import SDRDeviceInfo
    from cubicsdr_tpu_torch.io.sources import SyntheticSource, Station
    from cubicsdr_tpu_torch.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)

    # Persisted app config, loaded at start and saved at exit
    # (ref: AppConfig ctor load + OnExit save, src/CubicSDR.cpp:215,433).
    config = AppConfig.load(name=args.config)
    mgr = DemodulatorMgr()
    center, rate = float(config.center_freq or 100e6), args.rate
    if args.session:
        sess = SessionMgr(mgr)
        if not sess.load_session(args.session):
            print(f"cannot load session {args.session}", file=sys.stderr)
            return 1
        center, rate = sess.center_freq, sess.sample_rate
    if not mgr.get_demodulators():
        mgr.new_demodulator(center + 200e3, "FM", 200000)
    device_info = SDRDeviceInfo("synthetic=0", "Synthetic Signal Generator",
                                "synthetic")
    src = None
    if args.soapy is not None:
        # Live hardware: "driver=rtlsdr,..." SoapySDR args string. Open the
        # device FIRST — it may renegotiate the rate (ref: SoapySDRThread
        # .cpp:499-513) and the pipeline, channel centers and audio
        # resampling must all be built from the APPLIED rate. Persisted
        # DeviceConfig (ppm/AGC/gains/settings) reapplies on open
        # (ref: src/CubicSDR.cpp:814-841).
        from cubicsdr_tpu_torch.io.soapy import SoapySDRSource
        dc = config.get_device(args.soapy)
        src = SoapySDRSource(
            args.soapy, sample_rate=dc.sample_rate or rate,
            frequency=center, ppm=dc.ppm, agc=dc.agc_mode,
            iq_swap=bool(dc.settings.get("iq_swap", False)),
            wire_format=args.wire_format)
        for gname, gval in dc.gains.items():
            src.set_gain(gname, gval)
        for k, v in dc.settings.items():
            if k != "iq_swap":
                src.write_setting(k, v)
        rate = src.sample_rate
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(rate, specs, chan_mode=args.channelizer,
                          device=args.device)
    controls = controls_from_manager(mgr, rx, keyed, center)
    if src is not None:
        src.set_block_len(rx.block_len)
    elif args.input:
        src = FileIQSource(args.input, rate, rx.block_len, loop=True)
    else:
        src = SyntheticSource(rate, rx.block_len,
                              [Station(200e3, "fm", audio_freq=1000.0),
                               Station(-300e3, "am", audio_freq=600.0)])
    # Native-format ingest: CS16/CS8 wire planes ride the ring and the
    # host->device copy at wire width and convert on the device.
    ingest = {"cf32": None, "cs16": np.int16,
              "cs8": np.int8}[args.wire_format]
    lr = LiveReceiver(rx, controls, src, center_freq=center,
                      record_path=args.record or config.recording_path
                      or None,
                      waterfall_fft=args.fft_size,
                      waterfall_lps=float(config.waterfall_lps or 30),
                      ingest_dtype=ingest)
    try:
        lr.waterfall.set_theme(config.theme)
    except KeyError:                       # unknown persisted theme
        pass
    if args.audio:
        # Host playback of the live mix (RtAudio role,
        # ref: src/audio/AudioThread.cpp:88-243).
        lr.set_audio_output(args.audio)
    viewer = WebViewer(lr, mgr, keyed, host=args.host,
                       port=args.port, device_info=device_info,
                       source=src, config=config).start()
    if args.rig:
        from cubicsdr_tpu_torch.app.rig import (
            RigController, SimulatedRig, open_hamlib_rig)
        if args.rig == "sim":
            rig = SimulatedRig(center)
        else:                              # "hamlib:<model>:<port>[:baud]"
            parts = args.rig.split(":")
            rig = open_hamlib_rig(int(parts[1]), parts[2],
                                  int(parts[3]) if len(parts) > 3 else 9600)
        viewer.attach_rig(RigController(rig))
    print(f"serving http://{args.host}:{viewer.port}/  "
          f"(center {format_frequency(center)}, rate {rate:.0f}, "
          f"{rx.device})", flush=True)

    # SIGTERM -> the same ordered drain as Ctrl-C (ref: CubicSDR::OnExit
    # source-first shutdown, src/CubicSDR.cpp:433-528); background shells
    # ignore SIGINT, so daemons get stopped with TERM.
    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    lr.start_producer()
    try:
        while True:
            n = lr.run_blocks(max_blocks=64)
            if n == 0:
                time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        lr.stop()
        viewer.stop()
        # Auto-save the config on exit (ref: CubicSDR::OnExit saves
        # config.xml, src/CubicSDR.cpp:433-443).
        config.center_freq = int(lr.center_freq)
        config.theme = lr.waterfall.theme_name
        config.waterfall_lps = int(lr.dist.lps)
        config.save(name=args.config)
        print(lr.status())


def cmd_modems(args):
    from cubicsdr_tpu_torch.modems import modem_names, make_modem
    for t in ("analog", "digital"):
        names = modem_names(t)
        if not names:
            continue
        print(f"{t}:")
        for n in names:
            m = make_modem(n)
            settings = {a.key: a.value for a in m.get_settings()}
            extra = f"  settings={settings}" if settings else ""
            print(f"  {n:6s} default_rate={m.default_sample_rate}{extra}")


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; "
                        "'cpu' runs the kernels' plain versions on the "
                        "host)")


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the JAX package's subcommands and arguments
    (less the sharded and multi-host ones), with ``--device``."""
    ap = argparse.ArgumentParser(
        prog="cubicsdr_tpu_torch",
        description="Software radio (CubicSDR capability set) on PyTorch "
                    "and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demod", help="demodulate one station from a capture")
    d.add_argument("input")
    d.add_argument("-r", "--rate", type=float, required=True)
    d.add_argument("-c", "--center", default="0",
                   help="capture center frequency")
    d.add_argument("-f", "--frequency", required=True,
                   help="station frequency (abs, or offset if center=0)")
    d.add_argument("-m", "--modem", default="FM")
    d.add_argument("-b", "--bandwidth", type=float, default=200000)
    d.add_argument("-o", "--output", default="audio.wav")
    d.add_argument("--squelch", type=float, default=None)
    d.add_argument("--channelizer", default="pfbch2",
                   choices=["pfbch", "pfbch2", "single"])
    d.add_argument("--max-seconds", type=float, default=0)
    _device_arg(d)
    d.set_defaults(fn=cmd_demod)

    w = sub.add_parser("waterfall", help="render a waterfall PNG")
    w.add_argument("input")
    w.add_argument("-r", "--rate", type=float, required=True)
    w.add_argument("-o", "--output", default="waterfall.png")
    w.add_argument("--fft-size", type=int, default=2048)
    w.add_argument("--lines", type=int, default=512)
    w.add_argument("--lps", type=float, default=30)
    w.add_argument("--theme", default="default")
    _device_arg(w)
    w.set_defaults(fn=cmd_waterfall)

    r = sub.add_parser("rx", help="run a saved session against a capture")
    r.add_argument("session")
    r.add_argument("input")
    r.add_argument("-o", "--output", default="mix.wav")
    r.add_argument("--channelizer", default="pfbch2",
                   choices=["pfbch", "pfbch2", "single"])
    r.add_argument("--play", nargs="?", const="auto", default=None,
                   help="also play the mix to a host audio backend "
                        "(auto|sounddevice|wav:<path>|null)")
    _device_arg(r)
    r.set_defaults(fn=cmd_rx)

    s = sub.add_parser("serve", help="live receiver with web UI")
    s.add_argument("--wire-format", choices=["cf32", "cs16", "cs8"],
                   default="cf32",
                   help="ingest sample format: native CS16/CS8 halves/"
                        "quarters host->device bytes (on-device convert)")
    s.add_argument("session", nargs="?", default=None,
                   help="session .json (optional)")
    s.add_argument("input", nargs="?", default=None,
                   help="IQ capture to loop (default: synthetic stations)")
    s.add_argument("-r", "--rate", type=float, default=2_400_000)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("-p", "--port", type=int, default=8080)
    s.add_argument("--fft-size", type=int, default=1024)
    s.add_argument("--soapy", default=None,
                   help='live SoapySDR device args, e.g. "driver=rtlsdr"')
    s.add_argument("--rig", default=None,
                   help='rig control: "sim" or "hamlib:<model>:<port>[:baud]"')
    s.add_argument("--record", default=None,
                   help="base path to record per-demod WAVs")
    s.add_argument("--audio", nargs="?", const="auto", default=None,
                   help="play the live mix to a host audio backend "
                        "(auto|sounddevice|wav:<path>|null)")
    s.add_argument("-c", "--config", default="",
                   help="named config (ref: CubicSDR -c flag); loaded at "
                        "start, auto-saved at exit")
    s.add_argument("--channelizer", default="pfbch2",
                   choices=["pfbch", "pfbch2", "single"])
    _device_arg(s)
    s.set_defaults(fn=cmd_serve)

    m = sub.add_parser("modems", help="list modem types")
    m.set_defaults(fn=cmd_modems)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
