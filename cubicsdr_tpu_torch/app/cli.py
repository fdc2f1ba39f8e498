"""Command-line shell — the headless CubicSDR application on the port
(``cubicsdr_tpu/app/cli.py``).

    python -m cubicsdr_tpu_torch {demod,waterfall,rx,serve,multihost,modems,
                                  bench}

Replaces the wxApp shell (ref: src/CubicSDR.cpp OnInit/OnExit + cmdline
flags CubicSDR.h:259-268) with subcommands:

  demod      one receiver: IQ capture -> audio WAV
  rx         session file -> every demodulator -> stereo mix WAV
  waterfall  IQ capture -> spectrum/waterfall PNG
  serve      live receiver + web UI
  multihost  distributed receive: N processes, each feeding its own span
  modems     list registered modem types + settings schemas
  bench      the throughput benchmark (``cubicsdr_tpu_torch/bench.py``)

The subcommands that run the receiver take ``--device`` (default
``cuda``): they run on the card with both CUDA kernels, and fail where
the host has no CUDA device unless ``--device cpu`` is given (the
kernels' plain versions then run on the host). The arguments and output
files are the JAX package's. ``rx --mesh "time=T,chan=C"`` runs the
sharded receiver on T*C local ranks, one process each: one card per rank
with NCCL, or CPU ranks with gloo under ``--device cpu``; with it come
the options only that mode reads (``--fft-size``, ``--checkpoint``,
``--record``). ``multihost`` takes ``--devices`` as the device kind
(``cuda`` or ``cpu``), since each process holds one device. ``bench``
hands every argument after it to ``cubicsdr_tpu_torch.bench`` (the
throughput rows: ``--only``, ``--demods``, ``--block``, ``--no-kernels``,
``--live-blocks``, ``--device``). ``demod``, ``rx`` and ``waterfall`` run
their per-block step as a ``utils/compiled.py`` ``CompiledStep`` (the JAX
CLI's ``jax.jit``): on the card one CUDA graph replay per block, on the
CPU the same buffers run eagerly. ``rx --mesh`` runs each rank's
sharded step compiled too (``ShardedReceiver.make_step``): on the card a
CUDA graph per rank with its NCCL collectives inside, on CPU ranks the
same buffers run eagerly between gloo collectives.

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


def _compiled_apply(rx):
    """``rx.apply`` as a ``CompiledStep`` (the JAX CLI's ``jax.jit(
    rx.apply)``): on the card a CUDA graph per output slot, captured at
    the first block (``FileIQSource`` pads the last block, so every block
    has the plan's length); on the CPU the same buffers, run eagerly."""
    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    return CompiledStep(rx.apply, rx.device)


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
    step = _compiled_apply(rx)
    state = rx.init_state()
    w = WavWriter(args.output, 48000, 1)
    nblocks = 0
    for blk in src:
        state, out = step(state, (_planes(blk, rx.device), controls))
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

    def apply(sts, x):
        st_d, (frames, valid) = dist.apply(sts[0], x)
        st_s, out = sp.apply(sts[1], frames, valid=valid)
        return (st_d, st_s), (out, valid)

    from cubicsdr_tpu_torch.utils.compiled import CompiledStep
    step = CompiledStep(apply, dev)        # the JAX CLI's jitted step
    sts = (dist.init_state(), sp.init_state())
    n_lines = 0
    for blk in src:
        sts, (out, valid) = step(sts, _planes(blk, dev))
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
    if args.mesh:
        return _rx_sharded(args)
    rx = ReceiverPipeline(sess.sample_rate, specs,
                          chan_mode=args.channelizer, device=args.device)
    controls = _device_controls(
        controls_from_manager(mgr, rx, keyed, sess.center_freq), rx.device)
    src = FileIQSource(args.input, sess.sample_rate, rx.block_len)
    step = _compiled_apply(rx)
    state = rx.init_state()
    mix_w = WavWriter(args.output, 48000, 2)
    player = None
    if args.play:
        from cubicsdr_tpu_torch.io.audio_out import AudioOutput
        player = AudioOutput(48000, 2, backend=args.play)
    for blk in src:
        state, out = step(state, (_planes(blk, rx.device), controls))
        mix = out["mix"].cpu().numpy()
        mix_w.write(mix)
        if player is not None:
            player.write(mix)
    mix_w.close()
    if player is not None:
        player.close()
    print(f"wrote {mix_w.current_path} "
          f"({len(mgr.get_demodulators())} demods mixed)")


def _parse_mesh(spec: str) -> tuple[int, int]:
    kv = dict(p.split("=") for p in spec.split(","))
    return int(kv.get("time", 1)), int(kv.get("chan", 1))


def _rx_sharded(args):
    """Session rx on a mesh of local ranks: ShardedReceiver end to end
    (halo'd channelizer, chan-split demod rows, the mix summed into the
    WAV, the gathered spectrum into the waterfall PNG, per-demod recording
    taps, and a bit-continuous checkpoint of the sharded state)."""
    import torch
    from cubicsdr_tpu_torch.parallel.multihost import spawn_ranks
    nt, nc = _parse_mesh(args.mesh)
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if nt * nc > have:
            print(f"mesh {nt}x{nc} needs {nt * nc} CUDA devices (one per "
                  f"rank), have {have}", file=sys.stderr)
            return 1
    opts = {k: v for k, v in vars(args).items() if k != "fn"}
    spawn_ranks(_rx_rank, nt * nc, args=(opts,), device=args.device)
    return 0


def _rx_rank(rank: int, opts: dict) -> None:
    """One rank of ``rx --mesh``; rank 0 writes the files."""
    import os
    import torch
    from cubicsdr_tpu_torch.app.checkpoint import (
        load_sharded_state, save_sharded_state)
    from cubicsdr_tpu_torch.app.session import SessionMgr
    from cubicsdr_tpu_torch.io import FileIQSource, WavWriter
    from cubicsdr_tpu_torch.io.recorder import RecordingSink
    from cubicsdr_tpu_torch.io.sources import optimal_channel_count
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.receiver import (
        DemodulatorMgr, controls_from_manager, plan_from_manager)
    from cubicsdr_tpu_torch.visual import SpectrumProcessor, Waterfall
    from cubicsdr_tpu_torch.visual.spectrum import mags_to_display

    mgr = DemodulatorMgr()
    sess = SessionMgr(mgr)
    if not sess.load_session(opts["session"]):
        raise RuntimeError(f"cannot load session {opts['session']}")
    specs, keyed = plan_from_manager(mgr)
    nt, nc = _parse_mesh(opts["mesh"])
    dev = (torch.device("cuda", torch.cuda.current_device())
           if opts["device"] == "cuda" else torch.device(opts["device"]))
    mesh = make_receiver_mesh(nt, nc, device_type=dev.type)
    fft = opts["fft_size"]
    rx = ShardedReceiver(sess.sample_rate,
                         optimal_channel_count(sess.sample_rate), specs,
                         mesh=mesh, spectrum_fft=fft, device=dev)
    controls = rx.place_controls(
        controls_from_manager(mgr, rx, keyed, sess.center_freq))
    step = rx.make_step()        # the JAX CLI's jitted sharded step
    ck = opts["checkpoint"]
    state = rx.init_state()
    lead = rank == 0
    if ck and os.path.exists(ck):
        state, meta = load_sharded_state(ck, rx)
        if lead:
            print(f"resumed from {ck} (block {meta.get('blocks', '?')})")
    src = FileIQSource(opts["input"], sess.sample_rate, rx.block_len)
    if lead:
        mix_w = WavWriter(opts["output"], rx.audio_rate, 2)
        core = SpectrumProcessor(fft)
        st_sp = core.init_state()
        wf = Waterfall(fft, max(32, src.n_samples // rx.block_len * nt))
        recorders: dict[int, RecordingSink] = {}
    n_blocks = 0
    for blk in src:
        state, out = step(state, (rx.shard_iq(blk), controls))
        out = rx.gather_outputs(out)
        n_blocks += 1
        if not lead:
            continue
        mix_w.write(out["mix"])
        st_sp, pts = mags_to_display(core, st_sp, out["spectrum_mags"])
        wf.add_lines(np.tile(pts, (nt, 1)))
        if opts["record"]:
            flat = 0
            for g in out["groups"]:
                rows = g["level"].shape[0]
                for ri in range(rows if "audio" in g else 0):
                    key = flat + ri
                    if key not in recorders:
                        recorders[key] = RecordingSink(
                            f"{opts['record']}_demod{key}", rx.audio_rate,
                            channels=g["audio"].shape[1])
                    recorders[key].write(g["audio"][ri],
                                         bool(g["squelched"][ri]))
                flat += rows
    if ck:
        save_sharded_state(ck, rx, state, meta={"blocks": n_blocks})
    if not lead:
        return
    mix_w.close()
    for r in recorders.values():
        r.close()
    png = opts["output"].rsplit(".", 1)[0] + "_waterfall.png"
    with open(png, "wb") as f:
        f.write(wf.render_png_bytes())
    print(f"sharded rx on {nt}x{nc} mesh: {n_blocks} blocks -> "
          f"{mix_w.current_path}, {png}"
          + (f", checkpoint {ck}" if ck else ""), flush=True)


def cmd_multihost(args):
    """Distributed multi-process receive. Launcher mode (default): spawn N
    local worker processes over loopback and collect their reports.
    Worker mode (--worker): join the job as one process; on several hosts
    run one worker per host with --coordinator pointing at host 0. A
    worker dumps its threads' Python stacks to stderr on SIGUSR1, which
    the launcher sends at its timeout before it kills the job."""
    import json
    from cubicsdr_tpu_torch.parallel import multihost
    if args.worker:
        import faulthandler
        import signal
        faulthandler.register(signal.SIGUSR1, all_threads=True)
        rep = multihost.run_worker(args.coordinator, args.nprocs,
                                   args.process_id, steps=args.steps,
                                   verify=not args.no_verify,
                                   timed_steps=args.timed_steps,
                                   device=args.devices, plan=args.plan,
                                   host_collectives=args.host_collectives)
        print(json.dumps(rep), flush=True)
        return 0
    reports = multihost.launch_local(args.nprocs, steps=args.steps,
                                     timed_steps=args.timed_steps,
                                     device=args.devices, plan=args.plan,
                                     verify=not args.no_verify,
                                     host_collectives=args.host_collectives)
    for rep in reports:
        print(json.dumps(rep))
    ok = all(r["ok"] and r["process_count"] == args.nprocs
             for r in reports)
    print(f"multihost: {args.nprocs} processes on {args.devices}, "
          f"{'verified' if ok else 'FAILED'}")
    return 0 if ok else 1


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


def cmd_bench(args):
    from cubicsdr_tpu_torch import bench
    bench.main(args.bench_args)


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; "
                        "'cpu' runs the kernels' plain versions on the "
                        "host)")


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the JAX package's subcommands and arguments,
    with ``--device``; ``multihost --devices`` is the device kind;
    ``bench`` takes the bench's own arguments (see ``main``)."""
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
    r.add_argument("--mesh", default=None,
                   help='run on a mesh of local ranks, e.g. "time=4,chan=2" '
                        "(sharded receiver: halo channelizer, summed mix, "
                        "gathered spectrum waterfall)")
    r.add_argument("--fft-size", type=int, default=512,
                   help="waterfall FFT size (sharded mode)")
    r.add_argument("--checkpoint", default=None,
                   help="state snapshot path: resumed if present, saved "
                        "at end (bit-continuous, sharded mode)")
    r.add_argument("--record", default=None,
                   help="base path for per-demod recording WAVs "
                        "(sharded mode)")
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

    mh = sub.add_parser("multihost",
                        help="distributed multi-process receive")
    mh.add_argument("--nprocs", type=int, default=2)
    mh.add_argument("--steps", type=int, default=2)
    mh.add_argument("--devices", default="cuda", choices=["cuda", "cpu"],
                    help="device kind of each process (one device each)")
    mh.add_argument("--worker", action="store_true")
    mh.add_argument("--coordinator", default="localhost:9876")
    mh.add_argument("--process-id", type=int, default=0)
    mh.add_argument("--no-verify", action="store_true")
    mh.add_argument("--timed-steps", type=int, default=0,
                    help="append a steady-state timing phase of N steps "
                         "(reports aggregate MS/s)")
    mh.add_argument("--host-collectives", action="store_true",
                    help="run the collectives through gloo on host copies "
                         "of the card's tensors, so that processes may "
                         "share a card")
    mh.add_argument("--plan", default="demo", choices=["demo", "scan58"],
                    help="the job's plan: a 1 MS/s FM + BPSK demo, or "
                         "scan58 (8 MS/s, 58 demods in six groups)")
    mh.set_defaults(fn=cmd_multihost)

    m = sub.add_parser("modems", help="list modem types")
    m.set_defaults(fn=cmd_modems)

    b = sub.add_parser("bench", add_help=False,
                       help="run the throughput benchmark (its arguments: "
                            "bench --help)")
    b.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = build_parser()
    if argv[:1] == ["bench"]:
        # Everything after ``bench`` is the bench's own command line.
        args = ap.parse_args(argv[:1])
        args.bench_args = argv[1:]
    else:
        args = ap.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
