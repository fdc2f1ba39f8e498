"""Multi-process distributed receive (``cubicsdr_tpu/parallel/multihost.py``)
on ``torch.distributed``: a real job of N processes, one device each.

Each process ingests ONLY its own time span of every IQ block (its local
SDR or socket source); no process gathers raw samples, and the step's
collectives are the only traffic between processes.

  * ``run_worker``    one process of an N-process job: initialises
                      ``torch.distributed``, builds the ('time', 'chan'=1)
                      mesh over all ranks, feeds its span per block
                      (``shard_iq_local``) through the compiled sharded
                      step (``make_step``; eager, by ``compiled=False``,
                      on host collectives, which no graph can capture)
                      and checks its outputs against the unsharded
                      ``ReceiverPipeline`` computed locally, eagerly.
                      ``python -m cubicsdr_tpu_torch multihost --worker``.
  * ``launch_local``  spawns N worker processes on this host over loopback
                      and collects their JSON reports through
                      ``wait_workers``, which watches every worker at
                      once: the first that fails ends the job with its
                      output, and a timeout ends it with every live
                      worker's Python stacks.

Processes on CPUs use gloo. Processes on CUDA devices use NCCL with one
device per process. NCCL takes one rank per GPU, so local processes that
outnumber the host's cards are refused unless the caller asks for host
collectives (``host_collectives=True``, ``multihost --host-collectives``):
then the ranks share the cards and run their collectives through gloo on
host copies of the card's tensors, the stand-in for a link between hosts.
``spawn_ranks`` runs a function on N local ranks in one call
(``rx --mesh``, the scaling harness and the dry run), and
``spawn_collect`` also returns rank 0's report.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# A small job: CPU workers run it in seconds.
DEMO_FS = 1_000_000.0
DEMO_CHANNELS = 8


def _demo_groups():
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec
    return [DemodGroupSpec("FM", 200000, 2),
            DemodGroupSpec("BPSK", 20000, 1)]


def _demo_block(rng, block_len, fs):
    """A deterministic two-station capture; every process makes the SAME
    whole block from the shared seed, then keeps only its own span (as its
    local source would feed just that span)."""
    t = np.arange(block_len) / fs
    msg = np.sin(2 * np.pi * 1000.0 * t)
    return (0.7 * np.exp(1j * (2 * np.pi * 150e3 * t
                               + 2 * np.pi * 75e3 * np.cumsum(msg) / fs))
            + 0.5 * np.exp(2j * np.pi * -300e3 * t)
            + 0.05 * (rng.standard_normal(block_len)
                      + 1j * rng.standard_normal(block_len))
            ).astype(np.complex64)


def _demo_plan():
    """(sample rate, channels, groups, control frequencies, capture,
    block length or None for the receiver's default)."""
    return (DEMO_FS, DEMO_CHANNELS, _demo_groups(), (150e3, -300e3),
            lambda rng, n: _demo_block(rng, n, DEMO_FS), None)


def _scan58_plan():
    from cubicsdr_tpu_torch.utils.synth import scan58
    plan = scan58()

    def capture(rng, n):
        p = plan.capture(n, "cpu", seed=int(rng.integers(1 << 30))).numpy()
        return (p[0] + 1j * p[1]).astype(np.complex64)

    return (plan.fs, plan.num_channels, list(plan.specs),
            tuple(np.asarray(f, np.float32) for f in plan.freqs), capture,
            None)


PLANS = {"demo": _demo_plan, "scan58": _scan58_plan}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_local_ranks(n_local: int, device: str,
                      host_collectives: bool) -> None:
    """Refuse ``n_local`` ranks on this host's cards where they outnumber
    the cards and the caller did not ask for host collectives (NCCL takes
    one rank per GPU); refuse the card where the host has none."""
    if device != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("this job runs on the card and the host has no "
                           "CUDA device; pass device='cpu'")
    have = torch.cuda.device_count()
    if n_local > have and not host_collectives:
        raise ValueError(f"{n_local} ranks need {n_local} CUDA devices (one "
                         f"per rank under NCCL), have {have}; ask for host "
                         f"collectives to share the cards")


def init_rank(init_method: str, world: int, rank: int,
              device: str = "cuda", host_collectives: bool = False) -> None:
    """Join a job: the device for this rank and the process group. CPU
    ranks use gloo; CUDA ranks NCCL with one device each, or, with
    ``host_collectives``, gloo on host copies of the card's tensors."""
    if device == "cuda":
        check_local_ranks(1, device, host_collectives)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = "nccl" if device == "cuda" and not host_collectives else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def _rank_main(rank, fn, world, init_method, device, args,
               host_collectives=False):
    if device == "cpu":                 # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_rank(init_method, world, rank, device, host_collectives)
    in_group(fn, rank, *args)


def in_group(fn, *args):
    """``fn(*args)`` in the process group this rank has joined, then
    leave the group (``destroy_process_group``). NCCL waits, as it
    destroys a communicator, until every CUDA graph that captured its
    collectives (a compiled sharded step's) is gone. So ``fn``'s frames,
    whose locals hold such graphs, go first: on a return, and on a raise,
    whose traceback would keep them alive through the destruction (every
    rank would then hang at its end, or a failing rank never exit)."""
    try:
        return fn(*args)
    except BaseException as e:
        traceback.clear_frames(e.__traceback__)
        raise
    finally:
        gc.collect()                     # graphs held in reference cycles
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), device: str = "cuda",
                init_method: str | None = None,
                host_collectives: bool = False) -> None:
    """Run ``fn(rank, *args)`` on ``world`` local ranks, one process and
    one device each (``fn`` must be importable by name); a rank that
    fails fails the call. On the card, ranks that outnumber the cards
    are refused (NCCL takes one rank per GPU) unless the caller asks for
    ``host_collectives``: then they share the cards and their collectives
    run through gloo on host copies."""
    import torch.multiprocessing as mp
    check_local_ranks(world, device, host_collectives)
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_rank_main, args=(fn, world, init_method, device,
                                         args, host_collectives),
                       nprocs=world, join=True, start_method="spawn")


def spawn_collect(fn, world: int, args=(), device: str = "cuda",
                  host_collectives: bool = False) -> dict:
    """``spawn_ranks`` for a function that reports: ``fn(rank, *args,
    report_path)`` runs on every rank and rank 0 writes a JSON object to
    ``report_path`` (a temporary file), which this returns."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "report.json")
        spawn_ranks(fn, world, (*args, path), device,
                    host_collectives=host_collectives)
        with open(path) as f:
            return json.load(f)


def rank_device(device: str) -> torch.device:
    """This rank's device after ``init_rank``."""
    return (torch.device("cuda", torch.cuda.current_device())
            if device == "cuda" else torch.device("cpu"))


# The parts of a worker whose wall seconds its report holds (``seconds``):
# joining the process group, building the receiver, building the compiled
# step (warm-ups and captures), the capture's synthesis summed over blocks,
# verification (the unsharded pipeline and ``_verify_span``), the verified
# steps, the timed loop, and the whole worker from its call to its report.
WORKER_PARTS = ("init_group", "build_receiver", "build_step", "synthesis",
                "verify", "verified_steps", "timed_loop")


@contextlib.contextmanager
def _part(seconds: dict, name: str, dev: torch.device | None = None):
    """Add the wall seconds of the block to ``seconds[name]``; on the card
    the block's own device work is waited for at its end."""
    t0 = time.perf_counter()
    yield
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds[name] += time.perf_counter() - t0


def run_worker(coordinator: str, num_processes: int, process_id: int,
               steps: int = 2, verify: bool = True, timed_steps: int = 0,
               device: str = "cuda", plan: str = "demo",
               host_collectives: bool = False) -> dict:
    """One process of the distributed receive job. Joins the group at
    ``coordinator`` (host:port), builds the ('time', 'chan'=1) mesh over
    all ranks, feeds its local IQ span per block through
    ``shard_iq_local`` and (optionally) checks its own outputs against an
    unsharded ``ReceiverPipeline`` on the same device (``_verify_span``:
    mix and audio at the pipeline's audio gates, rms < 2e-3 and 99.5%
    quantile < 5e-3, levels at 0.05, symbols where the unsharded slicer's
    margin is at least 1e-5). ``timed_steps`` appends a steady-state
    timing phase. ``host_collectives`` runs the collectives through gloo
    on host copies (processes sharing a card). The sharded step is
    compiled (``ShardedReceiver.make_step``) but on host collectives,
    where it runs eagerly; the report's ``compiled`` says which. The
    report's ``seconds`` holds the wall seconds of each of
    ``WORKER_PARTS`` and of the whole worker (``worker``); a part on the
    card ends in a synchronisation, so a verified step holds its wait
    for the other ranks' collectives."""
    t_worker = time.perf_counter()
    seconds = dict.fromkeys(WORKER_PARTS, 0.0)
    host = host_collectives and device == "cuda"
    with _part(seconds, "init_group"):
        init_rank(f"tcp://{coordinator}", num_processes, process_id, device,
                  host)
    return in_group(_job, num_processes, process_id, steps, verify,
                    timed_steps, device, plan, host, seconds, t_worker)


def _job(num_processes, process_id, steps, verify, timed_steps, device,
         plan, host, seconds, t_worker) -> dict:
    """``run_worker``'s work once this rank has joined the group."""
    from cubicsdr_tpu_torch.ops.kernels.pfb import pfbch2_planar
    from cubicsdr_tpu_torch.ops.kernels.route import routed_shifted_resample
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.parallel.mesh import make_receiver_mesh
    from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver
    from cubicsdr_tpu_torch.receiver import ReceiverPipeline

    dev = rank_device(device)
    with _part(seconds, "build_receiver", dev):
        fs, M, groups, freqs, capture, block_len = PLANS[plan]()
        mesh = make_receiver_mesh(n_time=num_processes, n_chan=1,
                                  device_type=dev.type,
                                  host_collectives=host)
        rx = ShardedReceiver(fs, M, groups, mesh=mesh,
                             block_len=block_len, device=dev)
        controls = rx.control_template()
        for ctl, f in zip(controls, freqs):
            ctl["frequency"][:] = f
        placed = rx.place_controls(controls)
        compiled = not host          # no graph holds a gloo host copy
        step = rx.make_step(compiled=compiled)
        state = rx.init_state()
    if verify:
        with _part(seconds, "verify", dev):
            pipe = ReceiverPipeline(fs, groups, num_channels=M,
                                    block_len=rx.block_len, device=dev)
            ref_state = pipe.init_state()
    lo = process_id * rx.local_len
    hi = lo + rx.local_len
    rng = np.random.default_rng(0xD15C0)
    worst = {"audio_rms": 0.0, "audio_q995": 0.0, "level": 0.0,
             "symbols_checked": 0}
    kernels = (pfbch2_planar, routed_shifted_resample)
    launches = dict.fromkeys((k.__name__ for k in kernels), 0)
    for i in range(steps):
        with _part(seconds, "synthesis"):
            iq = capture(rng, rx.block_len)
            local = np.stack([iq.real[lo:hi], iq.imag[lo:hi]])
        before = [k.launches for k in kernels]
        with _part(seconds, "verified_steps", dev):
            inputs = (rx.shard_iq_local(local), placed)
        if i == 0 and compiled:      # the build's warm-ups count
            with _part(seconds, "build_step", dev):
                step.prepare(state, inputs)
                step.build()
        with _part(seconds, "verified_steps", dev):
            state, out = step(state, inputs)
        for k, b in zip(kernels, before):    # the sharded step's own
            launches[k.__name__] += k.launches - b
        if verify:
            with _part(seconds, "verify", dev):
                blk = PC(torch.from_numpy(iq.real.copy()).to(dev),
                         torch.from_numpy(iq.imag.copy()).to(dev))
                before = ref_state
                ref_state, ref = pipe.apply(ref_state, (blk, controls))
                _verify_span(rx, pipe, out, ref, before, controls, worst)
    rep = {"process_id": process_id,
           "process_count": dist.get_world_size(),
           "local_devices": 1, "global_devices": num_processes,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "backend": dist.get_backend(),
           "host_collectives": host, "compiled": compiled,
           "plan": plan,
           "block_len": rx.block_len, "steps": steps,
           "launches": launches, "verified": bool(verify),
           "worst": worst, "ok": True}
    if timed_steps:
        with _part(seconds, "synthesis"):
            spans = [np.stack([b.real[lo:hi], b.imag[lo:hi]])
                     for b in (capture(rng, rx.block_len)
                               for _ in range(4))]
        with _part(seconds, "timed_loop", dev):
            rep["timed"] = _timed_loop(rx, step, state, placed, spans,
                                       timed_steps, dev)
    rep["seconds"] = {**seconds,
                      "worker": time.perf_counter() - t_worker}
    return rep


def _timed_loop(rx, step, state, placed, spans, timed_steps: int,
                dev: torch.device) -> dict:
    """The steady-state phase: one step, a barrier, then the ingest
    scatter (host span -> this rank's device block) alone and the steps
    with it, each over ``timed_steps`` blocks cycling through ``spans``."""
    state, out = step(state, (rx.shard_iq_local(spans[0]), placed))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(timed_steps):
        rx.shard_iq_local(spans[i % len(spans)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_scatter = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(timed_steps):
        state, out = step(state, (rx.shard_iq_local(spans[i % len(spans)]),
                                  placed))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"steps": timed_steps, "wall_s": dt,
            "aggregate_msps": timed_steps * rx.block_len / dt / 1e6,
            "ingest_scatter_s": t_scatter,
            "ingest_scatter_share": t_scatter / dt}


# Modems whose audio follows the carrier's phase (the rest demodulate
# phase-invariantly: discriminator, envelope, carrier recovery).
PHASE_AUDIO = ("CW", "I/Q", "USB", "LSB")


def _want_mix(rx, out, ref, controls, span):
    """This span of the unsharded mix with the PHASE_AUDIO groups' rows
    (audio and peaks) taken from this rank's own outputs, which are held
    to their own check: the mixer (``receiver/mixer.py``) over the rows
    of every analog group (a time-only mesh holds them all)."""
    from cubicsdr_tpu_torch.receiver.mixer import mix_audio
    audio, gains, active, peaks = [], [], [], []
    for g, r, ctl, spec in zip(out["groups"], ref["groups"], controls,
                               rx.groups):
        if "audio" not in r:
            continue
        mine = spec.modem_name in PHASE_AUDIO
        a = g["audio"] if mine else r["audio"][..., span]
        audio.append(torch.cat([a, a], dim=-2) if a.shape[-2] == 1 else a)
        peaks.append((g if mine else r)["peak"])
        gains.append(torch.as_tensor(ctl["gain"]))
        active.append(torch.as_tensor(ctl["active"]))
    mix, _ = mix_audio(torch.cat(audio, dim=-3), torch.cat(gains),
                       torch.cat(active), torch.cat(peaks))
    return mix


def _spectrum_distance(got, want):
    """Per row: the distance between the Hann-windowed magnitude spectra
    of ``got`` and ``want`` [..., C, L] over the norm of ``want``'s. A
    constant carrier phase leaves a row's magnitude spectrum as it is;
    another pitch, frequency offset or waveform moves it."""
    w = np.hanning(want.shape[-1])
    G, W = (np.abs(np.fft.rfft(x * w, axis=-1)) for x in (got, want))
    return np.sqrt(((G - W) ** 2).sum(axis=(-2, -1))
                   / np.maximum((W * W).sum(axis=(-2, -1)), 1e-30))


def _verify_span(rx, pipe, out, ref, ref_state_before, controls,
                 worst) -> None:
    """This rank's outputs against its span of the unsharded step's. On
    time shard t > 0 the NCO starts at the closed-form phase base + omega
    * t * L, rounded to float32 as the JAX package rounds it: at omega *
    t * L of about 1e5 rad that is 1e-2 rad away from the phase the
    unsharded route kernel accumulates tile by tile, and the next block's
    shard 0 inherits it through its filters' history. With more than one
    time shard, outputs that follow the carrier's phase are held to that:
    the audio of PHASE_AUDIO modems by each row's rms (within 2%) and
    magnitude spectrum (within 2% of its norm), the mix with those rows
    taken from this rank (``_want_mix``) by the gates, symbols by
    agreement above 0.999 (the JAX package's multihost gate); on one
    shard, and for every phase-invariant output, the pipeline's gates
    hold."""
    t, La = rx.mesh.t, rx.local_audio_len
    phase_off = rx.nt > 1

    def audio_gate(name, got, want):
        d = np.abs(got - want)
        rms, q = float(np.sqrt(np.mean(d * d))), float(np.quantile(d, 0.995))
        worst["audio_rms"] = max(worst["audio_rms"], rms)
        worst["audio_q995"] = max(worst["audio_q995"], q)
        worst.setdefault("by_output", {})[name] = max(
            worst.get("by_output", {}).get(name, 0.0), rms)
        if not (rms < 2e-3 and q < 5e-3):
            raise AssertionError(f"{name}: rms {rms}, 99.5% {q}")

    span = slice(t * La, (t + 1) * La)
    want_mix = (_want_mix(rx, out, ref, controls, span) if phase_off
                else ref["mix"][:, span])
    audio_gate("mix", out["mix"].cpu().numpy(), want_mix.cpu().numpy())
    for gi, (g, r) in enumerate(zip(out["groups"], ref["groups"])):
        lvl = np.abs(g["level"].cpu().numpy() - r["level"].cpu().numpy())
        worst["level"] = max(worst["level"], float(lvl.max()))
        if lvl.max() > 0.05:
            raise AssertionError(f"group {gi} level off by {lvl.max()}")
        if "audio" in r:
            got = g["audio"].cpu().numpy().astype(np.float64)
            want = r["audio"][..., span].cpu().numpy().astype(np.float64)
            if not phase_off or rx.groups[gi].modem_name not in PHASE_AUDIO:
                audio_gate(f"group {gi} audio", got, want)
                continue
            p, q = (np.sqrt(np.mean(x * x, axis=(-2, -1))) for x in (got,
                                                                     want))
            e = float(np.max(np.abs(p - q) / np.maximum(q, 1e-9)))
            s = float(np.max(_spectrum_distance(got, want)))
            worst["phase_audio_rms_rel"] = max(
                worst.get("phase_audio_rms_rel", 0.0), e)
            worst["phase_audio_spectrum_rel"] = max(
                worst.get("phase_audio_spectrum_rel", 0.0), s)
            if e > 0.02 or s > 0.02:
                raise AssertionError(f"group {gi} audio rms off by {e}, "
                                     f"spectrum by {s}")
            continue
        n = g["symbols"].shape[-1]
        sl = slice(t * n, (t + 1) * n)
        got, want = g["symbols"].cpu().numpy(), r["symbols"].cpu().numpy()
        want = want[..., sl]
        if phase_off:
            agree = float(np.mean(got == want))
            worst["symbol_agreement"] = min(
                worst.get("symbol_agreement", 1.0), agree)
            if agree <= 0.999:
                raise AssertionError(f"group {gi}: symbols agree {agree}")
            continue
        # One shard: equal wherever the unsharded slicer's two best scores
        # are at least 1e-5 apart.
        margin = pipe.kits[gi].decision_margin(
            ref_state_before["groups"][gi][1], r["iq"]).cpu().numpy()
        firm = margin[..., sl] >= 1e-5
        if not np.array_equal(got[firm], want[firm]):
            raise AssertionError(f"group {gi}: symbols differ")
        worst["symbols_checked"] += int(firm.sum())


class JobFailed(RuntimeError):
    """A job of local processes that failed or ran out of time
    (``wait_workers``). ``rank`` is the first rank that exited non-zero
    (None on a timeout); ``outputs`` each rank's (stdout, stderr)."""

    def __init__(self, message: str, rank: int | None, outputs: list):
        super().__init__(message)
        self.rank = rank
        self.outputs = outputs


def _drain(pipe, chunks: list) -> None:
    """Read the bytes pipe ``pipe`` to its end into ``chunks`` as it is
    written."""
    for chunk in iter(lambda: pipe.read1(1 << 16), b""):
        chunks.append(chunk)
    pipe.close()


def _tail(text: str, n: int) -> str:
    return text if len(text) <= n else "..." + text[-n:]


def _rank_text(rank: int, state: str, out: str, err: str) -> str:
    return (f"--- rank {rank}: {state} ---\n"
            f"[stdout, tail]\n{_tail(out, 2000)}\n"
            f"[stderr, tail]\n{_tail(err, 8000)}")


# Seconds between asking a job's live workers for their stacks and the kill.
STACK_GRACE_S = 3.0


def wait_workers(procs: list,
                 timeout_s: float = 600.0) -> list[tuple[str, str]]:
    """Wait for a job's processes, all at once. ``procs[r]`` is rank r's
    ``subprocess.Popen``, started with stdout and stderr on bytes pipes; one
    thread per pipe drains it while the process writes, so no process
    blocks on a full pipe. Returns each rank's (stdout, stderr) once every
    rank has exited 0.

    The first rank to exit non-zero ends the job: the others are killed
    (a rank waiting on a collective would wait for ever) and ``JobFailed``
    names that rank, its exit code and its output's tail, with every
    other rank's tail below. At ``timeout_s`` every live rank is sent
    SIGUSR1, on which a worker dumps its threads' Python stacks to stderr
    (``faulthandler.register``, ``multihost --worker``); ``STACK_GRACE_S``
    later the job is killed and ``JobFailed`` holds, for each rank,
    whether it was live or had exited, and its tail with the stacks. No
    process of ``procs`` is left running when this returns or raises."""
    chunks = [([], []) for _ in procs]
    readers = [threading.Thread(target=_drain, args=(pipe, buf),
                                daemon=True)
               for p, (out, err) in zip(procs, chunks)
               for pipe, buf in ((p.stdout, out), (p.stderr, err))]
    for t in readers:
        t.start()

    def outputs():
        for t in readers:
            t.join(timeout=10.0)
        return [tuple(b"".join(c).decode(errors="replace") for c in pair)
                for pair in chunks]

    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or None not in codes:
                break
            if time.monotonic() >= deadline:
                live = [p for p in procs if p.poll() is None]
                for p in live:
                    p.send_signal(signal.SIGUSR1)
                time.sleep(STACK_GRACE_S)
                states = [f"exited with code {p.returncode}" if p not in live
                          else "live at the timeout, stacks asked for, "
                               "killed" for p in procs]
                for p in live:
                    p.kill()
                    p.wait()
                outs = outputs()
                raise JobFailed(
                    f"the job of {len(procs)} processes did not end within "
                    f"{timeout_s:g} s; {len(live)} were live\n"
                    + "\n".join(_rank_text(r, st, *o) for r, (st, o)
                                in enumerate(zip(states, outs))),
                    None, outs)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = outputs()
    if not failed:
        return outs
    first = failed[0]
    states = [f"exited with code {c}" if c is not None
              else "live, killed when the first rank failed"
              for c in codes]
    others = [_rank_text(r, states[r], *outs[r]) for r in range(len(procs))
              if r != first]
    raise JobFailed(
        f"rank {first} of {len(procs)} exited with code {codes[first]}; "
        f"the job was ended\n"
        + "\n".join([_rank_text(first, states[first], *outs[first]),
                     *others]), first, outs)


def launch_local(num_processes: int = 2, steps: int = 2, port: int = 0,
                 timeout_s: float = 600.0, timed_steps: int = 0,
                 device: str = "cuda", plan: str = "demo",
                 verify: bool = True,
                 host_collectives: bool = False) -> list[dict]:
    """Spawn ``num_processes`` worker processes on this host (loopback
    rendezvous) and collect their JSON reports (``wait_workers``: a
    failing worker ends the job with its output, ``JobFailed``; so does
    ``timeout_s``, with every live worker's stacks). On the card,
    processes that outnumber the cards are refused unless
    ``host_collectives``."""
    check_local_ranks(num_processes, device, host_collectives)
    port = port or free_port()
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "2")
    procs = []
    try:
        for pid in range(num_processes):
            cmd = [sys.executable, "-m", "cubicsdr_tpu_torch", "multihost",
                   "--worker", "--coordinator", f"127.0.0.1:{port}",
                   "--nprocs", str(num_processes), "--process-id", str(pid),
                   "--steps", str(steps), "--timed-steps", str(timed_steps),
                   "--devices", device, "--plan", plan]
            if not verify:
                cmd.append("--no-verify")
            if host_collectives:
                cmd.append("--host-collectives")
            procs.append(subprocess.Popen(cmd, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    outs = wait_workers(procs, timeout_s)
    reports = []
    for rank, (out, err) in enumerate(outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith('{"process_id"')]
        if not lines:
            raise JobFailed(f"rank {rank} exited 0 without a report\n"
                            + _rank_text(rank, "exited with code 0", out,
                                         err), rank, outs)
        reports.append(json.loads(lines[-1]))
    return reports
