"""The ``multihost`` launcher's wait (``parallel/multihost.py``
``wait_workers``, which ``launch_local`` calls) on plain ``python -c``
children standing in for a job's ranks: a rank that fails while another
waits (as on a collective) ends the job with the failing rank's output; a
rank that fills its stderr pipe does not deadlock the job; a job that
outlasts its timeout ends with every live rank's Python stacks. A rank
leaves its process group only once what its work held is gone (the CUDA
graphs that NCCL waits for), whether the work returned or raised."""

import subprocess
import sys
import time
import traceback
import weakref

import pytest

pytest.importorskip("torch")

from cubicsdr_tpu_torch.parallel import multihost  # noqa: E402
from cubicsdr_tpu_torch.parallel.multihost import (  # noqa: E402
    JobFailed, wait_workers)


def _start(*codes):
    return [subprocess.Popen([sys.executable, "-c", code],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for code in codes]


def _none_alive(procs):
    return all(p.poll() is not None for p in procs)


def test_a_failing_rank_ends_the_job_while_another_waits():
    """Rank 0 sleeps as a rank waiting on a collective would; rank 1
    fails at once. The wait ends within 10 s (its timeout is 60), names
    rank 1, its exit code and its output, and leaves no rank alive."""
    procs = _start(
        "import time; print('rank 0 waiting', flush=True); time.sleep(120)",
        "import sys; print('marker-7f3a on stdout', flush=True); "
        "sys.exit('marker-7f3a gate failed')")
    t0 = time.monotonic()
    with pytest.raises(JobFailed) as e:
        wait_workers(procs, timeout_s=60.0)
    assert time.monotonic() - t0 < 10.0
    assert _none_alive(procs)
    msg = str(e.value)
    assert e.value.rank == 1
    assert msg.startswith("rank 1 of 2 exited with code 1")
    assert "marker-7f3a on stdout" in msg and "marker-7f3a gate failed" in msg
    assert "rank 0: live, killed when the first rank failed" in msg
    assert "rank 0 waiting" in msg
    assert "marker-7f3a gate failed" in e.value.outputs[1][1]


def test_a_rank_that_fills_its_stderr_pipe_does_not_deadlock(tmp_path):
    """Rank 1 writes 256 KiB to stderr (four times a pipe's buffer) before
    it creates a file; rank 0 exits only once that file exists. Read one
    rank after the other, rank 1 would block on its write while the
    launcher waits on rank 0."""
    flag = tmp_path / "written"
    procs = _start(
        f"import os, time\nwhile not os.path.exists({str(flag)!r}): "
        f"time.sleep(0.01)\nprint('peer done')",
        f"import sys\nsys.stderr.write('e' * 262144)\nsys.stderr.flush()\n"
        f"open({str(flag)!r}, 'w').close()\nprint('writer done')")
    outs = wait_workers(procs, timeout_s=30.0)
    assert _none_alive(procs)
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == ("peer done\n", "")
    assert outs[1] == ("writer done\n", "e" * 262144)


def test_a_timeout_raises_with_every_live_rank_stack():
    """Rank 0 waits past the timeout inside a named function, with the
    stack dump on SIGUSR1 that ``multihost --worker`` registers; rank 1
    ends at once. The error is ``JobFailed``, never a bare
    ``TimeoutExpired``, and holds rank 0's stack and both ranks' states."""
    procs = _start(
        "import faulthandler, signal, time\n"
        "faulthandler.register(signal.SIGUSR1, all_threads=True)\n"
        "def waiting_on_a_collective():\n"
        "    time.sleep(120)\n"
        "print('rank 0 ready', flush=True)\n"
        "waiting_on_a_collective()",
        "print('rank 1 done')")
    t0 = time.monotonic()
    with pytest.raises(JobFailed) as e:
        wait_workers(procs, timeout_s=4.0)
    assert time.monotonic() - t0 < 4.0 + multihost.STACK_GRACE_S + 5.0
    assert not isinstance(e.value, subprocess.TimeoutExpired)
    assert _none_alive(procs)
    msg = str(e.value)
    assert e.value.rank is None
    assert "did not end within 4 s; 1 were live" in msg
    assert "rank 0: live at the timeout, stacks asked for, killed" in msg
    assert "rank 1: exited with code 0" in msg and "rank 1 done" in msg
    assert "in waiting_on_a_collective" in msg
    assert "in waiting_on_a_collective" in e.value.outputs[0][1]


def test_launch_local_reports_a_failing_worker():
    """``launch_local`` through ``wait_workers`` on real workers: a plan
    the CLI does not know fails every worker at its argument parser, and
    the error holds the parser's message instead of a hang or a bare
    return code."""
    t0 = time.monotonic()
    with pytest.raises(JobFailed) as e:
        multihost.launch_local(2, device="cpu", plan="no-such-plan",
                               timeout_s=120.0)
    assert time.monotonic() - t0 < 60.0
    assert e.value.rank in (0, 1)
    assert "invalid choice: 'no-such-plan'" in str(e.value)


def test_worker_mode_registers_the_stack_dump(monkeypatch, capsys):
    """``multihost --worker`` registers the SIGUSR1 stack dump that the
    launcher's timeout relies on, before it joins the job."""
    import faulthandler
    import signal

    from cubicsdr_tpu_torch.app.cli import main
    calls = []
    monkeypatch.setattr(faulthandler, "register",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(multihost, "run_worker",
                        lambda *a, **k: calls.append("run") or {"ok": True})
    assert main(["multihost", "--worker", "--devices", "cpu"]) == 0
    assert calls == [((signal.SIGUSR1,), {"all_threads": True}), "run"]
    assert capsys.readouterr().out.strip() == '{"ok": true}'


def test_a_rank_leaves_its_group_after_its_work_is_gone(monkeypatch):
    """``in_group`` (``run_worker`` and the spawned ranks): when the group
    is destroyed, nothing the rank's function held is alive any more, on
    a return and on a raise, whose traceback keeps the function's frame
    (NCCL waits at the destruction for every graph that captured its
    collectives: the four-card job's ranks hung there at their end)."""
    class Graph:                     # stands in for a captured CUDA graph
        pass

    held, alive_at_destroy = [], []

    def work(fail):
        graph = Graph()
        held.append(weakref.ref(graph))
        if fail:
            raise ValueError("a gate failed")
        return {"ok": True}

    monkeypatch.setattr(multihost.dist, "destroy_process_group",
                        lambda: alive_at_destroy.append(
                            held[-1]() is not None))
    assert multihost.in_group(work, False) == {"ok": True}
    with pytest.raises(ValueError, match="a gate failed") as e:
        multihost.in_group(work, True)
    assert alive_at_destroy == [False, False]
    assert "in work" in "".join(traceback.format_tb(e.value.__traceback__))
