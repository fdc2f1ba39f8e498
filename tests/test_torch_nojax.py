"""The port stands alone: importing any of its modules loads neither jax
nor anything of the JAX package, no source of the port (nor chip_smoke.py)
imports them, and the host modules the port keeps its own copy of (the
native ring, the WAV writer, the recorder) behave byte for byte as the
JAX package's."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import cubicsdr_tpu_torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cubicsdr_tpu_torch"

_CHECK = ("bad = sorted(m for m in sys.modules if m == 'jax' or "
          "m.startswith('jax.') or m == 'cubicsdr_tpu' or "
          "m.startswith('cubicsdr_tpu.'))\n"
          "assert not bad, bad\n")


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        cubicsdr_tpu_torch.__path__, "cubicsdr_tpu_torch."))


def test_port_imports_without_jax():
    _run("import sys\n"
         "import cubicsdr_tpu_torch\n"
         "import cubicsdr_tpu_torch.receiver.pipeline\n"
         "import cubicsdr_tpu_torch.utils.interop\n" + _CHECK)


# The app shell's modules: the port keeps its own copies of the JAX
# package's host-only ones.
_APP_SHELL = (
    "cubicsdr_tpu_torch.io.sources", "cubicsdr_tpu_torch.io.devices",
    "cubicsdr_tpu_torch.io.net", "cubicsdr_tpu_torch.app.cli",
    "cubicsdr_tpu_torch.app.webview", "cubicsdr_tpu_torch.app.config",
    "cubicsdr_tpu_torch.app.session", "cubicsdr_tpu_torch.app.bookmarks",
    "cubicsdr_tpu_torch.app.rig", "cubicsdr_tpu_torch.app.digital_console",
    "cubicsdr_tpu_torch.__main__")


# The sharded receiver's modules (torch.distributed, one rank per process).
_SHARDED = (
    "cubicsdr_tpu_torch.parallel", "cubicsdr_tpu_torch.parallel.mesh",
    "cubicsdr_tpu_torch.parallel.halo",
    "cubicsdr_tpu_torch.parallel.shardable",
    "cubicsdr_tpu_torch.parallel.sharded",
    "cubicsdr_tpu_torch.parallel.multihost")


def test_sharded_modules_import_without_jax():
    """The sharded receiver, its mesh, halo and shard drivers and the
    multi-process job, imported in one fresh interpreter, load neither
    jax nor any module of the JAX package."""
    _run("import sys\n" + "".join(f"import {m}\n" for m in _SHARDED)
         + _CHECK)


# The analytic filter, the weak-scaling harness and the multi-rank dry
# run.
_HILBERT_SCALING_DRYRUN = (
    "cubicsdr_tpu_torch.ops.hilbert", "cubicsdr_tpu_torch.parallel.scaling",
    "cubicsdr_tpu_torch.parallel.dryrun")


def test_hilbert_scaling_and_dryrun_import_without_jax():
    """The analytic filter, the scaling harness and the dry run (whose
    rank functions import the sharded receiver when they run) load
    neither jax nor any module of the JAX package, and the package walk
    finds them."""
    assert set(_HILBERT_SCALING_DRYRUN) <= set(_port_modules())
    _run("import sys\n"
         + "".join(f"import {m}\n" for m in _HILBERT_SCALING_DRYRUN)
         + "from cubicsdr_tpu_torch.parallel import dryrun, scaling\n"
         "import cubicsdr_tpu_torch.parallel.sharded\n" + _CHECK)


@pytest.mark.parametrize("module", [
    "cubicsdr_tpu_torch.app.runner", "cubicsdr_tpu_torch.app.checkpoint",
    "cubicsdr_tpu_torch.visual", "cubicsdr_tpu_torch.receiver.manager",
    "cubicsdr_tpu_torch.utils.metrics", *_APP_SHELL])
def test_live_loop_modules_import_without_jax(module):
    """The live loop and the app shell run on the port's own ring,
    recorder, audio, IQ source, config, session, bookmark, rig and console
    modules: neither jax nor any module of the JAX package is loaded."""
    _run(f"import sys\nimport {module}\n" + _CHECK)


def test_every_port_module_imports_alone():
    """Every module of the port, found by walking the package, imported in
    one fresh interpreter: no jax, no cubicsdr_tpu module loaded."""
    mods = _port_modules()
    assert "cubicsdr_tpu_torch.native" in mods
    assert "cubicsdr_tpu_torch.io.soapy" in mods
    assert set(_APP_SHELL) <= set(mods), set(_APP_SHELL) - set(mods)
    assert set(_SHARDED) <= set(mods), set(_SHARDED) - set(mods)
    _run("import sys, importlib\n"
         f"for m in {mods!r}:\n"
         "    importlib.import_module(m)\n" + _CHECK)


def _foreign_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "cubicsdr_tpu"):
                yield f"{path.relative_to(ROOT)}:{node.lineno}: {n}"


def test_no_source_imports_jax_or_the_jax_package():
    """No import statement, at module level or inside a function, of jax or
    cubicsdr_tpu in the port's sources or in chip_smoke.py."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    scanned = {str(f.relative_to(ROOT).with_suffix("")).replace("/", ".")
               for f in files}
    assert set(_APP_SHELL) <= scanned, set(_APP_SHELL) - scanned
    bad = [hit for f in files for hit in _foreign_imports(f)]
    assert not bad, bad


def test_sample_ring_matches_jax_package():
    """The same writes and reads through the port's SampleRing and the JAX
    package's: equal reads, fill and shed counts (float32 and int16)."""
    from cubicsdr_tpu.native import SampleRing as JRing
    from cubicsdr_tpu_torch.native import SampleRing
    rng = np.random.default_rng(5)
    for dt in (np.float32, np.int16):
        a, b = SampleRing(1000, dt), JRing(1000, dt)
        for n in (300, 500, 400, 250, 600):
            blk = (rng.standard_normal((2, n)) * 1000).astype(dt)
            assert a.write(blk[0], blk[1]) == b.write(blk[0], blk[1])
            got, exp = a.read(350), b.read(350)
            assert (got is None) == (exp is None)
            if got is not None:
                for g, e in zip(got, exp):
                    np.testing.assert_array_equal(g, e)
            assert a.fill == b.fill
            assert a.dropped_samples == b.dropped_samples


def test_wav_writer_matches_jax_package(tmp_path):
    """Mono and stereo float blocks give byte-identical WAV files."""
    from cubicsdr_tpu.io.wav import WavWriter as JWav
    from cubicsdr_tpu_torch.io.wav import WavWriter
    rng = np.random.default_rng(6)
    for ch in (1, 2):
        blocks = [rng.uniform(-1.2, 1.2, (ch, n)).astype(np.float32)
                  for n in (480, 1000, 7)]
        for cls, name in ((WavWriter, "port"), (JWav, "jax")):
            w = cls(str(tmp_path / f"{name}{ch}"), 48000, ch)
            for blk in blocks:
                w.write(blk)
            w.close()
        assert ((tmp_path / f"port{ch}.wav").read_bytes()
                == (tmp_path / f"jax{ch}.wav").read_bytes())


@pytest.mark.parametrize("option", [0, 1, 2])
def test_recording_sink_matches_jax_package(tmp_path, option):
    """Squelched and open blocks under each squelch option give
    byte-identical recordings."""
    from cubicsdr_tpu.io.recorder import RecordingSink as JSink
    from cubicsdr_tpu_torch.io.recorder import RecordingSink, SquelchOption
    rng = np.random.default_rng(7)
    blocks = [(rng.uniform(-1, 1, 640).astype(np.float32), sq)
              for sq in (False, True, False, True)]
    for cls, name in ((RecordingSink, "port"), (JSink, "jax")):
        s = cls(str(tmp_path / name), 48000,
                squelch_option=SquelchOption(option))
        for blk, sq in blocks:
            s.write(blk, squelched=sq)
        s.close()
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())
