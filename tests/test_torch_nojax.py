"""Importing the port never imports jax: it runs where jax is absent."""

import subprocess
import sys

import pytest

pytest.importorskip("torch")


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_imports_without_jax():
    _run("import sys\n"
         "import cubicsdr_tpu_torch\n"
         "import cubicsdr_tpu_torch.receiver.pipeline\n"
         "import cubicsdr_tpu_torch.utils.interop\n"
         "assert 'jax' not in sys.modules, 'jax was imported'\n"
         "assert not any(m.startswith('cubicsdr_tpu.') or "
         "m == 'cubicsdr_tpu' for m in sys.modules)\n")


@pytest.mark.parametrize("module", [
    "cubicsdr_tpu_torch.app.runner", "cubicsdr_tpu_torch.app.checkpoint",
    "cubicsdr_tpu_torch.visual", "cubicsdr_tpu_torch.receiver.manager",
    "cubicsdr_tpu_torch.utils.metrics"])
def test_live_loop_modules_import_without_jax(module):
    """The live loop reuses the JAX package's numpy-only ring, recorder and
    audio modules by import, never its jax modules."""
    _run(f"import sys\nimport {module}\n"
         "assert 'jax' not in sys.modules, 'jax was imported'\n")
