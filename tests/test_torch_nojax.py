"""Importing the port never imports jax: it runs where jax is absent."""

import subprocess
import sys

import pytest

pytest.importorskip("torch")


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import cubicsdr_tpu_torch\n"
            "import cubicsdr_tpu_torch.receiver.pipeline\n"
            "import cubicsdr_tpu_torch.utils.interop\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m.startswith('cubicsdr_tpu.') or "
            "m == 'cubicsdr_tpu' for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
