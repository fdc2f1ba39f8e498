"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole (the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "cubicsdr_tpu"}


def imported_tops(path: Path) -> set:
    """Top-level names of every module ``path`` imports, lazily or not."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            tops.add(node.args[0].value.split(".", 1)[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 40
    for f in files:
        bad = imported_tops(f) & JAX_NAMES
        assert not bad, f"{f.relative_to(BENCH)} imports {sorted(bad)}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert "cubicsdr_tpu_torch" not in tops, f.relative_to(BENCH)
        assert not tops & JAX_NAMES, f.relative_to(BENCH)


def test_the_whole_name_is_compared():
    # The program's name begins with the JAX package's: a prefix test
    # would flag it, a whole-name test must not.
    src = "import cubicsdr_tpu_torch.app\nfrom cubicsdr_tpu_torch import ops\n"
    p = Path(__file__).with_name("_probe_imports.txt")
    try:
        p.write_text(src)
        assert imported_tops(p) == {"cubicsdr_tpu_torch"}
        assert not imported_tops(p) & JAX_NAMES
        p.write_text("import cubicsdr_tpu.ops\n")
        assert imported_tops(p) & JAX_NAMES == {"cubicsdr_tpu"}
    finally:
        p.unlink()


def test_loading_the_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.step\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cubicsdr_tpu_torch', 'cubicsdr_tpu', 'jax', 'jaxlib'))\n"
            "print(bad)\n") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
