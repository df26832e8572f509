"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``repro_torch`` is not ``repro``), and the
reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from xbench_tiny import ROOT

XBENCH = ROOT / "xbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in XBENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not {m.split(".")[0] for m in imported(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((XBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert tops <= {"__future__", "math", "dataclasses", "typing", "torch"}


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import xbench_tiny as t; "
            "r = t.tiny_run(t.CELLS[0], seconds=0.5); "
            "from xbench.harness import forbidden_modules; "
            "print(forbidden_modules())" % str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole():
    from xbench import harness
    sys.modules.setdefault("repro_torch_like", sys)
    assert "repro_torch" not in harness.forbidden_modules()
