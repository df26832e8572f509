"""Boundaries of the port: it imports neither JAX nor the JAX package,
and its entry points run on CUDA unless asked for the CPU — without CUDA
they raise instead of carrying on quietly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "kernel_times.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving, repro_torch.kernels, "
            "repro_torch.bridge, repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.optim, repro_torch.launch.train, repro_torch.ep, "
            "repro_torch.launch.serve, repro_torch.launch.inputs, "
            "repro_torch.launch.roofline, repro_torch.configs.shapes; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving import Engine, Scheduler
    cfg = ARCHS["granite-moe-1b-a400m"].reduced(num_layers=1,
                                                max_d_model=64,
                                                max_vocab=256)
    params = init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(cfg, params, num_slots=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    Engine(cfg, params, device="cpu")          # asking for the CPU works


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result; a
    lone copy of it (no repository around it) fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
