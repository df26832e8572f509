"""On the card: one short run of each cell through the benchmark's
command, its result line in the contract's shape and correct. Skips
without a CUDA device (decided in the fixture)."""
import json
import subprocess
import sys

import pytest

from xbench_tiny import BENCH, CELLS, ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "xbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["device"]["platform"] == "gpu"
    want = {m["name"] for m in BENCH.metrics(BENCH.cell(cell), False)}
    assert set(line["metrics"]) == want and "setup_s" in want


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("cell", [CELLS[0], "no-such-cell"])
def test_refuses_without_a_card_or_a_cell(no_card, cell):
    out = subprocess.run(
        [sys.executable, "xbench/run.py", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
