"""The check comes out false when the timed path is broken underneath
(the harness's look for a card skipped, a small size on the CPU), once
for each fault of ``xbench/faults.py``: a step whose state is left
unchanged, half of the batch left out, a token altered where it is
produced, one slot's experts lost. And the control, the reference in
float8, reads well above the program."""
import pytest
import torch

from xbench_tiny import CELLS, tiny_config, tiny_mix, tiny_run

from xbench import check, harness
from xbench.faults import FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(fault, cell, monkeypatch):
    FAULTS[fault](monkeypatch.setattr, int(tiny_mix(cell)["clients"]))
    r = tiny_run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    cfg, mix = tiny_config(cell), tiny_mix(cell)
    run, tree = harness.serve(cfg, mix, 4, 1.0, device=torch.device("cpu"))
    got = check.compare(run, tree, cfg, 4, 4, control=True)
    assert got["control"]["mean_gap"] > 3 * got["program"]["mean_gap"]
    assert got["control"]["agree_share"] < got["program"]["agree_share"]
