"""Every cell, mix, limit and metric of BENCHMARK.json resolves by
name, and the file keeps the benchmark's contract."""
import json
import re

import pytest

from xbench_tiny import BENCH, CELLS, ROOT, load_json

from xbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden_size|intermediate_size|head_dim|"
                   r"num_experts_per_tok|latent|expansion|state_size")


def test_top_level_keys():
    assert set(BENCH.spec) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert BENCH.spec["paths"] == ["xbench"]
    assert 1 <= BENCH.spec["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = BENCH.cell(cell)
    assert w["chips"] == 1 and NAME.match(w["name"])
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    cfg = BENCH.config(w)
    mix = BENCH.mix(w)
    lim = BENCH.limits(w)
    assert cfg["name"] == w["config"]
    assert mix["policy"]["mode"] in ("off", "batch")
    assert lim["limits"] and lim["sample_requests"] >= 2
    names = [m["name"] for m in BENCH.metrics(w, False)]
    assert "setup_s" in names and len(names) >= 2
    assert BENCH.metrics(w, True)


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH.spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH.spec[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("m", BENCH.spec["end_to_end"] + BENCH.spec["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert callable(harness.reader(m["name"]))
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in [e["name"] for e in BENCH.spec["end_to_end"]]
        assert m["layer"] and "\n" not in m["layer"]
    for w in m.get("workloads", []):
        BENCH.cell(w)


@pytest.mark.parametrize("c", BENCH.spec["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("xbench/")
    assert len(c["reduced"]) <= 16
    for key in c["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        assert key in cfg and key in cfg["source_values"], key
        assert cfg[key] != cfg["source_values"][key], key
    assert set(cfg["source_values"]) <= set(c["reduced"])
    for key in ("assumed", "departures", "deployment"):
        assert cfg[key]


def test_command_names_only_paths():
    cmd = BENCH.spec["command"]
    assert cmd[0] == "python3" and cmd[1].startswith("xbench/")
    assert (ROOT / cmd[1]).is_file()


def test_kernel_names_file():
    names = load_json("xbench/metrics/expert_ffn_roofline.kernels.json")
    assert names["kernels"]
