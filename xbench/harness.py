"""One run of one cell: resolve the cell's files by name, draw its
inputs from the seed, serve the window, read the metrics, free the
program, check the served tokens against the reference, and assemble
the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, found at the entry's ``file``, and a traffic mix, found
at ``xbench/traffic/<traffic>.json``; its limits are at
``xbench/cells/<cell>.json``. Each metric is a reader at
``xbench/metrics/<metric>.py``, or for a metric named ``<base>.<part>``
(one quantity held to its own bound in some cells) at
``xbench/metrics/<base>.py``: ``read(run)`` returns a number or None
(nothing to read, and the metric is left out of the line).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional


HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Bench:
    """BENCHMARK.json and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        entry = next(c for c in self.spec["configs"]
                     if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, cell: Dict) -> Dict:
        return json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                          .read_text())

    def limits(self, cell: Dict) -> Dict:
        return json.loads((HERE / "cells" / f"{cell['name']}.json")
                          .read_text())

    def metrics(self, cell: Dict, trace: bool) -> List[Dict]:
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"xbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def serve(cfg: Dict, mix: Dict, seed: int, seconds: float, *, device,
          trace: bool = False, t_start: Optional[float] = None):
    """Draw the inputs, build the engine and serve the closed loop.
    Returns (run, weights); the engine is gone when this returns."""
    import torch
    from repro_torch.serving import Engine
    from xbench import program, traffic, weights as W
    from xbench.loop import ClosedLoop
    from xbench.trace import Tracer

    t = [time.perf_counter()]
    traffic.check_mix(mix, int(mix["cache_len"]))
    table = traffic.make_table(mix, int(cfg["vocab_size"]), seed)
    t.append(time.perf_counter())
    tree = W.draw(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t.append(time.perf_counter())
    engine = Engine(program.arch_config(cfg), tree,
                    policy=program.policy(mix["policy"], cfg),
                    cache_len=int(mix["cache_len"]), seed=0, device=device)
    t.append(time.perf_counter())
    tracer = Tracer() if trace else None
    opened = {}

    def on_open():
        opened["t"] = time.perf_counter()

    loop = ClosedLoop(engine, table, mix, seconds,
                      trace_seconds=float(mix["trace_s"]) if trace else 0.0,
                      on_open=on_open,
                      on_trace=tracer.start if tracer is not None else None,
                      mark=tracer.mark if tracer is not None else None)
    if tracer is not None:
        tracer.clock = loop.clock
    run = loop.run()
    if tracer is not None:
        run.trace = tracer.stop()
    run.cfg = cfg
    pol = dict(mix["policy"])
    if pol["mode"] == "batch":
        pol["m_l"] = program.batch_budget(pol, cfg)
    run.policy = pol
    if t_start is not None and "t" in opened:
        run.setup_s = opened["t"] - t_start
        # set-up, part by part: imports and the card's context, the
        # traffic, the weights, the engine, the scheduler (its decode
        # graphs), serving up to the first pump, then the warm serving
        cuts = [t_start] + t + [loop.t_scheduler, loop.t_first_pump,
                                opened["t"]]
        run.setup_parts = {
            name: b - a for name, a, b in zip(
                ("start", "traffic", "weights", "engine", "scheduler",
                 "first_round", "warm"), cuts, cuts[1:])}
    return run, tree


def attempted_failed(run):
    sent = [s for s in run.requests.values()
            if run.t_open <= s.arrival <= run.t_close]
    failed = [s for s in run.requests.values()
              if s.state.finish_reason not in (None, "completed",
                                               "cancelled")]
    return len(sent), len(failed)


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, *, device, t_start: float,
             cfg: Optional[Dict] = None, mix: Optional[Dict] = None,
             limits: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's dict. ``cfg``, ``mix`` and
    ``limits`` replace the cell's own files (the CPU tests' small
    sizes)."""
    import torch
    from xbench import check
    cell = bench.cell(name)
    cfg = cfg or bench.config(cell)
    mix = mix or bench.mix(cell)
    limits = limits or bench.limits(cell)
    run, tree = serve(cfg, mix, seed, seconds, device=device, trace=trace,
                      t_start=t_start)
    metrics = {}
    for m in bench.metrics(cell, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if device.type == "cuda" else 0}
    out: Dict = {}
    if trace and run.trace is not None:
        from xbench.trace import breakdown, union_s
        spans = [(s, e) for _, s, e, _ in run.trace["device"]]
        dev["busy_s"] = union_s(spans, run.trace_open, run.trace_close)
        dev["window_s"] = run.trace_close - run.trace_open
        out["breakdown"] = breakdown(run.trace, run.trace_open,
                                     run.trace_close)
    gc.collect()                  # the engine, its caches and graphs
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    cmp = check.compare(run, tree, cfg, seed, int(limits["sample_requests"]))
    read = cmp["program"]
    ok = check.verdict(read, limits["limits"])
    attempted, failed = attempted_failed(run)
    checks = {k: {"value": read[k], "limit": lim}
              for k, lim in limits["limits"].items()}
    result = {"correct": bool(ok) and failed == 0 and attempted > 0,
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    result.update(out)
    if run.setup_parts:
        result["setup_parts"] = run.setup_parts
        print("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                                  run.setup_parts.items()), file=sys.stderr)
    result["sample"] = dict(cmp["sample"],
                            reference_s=time.perf_counter() - t_ref,
                            readings={k: v for k, v in read.items()})
    result["checks"] = checks
    return result
