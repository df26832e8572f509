"""Markdown tables of the planning records of ``launch/dryrun.py`` (the
JAX package's ``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json

The columns follow the port's records: each card's analytic state (the
reference's "peak GB (xla-cpu)" came from XLA's memory analysis, which
the port has none of), the analytic FLOPs and bytes per card, "n/a" for
the collective figures, and the trace time in place of the compile time.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

SINGLE_POD = "32x8"   # launch/mesh.make_production_mesh()


def fmt_e(x: Optional[float]) -> str:
    return "n/a" if x is None else f"{x:.2e}"


def state_gb(r: Dict) -> float:
    return sum(r.get("analytic", {}).values())


def dryrun_table(records: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | policy | state GB/card | analytic "
        "state GB | FLOPs/card | bytes/card | coll bytes/card | trace s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"],
                                            r["mesh"])):
        an = r.get("analytic", {})
        an_s = " + ".join(f"{k[:-3]}={v}" for k, v in an.items())
        n = r["devices"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['policy']} "
            f"| {state_gb(r):.3f} | {an_s} "
            f"| {fmt_e(r['analytic_flops_global'] / n)} "
            f"| {fmt_e(r['analytic_bytes_global'] / n)} "
            f"| n/a | {r['trace_s']} |")
    return "\n".join(lines)


def roofline_table(records: List[Dict], mesh: str = SINGLE_POD) -> str:
    """Single-pod roofline: 3 terms, dominant, MODEL_FLOPS ratio."""
    lines = [
        "| arch | shape | compute s | memory s | collective s | "
        "dominant | MODEL_FLOPS | analytic FLOPs (global) | useful ratio |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_e(r['compute_s'])} | {fmt_e(r['memory_s'])} "
            f"| {fmt_e(r['collective_s'])} | **{r['dominant']}** "
            f"| {fmt_e(r.get('model_flops', 0))} "
            f"| {fmt_e(r.get('analytic_flops_global', 0))} "
            f"| {r.get('useful_ratio', 0):.3f} |")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="Print the dry run's tables.")
    ap.add_argument("path", nargs="?", default="dryrun_results.json")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        records = json.load(f)
    print("## Dry-run records\n")
    print(dryrun_table(records))
    print(f"\n## Roofline (single-pod {SINGLE_POD})\n")
    print(roofline_table(records))


if __name__ == "__main__":
    main()
