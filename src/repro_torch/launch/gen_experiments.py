"""Assemble an EXPERIMENTS document from the planning records: the dry
run's (``launch/dryrun.py``) and the hillclimb's
(``launch/hillclimb.py``), the JAX package's
``repro.launch.gen_experiments`` rewritten for the H100.

    PYTHONPATH=src python -m repro_torch.launch.gen_experiments \\
        --dryrun dryrun_results.json [--hillclimb hillclimb_results.json] \\
        --out EXPERIMENTS.md

Left out: ``bench_section``, which renders ``benchmarks/results.json``,
the JAX package's own CPU benchmark numbers (the port has no benchmark
of its own yet), and the reference's optional
``dryrun_paper_models.json`` rows, which no script of either package
writes.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.launch.report import SINGLE_POD, state_gb

HEADER = """# EXPERIMENTS — XShare planning records for NVIDIA H100 meshes

All artifacts regenerate with:

```bash
PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.json
PYTHONPATH=src python -m repro_torch.launch.hillclimb --out hillclimb_results.json
PYTHONPATH=src python -m repro_torch.launch.gen_experiments \\
    --dryrun dryrun_results.json --hillclimb hillclimb_results.json \\
    --out EXPERIMENTS.md
```

Hardware model: NVIDIA H100 SXM5 80GB HBM3 at 700 W — 989e12 FLOP/s
bf16 (tensor cores, dense), 3.35e12 B/s HBM3, 450e9 B/s per direction
over NVLink 4. Meshes: single-pod 32x8 ("data","model") = 256 cards,
multi-pod 2x32x8 ("pod","data","model") = 512 cards; "model" is one
HGX node's 8 cards. Params and caches bf16 (or e4m3 where a record
says so), optimizer f32.

### Methodology notes (read first)

* **Trace on meta**: every (architecture x shape x mesh) combination runs
  its step once on PyTorch's meta device, which allocates and computes
  nothing: the train step (forward, backward, AdamW), the prefill, or
  one decode step. A trace shows that the step composes at full size
  and gives its outputs' shapes; it is not a compiled program.
* **Per-card state** is exact from the partition rules
  (`launch/partition.py`): params, optimizer and cache bytes divided by
  each tensor's shard count.
* **Roofline terms are analytic** closed forms over the model's
  structure (`launch/roofline.py`): compute = FLOPs / 989e12, memory =
  bytes / 3.35e12, decode with bottleneck-shard expert accounting over
  the mesh's "model" extent. There is **no collective term**: the
  port has no partitioner to say which collectives a layout needs, so
  `dominant` is taken over compute and memory.
* Decode shapes trace `serve_step` (ONE token against the cache);
  long_500k runs natively on SSM/hybrid, with native SWA on h2o-danube,
  and as the sliding-window variant (window 4096) on the
  full-attention archs — no architecture skips any shape.
* MoE decode shapes trace with the PAPER-FAITHFUL XShare policy
  (Alg 2, k0=1, m_l=16).
"""


def fmt(x: Optional[float], p: int = 3) -> str:
    return "n/a" if x is None else f"{x:.{p}f}"


def ms(x: Optional[float]) -> str:
    return "n/a" if x is None else fmt(x * 1e3)


def dryrun_section(records: List[Dict]) -> str:
    meshes = sorted({r["mesh"] for r in records})
    archs = sorted({r["arch"] for r in records})
    shapes = sorted({r["shape"] for r in records})
    out = [f"## §Dry-run — {len(archs)} architectures x {len(shapes)} "
           f"shapes x {len(meshes)} meshes\n",
           f"{len(records)} combinations trace on meta. Per-card state is "
           f"exact from the specs.\n"]
    out.append("| arch | shape | mesh | policy | state GB/card | analytic "
               "state GB | trace s |")
    out.append("|---|---|---|---|---|---|---|")
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"],
                                            r["mesh"])):
        an = r.get("analytic", {})
        an_s = " + ".join(f"{k[:-3]} {v}" for k, v in an.items()) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['policy']} "
            f"| {state_gb(r):.3f} | {an_s} | {r['trace_s']} |")
    return "\n".join(out)


FIXES = {
    "memory": "shrink the resident stream: fewer activated experts "
              "(XShare), e4m3 cache, window",
    "compute": "raise MFU: larger per-card batch, fused kernels, "
               "less remat",
}


def roofline_section(records: List[Dict]) -> str:
    out = [f"\n## §Roofline — single-pod ({SINGLE_POD}), per-card step "
           f"terms\n",
           "compute = analytic FLOPs/card / 989e12; memory = analytic "
           "bytes/card / 3.35e12 (decode uses bottleneck-shard expert "
           "accounting over the 8-card model axis); collective: n/a. "
           "useful = MODEL_FLOPS (6ND convention) / analytic FLOPs.\n"]
    out.append("| arch | shape | compute ms | memory ms | collective ms "
               "| dominant | MODEL_FLOPS | useful | one-line fix |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    for r in sorted(records, key=lambda r: (r["shape"], r["arch"])):
        if r["mesh"] != SINGLE_POD:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {ms(r['compute_s'])} | {ms(r['memory_s'])} "
            f"| {ms(r['collective_s'])} | **{r['dominant']}** "
            f"| {r.get('model_flops', 0):.2e} "
            f"| {fmt(r.get('useful_ratio', 0))} "
            f"| {FIXES[r['dominant']]} |")
    return "\n".join(out)


def perf_section(recs: List[Dict]) -> str:
    out = ["\n## §Perf — hillclimb on the three selected pairs\n",
           "Pairs: qwen3-moe x decode_32k (paper-representative), "
           "musicgen x decode_32k (its MHA cache dominates), zamba2 x "
           "train_4k (a small model under FSDP). Each row is one "
           "hypothesis -> change -> re-trace -> compare cycle.\n"]
    out.append("| experiment | hypothesis | compute ms | memory ms | "
               "collective ms | dominant | state GB/card |")
    out.append("|---|---|---|---|---|---|---|")
    for r in recs:
        out.append(
            f"| {r['experiment']} | {r['hypothesis']} "
            f"| {ms(r['compute_s'])} | {ms(r['memory_s'])} "
            f"| {ms(r['collective_s'])} | {r['dominant']} "
            f"| {state_gb(r):.3f} |")
    return "\n".join(out)


def perf_narrative(recs: List[Dict]) -> str:
    """The hillclimb read pair by pair, every figure from the records."""
    by = {r["experiment"]: r for r in recs}

    def step(a: str, b: str, key: str = "memory_s") -> str:
        x, y = by[a][key] * 1e3, by[b][key] * 1e3
        return f"{x:.3f} -> {y:.3f} ms ({(y - x) / x:+.0%})"

    out = ["\n### §Perf narrative (from the records above)\n"]
    q = [f"qwen3/{n}" for n in ("0-vanilla-topk", "1-paper-xshare-batch",
                                "2-beyond-ep-aware",
                                "3-beyond-ep+f8cache")]
    if all(k in by for k in q):
        out.append(
            "**1. qwen3-moe-235b x decode_32k.** Memory term: "
            f"Alg 2 {step(q[0], q[1])}; Alg 6 capping the bottleneck "
            f"shard {step(q[1], q[2])}; the e4m3 cache {step(q[2], q[3])}."
            f" Dominant after all three: {by[q[3]]['dominant']}.")
    m = ["musicgen/0-baseline", "musicgen/1-beyond-f8cache"]
    if all(k in by for k in m):
        c0 = by[m[0]]["analytic"].get("cache_gb", 0.0)
        c1 = by[m[1]]["analytic"].get("cache_gb", 0.0)
        out.append(
            "\n**2. musicgen-large x decode_32k.** The e4m3 cache: memory "
            f"term {step(m[0], m[1])}; cache {c0} -> {c1} GB a card. What "
            "is left is cache bandwidth; the architecture-level fix (GQA) "
            "is out of scope for a serving framework.")
    z = ["zamba2/0-baseline-fsdp", "zamba2/1-beyond-nofsdp"]
    if all(k in by for k in z):
        out.append(
            "\n**3. zamba2-1.2b x train_4k.** FSDP off: per-card state "
            f"{state_gb(by[z[0]]):.3f} -> {state_gb(by[z[1]]):.3f} GB. "
            "Its gain would be in the collective term, which these "
            "records do not have: the port has no partitioner to count "
            "the per-layer gathers.")
    return "\n".join(out)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="Write the EXPERIMENTS "
                                 "document from the planning records.")
    ap.add_argument("--dryrun", required=True)
    ap.add_argument("--hillclimb", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.dryrun) as f:
        records = json.load(f)
    parts = [HEADER, dryrun_section(records), roofline_section(records)]
    if args.hillclimb:
        with open(args.hillclimb) as f:
            recs = json.load(f)
        parts += [perf_section(recs), perf_narrative(recs)]
    with open(args.out, "w") as f:
        f.write("\n".join(parts) + "\n")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
