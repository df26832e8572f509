"""Planning hillclimb on three (arch x shape) pairs, each experiment one
hypothesis -> change -> re-trace -> compare cycle over the records of
``launch/dryrun.lower_one`` (the JAX package's
``repro.launch.hillclimb``):

  1. qwen3-moe-235b-a22b x decode_32k -- the paper's technique (MoE
     decode under XShare): off, batch, EP-aware, EP-aware + f8 cache.
  2. musicgen-large x decode_32k -- its MHA KV cache dominates the
     memory term: baseline, f8 cache.
  3. zamba2-1.2b x train_4k -- a 1.2B model under FSDP: baseline,
     FSDP off.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        [--exp qwen3|musicgen|zamba2] [--out hillclimb_results.json]

Records are printed; ``--out`` merges them into a JSON file (nothing is
written without it). Left out: the reference's zamba2 "no-seqpar"
ablation, which only drops the ``constrain(tag="seqpar")`` hints; the
port has no partitioner and no such hints, so it would give the
baseline's record again.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import XSharePolicy
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch.dryrun import lower_one
from repro_torch.launch.mesh import make_production_mesh

F8 = torch.float8_e4m3fn


def record(recs: List[Dict], name: str, rec: Dict, hypothesis: str) -> None:
    rec["experiment"] = name
    rec["hypothesis"] = hypothesis
    recs.append(rec)
    print(f"  -> {name}: mem={rec['memory_s'] * 1e3:.3f}ms "
          f"comp={rec['compute_s'] * 1e3:.3f}ms coll=n/a "
          f"dom={rec['dominant']} "
          f"state={sum(rec['analytic'].values()):.3f}GB", flush=True)


def exp_qwen3(recs: List[Dict], mesh) -> None:
    cfg = get_config("qwen3-moe-235b-a22b")
    shape = get_shape("decode_32k")
    groups = mesh.shape["model"]
    ep = XSharePolicy(mode="ep", k0=1, m_g=4, num_groups=groups)
    print("[qwen3 decode] baseline-off -> paper-faithful -> EP-aware -> "
          "f8 cache", flush=True)
    record(recs, "qwen3/0-vanilla-topk",
           lower_one(cfg, shape, mesh, policy=XSharePolicy(mode="off")),
           "vanilla routing: at B=128 nearly all 128 experts activate; "
           "expert weights dominate the memory term")
    record(recs, "qwen3/1-paper-xshare-batch",
           lower_one(cfg, shape, mesh,
                     policy=XSharePolicy(mode="batch", k0=1, m_l=16)),
           "PAPER-FAITHFUL Alg2 (k0=1,m=16): the expected selected set "
           "drops below 128 experts, and expert-weight traffic with it")
    record(recs, "qwen3/2-beyond-ep-aware",
           lower_one(cfg, shape, mesh, policy=ep),
           f"BEYOND: Alg6 with per-shard cap m_g=4 ({groups} shards): the "
           f"bottleneck shard loads 4 experts instead of its expected "
           f"share of the selected set")
    record(recs, "qwen3/3-beyond-ep+f8cache",
           lower_one(cfg, shape, mesh, policy=ep, cache_dtype=F8),
           "BEYOND: + e4m3 KV cache halves the cache read stream")


def exp_musicgen(recs: List[Dict], mesh) -> None:
    cfg = get_config("musicgen-large")
    shape = get_shape("decode_32k")
    print("[musicgen decode] baseline -> f8 cache", flush=True)
    record(recs, "musicgen/0-baseline",
           lower_one(cfg, shape, mesh),
           "MHA kv=32 cache dominates the memory term")
    record(recs, "musicgen/1-beyond-f8cache",
           lower_one(cfg, shape, mesh, cache_dtype=F8),
           "BEYOND: e4m3 KV cache halves the cache bytes, so the memory "
           "term nearly halves")


def exp_zamba(recs: List[Dict], mesh) -> None:
    cfg = get_config("zamba2-1.2b")
    shape = get_shape("train_4k")
    print("[zamba2 train] baseline -> no-FSDP", flush=True)
    record(recs, "zamba2/0-baseline-fsdp",
           lower_one(cfg, shape, mesh),
           "FSDP(data) x TP: a 1.2B model pays per-layer param "
           "all-gathers it would not need replicated")
    record(recs, "zamba2/1-beyond-nofsdp",
           lower_one(cfg, shape, mesh, fsdp=False),
           "BEYOND: drop FSDP for small models (params replicated over "
           "data): the per-card param and optimizer state grows by the "
           "data extent, the forward/backward param gathers vanish")


EXPERIMENTS = {"qwen3": exp_qwen3, "musicgen": exp_musicgen,
               "zamba2": exp_zamba}


def main(argv: Optional[list] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description="Re-trace the planning "
                                 "experiments and print their records.")
    ap.add_argument("--exp", default="all",
                    choices=["all"] + sorted(EXPERIMENTS))
    ap.add_argument("--out", default=None,
                    help="JSON file to append the records to")
    args = ap.parse_args(argv)
    mesh = make_production_mesh()
    recs: List[Dict] = []
    for name, exp in EXPERIMENTS.items():
        if args.exp in ("all", name):
            exp(recs, mesh)
    if args.out:
        old = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                old = json.load(f)
        with open(args.out, "w") as f:
            json.dump(old + recs, f, indent=1)
        print("wrote", args.out, flush=True)
    return recs


if __name__ == "__main__":
    main()
