"""Planning dry run: every (arch x shape x mesh) combination traced at
full size on the meta device, which allocates nothing and computes
nothing, with each card's share of the state from the partition rules
and the step's roofline on the H100 (the JAX package's
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape decode_32k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out ...]

The reference lowers and compiles each step with XLA's SPMD partitioner
on 512 forced host devices. The port has no partitioner, so "lowering"
is one run of the step on meta tensors under ``sharding.mesh_context``:
the train step (``launch/train.make_train_step``, forward, backward and
AdamW), the prefill (``launch/serve.make_prefill``) or one decode step
(``launch/serve.make_serve_step``), with the kernel wrappers taking
their plain versions, which on meta only propagate shapes and dtypes.
It shows that the step composes at full size, and gives its outputs'
shapes (``trace``).

A record keeps the reference's ``arch``, ``shape``, ``mesh``,
``devices``, ``policy`` and ``analytic`` (params / opt / cache GB per
card, exact from the specs) and the roofline row of
``roofline.step_terms`` (a 1-byte cache counted at 1 byte an element,
the experts spread over the mesh's "model" extent). ``trace_s`` takes
the place of ``compile_s``. Left out, because only a compiled XLA
program has them: ``flops_per_device`` / ``bytes_per_device``
(``cost_analysis``), the ``memory_analysis`` sizes and
``peak_hbm_gb``, and the collectives parsed from the HLO; the row's
collective term is None and ``dominant`` is taken over compute and
memory. ``disable_constraints`` is left out with ``sharding.constrain``,
and so are the batch axes the reference's context carries for it.
``--out`` has no default: nothing is written unless asked. ``--all``
traces in parallel processes (``run_all``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.bridge import flatten, init_params
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.configs.registry import assigned_names, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch import partition as PT
from repro_torch.launch import roofline as RL
from repro_torch.launch.inputs import (force_window_for, input_specs,
                                       policy_for)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import make_prefill, make_serve_step
from repro_torch.launch.train import make_train_step
from repro_torch.optim import adamw_init
from repro_torch.sharding import mesh_context

PARAM_DTYPE = torch.bfloat16


def _params_meta(cfg: ArchConfig) -> Dict:
    return init_params(cfg, dtype=PARAM_DTYPE, device="meta")


def per_device_gb(tree: Mapping, spec_tree: Mapping, mesh) -> float:
    """Exact per-card GB of a sharded tree of tensors (meta ones will do)
    from its specs, matched by path key."""
    specs = flatten(spec_tree)
    total = 0.0
    for key, t in flatten(tree).items():
        total += t.numel() * t.element_size() / PT.shard_count(specs[key],
                                                                mesh)
    return total / 1e9


def _accum(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """>50B-param models microbatch 8x to fit activations in memory."""
    return 8 if (shape.kind == "train"
                 and RL.param_counts(cfg)["total"] > 50e9) else 1


def trace(cfg: ArchConfig, shape: ShapeConfig, mesh, *, policy=None,
          capacity_factor: float = 1.25, cache_dtype=None,
          params: Optional[Dict] = None, inputs: Optional[Dict] = None):
    """Run the combination's step once on meta tensors under the mesh
    context and return its outputs: (params, opt state, metrics) for
    train, (logits, cache, aux) for prefill and decode."""
    policy = policy if policy is not None else policy_for(cfg, shape)
    fw = force_window_for(cfg, shape) if shape.kind != "train" else None
    params = _params_meta(cfg) if params is None else params
    ins = input_specs(cfg, shape, PARAM_DTYPE, cache_dtype=cache_dtype) \
        if inputs is None else inputs
    with mesh_context(mesh):
        if shape.kind == "train":
            fn = make_train_step(cfg, policy=policy, remat=True,
                                 capacity_factor=capacity_factor,
                                 accum_steps=_accum(cfg, shape))
            return fn(params, adamw_init(params), ins["tokens"],
                      ins.get("prefix_embeds"))
        with torch.no_grad():
            if shape.kind == "prefill":
                fn = make_prefill(cfg, cache_len=shape.seq_len + 512,
                                  force_window=fw,
                                  capacity_factor=capacity_factor)
                return fn(params, ins["tokens"], ins.get("prefix_embeds"))
            fn = make_serve_step(cfg, policy=policy, force_window=fw,
                                 capacity_factor=capacity_factor)
            return fn(params, ins["tokens"], ins["cache"])


def lower_one(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
              policy=None, capacity_factor: float = 1.25,
              fsdp: bool = True, cache_dtype=None,
              extra_tags: Optional[Dict] = None) -> Dict:
    """Trace one combination on meta; return its record (module doc)."""
    n_dev = mesh.size
    policy = policy if policy is not None else policy_for(cfg, shape)
    fw = force_window_for(cfg, shape) if shape.kind != "train" else None
    params = _params_meta(cfg)
    pspecs = PT.param_specs(cfg, mesh, params, fsdp=fsdp)
    ins = input_specs(cfg, shape, PARAM_DTYPE, cache_dtype=cache_dtype)
    t0 = time.perf_counter()
    trace(cfg, shape, mesh, policy=policy, capacity_factor=capacity_factor,
          params=params, inputs=ins)
    trace_s = time.perf_counter() - t0
    analytic = {"params_gb": per_device_gb(params, pspecs, mesh)}
    if shape.kind == "train":
        f32 = {k: torch.empty(t.shape, dtype=torch.float32, device="meta")
               for k, t in flatten(params).items()}
        analytic["opt_gb"] = 2.0 * per_device_gb(f32, flatten(pspecs), mesh)
    if shape.kind == "decode":
        analytic["cache_gb"] = per_device_gb(
            ins["cache"], PT.cache_specs(cfg, mesh, shape.global_batch),
            mesh)
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "devices": int(n_dev),
        "policy": policy.mode,
        "trace_s": round(trace_s, 3),
        "analytic": {k: round(v, 3) for k, v in analytic.items()},
    }
    cbe = 1 if (cache_dtype is not None and cache_dtype.itemsize == 1) \
        else 2
    rec.update(RL.step_terms(rec, n_dev, cfg, shape, window=fw,
                             accum=_accum(cfg, shape), policy=policy,
                             cache_bytes_per_el=cbe,
                             model_shards=mesh.shape.get("model", 1)))
    if extra_tags:
        rec.update(extra_tags)
    return rec


def record_line(rec: Dict) -> str:
    an = rec["analytic"]
    return (f"{rec['arch']:22s} {rec['shape']:12s} mesh={rec['mesh']:8s} "
            f"state={sum(an.values()):.3f}GB "
            f"comp={rec['compute_s'] * 1e3:.3f}ms "
            f"mem={rec['memory_s'] * 1e3:.3f}ms dom={rec['dominant']} "
            f"trace={rec['trace_s']}s")


def merge_into(out: str, recs: List[Dict]) -> None:
    """Merge records into the JSON list at ``out``, replacing any of the
    same (arch, shape, mesh)."""
    existing = []
    if os.path.exists(out):
        with open(out) as f:
            existing = json.load(f)
    keys = {(r["arch"], r["shape"], r["mesh"]) for r in recs}
    existing = [r for r in existing
                if (r["arch"], r["shape"], r["mesh"]) not in keys]
    with open(out, "w") as f:
        json.dump(existing + recs, f, indent=1)


def run(arch: str, shape_name: str, multi_pod: bool, out: Optional[str],
        capacity_factor: float = 1.25) -> Dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = lower_one(cfg, shape, mesh, capacity_factor=capacity_factor)
    print(record_line(rec), flush=True)
    if out:
        merge_into(out, [rec])
    return rec


def _lower_combo(combo: Tuple[str, str, bool]) -> Tuple[Optional[Dict],
                                                         Optional[str]]:
    """(record, None) or (None, the error) of one combination, in a worker
    process of ``run_all``."""
    arch, shape, mp = combo
    try:
        return lower_one(get_config(arch), get_shape(shape),
                         make_production_mesh(multi_pod=mp)), None
    except Exception:  # noqa: BLE001
        return None, traceback.format_exc()


def run_all(out: Optional[str]) -> List[Tuple]:
    """Every assigned arch x shape x (single-, multi-pod) mesh; returns the
    failures. A trace is host work only, and the 8 microbatches of a
    >50B model's train step make one trace take about a minute of meta
    ops, so the combinations go to one process per core but one (at
    most 8, each holding its own PyTorch), longest first, and ``out``
    is written once at the end."""
    import concurrent.futures as cf
    import multiprocessing as mp_

    combos = [(a, s, mp) for a in assigned_names() for s in SHAPES
              for mp in (False, True)]

    def cost(c):   # train, then prefill, larger models first
        kind = {"train": 0, "prefill": 1}.get(get_shape(c[1]).kind, 2)
        return kind, -RL.param_counts(get_config(c[0]))["total"]

    combos.sort(key=cost)
    jobs = max(1, min(8, (os.cpu_count() or 2) - 1))
    recs, fails = [], []
    with cf.ProcessPoolExecutor(
            jobs, mp_context=mp_.get_context("spawn")) as pool:
        futs = {pool.submit(_lower_combo, c): c for c in combos}
        for fut in cf.as_completed(futs):
            (arch, shape, mp), (rec, err) = futs[fut], fut.result()
            if err is None:
                recs.append(rec)
                print(record_line(rec), flush=True)
            else:
                fails.append((arch, shape, mp, err.splitlines()[-1]))
                print(f"FAIL {arch} {shape} multi={mp}:\n{err}", flush=True)
    if out:
        merge_into(out, recs)
    return fails


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Trace every (arch x shape x "
                                 "mesh) on the meta device and record its "
                                 "per-card state and roofline.")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="JSON file to merge the records into")
    args = ap.parse_args(argv)

    if args.all:
        fails = run_all(args.out)
        print(f"\n{len(fails)} failures")
        raise SystemExit(1 if fails else 0)
    run(args.arch, args.shape, args.multi_pod, args.out)


if __name__ == "__main__":
    main()
