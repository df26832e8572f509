"""The check that decides ``correct``: the served tokens against the
plain reference (``xbench/reference``), once the window has closed.

A sample drawn from the seed of the requests the run completed, the
longest among them, is compared position by position: at every position
that produced a served token, the gap by which that token's logit lies
below the best logit of the float32 reference. With the policy off the
reference runs the sampled requests alone; under Algorithm 2 a decode
step's selected set depends on every request live in that step, so the
reference runs every request that reached a decode step, and rebuilds
each step's batch from the rounds the loop recorded.

Two numbers are compared: the mean gap over every sampled position,
and the worst of the sampled requests' own mean gaps, so that a fault
in one slot of the batch shows even where the mean over all slots hides
it. Under Algorithm 2 the sample is every completed request, since the
reference runs them all anyway.

The control is the reference itself with its products in float8 e4m3
(``arith="fp8"``), in the program's place: at each position, the gap of
the token that the control puts first. The witness is the same with
its products' operands in bfloat16 (``arith="bf16"``), the program's
own precision: a wide gap that it reads too comes from rounding, not
from the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np
import torch

from xbench.reference.model import Reference, served_batch


def token_steps(run) -> Dict[int, np.ndarray]:
    """For each request: the decode step that produced each of its
    served tokens (-1 for the first, from the prefill)."""
    steps = {rid: np.full(len(s.state.tokens), -2, np.int64)
             for rid, s in run.requests.items()}
    for r in run.rounds:
        base = (r.index - 1) * run.chunk
        for rid, before, take in r.entries:
            steps[rid][before:before + take] = base + np.arange(take)
    for rid, st in steps.items():
        if len(st):
            st[0] = -1
            if (st < -1).any():
                raise RuntimeError(f"request {rid}: served tokens with no "
                                   f"recorded round")
    return steps


def sample(run, seed: int, count: int) -> List[int]:
    """``count`` completed requests drawn from the seed, the one with
    the most served tokens first."""
    done = sorted(rid for rid, s in run.requests.items() if s.completed)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(run.requests[r].state.tokens), -r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng([int(seed), 2])
    picked = [rest[i] for i in rng.permutation(len(rest))[:count - 1]]
    return [longest] + picked


def build(run, chosen: List[int]):
    """The reference's batch: the chosen requests alone with the policy
    off; every request with a decode step under a batch policy."""
    steps = token_steps(run)
    want: Set[int] = set(chosen)
    if run.policy["mode"] == "off":
        rids = list(chosen)
    else:
        rids = sorted(r for r, s in run.requests.items()
                      if len(s.state.tokens) >= 2 or r in want)
    seqs = [{"rid": r, "prompt": run.requests[r].prompt,
             "tokens": run.requests[r].tokens, "steps": steps[r]}
            for r in rids]
    served = [run.requests[s["rid"]].tokens for s in seqs
              if s["rid"] in want]
    return (served_batch(seqs, want), torch.as_tensor(np.concatenate(served)),
            [len(t) for t in served])


def gaps(stats: Dict[str, torch.Tensor]) -> np.ndarray:
    return (stats["best"] - stats["at_target"]).double().cpu().numpy()


def look(g: np.ndarray, margins, need) -> Dict[str, object]:
    """Why the widest gaps are wide: each needed position's smallest
    routing margin over the layers (``Reference.margins``), for the ten
    widest gaps, beside the quantiles of all positions' margins."""
    if not len(g) or not margins:
        return {}
    m = torch.stack(margins).min(0).values[need.to(margins[0].device)]
    m = m.double().cpu().numpy()
    top = np.argsort(-g)[:10]
    return {"widest": [[float(g[i]), float(m[i])] for i in top],
            "margin_q01_q05_q50": [float(q) for q in
                                   np.quantile(m, [0.01, 0.05, 0.5])]}


def numbers(g: np.ndarray, lens: List[int]) -> Dict[str, float]:
    """What one comparison reads: the mean gap, the worst request's mean
    gap (``lens``: each request's positions, in order), and beside them
    the widest gap, the 99th percentile and the share of positions where
    the reference's best token was served."""
    if not len(g):
        return {k: float("nan") for k in ("mean_gap", "worst_request_gap",
                                           "widest_gap", "p99_gap",
                                           "agree_share")}
    per = np.add.reduceat(g, np.cumsum([0] + lens[:-1])) / np.asarray(lens)
    return {"mean_gap": float(g.mean()),
            "worst_request_gap": float(per.max()),
            "widest_gap": float(g.max()),
            "p99_gap": float(np.percentile(g, 99)),
            "agree_share": float((g == 0).mean())}


def compare(run, weights: Dict, cfg: Dict, seed: int, count: int, *,
            control: bool = False, witness: bool = False
            ) -> Dict[str, Dict[str, float]]:
    """Run the reference over the sample; with ``control`` also the
    float8 control, with ``witness`` the bfloat16 witness. Returns
    {"program": numbers, "look": ..., ["control": numbers],
    ["witness": numbers, "witness_look": ...], "sample": {...}}."""
    chosen = sample(run, seed, count)
    if not chosen:
        return {"program": numbers(np.zeros(0), []),
                "sample": {"requests": 0, "tokens": 0}}
    batch, targets, lens = build(run, chosen)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(cfg, weights, run.policy)
        hidden = ref.final_hidden(batch)
        g = gaps(ref.head_stats(hidden, targets))
        out = {"program": numbers(g, lens),
               "look": look(g, ref.margins, batch.need)}
        for flag, kind, key in ((control, "fp8", "control"),
                                (witness, "bf16", "witness")):
            if not flag:
                continue
            other = Reference(cfg, weights, run.policy, arith=kind)
            picks = other.head_stats(other.final_hidden(batch),
                                     targets)["argmax"]
            gk = gaps(ref.head_stats(hidden, picks))
            out[key] = numbers(gk, lens)
            if key == "witness":
                out["witness_look"] = look(gk, ref.margins, batch.need)
            del other
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    out["sample"] = {"requests": len(chosen), "tokens": int(len(targets)),
                     "reference_rows": int(batch.tokens.numel())}
    return out


def verdict(read: Dict[str, float], limits: Dict[str, float]
            ) -> Optional[bool]:
    """True when every limited number is within its limit; None when a
    number is missing (nothing was sampled)."""
    for name, lim in limits.items():
        v = read.get(name)
        if v is None or not np.isfinite(v):
            return None
        if v > lim:
            return False
    return True
