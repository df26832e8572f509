"""XShare batch-aware expert selection — Algorithms 1-6 of the paper.

Expert sets are boolean masks over the expert axis; budgets are Python
ints, so every function runs on the device without a host sync. Scores
are the router's full (pre-top-k) probabilities, shape (..., E).
Ties break toward the lower expert index everywhere (``routing.topk``),
as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.routing import topk

_BIG = 1e9  # priority bonus that dominates any sum of probabilities


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the top-k entries along the last axis (k <= 0:
    all False)."""
    E = scores.shape[-1]
    out = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    if k <= 0:
        return out
    _, idx = topk(scores, min(k, E))
    return out.scatter(-1, idx, True)


def warmup_union(gates: torch.Tensor, k0: int) -> torch.Tensor:
    """S0 = union over tokens of each token's top-k0 experts.
    gates: (..., T, E) -> (..., E). All-zero rows (masked slots) add
    nothing."""
    if k0 <= 0:
        return torch.zeros(gates.shape[:-2] + gates.shape[-1:],
                           dtype=torch.bool, device=gates.device)
    per_token = topk_mask(gates, k0) & (gates.sum(-1, keepdim=True) > 0)
    return per_token.any(dim=-2)


def greedy_select(gates: torch.Tensor, m: int,
                  warmup: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Algorithm 1 — the proxy objective is modular, so greedy is the
    top-m experts by batch-aggregated score outside the warm-up set.
    gates: (T, E); warmup: (E,) bool or None. Returns (E,) bool."""
    E = gates.shape[-1]
    agg = gates.sum(dim=0)
    if warmup is None:
        warmup = torch.zeros((E,), dtype=torch.bool, device=gates.device)
    if m <= 0:
        return warmup
    pool = torch.where(warmup, -torch.inf, agg)
    return warmup | topk_mask(pool, min(m, E))


def batch_select(gates: torch.Tensor, m_l: int, k0: int) -> torch.Tensor:
    """Algorithm 2 — warm-up + batch-level greedy. gates: (T, E)."""
    return greedy_select(gates, m_l, warmup_union(gates, k0))


def per_request_select(gates: torch.Tensor, m_r: int, k0: int, *,
                       priors: Optional[torch.Tensor] = None,
                       corr: float = 1.0) -> torch.Tensor:
    """Algorithm 3 — per-request greedy, vectorized over requests.
    gates: (b, t, E) -> (b, E). Requests with all-zero gates select
    nothing; priors (b, E) blend each request's history into its score."""
    s0 = warmup_union(gates, k0)
    agg = gates.sum(dim=-2)
    live = agg.sum(-1, keepdim=True) > 0
    if priors is not None and corr > 0.0:
        pnorm = priors / priors.sum(-1, keepdim=True).clamp_min(1e-30)
        agg = agg + corr * agg.sum(-1, keepdim=True) * pnorm
    if m_r <= 0:
        return s0
    pool = torch.where(s0, -torch.inf, agg)
    picked = topk_mask(pool, min(m_r, gates.shape[-1]))
    return s0 | (picked & live)


def spec_select(gates: torch.Tensor, m: int, m_r: int, k0: int, *,
                priors: Optional[torch.Tensor] = None,
                corr: float = 1.0) -> torch.Tensor:
    """Algorithm 4 — hierarchical selection for speculative decoding:
    per-request budgets, unioned, topped up to the batch budget.
    gates: (b, 1+L_s, E). Returns (E,) bool."""
    s_batch = per_request_select(gates, m_r, k0, priors=priors,
                                 corr=corr).any(dim=0)
    flat = gates.reshape(-1, gates.shape[-1])
    if priors is not None and corr > 0.0:
        pnorm = priors / priors.sum(-1, keepdim=True).clamp_min(1e-30)
        req_mass = gates.sum(dim=(-2, -1))
        blended = flat.sum(0) + corr * (pnorm * req_mass[:, None]).sum(0)
        if m <= 0:
            return s_batch
        pool = torch.where(s_batch, -torch.inf, blended)
        return s_batch | topk_mask(pool, min(m, gates.shape[-1]))
    return greedy_select(flat, m, s_batch)


def ep_select(gates: torch.Tensor, m_g: int, num_groups: int, k0: int, *,
              strict_cap: bool = True) -> torch.Tensor:
    """Algorithms 5+6 — top-m_g experts within each contiguous device
    group (ceil(E/G) wide; padding slots carry -inf). strict_cap counts
    warm-up members against the group budget. gates: (T, E) -> (E,)."""
    T, E = gates.shape
    per = -(-E // num_groups)
    s0 = warmup_union(gates, k0)
    agg = gates.sum(dim=0)
    if m_g <= 0:
        return s0 if not strict_cap else torch.zeros_like(s0)
    prio = agg + _BIG * s0.to(agg.dtype)
    pad = torch.full((num_groups * per - E,), -torch.inf, dtype=prio.dtype,
                     device=prio.device)
    grouped = torch.cat([prio, pad]).reshape(num_groups, per)
    picked = topk_mask(grouped, min(m_g, per)).reshape(-1)[:E]
    return picked if strict_cap else picked | s0


def restricted_topk(gates: torch.Tensor, mask: torch.Tensor, k: int, *,
                    logits: Optional[torch.Tensor] = None,
                    normalize: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token top-k within the selected set S. gates: (T, E) full
    probabilities; mask: (E,). Returns (indices, weights), each (T, k);
    picks outside S (possible when |S| < k) get weight 0, and a row
    with no valid pick gets all-zero weights, not NaN."""
    T, E = gates.shape
    k = min(k, E)
    masked = torch.where(mask[None, :], gates, -torch.inf)
    top_g, idx = topk(masked, k)
    valid = torch.isfinite(top_g)
    if normalize:
        src = logits if logits is not None else torch.log(
            gates.clamp_min(1e-30))
        sel = torch.gather(src, -1, idx)
        sel = torch.where(valid, sel, -torch.inf)
        w = torch.softmax(sel, dim=-1)
        w = torch.where(valid, w, 0.0)
        w = torch.where(valid.any(dim=-1, keepdim=True), w, 0.0)
    else:
        w = torch.where(valid, top_g, 0.0)
    return idx, w


# ------------------------------------------------- scheduling affinity ----

def gate_histogram(gates: torch.Tensor) -> torch.Tensor:
    """Mean router probability over tokens: (..., T, E) -> (..., E)."""
    return gates.mean(dim=-2)


def affinity_score(cand_hist: torch.Tensor,
                   batch_mass: torch.Tensor) -> torch.Tensor:
    """Histogram-intersection affinity (both sides normalized to unit
    mass): 1.0 = identical expert usage, 0.0 = disjoint or empty batch."""
    c = cand_hist / cand_hist.sum(-1, keepdim=True).clamp_min(1e-30)
    b = batch_mass / batch_mass.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.minimum(c, b).sum(-1)


def rank_by_affinity(cand_hists: torch.Tensor,
                     batch_mass: torch.Tensor) -> torch.Tensor:
    """Affinity per waiting request: (N, E), (E,) -> (N,). Admission
    takes the argmax, first index on ties (FIFO for an empty batch)."""
    return affinity_score(cand_hists, batch_mass[None, :])


def apply_policy(gates: torch.Tensor, policy, *, top_k: int,
                 spec_shape: Optional[Tuple[int, int]] = None,
                 logits: Optional[torch.Tensor] = None,
                 priors: Optional[torch.Tensor] = None):
    """One XSharePolicy at one MoE layer. gates: (T, E).
    Returns (indices (T, top_k), weights (T, top_k), mask (E,))."""
    T, E = gates.shape
    mode = policy.mode
    if mode == "off":
        mask = torch.ones((E,), dtype=torch.bool, device=gates.device)
    elif mode == "batch":
        mask = batch_select(gates, policy.m_l, policy.k0)
    elif mode == "spec":
        if spec_shape is None:
            raise ValueError("mode='spec' needs spec_shape=(b, 1+L_s)")
        b, t = spec_shape
        if b * t != T:
            raise ValueError(f"spec_shape {spec_shape} does not cover T={T}")
        mask = spec_select(gates.reshape(b, t, E), policy.m_l, policy.m_r,
                           policy.k0, priors=priors, corr=policy.corr)
    elif mode == "ep":
        mask = ep_select(gates, policy.m_g, policy.num_groups, policy.k0,
                         strict_cap=policy.strict_cap)
    else:
        raise ValueError(f"unknown XShare mode {mode!r}")
    idx, w = restricted_topk(gates, mask, top_k, logits=logits)
    return idx, w, mask
