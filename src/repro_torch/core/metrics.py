"""Expert-activation metrics — the quantities the paper's tables report."""
from __future__ import annotations

import torch


def activated_mask(combine: torch.Tensor) -> torch.Tensor:
    """(T, E) combine matrix -> (E,) experts any token routed to."""
    return (combine.abs() > 0).any(dim=0)


def activated_experts(combine: torch.Tensor) -> torch.Tensor:
    """|union of experts any token routed to| for one layer."""
    return activated_mask(combine).sum()


def per_group_load(active: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Activated experts per contiguous device group, groups ceil(E/G)
    wide with the trailing one(s) narrower."""
    E = active.shape[-1]
    per = -(-E // num_groups)
    a = active.to(torch.int32)
    pad = torch.zeros(a.shape[:-1] + (num_groups * per - E,),
                      dtype=a.dtype, device=a.device)
    padded = torch.cat([a, pad], dim=-1)
    return padded.reshape(a.shape[:-1] + (num_groups, per)).sum(dim=-1)


def max_group_load(active: torch.Tensor, num_groups: int) -> torch.Tensor:
    """MaxLoad(S) — the paper's bottleneck-GPU metric (Sec 5.1)."""
    return per_group_load(active, num_groups).max()


def gate_mass_captured(gates: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Fraction of the gating probability mass inside the selected set."""
    total = gates.sum()
    kept = torch.where(mask[None, :], gates, 0.0).sum()
    return kept / total.clamp_min(1e-30)


def expected_activated(num_experts: int, top_k: int, batch: int) -> float:
    """Closed-form E[N_a] = N(1-(1-k/N)^B) from the introduction."""
    return num_experts * (1.0 - (1.0 - top_k / num_experts) ** batch)


def topk_overlap(idx_a: torch.Tensor, idx_b: torch.Tensor,
                 num_experts: int) -> torch.Tensor:
    """|TopK(a) ∩ TopK(b)| over (..., k) expert indices."""
    def as_set(idx):
        out = torch.zeros(idx.shape[:-1] + (num_experts,), dtype=torch.bool,
                          device=idx.device)
        return out.scatter(-1, idx.long(), True)
    return (as_set(idx_a) & as_set(idx_b)).sum(dim=-1)
