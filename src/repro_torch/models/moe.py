"""Mixture-of-Experts FFN layer with XShare batch-aware selection.

Expert compute goes through the ``dispatch`` switch of expert_ffn:

  sorted — sort token-expert pairs by expert, grouped FFN over the
           occupied tiles (``kernels.grouped_ffn``), combine.
  einsum — the GShard capacity-based one-hot dispatch/combine einsums,
           kept as the reference semantics.
  dense  — decode sizes (T <= 32): the XShare masked FFN
           (``kernels.moe_ffn``) over the selected experts only, with the
           combine matrix as gate weights. The JAX package computes this
           case as flat GEMMs over all E experts; the kernel computes the
           same function reading only the selected experts' weights.
  auto   — dense for decode-sized drop-free batches, sorted otherwise.
  ep     — expert-parallel execution through the EPExecutor bound by
           ``repro_torch.ep.ep_context`` (ep/executor.py): per-shard
           sort, row exchange, one grouped FFN over every shard's local
           experts, reverse exchange and combine. Bit-equal to "sorted";
           with no executor bound it is "sorted".
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.bridge import dense_sampler, moe_params
from repro_torch.configs.base import MoEConfig, XSharePolicy
from repro_torch.core import metrics as M
from repro_torch.core import selection
from repro_torch.core.routing import combine_matrix, topk_route
from repro_torch.device import DeviceLike
from repro_torch.kernels import moe_ffn
from repro_torch.models import dispatch as DSP
from repro_torch.models.layers import mlp_apply

OFF = XSharePolicy(mode="off")

DISPATCH_MODES = ("auto", "sorted", "einsum", "dense", "ep")


def policy_max_active(policy: XSharePolicy, num_tokens: int,
                      num_experts: int, *,
                      spec_shape: Optional[Tuple[int, int]] = None) -> int:
    """Static upper bound on |selected expert set| under a policy — the
    XShare budget the dense kernel's slot count and the sorted path's
    padded buffer scale with."""
    E, T = num_experts, num_tokens
    if policy.mode == "batch":
        return min(E, policy.k0 * T + policy.m_l)
    if policy.mode == "ep":
        bound = policy.num_groups * policy.m_g
        if not policy.strict_cap:
            bound += policy.k0 * T
        return min(E, bound)
    if policy.mode == "spec" and spec_shape is not None:
        b, t = spec_shape
        return min(E, b * (policy.k0 * t + policy.m_r) + policy.m_l)
    return E


def init_moe(moe: MoEConfig, d_model: int, dtype: torch.dtype, *,
             stack: Optional[int] = None,
             generator: Optional[torch.Generator] = None, seed: int = 0,
             device: DeviceLike = None) -> Dict:
    """One MoE layer's parameters (stacked on a leading ``stack`` axis
    when given): the JAX package's ``init_moe`` keys, shapes and dtypes,
    N(0, 0.02) drawn from ``generator`` (a new one seeded with ``seed``
    when None) on ``device``, the card unless the caller names another."""
    _, dense = dense_sampler(seed, dtype, device, generator)
    return moe_params(moe, d_model, dense,
                      () if stack is None else (stack,))


def route(p: Dict, x: torch.Tensor, moe: MoEConfig, policy: XSharePolicy,
          spec_shape: Optional[Tuple[int, int]] = None,
          token_mask: Optional[torch.Tensor] = None,
          spec_priors: Optional[torch.Tensor] = None):
    """Router + XShare selection. x: (T, d).

    token_mask (T,) bool drops masked tokens (inactive slots) from
    routing: their gate mass is zeroed before selection and their expert
    index becomes -1.

    Returns (idx (T, k), weights (T, k), combine (T, E) f32, aux)."""
    E = moe.num_experts
    logits = x.float() @ p["wg"].float()
    probs = torch.softmax(logits, dim=-1)
    if token_mask is not None:
        probs = probs * token_mask[:, None].to(probs.dtype)
    if policy.mode == "off":
        idx, w = topk_route(logits, moe.top_k, normalize=moe.normalize_gates)
        mask = torch.ones((E,), dtype=torch.bool, device=x.device)
    else:
        idx, w, mask = selection.apply_policy(
            probs, policy, top_k=moe.top_k, spec_shape=spec_shape,
            logits=logits, priors=spec_priors)
    if token_mask is not None:
        idx = torch.where(token_mask[:, None], idx, -1)
        w = torch.where(token_mask[:, None], w, 0.0)
    combine = combine_matrix(idx, w, E)                    # (T, E)
    active = (combine > 0).any(dim=0)
    G = policy.num_groups
    # Switch-Transformer load-balance auxiliary over the live tokens
    denom = probs.shape[0] if token_mask is None else \
        token_mask.sum().clamp_min(1).float()
    routed = combine_matrix(idx, torch.ones_like(w), E) > 0
    frac = routed.float().sum(0) / denom
    lb = E * (frac * (probs.sum(0) / denom)).sum() / moe.top_k
    counts = combine_matrix(idx, (w != 0.0).float(), E).sum(0)
    counts = counts.to(torch.int32)
    aux = {
        "activated_experts": active.sum(),
        "selected_set": mask.sum(),
        "max_group_load": M.max_group_load(active, G),
        "max_group_tokens": DSP.group_token_loads(counts, G).max(),
        "gate_mass": M.gate_mass_captured(probs, mask),
        "lb_loss": lb,
    }
    if spec_shape is not None:
        b, t = spec_shape
        pr = probs.reshape(b, t, probs.shape[-1])
        if token_mask is not None:
            denom_r = token_mask.reshape(b, t).sum(-1, keepdim=True)
            denom_r = denom_r.clamp_min(1)
        else:
            denom_r = torch.full((b, 1), t, device=x.device)
        aux["req_gate_hist"] = pr.sum(dim=1) / denom_r
    return idx, w, combine, aux


def einsum_capacity(tokens_per_group: int, top_k: int, num_experts: int,
                    capacity_factor: float, *, min_capacity: int = 4,
                    capacity: Optional[int] = None) -> int:
    """Per-expert per-group buffer size C of the einsum dispatch path."""
    t = tokens_per_group
    if capacity is not None:
        return min(capacity, t)
    c = max(min_capacity,
            int(-(-t * top_k * capacity_factor // num_experts)))
    return min(c, t)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """one_hot in f32 where an index outside [0, n) gives a zero row."""
    ok = (idx >= 0) & (idx < n)
    out = F.one_hot(torch.where(ok, idx, 0).long(), n).float()
    return out * ok[..., None].float()


def expert_ffn(p: Dict, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
               moe: MoEConfig, *, capacity_factor: float = 1.25,
               min_capacity: int = 4, capacity: Optional[int] = None,
               group_size: int = 2048, dispatch: str = "auto",
               combine: Optional[torch.Tensor] = None,
               max_active: Optional[int] = None) -> torch.Tensor:
    """Routed-expert compute behind the dispatch switch (module doc).
    x: (T, d); idx/w: (T, k); combine: optional (T, E) from route();
    max_active: the XShare budget bound (policy_max_active)."""
    T, d = x.shape
    E, k = moe.num_experts, idx.shape[-1]
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if dispatch == "ep":
        from repro_torch import ep as EP
        ex = EP.current_executor()
        if ex is not None:
            return ex.ffn(x, p["w1"], p["w3"], p["w2"], idx, w).to(x.dtype)
        dispatch = "sorted"                   # the single-device path
    G = 1
    if T > group_size:
        for cand in range(T // group_size, 0, -1):
            if T % cand == 0 and T // cand <= group_size:
                G = cand
                break
    t = T // G
    C = einsum_capacity(t, k, E, capacity_factor,
                        min_capacity=min_capacity, capacity=capacity)
    if dispatch == "auto":
        dispatch = "dense" if (G == 1 and C >= T and T <= 32) else "sorted"

    if dispatch == "dense":
        if combine is None:
            combine = combine_matrix(idx, w.float(), E)
        combine = combine.float()
        active = (combine != 0).any(dim=0)
        return moe_ffn(x, p["w1"], p["w3"], p["w2"], combine, active,
                       max_active=E if max_active is None else max_active)

    if dispatch == "sorted":
        return DSP.sorted_expert_ffn(x, p["w1"], p["w3"], p["w2"], idx, w,
                                     capacity=capacity,
                                     max_active=max_active)

    xg = x.reshape(G, t, d)
    one_hot = _one_hot(idx.reshape(G, t, k), E)                # (G,t,k,E)
    gate = (one_hot * w.reshape(G, t, k)[..., None].float()).sum(-2)
    routed = one_hot.sum(-2)                                   # (G,t,E)
    pos = torch.cumsum(routed, dim=1) - routed
    keep = routed * (pos < C).float()
    disp = keep[..., None] * _one_hot(pos.long(), C)           # (G,t,E,C)
    xe = torch.einsum("gtec,gtd->gecd", disp, xg.float()).to(x.dtype)
    h = torch.einsum("gecd,edf->gecf", xe, p["w1"])
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", xe, p["w3"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w2"])
    comb = disp * gate[..., None]
    y = torch.einsum("gtec,gecd->gtd", comb, ye.float())
    return y.reshape(T, d).to(x.dtype)


def moe_apply(p: Dict, x: torch.Tensor, moe: MoEConfig,
              policy: XSharePolicy = OFF, *,
              spec_shape: Optional[Tuple[int, int]] = None,
              capacity_factor: float = 1.25,
              capacity: Optional[int] = None,
              token_mask: Optional[torch.Tensor] = None,
              dispatch: str = "auto",
              spec_priors: Optional[torch.Tensor] = None):
    """Full MoE layer. x: (..., d), leading dims flattened; token_mask
    matches them. Shared experts are added for every token. Returns
    (y, aux)."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    tm = None if token_mask is None else token_mask.reshape(-1)
    idx, w, combine, aux = route(p, xt, moe, policy, spec_shape,
                                 token_mask=tm, spec_priors=spec_priors)
    ma = policy_max_active(policy, xt.shape[0], moe.num_experts,
                           spec_shape=spec_shape)
    y = expert_ffn(p, xt, idx, w, moe, capacity_factor=capacity_factor,
                   capacity=capacity, dispatch=dispatch, combine=combine,
                   max_active=ma)
    if "ws1" in p:
        y = y + mlp_apply({"w1": p["ws1"], "w3": p["ws3"], "w2": p["ws2"]},
                          xt, "swiglu")
    return y.reshape(shape), aux
