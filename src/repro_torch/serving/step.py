"""The decode loop of the continuous-batching scheduler.

``decode_steps_fused`` advances the running batch N tokens between
scheduler interventions, with sampling on the device, so the host reads
results once per N tokens (the JAX package runs the same loop as one
jitted lax.scan; here it is a Python loop of eager steps, and nothing in
it waits for the device).

Per-slot active masks keep the fixed-size batch safe: finished or empty
slots are left out of MoE routing, their cur_len does not advance and
their tokens are never read. Numerics quarantine: a slot whose logits
go non-finite is frozen on the spot and reported in ``poisoned``, so one
NaN ends one request, not the batch. On a healthy batch every guard is
the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, XSharePolicy
from repro_torch.core.selection import gate_histogram
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import (decode_step, embed_tokens, evict_slot,
                                      insert_request, prefill, stack_aux)
from repro_torch.models.moe import OFF
from repro_torch.serving.sampler import sample_step

NO_FAULT = (-1, -1)   # disabled (slot, step) NaN-injection operand


def decode_steps_fused(cfg: ArchConfig, params, tok: torch.Tensor,
                       cache: dict, remaining: torch.Tensor,
                       generator: Optional[torch.Generator], *,
                       num_steps: int,
                       policy: XSharePolicy = OFF,
                       temperature: float = 0.0,
                       force_window: Optional[int] = None,
                       capacity_factor: float = 8.0,
                       dispatch: str = "auto",
                       fault: Tuple[int, int] = NO_FAULT):
    """Run ``num_steps`` decode + sample steps.

    tok: (B,) each slot's last emitted token; remaining: (B,) tokens each
    slot still owes (0 = empty slot). The active mask is
    ``remaining > 0`` and is updated every step, so a slot that reaches
    its budget mid-chunk drops out of routing on the next step.
    fault: (slot, step) whose logits are poisoned with NaN — the fault
    harness's hook; (-1, -1) disables it.

    Returns (tok', cache', toks (num_steps, B), aux (num_steps, L) per
    key, ok (num_steps, B) bool, poisoned (B,) bool): ``ok[i, b]`` marks
    a real token (slot active and finite at step i)."""
    B = tok.shape[0]
    f_slot, f_step = int(fault[0]), int(fault[1])
    poisoned = torch.zeros((B,), dtype=torch.bool, device=tok.device)
    toks, oks, auxs = [], [], []
    for step_i in range(num_steps):
        active = (remaining > 0) & ~poisoned
        cur0 = cache["cur_len"]
        lg, cache, aux = decode_step(
            cfg, params, tok[:, None], cache, policy=policy,
            force_window=force_window, capacity_factor=capacity_factor,
            active=active, dispatch=dispatch)
        last = lg[:, -1]                                   # (B, V)
        if step_i == f_step and 0 <= f_slot < B:
            last = last.clone()
            last[f_slot] = float("nan")
        finite = torch.isfinite(last).reshape(B, -1).all(dim=1)
        ok = active & finite
        poisoned = poisoned | (active & ~finite)
        nxt = sample_step(last, generator, temperature=temperature)
        nxt = torch.where(ok, nxt, tok)
        cache["cur_len"] = torch.where(ok, cur0 + 1, cur0)
        remaining = remaining - ok.to(remaining.dtype)
        tok = nxt
        toks.append(nxt)
        oks.append(ok)
        auxs.append(aux)
    return (tok, cache, torch.stack(toks), stack_aux(auxs),
            torch.stack(oks), poisoned)


def gate_probe(cfg: ArchConfig, params, tokens: torch.Tensor
               ) -> torch.Tensor:
    """A request's expert gate histogram (E,) from the first MoE layer's
    router on the embedded prompt — no attention, no FFN, no cache."""
    x = embed_tokens(cfg, params, tokens)                  # (B, S, d)
    h = rms_norm(x, params["layers"]["moe_norm"][0], cfg.norm_eps)
    wg = params["layers"]["moe"]["wg"][0].float()
    probs = torch.softmax(h.float() @ wg, dim=-1)
    return gate_histogram(probs).mean(dim=0)


@dataclass
class StepFns:
    """Serving functions shared by Engine and Scheduler."""
    prefill: Callable        # (params, tokens)            -> (lg, cache, aux)
    fused: Callable          # (params, tok, cache, remaining, gen, fault)
    #                        -> (tok', cache', toks, aux, ok, poisoned)
    insert: Callable         # (cache, req_cache, slot, src) -> cache
    evict: Callable          # (cache, slot)               -> cache
    evict_scrub: Callable    # (cache, slot) -> cache, row zeroed (poisoned)
    probe: Optional[Callable]  # (params, tokens) -> (E,) | None (no MoE)
    decode_chunk: int


def make_fused(cfg: ArchConfig, *,
               policy: XSharePolicy = OFF,
               decode_chunk: int = 8,
               temperature: float = 0.0,
               force_window: Optional[int] = None,
               capacity_factor: float = 8.0,
               dispatch: str = "auto") -> Callable:
    """One decode-loop closure; the scheduler's degradation ladder makes
    variants with a tightened XShare policy."""
    def fused(p, tok, c, rem, gen, fault=NO_FAULT):
        return decode_steps_fused(
            cfg, p, tok, c, rem, gen, num_steps=decode_chunk,
            policy=policy, temperature=temperature,
            force_window=force_window, capacity_factor=capacity_factor,
            dispatch=dispatch, fault=fault)
    return fused


def build_step_fns(cfg: ArchConfig, *,
                   policy: XSharePolicy = OFF,
                   cache_len: int = 512,
                   decode_chunk: int = 8,
                   temperature: float = 0.0,
                   force_window: Optional[int] = None,
                   capacity_factor: float = 8.0,
                   dispatch: str = "auto") -> StepFns:
    """The function bundle for one (model config, serving config) pair.
    decode_chunk is the N of decode_steps_fused."""
    def pre(p, t):
        return prefill(cfg, p, t, cache_len=cache_len, policy=OFF,
                       force_window=force_window,
                       capacity_factor=capacity_factor, dispatch=dispatch)

    probe = None
    if cfg.family == "moe":
        def probe(p, t):
            return gate_probe(cfg, p, t)
    return StepFns(
        prefill=pre,
        fused=make_fused(cfg, policy=policy, decode_chunk=decode_chunk,
                         temperature=temperature, force_window=force_window,
                         capacity_factor=capacity_factor, dispatch=dispatch),
        insert=insert_request, evict=evict_slot,
        evict_scrub=lambda c, s: evict_slot(c, s, scrub=True),
        probe=probe, decode_chunk=decode_chunk)
