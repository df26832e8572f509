"""The decode loops of the continuous-batching schedulers.

``decode_steps_fused`` advances the running batch N tokens between
scheduler interventions, and ``spec_steps_fused`` runs N draft-then-
verify rounds, both with sampling on the device, so the host reads
results once per dispatch. Nothing in either loop waits for the device:
the NaN-fault operand is a device tensor compared with the step index
on the device, and the running state (``tok``, the caches' ``cur_len``,
the KV, conv and SSM tensors) is written in place. So the loops can be
captured whole as CUDA graphs (serving/graphs.py), the port's
counterpart of the JAX package's jitted lax.scan; on the CPU they run
as they are.

Per-slot active masks keep the fixed-size batch safe: finished or empty
slots are left out of MoE routing, their cur_len does not advance and
their tokens are never read. Numerics quarantine: a slot whose logits
go non-finite is frozen on the spot and reported in ``poisoned``, so one
NaN ends one request, not the batch. On a healthy batch every guard is
the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch.configs.base import ArchConfig, XSharePolicy
from repro_torch.core.selection import gate_histogram
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import (decode_step, embed_tokens, evict_slot,
                                      insert_request, prefill, stack_aux)
from repro_torch.models.moe import OFF
from repro_torch.serving.sampler import greedy, sample_step
from repro_torch.serving.spec_decode import greedy_accept

NO_FAULT = (-1, -1)   # disabled (slot, step or round) NaN-injection operand

Fault = Union[torch.Tensor, Sequence[int]]


def _fault_operand(fault: Fault, device) -> torch.Tensor:
    """The (2,) int32 (slot, step or round) NaN-fault operand on
    ``device``; a tensor already there is used as it is (a captured
    loop's static buffer), a pair of ints is copied over."""
    if isinstance(fault, torch.Tensor) and fault.device == device:
        return fault
    return torch.as_tensor(fault, dtype=torch.int32, device=device)


def _inject(x: torch.Tensor, fault: torch.Tensor,
            index: int) -> torch.Tensor:
    """x (B, ...) with row fault[0] set to NaN when index == fault[1],
    compared on the device as the JAX package does."""
    B = x.shape[0]
    hit = (torch.arange(B, device=x.device) == fault[0]) & \
        (fault[1] == index)
    return torch.where(hit.reshape((B,) + (1,) * (x.ndim - 1)),
                       float("nan"), x)


def decode_steps_fused(cfg: ArchConfig, params, tok: torch.Tensor,
                       cache: dict, remaining: torch.Tensor,
                       generator: Optional[torch.Generator], *,
                       num_steps: int,
                       policy: XSharePolicy = OFF,
                       temperature: float = 0.0,
                       force_window: Optional[int] = None,
                       capacity_factor: float = 8.0,
                       dispatch: str = "auto",
                       fault: Fault = NO_FAULT):
    """Run ``num_steps`` decode + sample steps.

    tok: (B,) each slot's last emitted token ((B, K) for the audio
    family's codebook frames); remaining: (B,) tokens each
    slot still owes (0 = empty slot). The active mask is
    ``remaining > 0`` and is updated every step, so a slot that reaches
    its budget mid-chunk drops out of routing on the next step.
    fault: (2,) int32 (slot, step) whose logits are poisoned with NaN —
    the fault harness's hook; (-1, -1) disables it (a pair of ints is
    accepted too).

    ``tok`` and ``cache`` (its ``cur_len`` too) are updated in place.
    Returns (tok, cache, toks (num_steps, B[, K]), aux (num_steps, L) per
    key, ok (num_steps, B) bool, poisoned (B,) bool): ``ok[i, b]`` marks
    a real token (slot active and finite at step i)."""
    B = tok.shape[0]
    fault = _fault_operand(fault, tok.device)
    poisoned = torch.zeros((B,), dtype=torch.bool, device=tok.device)
    toks, oks, auxs = [], [], []
    for step_i in range(num_steps):
        active = (remaining > 0) & ~poisoned
        cur0 = cache["cur_len"]
        lg, _, aux = decode_step(
            cfg, params, tok[:, None], cache, policy=policy,
            force_window=force_window, capacity_factor=capacity_factor,
            active=active, dispatch=dispatch)
        last = _inject(lg[:, -1], fault, step_i)           # (B[, K], V)
        finite = torch.isfinite(last).reshape(B, -1).all(dim=1)
        ok = active & finite
        poisoned = poisoned | (active & ~finite)
        nxt = sample_step(last, generator, temperature=temperature)
        nxt = torch.where(ok if tok.ndim == 1 else ok[:, None], nxt, tok)
        cur0.copy_(torch.where(ok, cur0 + 1, cur0))
        remaining = remaining - ok.to(remaining.dtype)
        tok.copy_(nxt)
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
    #                        -> (tok, cache, toks, aux, ok, poisoned)
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


def spec_steps_fused(cfg: ArchConfig, params, dcfg: ArchConfig, dparams,
                     tok: torch.Tensor, cache: dict, dcache: dict,
                     remaining: torch.Tensor, budget: torch.Tensor,
                     draft_len: torch.Tensor, spec_on: torch.Tensor,
                     priors: torch.Tensor, *,
                     num_rounds: int, spec_len: int,
                     policy: XSharePolicy = OFF,
                     force_window: Optional[int] = None,
                     capacity_factor: float = 8.0,
                     dispatch: str = "auto",
                     fault: Fault = NO_FAULT):
    """``num_rounds`` draft-then-verify rounds, speculative and plain
    requests sharing one running batch; like decode_steps_fused, nothing
    in the loop waits for the device.

    Each round drafts ``spec_len`` tokens per slot with the draft model
    (spec_len + 1 greedy steps: the extra one writes the last draft's
    KV), then runs ONE target verify pass over (B, 1 + spec_len) tokens
    routed with the policy (mode "spec": Algorithm 4 with the per-slot
    ``priors``). Ragged acceptance (greedy_accept with the per-slot limit
    ``min(draft_len, remaining - 1, budget)``, 0 for inactive or plain
    slots) rolls both caches back to cur0 + num_new. A slot with limit 0
    is plain greedy decode: accepted 0, one bonus token from the verify
    pass's position-0 logits. Speculative slots with an exhausted budget
    keep drafting so their draft cache stays in step, but accept
    nothing.

    tok: (B,) each slot's last emitted (uncached) token; remaining: (B,)
    tokens still owed (0 = empty slot); budget: (B,) draft tokens a slot
    may still spend; draft_len: (B,) per-slot draft length <= spec_len;
    spec_on: (B,) bool, the slot runs the draft model; priors: (B, E)
    correlation priors ((B, 0) when the target has no router).
    fault: (2,) int32 (slot, round) whose verify logits are poisoned
    with NaN; (-1, -1) disables it (a pair of ints is accepted too).

    ``tok`` and both caches (their ``cur_len`` too) are updated in
    place. Returns (tok, cache, dcache, remaining', budget',
    new_tokens (R, B, spec_len+1), num_new (R, B), accepted (R, B),
    drafted (R, B), aux (R, L) per key, poisoned (B,)): harvest round r
    of slot b as ``new_tokens[r, b, :num_new[r, b]]``."""
    B = tok.shape[0]
    fault = _fault_operand(fault, tok.device)
    use_priors = priors.shape[-1] > 0
    poisoned = torch.zeros((B,), dtype=torch.bool, device=tok.device)
    outs = []
    for round_i in range(num_rounds):
        active = (remaining > 0) & ~poisoned
        dactive = active & spec_on
        lim = torch.minimum(torch.minimum(draft_len,
                                          (remaining - 1).clamp_min(0)),
                            budget)
        lim = torch.where(dactive, lim, 0).to(torch.int32)

        # draft spec_len tokens (one extra step writes the last KV)
        dcur = dcache["cur_len"]
        dstart = dcur.clone()
        dtok, drafts = tok, []
        for _ in range(spec_len + 1):
            dlg, _, _ = decode_step(
                dcfg, dparams, dtok[:, None], dcache,
                capacity_factor=capacity_factor, active=dactive,
                dispatch=dispatch)
            dtok = torch.where(dactive, greedy(dlg[:, -1]), dtok)
            dcur.copy_(torch.where(dactive, dcur + 1, dcur))
            drafts.append(dtok)
        drafts = torch.stack(drafts[:spec_len], dim=1)    # (B, spec_len)

        # one verify pass over (B, 1 + spec_len)
        verify_in = torch.cat([tok[:, None], drafts], dim=1)
        cur = cache["cur_len"]
        vlg, _, aux = decode_step(
            cfg, params, verify_in, cache, policy=policy,
            spec_shape=(B, 1 + spec_len), force_window=force_window,
            capacity_factor=capacity_factor, active=active,
            dispatch=dispatch,
            spec_priors=(priors * active[:, None] if use_priors else None))
        vlg = _inject(vlg, fault, round_i)
        finite = torch.isfinite(vlg).reshape(B, -1).all(dim=1)
        ok = active & finite
        poisoned = poisoned | (active & ~finite)

        res = greedy_accept(vlg, drafts, limit=lim)
        num_new = torch.where(ok, res.num_new, 0).to(torch.int32)
        # ragged rollback: both caches advance by this round's emission;
        # verify KV written above cur0 + num_new is dead and overwritten
        # by later rounds
        cur.copy_(cur + num_new)
        dcur.copy_(torch.where(dactive, dstart + num_new, dcur))
        x0 = torch.gather(res.new_tokens, 1,
                          res.accepted[:, None].long())[:, 0]
        tok.copy_(torch.where(ok, x0, tok))
        remaining = remaining - num_new
        budget = budget - torch.where(dactive, lim, 0)
        outs.append((res.new_tokens, num_new, res.accepted, lim, aux))
    new_tokens, num_new, accepted, drafted, auxs = zip(*outs)
    return (tok, cache, dcache, remaining, budget,
            torch.stack(new_tokens), torch.stack(num_new),
            torch.stack(accepted), torch.stack(drafted), stack_aux(auxs),
            poisoned)


@dataclass
class SpecStepFns:
    """Speculative-decoding functions layered on a StepFns bundle
    (serving/spec_scheduler.py drives both)."""
    dprefill: Callable   # (dparams, tokens) -> (lg, dcache, aux)
    fused: Callable      # (p, dp, tok, cache, dcache, remaining, budget,
    #                       draft_len, spec_on, priors, fault) -> 11-tuple
    spec_len: int        # max draft tokens per round
    num_rounds: int      # draft-verify rounds per dispatch


def make_spec_fused(cfg: ArchConfig, dcfg: ArchConfig, *,
                    policy: XSharePolicy = OFF,
                    spec_len: int,
                    num_rounds: int,
                    force_window: Optional[int] = None,
                    capacity_factor: float = 8.0,
                    dispatch: str = "auto") -> Callable:
    """One draft-verify loop closure (split out, like make_fused, so the
    degradation ladder can make tightened-policy variants)."""
    def fused(p, dp, tok, c, dc, rem, bud, dl, so, pri, fault=NO_FAULT):
        return spec_steps_fused(
            cfg, p, dcfg, dp, tok, c, dc, rem, bud, dl, so, pri,
            num_rounds=num_rounds, spec_len=spec_len, policy=policy,
            force_window=force_window, capacity_factor=capacity_factor,
            dispatch=dispatch, fault=fault)
    return fused


def build_spec_fns(cfg: ArchConfig, dcfg: ArchConfig, *,
                   policy: XSharePolicy = OFF,
                   spec_len: int,
                   num_rounds: int = 4,
                   cache_len: int = 512,
                   force_window: Optional[int] = None,
                   capacity_factor: float = 8.0,
                   dispatch: str = "auto") -> SpecStepFns:
    """The speculative bundle for one (target, draft) pair. ``policy``
    must already be spec-compatible (mode "off" or "spec"; the Engine
    maps other modes to OFF for the verify pass)."""
    def dpre(p, t):
        return prefill(dcfg, p, t, cache_len=cache_len,
                       capacity_factor=capacity_factor)

    return SpecStepFns(
        dprefill=dpre,
        fused=make_spec_fused(cfg, dcfg, policy=policy, spec_len=spec_len,
                              num_rounds=num_rounds,
                              force_window=force_window,
                              capacity_factor=capacity_factor,
                              dispatch=dispatch),
        spec_len=spec_len, num_rounds=num_rounds)
