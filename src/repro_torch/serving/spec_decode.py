"""Speculative decoding: draft-then-verify with per-request (ragged)
acceptance under greedy matching.

Verification feeds the target model (1 + L_s) tokens per request — the
batch shape XShare's Algorithm 4 selects experts for — and the accepted
prefix plus one bonus token advance each row by its own count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SpecResult(NamedTuple):
    accepted: torch.Tensor    # (B,) number of accepted draft tokens
    new_tokens: torch.Tensor  # (B, L_s+1) accepted drafts + bonus, padded
    num_new: torch.Tensor     # (B,) == accepted + 1


def rollback_cur_len(cur_len: torch.Tensor,
                     res: SpecResult) -> torch.Tensor:
    """Ragged cache rollback after verification: each row advances by
    its own emitted count (the per-slot cur_len is the whole cache
    state; verify KV above it is dead and overwritten later)."""
    return cur_len + res.num_new


def greedy_accept(verify_logits: torch.Tensor, drafts: torch.Tensor,
                  limit: Optional[torch.Tensor] = None) -> SpecResult:
    """verify_logits: (B, 1+L_s, V) target logits for inputs
    [x0, d_1..d_Ls]; drafts: (B, L_s).

    Position i's logits predict the token after [x0, d_1..d_i], so draft
    d_{i+1} is accepted iff it equals argmax(logits[:, i]) (the lower
    index on ties) and every earlier draft was accepted. One bonus token
    (the target's own pick at the first mismatch or after the last
    draft) is always emitted.

    limit: optional (B,) per-row cap on the draft positions considered;
    limit 0 makes the row plain greedy decode (accepted 0, bonus =
    argmax(logits[:, 0]))."""
    B, T, _ = verify_logits.shape
    Ls = T - 1
    t_hat = torch.argmax(verify_logits, dim=-1).to(torch.int32)  # (B, T)
    match = drafts.to(torch.int32) == t_hat[:, :Ls]
    if limit is not None:
        match = match & (torch.arange(Ls, device=match.device)[None, :]
                         < limit.to(match.device)[:, None])
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    accepted = accepted.to(torch.int32)
    bonus = torch.gather(t_hat, 1, accepted[:, None].long())[:, 0]
    # new_tokens[b] = d_1..d_n, bonus, then bonus repeated as padding
    # (masked by num_new downstream)
    pos = torch.arange(Ls + 1, device=match.device)[None, :]
    padded = torch.cat([drafts.to(torch.int32),
                        torch.zeros((B, 1), dtype=torch.int32,
                                    device=drafts.device)], dim=1)
    new_tokens = torch.where(pos < accepted[:, None], padded,
                             bonus[:, None])
    return SpecResult(accepted=accepted, new_tokens=new_tokens,
                      num_new=accepted + 1)
