"""Token sampling from model logits. Random draws take an explicit
``torch.Generator`` (on the logits' device) and never wait for the
device, so a decode loop that samples can be captured as a CUDA
graph."""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab axis, first index on ties. (..., V) ->
    (...,) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator], *,
           temperature: float = 1.0, top_p: float = 1.0) -> torch.Tensor:
    if temperature == 0.0:
        return greedy(logits)
    logits = logits.float() / temperature
    # a non-finite row degrades to a draw over its finite entries
    logits = torch.where(torch.isfinite(logits), logits, -1e30)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        cutoff_idx = (csum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    # torch.multinomial's own one-sample draw, argmax(p / q) with
    # q ~ Exp(1) from the generator, without its validity check, which
    # reads the probabilities back to the host (p is a softmax here)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def sample_step(logits: torch.Tensor, generator: Optional[torch.Generator],
                *, temperature: float = 0.0,
                top_p: float = 1.0) -> torch.Tensor:
    """Per-step sampler of the decode loop: greedy (no random draw) at
    temperature 0, else a draw from ``generator``."""
    if temperature == 0.0:
        return greedy(logits)
    return sample(logits, generator, temperature=temperature, top_p=top_p)
