"""Router / gating primitives shared by the MoE layer and the selection
algorithms.

``topk`` breaks ties toward the lower index, as ``jax.lax.top_k`` does;
``torch.topk`` promises no order among equal values, so it is a stable
descending sort, sliced.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def router_probs(x: torch.Tensor, w_g: torch.Tensor,
                 bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full gating distribution softmax(x W_g) over all experts. x:
    (T, d), w_g: (d, E). Returns (logits, probs), each (T, E) in f32:
    routing is decided in full precision."""
    logits = x.float() @ w_g.float()
    if bias is not None:
        logits = logits + bias
    return logits, torch.softmax(logits, dim=-1)


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis;
    equal values come out lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_route(logits: torch.Tensor, k: int, *, normalize: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vanilla per-token top-k routing: (indices, gate weights), each
    (T, k). Weights are a softmax over the selected logits when
    normalize, else the full distribution's probabilities there."""
    top_l, idx = topk(logits, k)
    if normalize:
        w = torch.softmax(top_l, dim=-1)
    else:
        w = torch.gather(torch.softmax(logits, dim=-1), -1, idx)
    return idx, w


def combine_matrix(idx: torch.Tensor, w: torch.Tensor,
                   num_experts: int) -> torch.Tensor:
    """(T, E) gate weight per token-expert cell from sparse (T, k)
    routing. idx == -1 (a masked slot) contributes nothing: it goes to a
    spare column that is cut off (torch's one_hot rejects -1)."""
    T = idx.shape[0]
    col = torch.where(idx < 0, num_experts, idx).long()
    out = torch.zeros((T, num_experts + 1), dtype=w.dtype, device=w.device)
    out.scatter_add_(1, col, w)
    return out[:, :num_experts]


def dispatch_combine_weights(idx: torch.Tensor, w: torch.Tensor,
                             num_experts: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style dense tensors from sparse (T, k) routing: (dispatch
    (T, E) bool, True where a token goes to an expert; combine (T, E),
    its gate weight there and 0 elsewhere)."""
    combine = combine_matrix(idx, w, num_experts)
    return combine > 0, combine
