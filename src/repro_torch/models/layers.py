"""Basic blocks: norms, MLPs and the cross-entropy, as plain functions on
tensors. Stacked layer parameters carry a leading (L, ...) axis that
model.py indexes."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def mlp_apply(params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (w1, w3, w2) or GELU (w1, w2) MLP. x: (..., d). GELU is the
    tanh form, which is what jax.nn.gelu computes by default."""
    h = x @ params["w1"]
    if act == "swiglu":
        h = F.silu(h) * (x @ params["w3"])
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ params["w2"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy. logits (..., V) in any float dtype,
    taken in f32; labels integer (...,); mask (...,) optional, the mean
    then over its live positions (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
