"""Basic blocks: norms and MLPs, as plain functions on tensors. Stacked
layer parameters carry a leading (L, ...) axis that model.py indexes."""
from __future__ import annotations

from typing import Dict

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
