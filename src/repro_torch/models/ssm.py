"""Mamba2 (SSD, state-space duality) block. [arXiv:2405.21060]

A full sequence runs the chunked SSD scan (``kernels.ssd_scan``: the
hand-written kernel on a CUDA tensor, its plain version on a CPU one);
decode runs the O(1) recurrence over a ((conv_x, conv_B, conv_C),
state) cache, in plain PyTorch. Projections are separate matrices (z, x,
B, C, dt) in the JAX package's layouts.

These functions return new cache tensors; ``models/model.py`` copies
them into the stacked decode cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ssd_scan
from repro_torch.models.layers import rms_norm


def dims(ssm: SSMConfig, d_model: int):
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    d_bc = ssm.n_groups * ssm.d_state
    return d_inner, n_heads, d_bc


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) for every x (``jax.nn.softplus``; ``F.softplus``
    switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU, summed in u's dtype in tap order
    (as the JAX package does; ``F.conv1d`` sums in another order and
    precision). u: (B, S, C); w: (K, C); init_state: (B, K-1, C)
    pre-conv context of a previous segment (None: zeros)."""
    K, S = w.shape[0], u.shape[1]
    if init_state is None:
        pad = u.new_zeros((u.shape[0], K - 1) + tuple(u.shape[2:]))
    else:
        pad = init_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = up[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + up[:, i:i + S] * w[i]
    return F.silu(out + b)


def _conv_tail(u: torch.Tensor, K: int,
               init_state: Optional[torch.Tensor]) -> torch.Tensor:
    """Last K-1 pre-conv inputs (the next segment's init_state)."""
    if init_state is None:
        pad = u.new_zeros((u.shape[0], K - 1) + tuple(u.shape[2:]))
    else:
        pad = init_state.to(u.dtype)
    return torch.cat([pad, u], dim=1)[:, -(K - 1):]


def ssm_forward(p: Dict, x: torch.Tensor, ssm: SSMConfig, d_model: int,
                eps: float, *,
                init_conv: Optional[Tuple] = None,
                init_state: Optional[torch.Tensor] = None):
    """Full-sequence Mamba2 block. x: (B, S, d) -> (y (B, S, d), cache),
    cache = ((conv_x, conv_B, conv_C) pre-conv tails, ssm state)."""
    Bsz, S, _ = x.shape
    d_inner, nh, _ = dims(ssm, d_model)
    K = ssm.d_conv
    z = x @ p["in_z"]
    xr = x @ p["in_x"]
    Br = x @ p["in_B"]
    Cr = x @ p["in_C"]
    dt_raw = x @ p["in_dt"]
    ic = init_conv or (None, None, None)
    xc = _causal_conv(xr, p["conv_x_w"], p["conv_x_b"], ic[0])
    Bc = _causal_conv(Br, p["conv_B_w"], p["conv_B_b"], ic[1])
    Cc = _causal_conv(Cr, p["conv_C_w"], p["conv_C_b"], ic[2])
    xh = xc.reshape(Bsz, S, nh, ssm.head_dim)
    Bm = Bc.reshape(Bsz, S, ssm.n_groups, ssm.d_state)
    Cm = Cc.reshape(Bsz, S, ssm.n_groups, ssm.d_state)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final_state = ssd_scan(xh, dt, A, Bm, Cm, chunk=ssm.chunk_size,
                              init_state=init_state)
    y = y + (p["D"][None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(Bsz, S, d_inner)
    y = rms_norm(y * F.silu(z), p["norm_w"], eps)
    out = y @ p["out_proj"]
    conv_cache = (_conv_tail(xr, K, ic[0]), _conv_tail(Br, K, ic[1]),
                  _conv_tail(Cr, K, ic[2]))
    return out, (conv_cache, final_state)


def ssm_decode(p: Dict, x_t: torch.Tensor, cache, ssm: SSMConfig,
               d_model: int, eps: float):
    """One-token recurrence. x_t: (B, d);
    cache = ((conv_x, conv_B, conv_C), ssm state). Returns (y (B, d),
    new cache)."""
    (cx, cB, cC), state = cache
    Bsz = x_t.shape[0]
    d_inner, nh, _ = dims(ssm, d_model)
    z = x_t @ p["in_z"]
    xr = x_t @ p["in_x"]
    Br = x_t @ p["in_B"]
    Cr = x_t @ p["in_C"]
    dt_raw = x_t @ p["in_dt"]

    def conv1(st, new, w, b):
        # in f32, cast back (as the JAX package's decode conv does)
        win = torch.cat([st, new[:, None].to(st.dtype)], dim=1)  # (B,K,C)
        out = F.silu(torch.einsum("bkc,kc->bc", win.float(), w.float())
                     + b).to(x_t.dtype)
        return out, win[:, 1:]

    xc, cx = conv1(cx, xr, p["conv_x_w"], p["conv_x_b"])
    Bc, cB = conv1(cB, Br, p["conv_B_w"], p["conv_B_b"])
    Cc, cC = conv1(cC, Cr, p["conv_C_w"], p["conv_C_b"])

    xh = xc.reshape(Bsz, nh, ssm.head_dim).float()
    rep = nh // ssm.n_groups
    Bm = Bc.reshape(Bsz, ssm.n_groups, ssm.d_state).float() \
        .repeat_interleave(rep, dim=1)                         # (B,nh,ds)
    Cm = Cc.reshape(Bsz, ssm.n_groups, ssm.d_state).float() \
        .repeat_interleave(rep, dim=1)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                     # (B,nh)
    new_state = (state.float() * dA[:, :, None, None]
                 + torch.einsum("bh,bhp,bhs->bhps", dt, xh, Bm))
    y = torch.einsum("bhs,bhps->bhp", Cm, new_state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(Bsz, d_inner).to(x_t.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], eps)
    out = y @ p["out_proj"]
    return out, ((cx, cB, cC), new_state.to(state.dtype))
