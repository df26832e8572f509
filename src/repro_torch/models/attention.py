"""Attention: GQA + RoPE, full-sequence causal attention for prefill and
cache-based attention for decode.

``cached_attention`` sends every decode and verify step (T new tokens,
full or rolling-window cache) to the ``decode_attention`` kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.kernels.decode_attn import (decode_attention_cached,
                                             decode_attention_cached_plain)
from repro_torch.models.layers import rms_norm

_NEG = -1e30


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotary embedding in f32. x: (B, S, H, dh); positions:
    (B, S) or (S,) integer."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def qkv_project(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                attn: AttnConfig, eps: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B, S, H, dh), k / v (B, S, Hkv, dh), RoPE on
    q and k."""
    B, S, _ = x.shape
    H, Hkv, dh = attn.num_heads, attn.num_kv_heads, attn.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, dh)
    if attn.qk_norm:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    return (apply_rope(q, positions, attn.rope_theta),
            apply_rope(k, positions, attn.rope_theta), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 512) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over a full sequence,
    forward only, in f32, one chunk of queries at a time so the score
    tensor is at most (B, H, q_chunk, S).

    q: (B, S, H, dh); k, v: (B, S, Hkv, dh). Returns (B, S, H, dh)."""
    B, S, H, dh = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    col = torch.arange(S, device=q.device)
    outs = []
    for lo in range(0, S, q_chunk):
        qb = q[:, lo:lo + q_chunk].float()
        row = torch.arange(lo, lo + qb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kf) / math.sqrt(dh)
        mask = torch.ones((row.numel(), S), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= col[None, :] <= row[:, None]
        if window is not None:
            mask &= col[None, :] > row[:, None] - window
        s = torch.where(mask, s, _NEG)
        p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
        o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
        o = o / p.sum(-1).clamp_min(1e-30).transpose(1, 2)[..., None]
        outs.append(o)
    return torch.cat(outs, dim=1).to(q.dtype)


def _cur_rows(cur_len, B: int, device) -> torch.Tensor:
    cur = torch.as_tensor(cur_len, device=device)
    return cur.reshape(-1, 1).expand(B, 1) if cur.ndim \
        else torch.full((B, 1), int(cur), device=device)


def cached_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cur_len, *,
                     window: Optional[int] = None,
                     start_pos: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Score T new tokens against an (already updated) KV cache.

    q: (B, T, H, dh) for the tokens written at [cur_len, cur_len+T);
    cache_k/v: (B, C, Hkv, dh); cur_len a scalar or (B,). A full cache
    holds position c in slot c; a rolling window cache holds in slot c
    the latest position p < cur_len+T with p % C == c. Returns
    (B, T, H, dh).

    Every T and window goes to the decode_attention kernel (its plain
    version on the CPU). start_pos, which no caller passes, is computed
    on the CPU only and raises on the card.
    """
    if start_pos is not None:
        if q.device.type != "cpu":
            raise NotImplementedError(
                "cached_attention: start_pos has no kernel (the JAX "
                "package's form needs a (B, 1, 1) shape and no caller "
                "passes it)")
        return decode_attention_cached_plain(q, cache_k, cache_v, cur_len,
                                             window=window,
                                             start_pos=start_pos)
    cur = _cur_rows(cur_len, q.shape[0], q.device)[:, 0]
    return decode_attention_cached(q, cache_k, cache_v, cur, window=window)


def update_cache(cache: torch.Tensor, new: torch.Tensor, cur_len, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """Write T new per-token kv rows at positions [cur_len, cur_len+T)
    IN PLACE and return the cache. cache: (B, C, Hkv, dh); new:
    (B, T, Hkv, dh). Rolling-window caches wrap modulo C; full caches
    assume cur_len+T <= C (a row past the end is dropped, which is what
    the JAX package's select-based write does)."""
    B, T = new.shape[0], new.shape[1]
    C = cache.shape[1]
    cur_b = _cur_rows(cur_len, B, cache.device)[:, 0]
    rows = torch.arange(B, device=cache.device)
    newc = new.to(cache.dtype)
    for i in range(T):
        pos = cur_b + i
        if window is not None:
            pos = torch.remainder(pos, C)
        keep = pos < C
        # out-of-range rows are sent to their own slot 0 with its own
        # value, so the write is a no-op there
        pos_c = torch.where(keep, pos, 0)
        val = torch.where(keep[:, None, None], newc[:, i],
                          cache[rows, pos_c])
        cache[rows, pos_c] = val
    return cache
