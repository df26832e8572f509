"""Input stand-ins per (arch x shape) on the meta device — the shapes and
dtypes of a step's inputs, with nothing allocated — plus the decisions
per combination: a forced sliding window for long-context dense decode,
and the XShare policy defaults for MoE archs (the JAX package's
``repro.launch.inputs``, whose stand-ins are ``jax.ShapeDtypeStruct``s).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, XSharePolicy
from repro_torch.models import init_cache

CACHE_MARGIN = 512      # decode-cache slack: spec verify room + shard-
                        # divisibility alignment (512 | every mesh extent)
LONG_CTX_WINDOW = 4096  # forced sliding window for full-attention archs
                        # at long_500k

META = torch.device("meta")


def force_window_for(cfg: ArchConfig, shape: ShapeConfig) -> Optional[int]:
    """long_500k on a full-attention arch => explicit windowed variant.
    (h2o-danube already has a native 4096 window; ssm/hybrid run native.)"""
    if shape.name != "long_500k" or not cfg.has_attention:
        return None
    if cfg.family == "hybrid":
        return None                   # few shared-attn caches: keep full
    if cfg.attn.sliding_window:
        return None                   # native SWA
    return LONG_CTX_WINDOW


def policy_for(cfg: ArchConfig, shape: ShapeConfig) -> XSharePolicy:
    """Paper-faithful default: XShare batch-aware selection on MoE decode
    (Alg 2, the (m_l=16, k0=1) configuration of Table 3)."""
    if cfg.has_moe and shape.kind == "decode":
        return XSharePolicy(mode="batch", k0=1, m_l=16)
    return XSharePolicy(mode="off")


def decode_cache_len(cfg: ArchConfig, shape: ShapeConfig) -> int:
    return shape.cache_len + CACHE_MARGIN


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16,
                cache_dtype: Optional[torch.dtype] = None) -> Dict:
    """{tokens, prefix_embeds?, cache?} as meta tensors: int32 tokens (B,
    S) ((B, S, K) audio; S = 1 at decode), prefix embeddings (B, P, d) in
    ``dtype``, and at decode the cache ``init_cache`` would build, in
    ``cache_dtype`` (default ``dtype``). A float8 cache is fine here:
    only the card refuses one."""
    B = shape.global_batch
    out: Dict = {}
    tok = dict(dtype=torch.int32, device=META)
    books = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    if shape.kind in ("train", "prefill"):
        S = shape.seq_len - cfg.prefix_len
        out["tokens"] = torch.empty((B, S) + books, **tok)
        if cfg.prefix_len:
            out["prefix_embeds"] = torch.empty(
                (B, cfg.prefix_len, cfg.d_model), dtype=dtype, device=META)
    else:  # decode
        out["tokens"] = torch.empty((B, 1) + books, **tok)
        out["cache"] = init_cache(
            cfg, B, decode_cache_len(cfg, shape), cache_dtype or dtype,
            force_window=force_window_for(cfg, shape), device=META)
    return out
