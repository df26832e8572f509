"""Model composition: embed -> decoder blocks -> head, for the dense,
MoE, SSM (Mamba2) and hybrid (Zamba2) families (the VLM and audio
families are not ported). The hybrid applies one weight-shared
attention + MLP block before each group of ``attn_every`` SSM layers.

Parameters are the JAX package's nested dict with the same keys and
layouts; layer parameters are stacked on a leading L axis and the
layers run as a Python loop over it. ``Model`` is the ``nn.Module`` that
owns such a tree (device placement, ``.to``); the functions below take
the tree itself.

  forward      full sequence, no cache
  prefill      full sequence, builds the decode cache
  decode_step  T new tokens per row against the cache

Cache writes (decode_step, insert_request, evict_slot) update the cache
tensors in place — KV rows, conv tails and SSM states; the JAX package
returns new arrays; in place saves a copy of the whole cache per step —
and return the cache dict. As in the JAX package, a decode step advances
the SSM state of every row, inactive ones included; insert_request
overwrites a row whole before it is reused.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs.base import ArchConfig, XSharePolicy
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.layers import mlp_apply, rms_norm
from repro_torch.models.moe import OFF, moe_apply

WINDOW_MARGIN = 512   # rolling-cache slack, as in the JAX package

_FAMILIES = ("dense", "moe", "ssm", "hybrid")
_SSM_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (have {_FAMILIES})")


def params_to(params: Dict, device) -> Dict:
    """The parameter tree on ``device`` (leaves already there are kept)."""
    return {k: params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def layer_params(layers: Dict, i: int) -> Dict:
    """Layer i's parameters (views into the stacked (L, ...) tensors)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def stack_aux(auxs) -> Dict:
    """Per-layer (or per-step) aux dicts -> one dict of stacked tensors."""
    auxs = [a for a in auxs if a]
    if not auxs:
        return {}
    return {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}


class Model(nn.Module):
    """Owns a parameter tree in the reference layouts as frozen
    parameters; ``params`` gives the nested dict back (same tensors)."""

    def __init__(self, cfg: ArchConfig, params: Dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self._keys = list(flatten(params))
        for key, t in flatten(params).items():
            self.register_parameter(key.replace("/", "__"),
                                    nn.Parameter(t, requires_grad=False))

    @property
    def params(self) -> Dict:
        return unflatten({k: getattr(self, k.replace("/", "__"))
                          for k in self._keys})

    def forward(self, tokens: torch.Tensor, **kw):
        return forward(self.cfg, self.params, tokens, **kw)


# ---------------------------------------------------------- embed / head --

def embed_tokens(cfg: ArchConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    _check_family(cfg)
    return params["embed"][tokens.long()]


def lm_head_apply(cfg: ArchConfig, params: Dict,
                  x: torch.Tensor) -> torch.Tensor:
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ table
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ------------------------------------------------------------ block fns ---

def _ffn_block(cfg: ArchConfig, lp: Dict, x: torch.Tensor,
               policy: XSharePolicy, spec_shape, capacity,
               capacity_factor: float,
               token_mask: Optional[torch.Tensor] = None,
               dispatch: str = "auto",
               spec_priors: Optional[torch.Tensor] = None):
    if cfg.family == "moe":
        h = rms_norm(x, lp["moe_norm"], cfg.norm_eps)
        y, aux = moe_apply(lp["moe"], h, cfg.moe, policy,
                           spec_shape=spec_shape, capacity=capacity,
                           capacity_factor=capacity_factor,
                           token_mask=token_mask, dispatch=dispatch,
                           spec_priors=spec_priors)
        return x + y, aux
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg.act), {}


def _shared_attn_block(cfg: ArchConfig, sp: Dict, x: torch.Tensor,
                       positions: torch.Tensor, window: Optional[int],
                       cache=None, cur_len=None):
    """The hybrid family's weight-shared attention + MLP block. Full
    sequence when ``cache`` is None, else against the (ck, cv) cache,
    written in place. Returns (x, k, v)."""
    B, T = x.shape[:2]
    h = rms_norm(x, sp["attn_norm"], cfg.norm_eps)
    q, k, v = A.qkv_project(sp["attn"], h, positions, cfg.attn, cfg.norm_eps)
    if cache is None:
        a = A.flash_attention(q, k, v, causal=True, window=window)
    else:
        ck, cv = cache
        A.update_cache(ck, k, cur_len, window=window)
        A.update_cache(cv, v, cur_len, window=window)
        a = A.cached_attention(q, ck, cv, cur_len, window=window)
    x = x + a.reshape(B, T, -1) @ sp["attn"]["wo"]
    h = rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(sp["mlp"], h, cfg.act), k, v


def _num_shared_apps(cfg: ArchConfig) -> int:
    return -(-cfg.num_layers // cfg.attn_every) if cfg.attn_every else 0


def _ssm_segments(cfg: ArchConfig):
    """(shared-block application or None, first layer, end layer) in
    order: one segment of all layers for the SSM family; for the hybrid,
    application g before layers g·ae .. min((g+1)·ae, L)."""
    if cfg.family == "ssm":
        return [(None, 0, cfg.num_layers)]
    ae = cfg.attn_every
    return [(g, g * ae, min((g + 1) * ae, cfg.num_layers))
            for g in range(_num_shared_apps(cfg))]


def _ssm_layer(cfg: ArchConfig, params: Dict, i: int, x: torch.Tensor):
    """Pre-norm SSM layer i over a full sequence: (x + y, layer cache)."""
    lp = layer_params(params["layers"], i)
    hn = rms_norm(x, lp["norm"], cfg.norm_eps)
    y, cache = S.ssm_forward(lp["ssm"], hn, cfg.ssm, cfg.d_model,
                             cfg.norm_eps)
    return x + y, cache


def _ssm_decode_multi(cfg: ArchConfig, lp: Dict, h: torch.Tensor,
                      conv, state):
    """h: (B, T, d) -> (B, T, d), the recurrence stepped over T."""
    ys = []
    for t in range(h.shape[1]):
        y, (conv, state) = S.ssm_decode(lp, h[:, t], (conv, state),
                                        cfg.ssm, cfg.d_model, cfg.norm_eps)
        ys.append(y)
    return torch.stack(ys, dim=1), conv, state


def effective_window(cfg: ArchConfig, *,
                     force_window: Optional[int] = None) -> Optional[int]:
    if force_window is not None:
        return force_window
    return cfg.attn.sliding_window if cfg.attn else None


# -------------------------------------------------------------- forward ---

def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            policy: XSharePolicy = OFF,
            spec_shape: Optional[Tuple[int, int]] = None,
            window: Optional[int] = None,
            capacity: Optional[int] = None,
            capacity_factor: float = 1.25,
            dispatch: str = "auto"):
    """Full-sequence forward. Returns (logits over all positions, aux)."""
    x = embed_tokens(cfg, params, tokens)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    win = window if window is not None else effective_window(cfg)
    auxs = []
    if cfg.family in _SSM_FAMILIES:
        for g, lo, hi in _ssm_segments(cfg):
            if g is not None:
                x, _, _ = _shared_attn_block(cfg, params["shared_attn"], x,
                                             positions, win)
            for i in range(lo, hi):
                x, _ = _ssm_layer(cfg, params, i, x)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return lm_head_apply(cfg, params, x), {}
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = A.qkv_project(lp["attn"], h, positions, cfg.attn,
                                cfg.norm_eps)
        a = A.flash_attention(q, k, v, causal=True, window=win)
        x = x + a.reshape(B, T, -1) @ lp["attn"]["wo"]
        x, aux = _ffn_block(cfg, lp, x, policy, spec_shape, capacity,
                            capacity_factor, dispatch=dispatch)
        auxs.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_head_apply(cfg, params, x), stack_aux(auxs)


# ---------------------------------------------------------------- cache ---

def check_cache_dtype(dtype, device) -> None:
    """Refuse, before anything is allocated, a 1-byte (float8) cache on
    the card: decode_attention has no e4m3 instance to read it. The CPU
    reads one through the plain version, dequantized per use as the JAX
    package does."""
    if dtype is not None and device is not None \
            and torch.device(device).type == "cuda" and dtype.itemsize < 2:
        raise ValueError(
            f"a {dtype} KV cache cannot be read on the card: "
            f"decode_attention has no e4m3 (1-byte) instance")


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
               force_window: Optional[int] = None,
               device=None) -> Dict:
    """Decode cache: per-slot ``cur_len`` (batch,); for the dense and MoE
    families KV of shape (L, batch, C, Hkv, dh), C = cache_len (or
    window + margin); for the SSM and hybrid families the conv tails
    ``conv_x`` / ``conv_B`` / ``conv_C`` (L, batch, K-1, ·) and the f32
    ``state`` (L, batch, nh, hd, ds); for the hybrid also the shared
    block's ``shared_k`` / ``shared_v`` (apps, batch, C, Hkv, dh). A
    1-byte dtype on the card raises (check_cache_dtype)."""
    _check_family(cfg)
    check_cache_dtype(dtype, device)
    win = effective_window(cfg, force_window=force_window)
    C = (win + WINDOW_MARGIN) if win is not None else cache_len
    L = cfg.num_layers
    cache = {"cur_len": torch.zeros((batch,), dtype=torch.int32,
                                    device=device)}

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    a = cfg.attn
    if cfg.family in _SSM_FAMILIES:
        d_inner, nh, d_bc = S.dims(cfg.ssm, cfg.d_model)
        K = cfg.ssm.d_conv
        cache["conv_x"] = zeros(L, batch, K - 1, d_inner)
        cache["conv_B"] = zeros(L, batch, K - 1, d_bc)
        cache["conv_C"] = zeros(L, batch, K - 1, d_bc)
        cache["state"] = zeros(L, batch, nh, cfg.ssm.head_dim,
                               cfg.ssm.d_state, dt=torch.float32)
        if cfg.family == "hybrid":
            apps = _num_shared_apps(cfg)
            cache["shared_k"] = zeros(apps, batch, C, a.num_kv_heads,
                                      a.head_dim)
            cache["shared_v"] = zeros(apps, batch, C, a.num_kv_heads,
                                      a.head_dim)
        return cache
    cache["kv_k"] = zeros(L, batch, C, a.num_kv_heads, a.head_dim)
    cache["kv_v"] = zeros(L, batch, C, a.num_kv_heads, a.head_dim)
    return cache


def insert_request(cache: Dict, req_cache: Dict, slot: int,
                   src: int = 0) -> Dict:
    """Copy row ``src`` of a prefilled cache into row ``slot`` of the
    running cache, whole sequence extent included (in place)."""
    for k, v in cache.items():
        if k == "cur_len":
            v[slot] = req_cache[k][src].to(v.dtype)
        else:
            v[:, slot] = req_cache[k][:, src].to(v.dtype)
    return cache


def evict_slot(cache: Dict, slot: int, *, scrub: bool = False) -> Dict:
    """Mark row ``slot`` free (cur_len = 0, in place). scrub=True also
    zeroes the row in every cache tensor (numerics quarantine)."""
    for k, v in cache.items():
        if k == "cur_len":
            v[slot] = 0
        elif scrub:
            v[:, slot] = 0
    return cache


# -------------------------------------------------------------- prefill ---

def _build_cache_slice(k: torch.Tensor, C: int,
                       win: Optional[int]) -> torch.Tensor:
    """Full-sequence kv (B, S, Hkv, dh) -> a cache buffer (B, C, ...)."""
    B, Ss = k.shape[0], k.shape[1]
    buf = torch.zeros((B, C) + tuple(k.shape[2:]), dtype=k.dtype,
                      device=k.device)
    if win is None:
        if Ss > C:
            raise ValueError(f"prompt length {Ss} exceeds cache {C}")
        buf[:, :Ss] = k
        return buf
    n = min(Ss, C)
    slots = torch.arange(Ss - n, Ss, device=k.device) % C
    buf[:, slots] = k[:, Ss - n:]
    return buf


def prefill(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            cache_len: int,
            policy: XSharePolicy = OFF,
            force_window: Optional[int] = None,
            cache_dtype=None,
            capacity_factor: float = 1.25,
            dispatch: str = "auto"):
    """Process the prompt and build the decode cache. tokens: (B, S);
    cache_dtype defaults to the activations' (a 1-byte one raises on the
    card, before any work). Returns (last-position logits (B, V), cache,
    aux)."""
    check_cache_dtype(cache_dtype, tokens.device)
    x = embed_tokens(cfg, params, tokens)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    win = effective_window(cfg, force_window=force_window)
    C = (win + WINDOW_MARGIN) if win is not None else cache_len
    cdt = cache_dtype or x.dtype
    cache = init_cache(cfg, B, cache_len, cdt, force_window=force_window,
                       device=x.device)
    cache["cur_len"].fill_(T)
    if cfg.family in _SSM_FAMILIES:
        for g, lo, hi in _ssm_segments(cfg):
            if g is not None:
                x, k, v = _shared_attn_block(cfg, params["shared_attn"], x,
                                             positions, win)
                cache["shared_k"][g] = _build_cache_slice(k, C, win).to(cdt)
                cache["shared_v"][g] = _build_cache_slice(v, C, win).to(cdt)
            for i in range(lo, hi):
                x, ((cx, cB, cC), state) = _ssm_layer(cfg, params, i, x)
                cache["conv_x"][i] = cx.to(cdt)
                cache["conv_B"][i] = cB.to(cdt)
                cache["conv_C"][i] = cC.to(cdt)
                cache["state"][i] = state
        x_last = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return lm_head_apply(cfg, params, x_last)[:, 0], cache, {}
    auxs = []
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        hn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = A.qkv_project(lp["attn"], hn, positions, cfg.attn,
                                cfg.norm_eps)
        a = A.flash_attention(q, k, v, causal=True, window=win)
        x = x + a.reshape(B, T, -1) @ lp["attn"]["wo"]
        x, aux = _ffn_block(cfg, lp, x, policy, None, None,
                            capacity_factor, dispatch=dispatch)
        auxs.append(aux)
        cache["kv_k"][i] = _build_cache_slice(k, C, win).to(cdt)
        cache["kv_v"][i] = _build_cache_slice(v, C, win).to(cdt)
    x_last = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = lm_head_apply(cfg, params, x_last)[:, 0]
    return logits, cache, stack_aux(auxs)


# ---------------------------------------------------------------- decode --

def decode_step(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                cache: Dict, *,
                policy: XSharePolicy = OFF,
                spec_shape: Optional[Tuple[int, int]] = None,
                force_window: Optional[int] = None,
                capacity_factor: float = 2.0,
                active: Optional[torch.Tensor] = None,
                dispatch: str = "auto",
                spec_priors: Optional[torch.Tensor] = None):
    """T new tokens per row against the cache. tokens: (B, T).

    active: optional (B,) bool compute mask — False rows are left out of
    MoE routing and its aux metrics; their logits are garbage the caller
    ignores.

    Returns (logits (B, T, V), cache with cur_len advanced by T, aux);
    the KV, conv and state tensors are updated in place."""
    x = embed_tokens(cfg, params, tokens)
    B, T = x.shape[:2]
    cur = cache["cur_len"]
    positions = cur.reshape(-1, 1) + torch.arange(T, device=x.device)[None]
    win = effective_window(cfg, force_window=force_window)
    token_mask = None if active is None else active[:, None].expand(B, T)
    auxs = []
    if cfg.family in _SSM_FAMILIES:
        for g, lo, hi in _ssm_segments(cfg):
            if g is not None:
                x, _, _ = _shared_attn_block(
                    cfg, params["shared_attn"], x, positions, win,
                    cache=(cache["shared_k"][g], cache["shared_v"][g]),
                    cur_len=cur)
            for i in range(lo, hi):
                lp = layer_params(params["layers"], i)
                conv = (cache["conv_x"][i], cache["conv_B"][i],
                        cache["conv_C"][i])
                h = rms_norm(x, lp["norm"], cfg.norm_eps)
                y, conv, state = _ssm_decode_multi(cfg, lp["ssm"], h, conv,
                                                   cache["state"][i])
                x = x + y
                cache["conv_x"][i] = conv[0]
                cache["conv_B"][i] = conv[1]
                cache["conv_C"][i] = conv[2]
                cache["state"][i] = state
    else:
        for i in range(cfg.num_layers):
            lp = layer_params(params["layers"], i)
            ck, cv = cache["kv_k"][i], cache["kv_v"][i]
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            q, k, v = A.qkv_project(lp["attn"], h, positions, cfg.attn,
                                    cfg.norm_eps)
            A.update_cache(ck, k, cur, window=win)
            A.update_cache(cv, v, cur, window=win)
            a = A.cached_attention(q, ck, cv, cur, window=win)
            x = x + a.reshape(B, T, -1) @ lp["attn"]["wo"]
            x, aux = _ffn_block(cfg, lp, x, policy, spec_shape, None,
                                capacity_factor, token_mask, dispatch,
                                spec_priors)
            auxs.append(aux)
    new_cache = dict(cache)
    new_cache["cur_len"] = cur + T
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_head_apply(cfg, params, x), new_cache, stack_aux(auxs)
