"""Model composition: embed -> decoder blocks -> head, for the six
families: dense, MoE, SSM (Mamba2), hybrid (Zamba2), VLM (PaliGemma's
decoder) and audio (MusicGen's). The hybrid applies one weight-shared
attention + MLP block before each group of ``attn_every`` SSM layers.
The VLM and audio families are dense decoders: ``prefix_embeds`` (B, P,
d), the stubbed image or conditioning frontend's output, go before the
embedded tokens (forward, loss_fn, prefill), and the audio family's
tokens are (B, S, K) frames of K codebooks, embedded as the sum of K
lookups and read out by one head per codebook as (B, S, K, V) logits.

Parameters are the JAX package's nested dict with the same keys and
layouts; layer parameters are stacked on a leading L axis and the
layers run as a Python loop over it. ``Model`` is the ``nn.Module`` that
owns such a tree (device placement, ``.to``); the functions below take
the tree itself.

  forward      full sequence, no cache (``_backbone`` + the head)
  loss_fn      next-token cross-entropy for training (``_backbone`` with
               per-layer remat, ``_fused_head_ce``)
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
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs.base import ArchConfig, XSharePolicy
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.layers import mlp_apply, rms_norm
from repro_torch.models.moe import OFF, moe_apply

WINDOW_MARGIN = 512   # rolling-cache slack, as in the JAX package

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_SSM_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (have {_FAMILIES})")


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
    """(B, S) tokens -> (B, S, d); audio (B, S, K) frames -> the sum of
    the K codebooks' embeddings, added in codebook order."""
    _check_family(cfg)
    tokens = tokens.long()
    if cfg.family == "audio":
        out = params["embed"][0][tokens[..., 0]]
        for k in range(1, cfg.num_codebooks):
            out = out + params["embed"][k][tokens[..., k]]
        return out
    return params["embed"][tokens]


def _embed_with_prefix(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                       prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The embedded tokens, after prefix_embeds (B, P, d) cast to their
    dtype when given."""
    x = embed_tokens(cfg, params, tokens)
    if prefix_embeds is None:
        return x
    pe = torch.as_tensor(prefix_embeds, device=x.device).to(x.dtype)
    return torch.cat([pe, x], dim=1)


def lm_head_apply(cfg: ArchConfig, params: Dict,
                  x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> logits (B, S, V), audio (B, S, K, V); the padded
    vocabulary's columns are -1e30."""
    if cfg.family == "audio":
        logits = torch.einsum("bsd,kvd->bskv", x, params["embed"]) \
            if cfg.tie_embeddings else \
            torch.einsum("bsd,kdv->bskv", x, params["lm_head"])
    else:
        table = params["embed"].T if cfg.tie_embeddings \
            else params["lm_head"]
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

def _backbone(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
              prefix_embeds: Optional[torch.Tensor] = None,
              policy: XSharePolicy = OFF,
              spec_shape: Optional[Tuple[int, int]] = None,
              remat: bool = False,
              window: Optional[int] = None,
              capacity: Optional[int] = None,
              capacity_factor: float = 1.25,
              dispatch: str = "auto"):
    """Full-sequence backbone. Returns (final-normed hidden states (B, S,
    d), aux stacked over the layers).

    window overrides the config's sliding window. remat=True runs each
    layer (each SSM layer of the hybrid; not its shared block, as in
    the JAX package) under ``torch.utils.checkpoint``: its activations
    are recomputed in the backward instead of kept. prefix_embeds (B,
    P, d), cast to the activations' dtype, go before the embedded
    tokens; the positions count them."""
    x = _embed_with_prefix(cfg, params, tokens, prefix_embeds)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    win = window if window is not None else effective_window(cfg)

    def run(layer, i, h):
        if remat:
            return checkpoint(layer, i, h, use_reentrant=False)
        return layer(i, h)

    auxs = []
    if cfg.family in _SSM_FAMILIES:
        def ssm_layer(i, h):
            return _ssm_layer(cfg, params, i, h)[0]
        for g, lo, hi in _ssm_segments(cfg):
            if g is not None:
                x, _, _ = _shared_attn_block(cfg, params["shared_attn"], x,
                                             positions, win)
            for i in range(lo, hi):
                x = run(ssm_layer, i, x)
    else:
        def layer(i, h):
            lp = layer_params(params["layers"], i)
            a = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            q, k, v = A.qkv_project(lp["attn"], a, positions, cfg.attn,
                                    cfg.norm_eps)
            a = A.flash_attention(q, k, v, causal=True, window=win)
            h = h + a.reshape(B, T, -1) @ lp["attn"]["wo"]
            return _ffn_block(cfg, lp, h, policy, spec_shape, capacity,
                              capacity_factor, dispatch=dispatch)
        for i in range(cfg.num_layers):
            x, aux = run(layer, i, x)
            auxs.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, stack_aux(auxs)


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, **kw):
    """Full-sequence forward (``_backbone``'s keywords). Returns (logits
    over all positions, aux)."""
    x, aux = _backbone(cfg, params, tokens, **kw)
    return lm_head_apply(cfg, params, x), aux


def _fused_head_ce(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                   targets: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Head projection and cross-entropy over sequence chunks of at most
    ``chunk`` positions, each chunk under ``torch.utils.checkpoint``: the
    (B, S, V) f32 logits never exist at once, forward or backward (a
    chunk's are recomputed in the backward). x: (B, S, d); targets (B,
    S), audio (B, S, K), whose NLL is averaged over the codebooks.
    Returns the mean negative log-likelihood."""
    B, Sx = x.shape[0], x.shape[1]
    c = min(chunk, Sx)

    def chunk_nll(xc, tc):
        logits = lm_head_apply(cfg, params, xc).float()  # (B, c[, K], V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
        nll = logz - gold
        if nll.ndim == 3:                                 # codebooks
            nll = nll.mean(-1)
        return nll.sum()

    total = x.new_zeros((), dtype=torch.float32)
    for lo in range(0, Sx, c):
        total = total + checkpoint(chunk_nll, x[:, lo:lo + c],
                                   targets[:, lo:lo + c], use_reentrant=False)
    return total / max(B * Sx, 1)


def loss_fn(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            policy: XSharePolicy = OFF, remat: bool = True,
            capacity_factor: float = 1.25, lb_weight: float = 0.02):
    """Mean next-token cross-entropy through the fused chunked head, plus
    lb_weight times the MoE load-balance auxiliary averaged over the
    layers. tokens: (B, S) (audio (B, S, K)); the P positions of
    prefix_embeds predict nothing. Returns (loss, aux)."""
    x, aux = _backbone(cfg, params, tokens, prefix_embeds=prefix_embeds,
                       policy=policy, remat=remat,
                       capacity_factor=capacity_factor)
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    # the hidden state at position P + i predicts tokens[:, i + 1]
    loss = _fused_head_ce(cfg, params, x[:, P:-1], tokens[:, 1:])
    if lb_weight and "lb_loss" in aux:
        loss = loss + lb_weight * aux["lb_loss"].mean()
    return loss, aux


# ---------------------------------------------------------------- cache ---

def check_cache_dtype(dtype, device) -> None:
    """Refuse, before anything is allocated, a 1-byte cache on the card
    that decode_attention has no instance for: any but
    torch.float8_e4m3fn (e5m2, integers). An e4m3 cache is read by the
    kernel's e4m3 instance on the card; the CPU reads any float8 cache
    through the plain version, dequantized per use as the JAX package
    does."""
    if dtype is not None and device is not None \
            and torch.device(device).type == "cuda" and dtype.itemsize < 2 \
            and dtype != torch.float8_e4m3fn:
        raise ValueError(
            f"a {dtype} KV cache cannot be read on the card: "
            f"decode_attention's only 1-byte instance is "
            f"torch.float8_e4m3fn")


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
               force_window: Optional[int] = None,
               device=None) -> Dict:
    """Decode cache: per-slot ``cur_len`` (batch,); for the dense, MoE,
    VLM and audio families KV of shape (L, batch, C, Hkv, dh), C = cache_len (or
    window + margin); for the SSM and hybrid families the conv tails
    ``conv_x`` / ``conv_B`` / ``conv_C`` (L, batch, K-1, ·) and the f32
    ``state`` (L, batch, nh, hd, ds); for the hybrid also the shared
    block's ``shared_k`` / ``shared_v`` (apps, batch, C, Hkv, dh). A
    1-byte dtype other than float8_e4m3fn raises on the card
    (check_cache_dtype)."""
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
            prefix_embeds: Optional[torch.Tensor] = None,
            policy: XSharePolicy = OFF,
            force_window: Optional[int] = None,
            cache_dtype=None,
            capacity_factor: float = 1.25,
            dispatch: str = "auto"):
    """Process the prompt and build the decode cache. tokens: (B, S)
    (audio (B, S, K)), after prefix_embeds (B, P, d) when given, so the
    cache holds P + S positions; cache_dtype defaults to the
    activations' (a 1-byte one other than float8_e4m3fn raises on the
    card, before any work; an e4m3 cache is written as each layer's rows
    rounded by ``.to``, round to nearest even as JAX's ``astype``).
    Returns (last-position logits (B, V) (audio (B, K, V)), cache,
    aux)."""
    check_cache_dtype(cache_dtype, tokens.device)
    x = _embed_with_prefix(cfg, params, tokens, prefix_embeds)
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
    """T new tokens per row against the cache. tokens: (B, T) (audio
    (B, T, K)).

    active: optional (B,) bool compute mask — False rows are left out of
    MoE routing and its aux metrics; their logits are garbage the caller
    ignores.

    Returns (logits (B, T, V) (audio (B, T, K, V)), cache with cur_len
    advanced by T, aux);
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
