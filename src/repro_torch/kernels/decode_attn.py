"""Flash-decode GQA attention kernel (``csrc/decode_attn.cuh``) and its
plain PyTorch versions.

Two entry points reach the one kernel:

  decode_attention         one query per row masked to ``lengths`` — the
                           Pallas kernel's contract;
  decode_attention_cached  T queries per row at positions cur_len + t
                           against a full or rolling-window cache — the
                           contract of ``models.attention.cached_attention``
                           (a decode step, T = 1, or a verify pass,
                           T = 1 + L_s).

A CPU tensor goes to the plain version, a CUDA tensor to the kernel;
``decode_attention.launches`` counts the kernel's launches from either.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_HEAD_DIMS = (32, 64, 80, 128, 256)   # csrc/decode_attn_dh*.cu
_MAX_TILE = 8     # queries of one KV head the kernel holds in registers
_BLOCKS_PER_SM = 16      # the most split blocks per SM a full cache gives
_NEG = -1e30


@functools.lru_cache(maxsize=None)
def block_step(dh: int, dtype_code: int) -> int:
    """Positions a split block walks per step at head dim ``dh`` in the
    dtype of ``build.dtype_code``: the unit of a span. The kernel library
    owns the lane geometry behind it (csrc/decode_attn.cu
    ``decode_attention_step``) and refuses a span of other units."""
    return build.lib().decode_attention_step(dh, dtype_code)


def split_plan(B: int, S: int, Hkv: int, step: int, sms: int) -> tuple:
    """(n_split, span): the kernel cuts the S positions a row's queries
    can see (a full cache's slots, or a window's positions) into n_split
    spans of ``span`` positions, one block per (span, KV head, row) — B
    counts rows times query tiles. A span is a whole number of the
    block's ``step`` positions (``block_step``), as short as keeps the
    grid under ``_BLOCKS_PER_SM`` blocks per SM when every position is
    live. It reads shapes only, never the positions, so choosing it
    needs no host sync."""
    steps = -(-S // step)
    most = max(1, _BLOCKS_PER_SM * sms // (B * Hkv))   # splits allowed
    span = -(-steps // min(steps, most)) * step
    return -(-S // span), span


def query_tiles(T: int, rep: int) -> tuple:
    """(queries per tile, tiles): the T * rep queries of one KV head cut
    into as few tiles of at most ``_MAX_TILE`` as will do, evenly."""
    n = T * rep
    n_qt = -(-n // _MAX_TILE)
    return -(-n // n_qt), n_qt


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One query per row against a KV cache masked to ``lengths`` (the
    JAX package's ``ref.decode_attn_ref``), in f32. Masked positions get
    probability exactly 0 and the normalizer a 1e-30 floor, so a row of
    length 0 gives zeros — as the Pallas kernel does.

    q: (B, H, dh); k, v: (B, S, Hkv, dh); lengths: (B,)."""
    B, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", qf, kf) / math.sqrt(dh)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, :]        # (B,1,S)
    s = torch.where(mask, s, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    out = torch.einsum("bhs,bshd->bhd", p, vf)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def decode_attention_cached_plain(q: torch.Tensor, cache_k: torch.Tensor,
                                  cache_v: torch.Tensor, cur_len, *,
                                  window: Optional[int] = None,
                                  start_pos: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The JAX package's ``cached_attention`` (models/attention.py:276):
    q cast to the cache's dtype, scores in that dtype, softmax in f32,
    the output in q's dtype; a 1-byte (float8) cache is dequantized to
    bf16 for each use, as the reference does.

    q: (B, T, H, dh) for the tokens written at [cur_len, cur_len+T);
    cache_k/v: (B, C, Hkv, dh); cur_len a scalar or (B,). A full cache
    holds position c in slot c; a rolling window cache holds in slot c
    the latest position p < cur_len+T with p % C == c. start_pos, shaped
    to broadcast against (B, T, C), masks positions before it. Returns
    (B, T, H, dh)."""
    B, T, H, dh = q.shape
    C, Hkv = cache_k.shape[1], cache_k.shape[2]
    cur_b = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1) \
        .expand(B, 1)
    rep = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    if cache_k.element_size() < 2:
        cache_k = cache_k.to(torch.bfloat16)
        cache_v = cache_v.to(torch.bfloat16)
    qg = q.reshape(B, T, Hkv, rep, dh).to(cache_k.dtype)
    s = torch.einsum("btgrd,bcgd->bgrtc", qg, cache_k)
    s = s.float().reshape(B, H, T, C) * scale
    slot = torch.arange(C, device=q.device)[None, None, :]
    q_pos = (cur_b + torch.arange(T, device=q.device)[None, :])[..., None]
    if window is None:
        slot_pos = slot.expand(B, T, C)
    else:
        slot_pos = q_pos - torch.remainder(q_pos - slot, C)
    mask = (slot_pos <= q_pos) & (slot_pos >= 0)
    if window is not None:
        mask &= slot_pos > q_pos - window
    if start_pos is not None:
        mask &= slot_pos >= torch.as_tensor(start_pos, device=q.device)
    s = torch.where(mask[:, None], s, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask[:, None]
    pg = p.reshape(B, Hkv, rep, T, C).to(cache_v.dtype)
    out = torch.einsum("bgrtc,bcgd->btgrd", pg, cache_v)
    out = out.float().reshape(B, T, H, dh)
    denom = p.sum(-1)[..., None].transpose(1, 2)
    return (out / denom.clamp_min(1e-30)).to(q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cur: torch.Tensor, window: Optional[int],
            shift: int) -> torch.Tensor:
    """The kernel on q (B, T, H, dh): query t of row b at position
    cur[b] + shift + t, seeing the last ``window`` positions (None: the
    whole cache)."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, T, H, dh = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, C, Hkv, dh) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % Hkv or dh not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: H={H}, Hkv={Hkv}, dh={dh} "
                         f"not supported (dh in {_HEAD_DIMS})")
    if T > C:
        raise ValueError(f"decode_attention: {T} queries > cache {C}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("decode_attention: q, k, v must share a dtype")
    cur = cur.to(device=q.device, dtype=torch.int32).contiguous()
    if cur.shape != (B,):
        raise ValueError(f"decode_attention: positions of shape "
                         f"{tuple(cur.shape)}, want ({B},)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} not 16-byte "
                             f"aligned")
    # 0: a full cache, whose C slots the queries see; a window sees
    # window + T - 1 positions, each in slot position mod C
    win = 0 if window is None else min(window, C)
    nq, n_qt = query_tiles(T, H // Hkv)
    code = build.dtype_code(q)
    n_split, span = split_plan(B * n_qt, win + T - 1 if win else C, Hkv,
                               block_step(dh, code),
                               _sm_count(q.device.index or 0))
    part = torch.empty(n_split * B * T * H * (dh + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    build.check(build.lib().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cur.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, C, T, H, Hkv, dh, win, shift,
        nq, n_qt, n_split, span, 1.0 / math.sqrt(dh), code,
        build.stream_ptr(q.device)), "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Flash-decode attention, one query per row. q: (B, H, dh); k, v:
    (B, S, Hkv, dh); lengths: (B,) live cache length per row. Returns
    (B, H, dh)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.ndim != 3:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, want "
                         f"(B, H, dh)")
    # query 0 at position lengths - 1 sees slots [0, lengths)
    return _launch(q[:, None], k, v, lengths, None, -1)[:, 0]


def decode_attention_cached(q: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, cur_len: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """Flash-decode attention under ``cached_attention``'s contract: q
    (B, T, H, dh) for the tokens just written at [cur_len, cur_len + T)
    of the cache (B, C, Hkv, dh); cur_len (B,); a rolling-window cache
    when ``window`` is set. Returns (B, T, H, dh) in q's dtype.

    A cache of another dtype than q's is read as the reference reads it:
    q is cast to the cache's dtype (on the card too), and the output
    cast back. The card has no instance for a 1-byte (float8) cache and
    refuses it; ``models.model.init_cache`` refuses such a cache on the
    card before it is made."""
    if q.device.type == "cpu":
        return decode_attention_cached_plain(q, cache_k, cache_v, cur_len,
                                             window=window)
    if cache_k.element_size() < 2:
        raise ValueError(f"decode_attention: no {cache_k.dtype} (e4m3) "
                         f"instance for a 1-byte cache on the card")
    if q.dtype != cache_k.dtype:
        return _launch(q.to(cache_k.dtype), cache_k, cache_v, cur_len,
                       window, 0).to(q.dtype)
    return _launch(q, cache_k, cache_v, cur_len, window, 0)


decode_attention.launches = 0
