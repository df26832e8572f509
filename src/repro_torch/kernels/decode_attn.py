"""Flash-decode GQA attention kernel (``csrc/decode_attn.cu``) and its
plain PyTorch version.

A CPU tensor goes to the plain version, a CUDA tensor to the kernel;
``decode_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

_HEAD_DIMS = (32, 64, 128, 256)
_MAX_GROUP = 8    # query heads per KV head the kernel holds in registers
_WARPS, _UNROLL = 4, 4   # the split kernel's NW and U (csrc/decode_attn.cu)
_BLOCKS_PER_SM = 16      # the most split blocks per SM a full cache gives


def split_plan(B: int, S: int, Hkv: int, dh: int, itemsize: int,
               sms: int) -> tuple:
    """(n_split, span): the kernel cuts each row's S positions into
    n_split spans of ``span`` positions, one block per (span, KV head,
    row). A span is a whole number of the block's steps (each lane loads
    16 bytes of a row per position, ``_UNROLL`` positions a step), as
    short as keeps the grid under ``_BLOCKS_PER_SM`` blocks per SM when
    the whole cache is live. It reads S, B and Hkv only, never the
    lengths, so choosing it needs no host sync."""
    lanes_per_row = min(32, dh * itemsize // 16)
    step = _WARPS * _UNROLL * (32 // lanes_per_row)
    steps = -(-S // step)
    most = max(1, _BLOCKS_PER_SM * sms // (B * Hkv))   # splits allowed
    span = -(-steps // min(steps, most)) * step
    return -(-S // span), span


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
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    out = torch.einsum("bhs,bshd->bhd", p, vf)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Flash-decode attention. q: (B, H, dh); k, v: (B, S, Hkv, dh);
    lengths: (B,) live cache length per row. Returns (B, H, dh)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, dh) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % Hkv or H // Hkv > _MAX_GROUP or dh not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: H={H}, Hkv={Hkv}, dh={dh} "
                         f"not supported (dh in {_HEAD_DIMS}, "
                         f"H/Hkv <= {_MAX_GROUP})")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("decode_attention: q, k, v must share a dtype")
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} not 16-byte "
                             f"aligned")
    n_split, span = split_plan(B, S, Hkv, dh, q.element_size(),
                               _sm_count(q.device.index or 0))
    part = torch.empty(n_split * B * H * (dh + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    build.check(build.lib().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, S, H, Hkv, dh, n_split, span,
        1.0 / math.sqrt(dh), build.dtype_code(q),
        build.stream_ptr(q.device)), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
