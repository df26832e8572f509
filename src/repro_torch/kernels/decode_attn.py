"""Flash-decode GQA attention kernel (``csrc/decode_attn.cu``) and its
plain PyTorch version.

A CPU tensor goes to the plain version, a CUDA tensor to the kernel;
``decode_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

_HEAD_DIMS = (32, 64, 128, 256)
_MAX_GROUP = 8    # query heads per KV head the kernel holds in registers


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
    out = torch.empty_like(q)
    lib = build.lib()
    build.check(lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, S, H, Hkv, dh, 1.0 / math.sqrt(dh),
        build.dtype_code(q), build.stream_ptr(q.device)), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
