"""Public wrappers around the port's kernels, with the JAX package's
names and positional arguments (``repro.kernels.ops``), plus the
byte-traffic models the roofline and the benchmarks use.

Each wrapper is the kernel's own wrapper: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel (which counts the launch),
anything else raises. The reference's arguments that only choose a
Pallas tile have no meaning for the CUDA kernels, which pick their own
tiling, and are left out: ``block_f`` (xshare_moe_ffn,
xshare_grouped_ffn), ``block_s`` (flash_decode), ``block_h``
(ssd_chunk_scan), and ``interpret`` everywhere.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.kernels.moe_ffn import grouped_ffn, moe_ffn
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["xshare_moe_ffn", "xshare_grouped_ffn", "flash_decode",
           "ssd_chunk_scan", "moe_step_bytes", "dispatch_einsum_bytes",
           "dispatch_sorted_bytes"]


def xshare_moe_ffn(x, w1, w3, w2, combine, active, *,
                   max_active: Optional[int] = None):
    """Masked expert FFN over the selected experts; on the card only
    their weights are read. max_active (None: E, and at most E) must
    bound active.sum()."""
    E = w1.shape[0]
    ma = E if max_active is None else min(max_active, E)
    return moe_ffn(x, w1, w3, w2, combine, active, max_active=ma)


def xshare_grouped_ffn(xs, w1, w3, w2, tile_eid, tile_valid, *,
                       block_t: int):
    """Grouped expert FFN over an expert-sorted, tile-padded row layout
    (``models.dispatch.dispatch_plan`` builds it): weight traffic scales
    with the occupied experts, compute with the routed rows."""
    return grouped_ffn(xs, w1, w3, w2, tile_eid, tile_valid,
                       block_t=block_t)


def flash_decode(q, k, v, lengths):
    """q (B, H, dh) against k, v (B, S, Hkv, dh) masked to lengths (B,):
    (B, H, dh)."""
    return decode_attention(q, k, v, lengths)


def ssd_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Mamba2's chunked SSD scan: (y (B, S, nh, hd), final state (B, nh,
    hd, ds) f32)."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def moe_step_bytes(num_active: float, d_model: int, d_ff: int,
                   dtype_bytes: int = 2, *, tokens: int = 0,
                   top_k: int = 0) -> float:
    """Bytes moved per MoE layer per decode step under XShare.

    Expert weights dominate in the decode regime (the paper's premise):
    3 * d * f per expert, fetched once per step for each *activated*
    expert; activations add 2*T*d + routed intermediate traffic.
    """
    w = num_active * 3 * d_model * d_ff * dtype_bytes
    act = tokens * d_model * dtype_bytes * (2 + 2 * top_k)
    return w + act


def dispatch_einsum_bytes(tokens: int, num_experts: int, capacity: int,
                          d_model: int, dtype_bytes: int = 4,
                          groups: int = 1) -> float:
    """Peak dispatch-intermediate footprint of the GShard einsum path:
    the (G, t, E, C) dispatch + combine one-hots and the (G, E, C, d)
    gathered/expert-output activations — all scale with E * C whether
    or not an expert is routed."""
    t = tokens // groups
    onehots = 2 * groups * t * num_experts * capacity * dtype_bytes
    expert_act = 2 * groups * num_experts * capacity * d_model * dtype_bytes
    return onehots + expert_act


def dispatch_sorted_bytes(tokens: int, top_k: int, num_experts: int,
                          d_model: int, dtype_bytes: int = 4,
                          block_t: int = 128,
                          max_active: Optional[int] = None) -> float:
    """Peak dispatch-intermediate footprint of the sorted grouped path:
    the (P, d) gathered rows + (P, d) expert outputs where
    P = T*k (+ tile padding per occupied expert), plus the (N,)-sized
    sort/offset vectors. Scales with routed pairs, not E * C.

    Weight traffic is left out on both sides: the grouped kernel streams
    each occupied expert's weight tiles once, and the einsum path reads
    each expert's weights once too."""
    n = tokens * top_k
    occ = min(num_experts, n) if max_active is None else max_active
    p = n + occ * (block_t - 1)
    rows = 2 * p * d_model * dtype_bytes
    vecs = 5 * n * 4
    return rows + vecs
