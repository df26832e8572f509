"""Sort-based grouped expert dispatch — the capacity-free MoE path.

  1. flatten the (T, k) token-expert pairs and sort them by expert id
     (stable: within an expert, tokens keep batch order, so a capacity
     clamp keeps the first tokens);
  2. per-expert counts and an exclusive cumsum give segment offsets;
     each segment is padded to a multiple of block_t so every row tile
     belongs to one expert;
  3. gather the token rows into that layout and run the grouped FFN
     (``kernels.grouped_ffn``: the CUDA kernel on the GPU, the tile-
     gather einsum on the CPU);
  4. combine each token's rows back with its gate weights.

Every shape is static (P and block_t are Python ints from N, E and the
budget), so the plan is built on the device without a host sync. The
JAX package drops out-of-range scatter indices (mode="drop"); torch
raises on them, so each such scatter writes into a buffer one row or
column longer and cuts the spare off.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import grouped_ffn


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_block_t(num_pairs: int, num_experts: int) -> int:
    """Row-tile size: about half the mean segment length, a power of
    two in [8, 256]."""
    target = max(8, num_pairs // (2 * num_experts))
    bt = 8
    while bt * 2 <= min(target, 256):
        bt *= 2
    return bt


class DispatchPlan(NamedTuple):
    """Static-shape sorted-dispatch layout for one (T, k, E) routing."""
    order: torch.Tensor       # (N,) argsort of pairs by expert id
    s_tok: torch.Tensor       # (N,) token index of each sorted pair
    s_w: torch.Tensor         # (N,) gate weight (0 for dropped pairs)
    dest: torch.Tensor        # (N,) padded-row index (P => dropped)
    counts: torch.Tensor      # (E,) real per-expert segment sizes
    tile_eid: torch.Tensor    # (P/block_t,) owning expert per row tile
    tile_valid: torch.Tensor  # (P/block_t,) 1 = tile holds real rows
    block_t: int
    padded_rows: int          # P


def dispatch_plan(idx: torch.Tensor, w: torch.Tensor, num_experts: int, *,
                  block_t: Optional[int] = None,
                  capacity: Optional[int] = None,
                  max_active: Optional[int] = None) -> DispatchPlan:
    """Build the sorted grouped-dispatch layout. idx/w: (T, k); pairs with
    idx == -1 or w == 0 are dropped. capacity clamps each expert's rows
    (first tokens kept); max_active bounds the occupied experts (the
    XShare budget) and so the padded buffer."""
    T, k = idx.shape
    E = num_experts
    N = T * k
    dev = idx.device
    bt = default_block_t(N, E) if block_t is None else block_t
    occ_bound = min(E, N) if max_active is None else min(max_active, E, N)
    P = _round_up(N + occ_bound * (bt - 1), bt)
    num_tiles = P // bt

    flat_e = idx.reshape(N).to(torch.int32)
    flat_w = w.reshape(N).float()
    tok = torch.arange(N, dtype=torch.int32, device=dev) // k
    live = (flat_e >= 0) & (flat_e < E) & (flat_w != 0.0)
    key = torch.where(live, flat_e, E)        # sentinel E sorts last

    order = torch.argsort(key, stable=True)
    s_e = key[order]
    s_w = torch.where(live[order], flat_w[order], 0.0)
    s_tok = tok[order]

    raw_counts = torch.zeros(E + 1, dtype=torch.int32, device=dev)
    raw_counts.scatter_add_(0, key.long(), torch.ones_like(key))
    raw_counts = raw_counts[:E]
    counts = raw_counts if capacity is None else \
        raw_counts.clamp(max=capacity)
    raw_start = torch.cumsum(raw_counts, 0, dtype=torch.int32) - raw_counts
    e_clip = s_e.clamp(0, E - 1).long()
    rank = torch.arange(N, dtype=torch.int32, device=dev) - raw_start[e_clip]
    kept = (s_e < E) & (rank < counts[e_clip])
    s_w = torch.where(kept, s_w, 0.0)

    pad_counts = ((counts + bt - 1) // bt) * bt
    pad_end = torch.cumsum(pad_counts, 0, dtype=torch.int32)
    pad_start = pad_end - pad_counts
    dest = torch.where(kept, pad_start[e_clip] + rank, P).to(torch.int32)

    tile_start = torch.arange(num_tiles, dtype=torch.int32, device=dev) * bt
    owner = torch.searchsorted(pad_end, tile_start, right=True)
    owner = owner.to(torch.int32)
    tile_valid = (owner < E).to(torch.int32)
    # tail tiles point at the first occupied expert, so a kernel that
    # reads weights for them never touches an unrouted expert
    fallback = torch.where(owner[0] < E, owner[0], 0)
    tile_eid = torch.where(owner < E, owner, fallback).to(torch.int32)
    return DispatchPlan(order=order, s_tok=s_tok, s_w=s_w, dest=dest,
                        counts=counts, tile_eid=tile_eid,
                        tile_valid=tile_valid, block_t=bt, padded_rows=P)


def gather_tokens(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """x: (T, d) -> (P, d) expert-contiguous padded rows, zeros in the
    padding (FFN(0) = 0, so padding never reaches the combine)."""
    P = plan.padded_rows
    xs = torch.zeros((P + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    xs[plan.dest.long()] = x[plan.s_tok.long()]
    return xs[:P]


def grouped_ffn_apply(xs: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """The grouped FFN over a plan's layout: the CUDA kernel for CUDA
    tensors, its plain version (the tile-gather einsum) for CPU ones."""
    return grouped_ffn(xs, w1, w3, w2, plan.tile_eid, plan.tile_valid,
                       block_t=plan.block_t)


def combine_scatter(ys: torch.Tensor, plan: DispatchPlan, num_tokens: int,
                    out_dtype, top_k: int) -> torch.Tensor:
    """y[t] = sum over t's kept pairs of gate_w * FFN_e(x[t]).

    Each sorted row goes back to its (token, slot) cell by the inverse of
    the sort — a permutation, so no two writes collide — and the k slots
    of a token are summed in slot order. No atomics: the result does not
    depend on scheduling."""
    P = plan.padded_rows
    rows = ys[plan.dest.clamp(max=P - 1).long()].float()     # (N, d)
    contrib = plan.s_w[:, None] * rows
    per_pair = torch.empty_like(contrib)
    per_pair[plan.order] = contrib
    y = per_pair.reshape(num_tokens, top_k, -1).sum(dim=1)
    return y.to(out_dtype)


def group_token_loads(counts: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Token-assignment rows landing on each contiguous expert group,
    groups ceil(E/G) wide with the trailing one(s) narrower."""
    E = counts.shape[0]
    per = -(-E // num_groups)
    pad = torch.zeros(num_groups * per - E, dtype=counts.dtype,
                      device=counts.device)
    return torch.cat([counts, pad]).reshape(num_groups, per).sum(-1)


def sorted_expert_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      *, block_t: Optional[int] = None,
                      capacity: Optional[int] = None,
                      max_active: Optional[int] = None) -> torch.Tensor:
    """Full sorted pipeline: plan -> gather -> grouped FFN -> combine."""
    T = x.shape[0]
    E = w1.shape[0]
    plan = dispatch_plan(idx, w, E, block_t=block_t, capacity=capacity,
                         max_active=max_active)
    ys = grouped_ffn_apply(gather_tokens(x, plan), w1, w3, w2, plan)
    return combine_scatter(ys, plan, T, x.dtype, idx.shape[1])
