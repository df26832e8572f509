"""Roofline terms of a step on the NVIDIA H100, from closed-form FLOP
and byte counts of the model (the JAX package's
``repro.launch.roofline``, lines 95-389, with the H100's constants).

Peaks of one H100 SXM5 80GB HBM3 at its 700 W power limit, from NVIDIA's
data sheet (dense, no sparsity): 989e12 bf16 FLOP/s on the tensor cores,
67e12 f32 FLOP/s outside them, 3.35e12 bytes/s of HBM3, and 450e9
bytes/s per direction over NVLink 4 for the collective term:

  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = collective bytes / LINK_BW

The experts' model-axis extent is ``model_shards`` (``expected_selected``,
``analytic_bytes``, ``step_terms``): its default, 16, gives the
reference's figures; a one-card caller passes 1.

Left out: ``collective_bytes``, ``collective_bytes_split`` and
``_shape_bytes``, which parse XLA HLO text; the port produces none. A
caller puts its own collective bytes in the step record (the EP
executor counts its exchange in ``EPStats.a2a_bytes``).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig, XSharePolicy

PEAK_FLOPS = 989e12      # bf16 FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12   # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12         # bytes/s of HBM3
LINK_BW = 450e9          # bytes/s per direction, NVLink 4


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float) -> Dict[str, float]:
    t_c = flops / PEAK_FLOPS
    t_m = bytes_accessed / HBM_BW
    t_x = coll_bytes / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom}


# ------------------------------------------------------- model FLOPs ------

def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Analytic parameter counts: total and per-token-active (MoE)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.padded_vocab
    emb = V * d * (cfg.num_codebooks if cfg.family == "audio" else 1)
    head = 0 if cfg.tie_embeddings else emb
    per_layer_active = 0.0
    per_layer_total = 0.0
    if cfg.has_attention and cfg.family not in ("ssm", "hybrid"):
        a = cfg.attn
        attn = d * a.num_heads * a.head_dim * 2 \
            + d * a.num_kv_heads * a.head_dim * 2
        per_layer_total += attn
        per_layer_active += attn
    if cfg.family in ("ssm", "hybrid") and cfg.ssm:
        di, nh, dbc = (cfg.ssm.expand * d,
                       cfg.ssm.expand * d // cfg.ssm.head_dim,
                       cfg.ssm.n_groups * cfg.ssm.d_state)
        ssm = d * di * 2 + d * dbc * 2 + d * nh + di * d
        per_layer_total += ssm
        per_layer_active += ssm
    if cfg.has_moe:
        e = cfg.moe
        expert = 3 * d * e.d_ff_expert
        per_layer_total += e.num_experts * expert + d * e.num_experts
        per_layer_active += e.top_k * expert + d * e.num_experts
        if e.num_shared_experts:
            sh = 3 * d * e.d_ff_shared * e.num_shared_experts
            per_layer_total += sh
            per_layer_active += sh
    elif cfg.d_ff:
        mlp = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
        per_layer_total += mlp
        per_layer_active += mlp
    shared_attn = 0
    if cfg.family == "hybrid" and cfg.attn:
        a = cfg.attn
        shared_attn = d * a.num_heads * a.head_dim * 2 \
            + d * a.num_kv_heads * a.head_dim * 2 \
            + 3 * d * cfg.d_ff
    total = emb + head + L * per_layer_total + shared_attn
    active = emb + head + L * per_layer_active + shared_attn
    return {"total": total, "active": active}


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Global MODEL_FLOPS = 6*N*D (6*N_active*D for MoE), D = tokens
    processed by the step (train counts fwd+bwd via the 6x factor;
    prefill uses 2*N*D, decode 2*N_active*B)."""
    counts = param_counts(cfg)
    n = counts["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # one decode step


# ----------------------------------------------- analytic step costs ------
#
# Closed-form per-step costs from the model's structure (the trip counts
# are known by construction); a step record contributes only the
# collective bytes, whose inside-loop share is scaled by the layer trip
# count.

BYTES_W = 2          # bf16 weights/cache


def expected_selected(E: int, k: int, B_tokens: int, policy,
                      model_shards: int = 16) -> float:
    """Expected |selected expert set| per layer under a policy.

    Baseline (off): the paper's E[N_a] = E(1-(1-k/E)^B).
    batch:  warm-up E(1-(1-k0/E)^B) + m_l, capped by baseline.
    spec:   per-request warm-up/budgets union, capped similarly.
    ep:     m_g per group * model_shards groups (the model axis).
    """
    base = E * (1 - (1 - k / E) ** B_tokens)
    m = policy.mode
    if m == "off":
        return base
    if m == "batch":
        warm = E * (1 - (1 - min(policy.k0, E) / E) ** B_tokens) \
            if policy.k0 else 0.0
        return min(base, warm + policy.m_l)
    if m == "spec":
        warm = E * (1 - (1 - min(policy.k0, E) / E) ** B_tokens) \
            if policy.k0 else 0.0
        b = max(1, B_tokens // 4)
        return min(base, warm + b * policy.m_r + policy.m_l)
    if m == "ep":
        return min(base, policy.m_g * model_shards)
    return base


def bottleneck_shard_load(selected: float, shards: int, policy) -> float:
    """Expected MAX experts on one model-axis shard. EP-aware selection
    bounds it at m_g by construction; otherwise balanced-binomial mean +
    ~2 sigma imbalance."""
    if policy is not None and policy.mode == "ep":
        return float(policy.m_g)
    mean = selected / shards
    return min(mean + 2.0 * (mean ** 0.5) + 1.0, selected)


def _attn_flops(cfg, tokens: int, ctx: float) -> float:
    a = cfg.attn
    d, dh = cfg.d_model, a.head_dim
    proj = 2 * d * dh * (2 * a.num_heads + 2 * a.num_kv_heads)
    attn = 4 * ctx * a.num_heads * dh
    return tokens * (proj + attn)


def _ssm_flops(cfg, tokens: int, decode: bool) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    nh = d_inner // s.head_dim
    dbc = s.n_groups * s.d_state
    proj = 2 * d * (2 * d_inner + 2 * dbc + nh) + 2 * d_inner * d
    if decode:
        scan = nh * 4 * s.d_state * s.head_dim
    else:
        l = s.chunk_size
        scan = nh * (2 * l * s.d_state + 2 * l * s.head_dim
                     + 4 * s.d_state * s.head_dim)
    conv = 2 * s.d_conv * (d_inner + 2 * dbc)
    return tokens * (proj + scan + conv)


def _ffn_flops(cfg, tokens: int) -> float:
    d = cfg.d_model
    if cfg.has_moe:
        e = cfg.moe
        f = 2 * d * e.num_experts + 6 * d * e.d_ff_expert * e.top_k
        if e.num_shared_experts:
            f += 6 * d * e.d_ff_shared * e.num_shared_experts
        return tokens * f
    mult = 6 if cfg.act == "swiglu" else 4
    return tokens * mult * d * cfg.d_ff


def analytic_flops(cfg: ArchConfig, shape: ShapeConfig,
                   window: Optional[int] = None) -> float:
    """Global FLOPs for one step (fwd only; train multiplies below)."""
    B = shape.global_batch
    if shape.kind == "decode":
        tokens = B
        ctx = min(window, shape.cache_len) if window else shape.cache_len
    else:
        tokens = B * shape.seq_len
        eff = min(window, shape.seq_len) if window else shape.seq_len
        ctx = eff / 2                      # mean causal context
    total = 0.0
    L = cfg.num_layers
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        total += L * (_attn_flops(cfg, tokens, ctx)
                      + _ffn_flops(cfg, tokens))
    elif cfg.family == "ssm":
        total += L * _ssm_flops(cfg, tokens, shape.kind == "decode")
    elif cfg.family == "hybrid":
        total += L * _ssm_flops(cfg, tokens, shape.kind == "decode")
        n_app = -(-L // cfg.attn_every)
        total += n_app * (_attn_flops(cfg, tokens, ctx)
                          + tokens * 6 * cfg.d_model * cfg.d_ff)
    head = 2 * cfg.d_model * cfg.padded_vocab
    total += tokens * head if shape.kind != "decode" else B * head
    if shape.kind == "train":
        total *= 4.0   # bwd = 2x fwd, remat recompute = +1x fwd
    return total


def analytic_bytes(cfg: ArchConfig, shape: ShapeConfig, *,
                   window: Optional[int] = None,
                   policy=None, num_devices: int = 256,
                   cache_bytes_per_el: int = BYTES_W,
                   model_shards: int = 16) -> float:
    """Global-equivalent HBM bytes for one step.

    Decode uses BOTTLENECK-SHARD accounting for MoE expert weights (the
    paper's Sec 5 insight: the layer waits for the hottest expert
    shard), expressed as bottleneck-per-device * num_devices so the
    caller's /num_devices yields the bottleneck device's traffic. The
    experts are spread over min(model_shards, E) shards: 1 on one card.
    """
    counts = param_counts(cfg)
    B = shape.global_batch
    d = cfg.d_model
    if shape.kind == "decode":
        w_bytes = counts["total"] * BYTES_W
        if cfg.has_moe:
            e = cfg.moe
            per_exp = 3 * d * e.d_ff_expert
            pol = policy
            if pol is None:
                pol = XSharePolicy(mode="off")
            sel = expected_selected(e.num_experts, e.top_k, B, pol,
                                    model_shards)
            shards = min(model_shards, e.num_experts)
            bottleneck = bottleneck_shard_load(sel, shards, pol)
            # remove all expert weights, add bottleneck-shard load
            # scaled to a global-equivalent figure
            w_bytes -= cfg.num_layers * per_exp * e.num_experts * BYTES_W
            w_bytes += cfg.num_layers * per_exp * bottleneck * shards \
                * BYTES_W
        cache = _cache_bytes(cfg, shape, window) \
            * cache_bytes_per_el / BYTES_W
        return w_bytes + cache * (1 + 2 / max(shape.cache_len, 1)) \
            + B * d * cfg.num_layers * 8 * BYTES_W
    tokens = B * shape.seq_len
    act_traffic = tokens * d * 8 * BYTES_W * cfg.num_layers
    if cfg.has_attention and cfg.family not in ("ssm",):
        nq = max(1, shape.seq_len // 512)
        kv_stream = tokens * cfg.attn.num_kv_heads * cfg.attn.head_dim \
            * 2 * BYTES_W * min(nq, 8) * cfg.num_layers
        act_traffic += kv_stream
    w_bytes = counts["total"] * BYTES_W
    if shape.kind == "train":
        # params read fwd+bwd(+remat) + grad write + AdamW state r/w f32
        w_bytes = counts["total"] * (3 * BYTES_W + BYTES_W + 4 * 4)
        act_traffic *= 3
    return w_bytes + act_traffic


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig,
                 window: Optional[int]) -> float:
    B = shape.global_batch
    total = 0.0
    if cfg.has_attention and cfg.family not in ("ssm", "hybrid"):
        C = (window + 512) if window else shape.cache_len
        a = cfg.attn
        total += cfg.num_layers * B * C * a.num_kv_heads * a.head_dim \
            * 2 * BYTES_W
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        nh = d_inner // s.head_dim
        total += cfg.num_layers * B * nh * s.head_dim * s.d_state * 4
    if cfg.family == "hybrid":
        a = cfg.attn
        n_app = -(-cfg.num_layers // cfg.attn_every)
        total += n_app * B * shape.cache_len * a.num_kv_heads \
            * a.head_dim * 2 * BYTES_W
    return total


def step_terms(record: Dict, num_devices: int,
               cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None,
               window: Optional[int] = None,
               accum: int = 1, policy=None,
               cache_bytes_per_el: int = BYTES_W,
               model_shards: int = 16) -> Dict:
    """Assemble the roofline row of a step record ({flops_per_device,
    bytes_per_device, collective_bytes_per_device} and optionally
    collective_bytes_inside_loop / _outside_loop): analytic compute and
    memory terms, and the record's collective bytes with the inside-loop
    share scaled by the layer trip count. The row's keys are the
    reference's ("hlo_*_raw" hold the record's own figures)."""
    row: Dict = {"hlo_flops_per_device_raw": record["flops_per_device"],
                 "hlo_bytes_per_device_raw": record["bytes_per_device"]}
    if cfg is None or shape is None:
        row.update(roofline_terms(record["flops_per_device"],
                                  record["bytes_per_device"],
                                  record["collective_bytes_per_device"]))
        return row
    flops_g = analytic_flops(cfg, shape, window)
    bytes_g = analytic_bytes(cfg, shape, window=window, policy=policy,
                             num_devices=num_devices,
                             cache_bytes_per_el=cache_bytes_per_el,
                             model_shards=model_shards)
    # the inside-loop share (or, unsplit, the whole record: bytes per
    # layer call) runs num_layers times (x accum for train)
    trips = cfg.num_layers * accum
    if "collective_bytes_inside_loop" in record:
        coll = (record["collective_bytes_inside_loop"] * trips
                + record["collective_bytes_outside_loop"])
    else:
        coll = record["collective_bytes_per_device"] * trips
    terms = roofline_terms(flops_g / num_devices, bytes_g / num_devices,
                           coll)
    row.update(terms)
    row["analytic_flops_global"] = flops_g
    row["analytic_bytes_global"] = bytes_g
    row["collective_trip_correction"] = trips
    mf = model_flops(cfg, shape)
    row["model_flops"] = mf
    row["useful_ratio"] = mf / max(flops_g, 1.0)
    return row
