"""Architecture / shape configuration dataclasses.

Every assigned architecture gets one module in this package exporting
``CONFIG: ArchConfig``; ``registry.py`` collects them under their public
``--arch`` ids.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    qk_norm: bool = False


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0  # DeepSeek-style always-on experts
    d_ff_shared: int = 0
    router_bias: bool = False
    # router softmax over the selected set (Mixtral/DSv3 style)
    normalize_gates: bool = True


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int              # dense-MLP hidden size (0 for attn-free / pure-MoE FFN)
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: apply the shared attention block every `attn_every` ssm layers
    attn_every: int = 0
    shared_attn: bool = False
    # moe: apply MoE FFN every `moe_every` layers (1 = every layer)
    moe_every: int = 1
    # modality frontend stubs (vlm/audio): length of precomputed
    # frame/patch embeddings prepended to the token sequence at prefill
    prefix_len: int = 0
    # audio: number of parallel codebook streams (embeddings summed,
    # one LM head per codebook)
    num_codebooks: int = 1
    act: str = "swiglu"    # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    citation: str = ""

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def has_moe(self) -> bool:
        return self.moe is not None

    @property
    def has_attention(self) -> bool:
        return self.attn is not None

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length == num_layers.

        dense/vlm/audio -> ('attn_mlp',)*L ; moe -> attn + MoE FFN;
        ssm -> ('ssm',)*L ; hybrid -> ssm with a shared attn block
        applied every `attn_every` layers (weights shared).
        """
        if self.family in ("dense", "vlm", "audio"):
            return ("attn_mlp",) * self.num_layers
        if self.family == "moe":
            kinds = []
            for i in range(self.num_layers):
                kinds.append("attn_moe" if (i % self.moe_every == 0) else "attn_mlp")
            return tuple(kinds)
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.family == "hybrid":
            return ("ssm",) * self.num_layers  # shared attn handled in-model
        raise ValueError(f"unknown family {self.family}")

    def reduced(self, *, num_layers: int = 2, max_d_model: int = 512,
                max_experts: int = 4, max_vocab: int = 1024) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        d_model = min(self.d_model, max_d_model)
        changes = dict(
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            d_ff=min(self.d_ff, 2 * d_model) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, max_vocab),
            prefix_len=min(self.prefix_len, 8),
        )
        if self.attn is not None:
            heads = max(2, min(self.attn.num_heads, d_model // 64))
            kv = max(1, min(self.attn.num_kv_heads, heads))
            while heads % kv:
                kv -= 1
            changes["attn"] = dataclasses.replace(
                self.attn, num_heads=heads, num_kv_heads=kv,
                head_dim=d_model // heads,
                sliding_window=(64 if self.attn.sliding_window else None))
        if self.moe is not None:
            ne = min(self.moe.num_experts, max_experts)
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=ne, top_k=min(self.moe.top_k, max(1, ne // 2)),
                d_ff_expert=min(self.moe.d_ff_expert, d_model),
                d_ff_shared=min(self.moe.d_ff_shared, d_model))
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16), head_dim=32,
                chunk_size=32)
        if self.attn_every:
            changes["attn_every"] = min(self.attn_every, num_layers)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    # decode: size of the KV/rolling cache backing each sequence
    cache_len: int = 0
    # speculative decoding verify width (tokens per request incl. base)
    spec_len: int = 0


@dataclass(frozen=True)
class EPConfig:
    """Expert-parallel execution knobs (ep/ package).

    num_shards:   EP mesh width (devices on the "model" axis).
    replicate_hot: hottest experts replicated this many ways; their
                  rows split across replicas by token-id modulus.
    max_replicas: per-expert replica cap (None = num_shards).
    rebalance_hysteresis: between-batch placement moves are adopted
                  only when the predicted peak load improves by more
                  than this relative fraction — weight redistribution
                  isn't free, so placement must not thrash.
    max_rows:     per-peer payload rows for the ragged all-to-all.
                  None = worst case (always exact); "auto" = counts
                  exchange first, pad to the per-round max (pow2
                  bucketed); int = hard clamp with GShard drop
                  semantics.
    block_t:      row-tile size of the per-shard grouped GEMM
                  (None = heuristic from dispatch.default_block_t).
    """
    num_shards: int = 8
    replicate_hot: int = 0
    max_replicas: Optional[int] = None
    rebalance_hysteresis: float = 0.1
    max_rows: object = None  # None | "auto" | int
    block_t: Optional[int] = None


@dataclass(frozen=True)
class XSharePolicy:
    """Inference-time batch-aware expert-selection policy (the paper).

    mode:
      off        - vanilla per-token top-k routing
      batch      - Algorithm 2 (warm-up k0, batch budget m_l, refinement)
      spec       - Algorithm 4 (per-request budget m_r, then batch greedy)
      ep         - Algorithm 6 (per-device-group budget m_g)
    Budgets follow the paper's convention: the final set is
    warmup ∪ top-m(extra), so m counts experts added *beyond* warm-up.
    """
    mode: str = "off"
    k0: int = 1          # warm-up per-token top-k0
    m_l: int = 0         # batch budget (experts added beyond warm-up)
    m_r: int = 0         # per-request budget (spec mode)
    m_g: int = 0         # per-device-group budget (ep mode)
    num_groups: int = 8  # EP group count G
    strict_cap: bool = True  # ep: cap warm-up experts at m_g per group too
    # spec: weight of the cross-pass correlation prior (per-request gate
    # histograms collected by the scheduler) blended into Algorithm-4
    # selection scores; 0 disables the prior entirely.
    corr: float = 1.0
