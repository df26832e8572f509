"""Qwen3-MoE 235B-A22B — 128-expert top-8 MoE, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B family card]"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    d_ff=0,                      # every FFN is MoE
    vocab_size=151936,
    attn=AttnConfig(num_heads=64, num_kv_heads=4, head_dim=128,
                    rope_theta=1000000.0, qk_norm=True),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536,
                  normalize_gates=True),
    moe_every=1,
    citation="hf:Qwen/Qwen3-30B-A3B (Qwen3 MoE model card)",
)
