"""Granite-3.0 1B-A400M MoE — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    d_ff=0,
    vocab_size=49155,
    attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=64,
                    rope_theta=10000.0),
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                  normalize_gates=True),
    moe_every=1,
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base (model card)",
)
