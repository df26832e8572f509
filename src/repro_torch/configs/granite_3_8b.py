"""Granite-3.0 8B — dense GQA decoder.
[hf:ibm-granite/granite-3.0-2b-base family card]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    d_ff=12800,
    vocab_size=49155,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=10000.0),
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-2b-base (Granite 3.0 model card)",
)
