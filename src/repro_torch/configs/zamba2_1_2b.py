"""Zamba2 1.2B — hybrid: Mamba2 backbone with a SHARED attention block
applied periodically (weights shared across applications). [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    d_ff=8192,                   # shared attn block's MLP
    vocab_size=32000,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=64,
                    rope_theta=10000.0),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=128),
    attn_every=6,                # shared attn block every 6 mamba layers
    shared_attn=True,
    citation="arXiv:2411.15242 (Zamba2 suite: Mamba2 + shared attention)",
)
