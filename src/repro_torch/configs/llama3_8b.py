"""Llama-3 8B — dense GQA decoder, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=500000.0),
    citation="arXiv:2407.21783 (The Llama 3 Herd of Models)",
)
