"""Mistral-NeMo 12B — dense GQA decoder, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=1000000.0),
    citation="hf:mistralai/Mistral-Nemo-Base-2407 (model card)",
)
