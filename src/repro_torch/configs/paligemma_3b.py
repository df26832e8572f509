"""PaliGemma 3B — gemma decoder backbone consuming SigLIP patch embeddings.
The SigLIP vision tower + projector are STUBBED per assignment: input_specs
provides precomputed patch embeddings (prefix_len x d_model).
[arXiv:2407.07726]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257216,
    attn=AttnConfig(num_heads=8, num_kv_heads=1, head_dim=256,
                    rope_theta=10000.0),
    prefix_len=256,              # 256 SigLIP patch embeddings (224px/14)
    act="gelu",
    tie_embeddings=True,
    citation="arXiv:2407.07726 (PaliGemma); SigLIP frontend stubbed",
)
