"""H2O-Danube 1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32000,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=80,
                    rope_theta=10000.0, sliding_window=4096),
    citation="arXiv:2401.16818 (H2O-Danube-1.8B Technical Report)",
)
