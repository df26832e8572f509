"""Mamba2 370M — attention-free SSD state-space model. [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,                      # attention-free, no dense MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    citation="arXiv:2405.21060 (Transformers are SSMs / Mamba2 SSD)",
)
