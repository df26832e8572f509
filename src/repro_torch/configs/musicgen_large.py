"""MusicGen-large — decoder-only transformer over EnCodec RVQ tokens,
4 parallel codebooks (delay pattern), vocab 2048 per codebook. The EnCodec
conv codec + text conditioner are STUBBED per assignment: input_specs
provides precomputed conditioning frame embeddings. [arXiv:2306.05284]"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=64,
                    rope_theta=10000.0),
    num_codebooks=4,
    prefix_len=64,               # stubbed conditioner embeddings
    act="gelu",
    vocab_pad_to=256,
    citation="arXiv:2306.05284 (Simple and Controllable Music Generation)",
)
