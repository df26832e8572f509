"""GPT-OSS 120B proxy — the paper's primary eval model: 128 routed experts,
top-4. Structure per the gpt-oss model card [arXiv:2508.10925]; used by the
paper-table benchmarks (reduced in smoke tests)."""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="gpt-oss-120b-proxy",
    family="moe",
    num_layers=36,
    d_model=2880,
    d_ff=0,
    vocab_size=201088,
    attn=AttnConfig(num_heads=64, num_kv_heads=8, head_dim=64,
                    rope_theta=150000.0),
    moe=MoEConfig(num_experts=128, top_k=4, d_ff_expert=2880,
                  normalize_gates=True),
    moe_every=1,
    citation="arXiv:2508.10925 (gpt-oss model card); paper eval model",
)
