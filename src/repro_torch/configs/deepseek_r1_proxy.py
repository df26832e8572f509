"""DeepSeek-R1 proxy — the paper's EP eval model: 256 routed experts top-8
plus 1 shared expert. MLA is proxied with GQA kv=16 (documented in
DESIGN.md §3); expert structure is exact. [arXiv:2501.12948]"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-r1-proxy",
    family="moe",
    num_layers=61,
    d_model=7168,
    d_ff=0,
    vocab_size=129280,
    attn=AttnConfig(num_heads=128, num_kv_heads=16, head_dim=128,
                    rope_theta=10000.0),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, d_ff_shared=2048,
                  normalize_gates=True),
    moe_every=1,
    citation="arXiv:2501.12948 (DeepSeek-R1); paper EP eval model",
)
