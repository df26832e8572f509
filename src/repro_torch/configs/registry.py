"""Architecture registry — maps public ``--arch`` ids to configs."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from repro_torch.configs import (
    llama3_8b,
    mamba2_370m,
    h2o_danube_1_8b,
    granite_3_8b,
    qwen3_moe_235b_a22b,
    mistral_nemo_12b,
    granite_moe_1b_a400m,
    zamba2_1_2b,
    paligemma_3b,
    musicgen_large,
    gpt_oss_120b_proxy,
    deepseek_r1_proxy,
)

# The 10 assigned architectures (dry-run matrix = these x 4 shapes).
ASSIGNED = (
    llama3_8b.CONFIG,
    mamba2_370m.CONFIG,
    h2o_danube_1_8b.CONFIG,
    granite_3_8b.CONFIG,
    qwen3_moe_235b_a22b.CONFIG,
    mistral_nemo_12b.CONFIG,
    granite_moe_1b_a400m.CONFIG,
    zamba2_1_2b.CONFIG,
    paligemma_3b.CONFIG,
    musicgen_large.CONFIG,
)

# The paper's own eval models (used by benchmarks; not in the dry-run matrix).
PAPER_MODELS = (
    gpt_oss_120b_proxy.CONFIG,
    deepseek_r1_proxy.CONFIG,
)

ARCHS = {c.name: c for c in ASSIGNED + PAPER_MODELS}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


def assigned_names():
    return [c.name for c in ASSIGNED]
