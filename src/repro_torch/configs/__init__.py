from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, AttnConfig, MoEConfig, SSMConfig, ShapeConfig, XSharePolicy,
    round_up,
)
