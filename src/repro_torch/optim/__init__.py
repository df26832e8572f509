"""AdamW, a cosine schedule and global-norm clipping over the nested
parameter dict (the JAX package's ``repro.optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule,
)
