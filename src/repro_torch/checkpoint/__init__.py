from repro_torch.checkpoint.ckpt import (  # noqa: F401
    load_checkpoint, restore_checkpoint, save_checkpoint,
)
