"""Assigned input shapes (public pool)."""
from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256,
                       kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32768, global_batch=128,
                         kind="decode", cache_len=32768)
LONG_500K = ShapeConfig(name="long_500k", seq_len=524288, global_batch=1,
                        kind="decode", cache_len=524288)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
