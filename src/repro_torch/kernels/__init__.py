"""Hand-written Hopper kernels of the serving path, each beside its plain
PyTorch version.

  grouped_ffn       prefill's sorted expert FFN     (csrc/grouped_ffn.cu)
  moe_ffn           a decode step's masked FFN      (csrc/moe_ffn.cu)
  decode_attention  flash-decode GQA over the cache (csrc/decode_attn.cuh)
  ssd_scan          Mamba2's chunked SSD scan       (csrc/ssd_scan.cu)

Nothing is compiled or loaded on import: the library is built at the
first launch on a CUDA tensor (``kernels/build.py``).
"""
from repro_torch.kernels.decode_attn import (  # noqa: F401
    decode_attention, decode_attention_cached, decode_attention_cached_plain,
    decode_attention_plain,
)
from repro_torch.kernels.moe_ffn import (  # noqa: F401
    grouped_ffn, grouped_ffn_plain, moe_ffn, moe_ffn_plain,
)
from repro_torch.kernels.ssd_scan import (  # noqa: F401
    ssd_scan, ssd_scan_plain,
)

KERNELS = {"grouped_ffn": grouped_ffn, "moe_ffn": moe_ffn,
           "decode_attention": decode_attention, "ssd_scan": ssd_scan}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
