"""Hand-written Hopper kernels of the serving and training paths, each
beside its plain PyTorch version.

  grouped_ffn       prefill's sorted expert FFN     (csrc/grouped_ffn.cu)
  grouped_ffn_bwd   its gradient, for training      (csrc/grouped_ffn_bwd.cu)
  moe_ffn           a decode step's masked FFN      (csrc/moe_ffn.cu)
  moe_ffn_bwd       its gradient, for training      (csrc/moe_ffn_bwd.cu)
  decode_attention  flash-decode GQA over the cache (csrc/decode_attn.cuh)
  ssd_scan          Mamba2's chunked SSD scan       (csrc/ssd_scan.cu)
  ssd_scan_bwd      its gradient, for training      (csrc/ssd_scan_bwd.cu)

``kernels/ops.py`` holds the JAX package's public wrappers over these
(``xshare_moe_ffn``, ``xshare_grouped_ffn``, ``flash_decode``,
``ssd_chunk_scan``) and its byte models. Nothing is compiled or loaded
on import: the library is built at the first launch on a CUDA tensor
(``kernels/build.py``).
"""
from repro_torch.kernels.decode_attn import (  # noqa: F401
    decode_attention, decode_attention_cached, decode_attention_cached_plain,
    decode_attention_plain,
)
from repro_torch.kernels.moe_ffn import (  # noqa: F401
    GroupedFFN, MoeFFN, grouped_ffn, grouped_ffn_bwd, grouped_ffn_bwd_plain,
    grouped_ffn_plain, moe_ffn, moe_ffn_bwd, moe_ffn_bwd_plain, moe_ffn_plain,
)
from repro_torch.kernels.ssd_scan import (  # noqa: F401
    SsdScan, ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain,
)
from repro_torch.kernels.ops import (  # noqa: F401
    dispatch_einsum_bytes, dispatch_sorted_bytes, flash_decode,
    moe_step_bytes, ssd_chunk_scan, xshare_grouped_ffn, xshare_moe_ffn,
)

KERNELS = {"grouped_ffn": grouped_ffn, "moe_ffn": moe_ffn,
           "decode_attention": decode_attention, "ssd_scan": ssd_scan,
           "grouped_ffn_bwd": grouped_ffn_bwd,
           "ssd_scan_bwd": ssd_scan_bwd, "moe_ffn_bwd": moe_ffn_bwd}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
