"""PyTorch / CUDA port of the XShare serving stack, for NVIDIA Hopper.

The module layout mirrors the JAX package ``repro`` (configs, core,
models, kernels, serving) so each module's counterpart is easy to find.
Parameters and caches keep the JAX package's layouts (``x @ W`` with W of
shape (d, f), layers stacked on a leading L axis, KV caches of shape
(L, B, C, Hkv, dh) with a per-slot ``cur_len``), so weights cross over by
path key with no transposes (``repro_torch.bridge``).

Entry points (``Engine``, ``Scheduler``, ``init_params``) run on the GPU
unless the caller passes ``device="cpu"``; with no CUDA device they raise.
"""
from repro_torch.device import resolve_device  # noqa: F401
