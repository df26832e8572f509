"""Weights across the boundary: the JAX parameter pytree <-> the port's.

Both sides hold the same nested dict with the same path keys
(``layers/moe/w1``, the keys of the JAX package's npz checkpoints) and
the same layouts, so conversion is a per-leaf copy with no transposes.
numpy has no bfloat16 of its own, so a bf16 leaf crosses as an f32
upcast and is cast back on arrival (what the JAX checkpoint writer does).

``init_params`` is the port's own initializer: same keys, shapes and
dtypes as the JAX package's ``init_params``, drawn from a
``torch.Generator`` (the numbers differ from ``jax.random``'s — parity
tests initialize in JAX and convert).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device

_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> {"a/b/c": leaf}."""
    out: Dict[str, object] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping[str, object]) -> Dict:
    """{"a/b/c": leaf} -> nested dict."""
    out: Dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _is_bf16(arr: np.ndarray) -> bool:
    return str(arr.dtype) == "bfloat16"


def from_numpy(tree: Mapping, *, dtypes: Optional[Mapping[str, str]] = None,
               device: DeviceLike = None) -> Dict:
    """Nested dict of numpy arrays -> nested dict of torch tensors.

    A bfloat16 leaf (the JAX arrays' own dtype) arrives as bf16. A
    float32 leaf listed as "bfloat16" in ``dtypes`` (the JSON sidecar of
    a JAX checkpoint, keyed by path) is the stored upcast and is cast
    back to bf16.
    """
    dev = resolve_device(device)
    flat = {}
    for key, arr in flatten(tree).items():
        arr = np.asarray(arr)
        want_bf16 = _is_bf16(arr) or (dtypes or {}).get(key) == "bfloat16"
        if _is_bf16(arr):
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True))
        if want_bf16:
            t = t.to(torch.bfloat16)
        flat[key] = t.to(dev)
    return unflatten(flat)


def to_numpy(params: Mapping) -> Dict:
    """Nested dict of torch tensors -> nested dict of numpy arrays, bf16
    leaves upcast to float32 (the checkpoint convention)."""
    flat = {}
    for key, t in flatten(params).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat[key] = t.numpy()
    return unflatten(flat)


def dtypes_of(params: Mapping) -> Dict[str, str]:
    """{path: dtype name} in the JAX checkpoint sidecar's spelling."""
    return {k: str(t.dtype).replace("torch.", "")
            for k, t in flatten(params).items()}


# ----------------------------------------------------------------- init ---

def init_params(cfg: ArchConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random parameters with the JAX package's keys, shapes and dtypes:
    N(0, 0.02) matrices (N(0, 0.1) conv taps), unit norm weights, zero
    conv biases, an f32 router, and the SSM's A_log = 0, D = 1 and
    dt_bias = 0 in f32 whatever the model's dtype."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (have {_FAMILIES})")
    dev = resolve_device(device)
    g = generator
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)

    def dense(shape, dt=dtype, scale=0.02):
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (scale * w).to(dt)

    def ones(shape, dt=dtype):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, device=dev, dtype=dt)

    def attn_params(pre):
        a = cfg.attn
        H, Hkv, dh = a.num_heads, a.num_kv_heads, a.head_dim
        p = {"wq": dense(pre + (d, H * dh)), "wk": dense(pre + (d, Hkv * dh)),
             "wv": dense(pre + (d, Hkv * dh)), "wo": dense(pre + (H * dh, d))}
        if a.qk_norm:
            p["q_norm"] = ones(pre + (dh,))
            p["k_norm"] = ones(pre + (dh,))
        return p

    def mlp_params(pre):
        p = {"w1": dense(pre + (d, cfg.d_ff)), "w2": dense(pre + (cfg.d_ff, d))}
        if cfg.act == "swiglu":
            p["w3"] = dense(pre + (d, cfg.d_ff))
        return p

    L, d, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner = s.expand * d
        nh, d_bc, K = d_inner // s.head_dim, s.n_groups * s.d_state, s.d_conv
        f32 = torch.float32
        layers: Dict = {"norm": ones((L, d)), "ssm": {
            "in_z": dense((L, d, d_inner)), "in_x": dense((L, d, d_inner)),
            "in_B": dense((L, d, d_bc)), "in_C": dense((L, d, d_bc)),
            "in_dt": dense((L, d, nh)),
            "conv_x_w": dense((L, K, d_inner), scale=0.1),
            "conv_x_b": zeros((L, d_inner)),
            "conv_B_w": dense((L, K, d_bc), scale=0.1),
            "conv_B_b": zeros((L, d_bc)),
            "conv_C_w": dense((L, K, d_bc), scale=0.1),
            "conv_C_b": zeros((L, d_bc)),
            "A_log": zeros((L, nh), f32), "D": ones((L, nh), f32),
            "dt_bias": zeros((L, nh), f32),
            "norm_w": ones((L, d_inner)),
            "out_proj": dense((L, d_inner, d))}}
    else:
        layers = {"attn_norm": ones((L, d)), "attn": attn_params((L,))}
    if cfg.family == "moe":
        m = cfg.moe
        E, f = m.num_experts, m.d_ff_expert
        moe = {"wg": dense((L, d, E), torch.float32),
               "w1": dense((L, E, d, f)), "w3": dense((L, E, d, f)),
               "w2": dense((L, E, f, d))}
        if m.num_shared_experts:
            fs = m.d_ff_shared * m.num_shared_experts
            moe.update(ws1=dense((L, d, fs)), ws3=dense((L, d, fs)),
                       ws2=dense((L, fs, d)))
        layers["moe_norm"] = ones((L, d))
        layers["moe"] = moe
    elif cfg.family == "dense":
        layers["mlp_norm"] = ones((L, d))
        layers["mlp"] = mlp_params((L,))
    params = {"embed": dense((V, d)), "layers": layers}
    if cfg.family == "hybrid":
        params["shared_attn"] = {"attn_norm": ones((d,)),
                                 "attn": attn_params(()),
                                 "mlp_norm": ones((d,)),
                                 "mlp": mlp_params(())}
    params["final_norm"] = ones((d,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, V))
    return params


def param_count(params: Mapping) -> int:
    return sum(t.numel() for t in flatten(params).values())
