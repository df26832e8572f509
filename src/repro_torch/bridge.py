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

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.device import DeviceLike, resolve_device

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


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


def _host_tensor(arr, want_bf16: bool = False) -> torch.Tensor:
    """One numpy leaf as a CPU tensor; a bfloat16 leaf stays bf16."""
    arr = np.asarray(arr)
    want_bf16 = want_bf16 or _is_bf16(arr)
    if _is_bf16(arr):
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(torch.bfloat16) if want_bf16 else t


def from_numpy(tree: Mapping, *, dtypes: Optional[Mapping[str, str]] = None,
               device: DeviceLike = None) -> Dict:
    """Nested dict of numpy arrays -> nested dict of torch tensors.

    A bfloat16 leaf (the JAX arrays' own dtype) arrives as bf16. A
    float32 leaf listed as "bfloat16" in ``dtypes`` (the JSON sidecar of
    a JAX checkpoint, keyed by path) is the stored upcast and is cast
    back to bf16.
    """
    dev = resolve_device(device)
    return unflatten({
        key: _host_tensor(arr, (dtypes or {}).get(key) == "bfloat16").to(dev)
        for key, arr in flatten(tree).items()})


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


# ------------------------------------------------------- expert shards ---

EXPERT_LEAVES = ("w1", "w3", "w2")     # of a "moe" node: (..., E, ·, ·)


def is_expert_leaf(key: str) -> bool:
    """A routed experts' weight stack: ``layers/moe/w1`` and the like."""
    parts = key.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" and \
        parts[-1] in EXPERT_LEAVES


def cut_experts(params: Mapping, local_eids, *, device: DeviceLike = None,
                into: Optional[Mapping] = None) -> Dict:
    """One expert-parallel rank's parameters: every routed experts' leaf
    (``is_expert_leaf``) cut to the experts ``local_eids`` (a rank's row
    of ``Placement.local_eids``) along its expert axis (-3), -1 padding
    reading expert 0 as the JAX executor's clipped gather does; every
    other leaf whole. ``params`` is the full tree on the host or on a
    device, numpy (the JAX package's, bf16 kept) or torch; the result
    lies on ``device``, the card unless the caller names another.

    ``into``: a rank's tree whose expert leaves have the cut's shapes
    (the same expert_cap): the new cut is copied into them in place, so
    whatever holds their addresses reads the new experts, and ``into``
    is returned. A placement update calls it with the host copy."""
    dev = resolve_device(device)
    eids = np.asarray(local_eids, np.int64)
    out = {}
    for key, leaf in flatten(params).items():
        if not is_expert_leaf(key):
            if into is None:
                out[key] = leaf.to(dev) if isinstance(leaf, torch.Tensor) \
                    else _host_tensor(leaf).to(dev)
            continue
        E = leaf.shape[-3]
        sel = np.clip(eids, 0, E - 1)
        if isinstance(leaf, torch.Tensor):
            cut = leaf.index_select(-3, torch.as_tensor(sel,
                                                        device=leaf.device))
        else:
            cut = _host_tensor(np.take(np.asarray(leaf), sel, axis=-3))
        out[key] = cut.to(dev)
    if into is None:
        return unflatten(out)
    dst = flatten(into)
    for key, cut in out.items():
        if dst[key].shape != cut.shape:
            raise ValueError(
                f"cut_experts(into=): {key} holds {tuple(dst[key].shape)}, "
                f"the cut is {tuple(cut.shape)} (another expert_cap: build "
                f"the rank's tree anew)")
        dst[key].copy_(cut)
    return into


# ----------------------------------------------------------------- init ---

def dense_sampler(seed: int, dtype: torch.dtype, device: DeviceLike,
                  generator: Optional[torch.Generator]):
    """(device, dense): ``dense(shape, dt=dtype, scale=0.02)`` draws
    N(0, scale) from ``generator`` (a new one seeded with ``seed`` when
    None) in place into a new tensor of dtype dt, so no leaf is ever
    held in a second dtype beside it (8 layers of gpt-oss-120b-proxy's
    stacked experts are one 17 GB bf16 leaf). On the meta device, which
    has no generator, it gives an empty tensor of the shape and dtype:
    a tree of meta tensors is the parameters' shapes and nothing else
    (``launch/dryrun.py`` traces a step over it)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        def empty(shape, dt=dtype, scale=0.02):
            return torch.empty(shape, dtype=dt, device=dev)
        return dev, empty
    g = generator
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)

    def dense(shape, dt=dtype, scale=0.02):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            0.0, scale, generator=g)
    return dev, dense


def moe_params(moe: MoEConfig, d_model: int, dense, pre: tuple = ()) -> Dict:
    """One MoE layer's leaves, stacked on ``pre``: the f32 router ``wg``
    (d, E), the experts' w1 / w3 (E, d, f) and w2 (E, f, d), and the
    shared experts' ws1 / ws3 / ws2 when the config has them."""
    E, f = moe.num_experts, moe.d_ff_expert
    d = d_model
    p = {"wg": dense(pre + (d, E), torch.float32),
         "w1": dense(pre + (E, d, f)), "w3": dense(pre + (E, d, f)),
         "w2": dense(pre + (E, f, d))}
    if moe.num_shared_experts:
        fs = moe.d_ff_shared * moe.num_shared_experts
        p.update(ws1=dense(pre + (d, fs)), ws3=dense(pre + (d, fs)),
                 ws2=dense(pre + (fs, d)))
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random parameters with the JAX package's keys, shapes and dtypes:
    N(0, 0.02) matrices (N(0, 0.1) conv taps), unit norm weights, zero
    conv biases, an f32 router, and the SSM's A_log = 0, D = 1 and
    dt_bias = 0 in f32 whatever the model's dtype. The audio family has
    one embedding table and one head per codebook: ``embed`` (K, V, d),
    ``lm_head`` (K, d, V)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (have {_FAMILIES})")
    dev, dense = dense_sampler(seed, dtype, device, generator)

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
        layers["moe_norm"] = ones((L, d))
        layers["moe"] = moe_params(cfg.moe, d, dense, (L,))
    elif cfg.family in ("dense", "vlm", "audio"):
        layers["mlp_norm"] = ones((L, d))
        layers["mlp"] = mlp_params((L,))
    books = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    params = {"embed": dense(books + (V, d)), "layers": layers}
    if cfg.family == "hybrid":
        params["shared_attn"] = {"attn_norm": ones((d,)),
                                 "attn": attn_params(()),
                                 "mlp_norm": ones((d,)),
                                 "mlp": mlp_params(())}
    params["final_norm"] = ones((d,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(books + (d, V))
    return params


def param_count(params: Mapping) -> int:
    return sum(t.numel() for t in flatten(params).values())
