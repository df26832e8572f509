"""Partitioning rules (the JAX package's ``repro.launch.partition``):
param / optimizer / cache / activation specs per architecture, by path
pattern.

A spec is a tuple with one entry per dimension of its tensor, each
None (replicated), an axis name, or a tuple of axis names (the
dimension split over their product) -- a ``PartitionSpec``'s content.
The rules are the reference's:

  * "model" axis: tensor parallel for dense projections (heads / d_ff /
    vocab), EXPERT parallel for MoE expert weights -- the paper's G
    groups == contiguous expert ranges per model-axis shard, so Alg 5/6's
    MaxLoad is the per-shard activated-expert count.
  * "data" (and "pod") axes: batch for train/prefill/decode; for
    batch-1 long-context decode the cache sequence axis takes the spare
    axes instead (flash-decode with cross-shard softmax reduction).

Left out: ``named`` (specs -> ``NamedSharding``s for ``jax.jit``). The
port places nothing by these specs; ``launch/dryrun.py`` reads them for
each card's share of the state.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as S

Spec = Tuple


def batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) whose size divides the batch."""
    axes = [a for a in ("pod", "data") if a in mesh.shape]
    for k in range(len(axes), -1, -1):
        cand = tuple(axes[:k])
        size = math.prod(mesh.shape[a] for a in cand) if cand else 1
        if batch % size == 0:
            return cand
    return ()


def seq_axes(mesh, batch: int) -> Tuple[str, ...]:
    """Axes left for the cache sequence dim after batch sharding."""
    used = set(batch_axes(mesh, batch))
    return tuple(a for a in ("pod", "data", "model") if a in mesh.shape
                 and a not in used)


def _axes_or_none(axes: Tuple[str, ...]):
    """A spec entry for a tuple of axes: None for none, the name for one
    (as ``PartitionSpec`` canonicalizes it), else the tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


# ----------------------------------------------------------------- params --

def param_specs(cfg: ArchConfig, mesh, params: Mapping, *,
                fsdp: bool = True) -> Dict:
    """Specs shaped like ``params`` (the port's nested dict; meta
    tensors will do, ``bridge.init_params(device="meta")``).

    2D "FSDP x TP" sharding: every large matrix shards its parallel
    dimension (heads / d_ff / experts / vocab) over "model" and its
    other big dimension (usually d_model) over "data" -- so parameter +
    optimizer memory scales with the FULL card count, while the "model"
    axis still carries the tensor/expert-parallel compute layout (per-
    layer all-gathers, ZeRO-3 semantics).
    """
    msize = mesh.shape["model"]
    dsize = mesh.shape["data"]
    a = cfg.attn

    def divides(n: int) -> bool:
        return n > 0 and n % msize == 0

    def _fsdp(n: int):
        """'data' if FSDP is on and the dim divides the data axis."""
        return "data" if (fsdp and n % dsize == 0) else None

    def spec2(shape, model_pos, data_pos) -> Spec:
        dims = [None] * len(shape)
        if model_pos is not None:
            dims[model_pos] = "model"
        if data_pos is not None:
            dims[data_pos] = _fsdp(shape[data_pos])
        return tuple(dims)

    def rule(s: str, sh) -> Spec:
        nd = len(sh)
        rep = (None,) * nd                        # replicated
        if s.endswith("embed"):
            if cfg.family == "audio":
                return spec2(sh, 1, 2)            # (K, V, d)
            return spec2(sh, 0, 1)                # (V, d)
        if s.endswith("lm_head"):
            return spec2(sh, nd - 1, nd - 2)      # (..., d, V)
        if "/attn/" in s:
            if s.endswith("wq"):
                return spec2(sh, nd - 1 if divides(a.num_heads) else None,
                             nd - 2)
            if s.endswith("wk") or s.endswith("wv"):
                return spec2(sh,
                             nd - 1 if divides(a.num_kv_heads) else None,
                             nd - 2)
            if s.endswith("wo"):
                return spec2(sh, nd - 2 if divides(a.num_heads) else None,
                             nd - 1)
            return rep                            # q_norm / k_norm
        if "/moe/" in s:
            if s.endswith("wg"):
                return rep                        # router replicated
            if s[-3:] in ("ws1", "ws3"):
                return spec2(sh, nd - 1, nd - 2)
            if s.endswith("ws2"):
                return spec2(sh, nd - 2, nd - 1)
            # expert weights (L, E, d, f) / (L, E, f, d): experts over
            # "model" (the paper's EP groups), d_ff over "data" (FSDP)
            fpos = nd - 1 if s.endswith("w1") or s.endswith("w3") \
                else nd - 2
            return tuple("model" if j == nd - 3 else
                         ("data" if fsdp and j == fpos
                          and sh[fpos] % dsize == 0 else None)
                         for j in range(nd))
        if "/mlp/" in s:
            mp = (nd - 1) if not s.endswith("w2") else (nd - 2)
            op = (nd - 2) if not s.endswith("w2") else (nd - 1)
            return spec2(sh, mp if divides(cfg.d_ff) else None, op)
        if "/ssm/" in s:
            if s.endswith("in_z") or s.endswith("in_x"):
                return spec2(sh, nd - 1, nd - 2)
            if s.endswith("in_dt"):
                d_inner = cfg.ssm.expand * cfg.d_model
                nh = d_inner // cfg.ssm.head_dim
                return spec2(sh, nd - 1 if divides(nh) else None, nd - 2)
            if s.endswith("in_B") or s.endswith("in_C"):
                return spec2(sh, None, nd - 2)
            if s.endswith("conv_x_w") or s.endswith("conv_x_b") \
                    or s.endswith("norm_w"):
                return (None,) * (nd - 1) + ("model",)
            if s.endswith("out_proj"):
                return spec2(sh, nd - 2, nd - 1)
            return rep                            # conv_B/C, A/D/dt_bias
        return rep                                # norms, biases

    return unflatten({k: rule(k, tuple(t.shape))
                      for k, t in flatten(params).items()})


def opt_specs(pspecs: Mapping):
    """AdamWState(step, mu, nu) specs mirroring the param specs."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=(), mu=pspecs, nu=unflatten(flatten(pspecs)))


# ------------------------------------------------------------------ cache --

def cache_specs(cfg: ArchConfig, mesh, batch: int) -> Dict[str, Spec]:
    """Specs of ``models.init_cache``'s tensors, by key."""
    ba = _axes_or_none(batch_axes(mesh, batch))
    sa = _axes_or_none(seq_axes(mesh, batch))
    if batch > 1:
        sa = "model" if "model" in mesh.shape else None
    specs: Dict[str, Spec] = {"cur_len": (None,)}
    msize = mesh.shape.get("model", 1)

    def kv_spec() -> Spec:
        # prefer HEAD sharding when kv_heads divides the model axis:
        # attention stays fully shard-local (no distributed softmax, no
        # scatter into a sharded sequence dim); fall back to sequence
        # sharding for small-kv GQA/MQA caches.
        if cfg.attn and cfg.attn.num_kv_heads % msize == 0 and batch > 1:
            return (None, ba, None, "model", None)
        return (None, ba, sa, None, None)

    if cfg.family in ("dense", "vlm", "audio", "moe"):
        specs["kv_k"] = kv_spec()
        specs["kv_v"] = kv_spec()
    if cfg.family in ("ssm", "hybrid"):
        msize = mesh.shape["model"]
        _, nh, _ = S.dims(cfg.ssm, cfg.d_model)
        head_ax = "model" if nh % msize == 0 else None
        specs["conv_x"] = (None, ba, None, "model")
        specs["conv_B"] = (None, ba, None, None)
        specs["conv_C"] = (None, ba, None, None)
        specs["state"] = (None, ba, head_ax, None, None)
    if cfg.family == "hybrid":
        specs["shared_k"] = kv_spec()
        specs["shared_v"] = kv_spec()
    return specs


# ------------------------------------------------------------- activations --

def token_spec(cfg: ArchConfig, mesh, batch: int) -> Spec:
    ba = _axes_or_none(batch_axes(mesh, batch))
    if cfg.family == "audio":
        return (ba, None, None)
    return (ba, None)


def logits_spec(cfg: ArchConfig, mesh, batch: int, *,
                with_seq: bool) -> Spec:
    ba = _axes_or_none(batch_axes(mesh, batch))
    dims = [ba] + ([None] if with_seq else [])
    if cfg.family == "audio":
        dims.append(None)                         # codebook axis
    dims.append("model")                          # padded vocab
    return tuple(dims)


def prefix_spec(cfg: ArchConfig, mesh, batch: int) -> Spec:
    ba = _axes_or_none(batch_axes(mesh, batch))
    return (ba, None, None)


def shard_count(spec: Spec, mesh) -> int:
    """How many ways a spec splits its tensor over ``mesh``."""
    n = 1
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh.shape[a]
    return n
