"""Checkpointing: nested dicts / lists / tuples of torch tensors and numpy
arrays <-> an ``.npz`` of path-keyed entries plus a ``.json`` sidecar.

The format is the JAX package's (``checkpoint/ckpt.py`` there), so a
file either side writes, the other side loads:

  * a leaf's key is its path, joined by ``/``: the dict key, or the
    list / tuple index, at each level (what
    ``jax.tree_util.tree_flatten_with_path`` gives, and the layout
    ``bridge.flatten`` uses for params);
  * npz has no bfloat16, so a bf16 leaf is stored as its f32 upcast
    (exact) and restored by casting back;
  * the sidecar holds ``step``, ``extra``, the sorted ``keys`` and each
    key's ``dtypes`` — a bf16 leaf's entry says ``"bfloat16"``, which
    ``bridge.from_numpy`` reads to cast the upcast back.

Host-side: every leaf is copied to the host to be written.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) in the JAX flattening order: dict keys sorted,
    sequences in index order; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name recorded in the sidecar)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":        # e.g. an ml_dtypes array
        return arr.astype(np.float32), "bfloat16"
    return arr, str(arr.dtype)


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_checkpoint(path: str, tree, *, step: Optional[int] = None,
                    extra: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat, dtypes = {}, {}
    for p, leaf in _leaves(tree):
        key = _key(p)
        flat[key], dtypes[key] = _to_host(leaf)
    base = _base(path)
    np.savez(base + ".npz", **flat)
    meta = {"step": step, "extra": extra or {}, "keys": sorted(flat),
            "dtypes": dtypes}
    with open(base + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str):
    """Load a checkpoint WITHOUT a target tree: returns ``(flat, meta)``,
    ``flat`` mapping path keys ("a/b/0") to numpy arrays exactly as
    stored (a bf16 leaf as its f32 upcast) and ``meta`` the JSON sidecar
    ({} if absent). The serving snapshots (serving/journal.py) build on
    this."""
    base = _base(path)
    with np.load(base + ".npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    meta: Dict[str, Any] = {}
    if os.path.exists(base + ".json"):
        with open(base + ".json") as f:
            meta = json.load(f)
    return flat, meta


def _restore_leaf(key: str, arr: np.ndarray, leaf):
    shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)
    if arr.shape != shape:
        raise ValueError(f"checkpoint leaf {key!r}: stored shape "
                         f"{arr.shape}, target shape {shape}")
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=leaf.device, dtype=leaf.dtype)
    # numpy targets keep their exact dtype: int64 slot tables and step
    # counters must not be narrowed
    return arr.astype(np.asarray(leaf).dtype)


def _rebuild(tree, flat: Dict[str, np.ndarray], prefix: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, flat, prefix + (i,)) for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    key = _key(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    return _restore_leaf(key, flat[key], tree)


def restore_checkpoint(path: str, target):
    """Restore into the structure of ``target`` (values replaced): a
    torch leaf comes back with the target's dtype and device (a bf16 one
    bit-exact from its upcast), a numpy leaf with the target's exact
    dtype. A missing key or a shape mismatch raises."""
    flat, _ = load_checkpoint(path)
    return _rebuild(target, flat)
