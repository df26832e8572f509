"""The ambient mesh of a traced step (the JAX package's
``repro.sharding``): ``mesh_context`` sets the mesh that
``launch/dryrun.py`` traces a step under, and model code reads it
through ``current_mesh`` and ``model_axis_size``. Outside a context the
mesh is None and the model axis 1, as in the reference.

A mesh here is a description (``launch/mesh.py``): axis names and
sizes, no devices.

Left out:

* ``constrain``: in the reference it hands ``with_sharding_constraint``
  hints to XLA's SPMD partitioner. The port has no partitioner to take
  them, so its model code carries no such call. The reference's
  ``mesh_context`` also takes the batch axes and the tags of hints to
  drop, and ``batch_axes()`` reads the former back; they feed only
  ``constrain``, so they are left out with it.
* ``get_shard_map`` and ``make_ep_mesh``: their counterpart is
  ``ep.spawn(fn, num_shards, backend=)`` (ep/dist.py), one process per
  shard joined by ``torch.distributed``, with ``ep.DistEPExecutor`` as
  the per-shard program; ``ep.EPExecutor(num_shards, device=)`` runs all
  the shards in one process instead.
"""
from __future__ import annotations

import contextlib

_STATE = {"mesh": None}


@contextlib.contextmanager
def mesh_context(mesh):
    old = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = old


def current_mesh():
    return _STATE["mesh"]


def model_axis_size() -> int:
    """Extent of the "model" mesh axis (1 outside any mesh context).

    The expert axis shards contiguously over "model", so this is also
    the number of expert-parallel shards: sorted dispatch rounds its
    tile count to a multiple of it (``models.dispatch.dispatch_plan``)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return 1
    return mesh.shape.get("model", 1)
