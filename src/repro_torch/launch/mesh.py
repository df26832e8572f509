"""Meshes of the planning tools (the JAX package's
``repro.launch.mesh``). A mesh here is a description, ``Mesh``: axis
names and their sizes. No ``torch.distributed`` ``DeviceMesh`` is made:
a mesh of 256 or 512 cards cannot be built in one process, and the
planning records (``launch/dryrun.py``) need only the axes' sizes.

Target hardware: NVIDIA H100 80GB HBM3 in HGX nodes of 8 cards joined
all to all by NVLink. "model" is one node's 8-card NVLink domain, which
carries the tensor- and expert-parallel traffic of every layer, and the
paper's G = 8 expert groups; "data" (and "pod") cross nodes. The
reference's v5e pod has a 16-chip "model" axis, but on the H100 a
16-way model axis would put half of every layer's collectives on the
slower links between nodes. So the production meshes keep the
reference's card counts with the other split: 32 x 8 = 256 cards
("data", "model"), and 2 x 32 x 8 = 512 ("pod", "data", "model").
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple


@dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, outermost first."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of cards the mesh spans."""
        return math.prod(self.axis_sizes)


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of any shape and axis names (the reference's name, which
    papers over ``jax.make_mesh``'s versions)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} for axes {tuple(axes)}")
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def make_host_mesh() -> Mesh:
    """("data", "model") = (cards, 1) over this host's cards (the CPU
    counts as one device where there is none, as JAX's host platform
    does)."""
    import torch
    n = max(1, torch.cuda.device_count())
    return make_mesh_compat((n, 1), ("data", "model"))
