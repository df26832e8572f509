"""Expert-parallel execution: histogram-driven placement with hot-expert
replication (placement.py) and the EP executors (executor.py):
``EPExecutor``, whose S shards run in one process on one device, batched
over a shard axis, with the all-to-all a permutation of per-shard
buffers and one grouped_ffn launch per layer call; and
``DistEPExecutor``, one process per shard (``spawn``, ep/dist.py), each with
only its own experts' weights, rows exchanged by
``torch.distributed.all_to_all_single``.

``ep_context`` binds an executor for model code: ``expert_ffn``'s
``dispatch="ep"`` mode routes through the bound executor, handing it the
layer's expert stacks (a rank's own, under a DistEPExecutor), and is the
bit-identical single-device sorted path when none is bound.
"""
from __future__ import annotations

import contextlib

from repro_torch.ep.dist import Rank, spawn
from repro_torch.ep.executor import (DistEPExecutor, EPExecutor, EPStats,
                                     exchange_counts)
from repro_torch.ep.placement import (Placement, contiguous_placement,
                                      even_cap, placement_peak,
                                      plan_placement, rebalance)

_STATE = {"executor": None}


@contextlib.contextmanager
def ep_context(executor: EPExecutor):
    """Bind an EPExecutor (or a DistEPExecutor) for
    ``expert_ffn(dispatch="ep")`` callers."""
    old = _STATE["executor"]
    _STATE["executor"] = executor
    try:
        yield executor
    finally:
        _STATE["executor"] = old


def current_executor():
    return _STATE["executor"]


def binding_key(dispatch: str):
    """What a decode loop captured under ``dispatch`` reads of the EP
    binding (``EPExecutor.graph_key``), or None: the binding under which
    the LoopPool lends the running batch that holds the loop, so a graph
    never replays under another executor or another table shape, and a
    new binding replaces the old one's batch."""
    ex = current_executor() if dispatch == "ep" else None
    return None if ex is None else ex.graph_key()


__all__ = [
    "DistEPExecutor", "EPExecutor", "EPStats", "Placement", "Rank",
    "binding_key", "contiguous_placement", "current_executor",
    "ep_context", "even_cap", "exchange_counts", "placement_peak",
    "plan_placement", "rebalance", "spawn",
]
