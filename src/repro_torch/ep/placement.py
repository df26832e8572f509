"""Dynamic expert-to-shard placement from gate histograms.

The EP bottleneck is the busiest shard: under sorted dispatch a shard
computes exactly the token segments of the experts it hosts, so peak
load is a pure function of (routing skew x placement). This module
consumes the per-expert load predictions the serving layer already
collects (``Scheduler.gate_priors()`` — the same priors feeding
Algorithm 4) and turns them into a placement:

  * assignment   — greedy LPT: experts in decreasing predicted load,
                   each to the currently least-loaded shard. Classic
                   4/3-approximation of makespan; deterministic
                   tie-breaking (expert id, then shard id) keeps
                   routing reproducible across hosts.
  * replication  — the hottest experts are copied onto extra shards and
                   their rows split deterministically across replicas
                   (token_id mod num_replicas — see executor.py), the
                   core idea of "Fast MoE Inference via Predictive
                   Prefetching and Expert Replication" (arxiv
                   2605.11537). A replica costs weight memory, not
                   accuracy: every replica holds identical weights.
  * rebalancing  — ``rebalance`` only adopts a new placement when its
                   predicted peak beats the incumbent's by more than a
                   hysteresis margin, so placement (and the weight
                   re-shard it implies) never churns between batches
                   with statistically identical traffic.

Everything here is host-side numpy: placement changes happen between
batches, never inside a decode step or a captured graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Placement:
    """Expert-to-shard map with replication.

    hosts[e]   — shard ids hosting expert e, primary first, padded by
                 cycling (padding is never indexed: the executor picks
                 ``hosts[e, token % nhosts[e]]``).
    nhosts[e]  — number of distinct hosts of e (>= 1).
    local_eids — (S, cap) global expert ids resident on each shard,
                 -1 padding; the executor gathers weight slices with it.
    local_slot — (S, E) local slot of expert e on shard s, -1 if absent.
    """
    num_experts: int
    num_shards: int
    hosts: np.ndarray        # (E, R_max) int32
    nhosts: np.ndarray       # (E,) int32
    local_eids: np.ndarray   # (S, cap) int32
    local_slot: np.ndarray   # (S, E) int32
    version: int = 0

    @property
    def expert_cap(self) -> int:
        return self.local_eids.shape[1]

    @property
    def replication_factor(self) -> float:
        """Mean replicas per expert (1.0 = no replication)."""
        return float(self.nhosts.mean())

    def weight_bytes_factor(self) -> float:
        """Per-shard weight memory vs an even non-replicated split:
        cap / ceil(E/S)."""
        even = -(-self.num_experts // self.num_shards)
        return self.expert_cap / even


def _tables(host_sets, E: int, S: int, version: int) -> Placement:
    """Freeze per-expert host lists into the dense lookup tables."""
    nhosts = np.array([len(h) for h in host_sets], np.int32)
    r_max = int(nhosts.max()) if E else 1
    hosts = np.zeros((E, r_max), np.int32)
    for e, hs in enumerate(host_sets):
        for j in range(r_max):
            hosts[e, j] = hs[j % len(hs)]
    per_shard = [[] for _ in range(S)]
    for e, hs in enumerate(host_sets):
        for s in hs:
            per_shard[s].append(e)
    cap = max(1, max(len(v) for v in per_shard))
    local_eids = np.full((S, cap), -1, np.int32)
    local_slot = np.full((S, E), -1, np.int32)
    for s, eids in enumerate(per_shard):
        for j, e in enumerate(eids):
            local_eids[s, j] = e
            local_slot[s, e] = j
    return Placement(num_experts=E, num_shards=S, hosts=hosts,
                     nhosts=nhosts, local_eids=local_eids,
                     local_slot=local_slot, version=version)


def contiguous_placement(num_experts: int, num_shards: int) -> Placement:
    """The static baseline layout: expert e on shard e // ceil(E/S) —
    exactly how the expert axis shards contiguously over the mesh
    "model" axis (last shard smaller when E % S != 0)."""
    per = -(-num_experts // num_shards)
    host_sets = [[min(e // per, num_shards - 1)] for e in range(num_experts)]
    return _tables(host_sets, num_experts, num_shards, version=0)


def _replicas(num_shards: int, max_replicas: Optional[int]) -> int:
    S = num_shards
    return S if max_replicas is None else max(1, min(max_replicas, S))


def even_cap(num_experts: int, num_shards: int, *, replicate_hot: int = 0,
             max_replicas: Optional[int] = None) -> int:
    """Experts per shard when the E experts and the hot ones' extra
    replicas are spread evenly: ceil((E + hot·(replicas − 1)) / S)."""
    hot = min(replicate_hot, num_experts) if replicate_hot > 0 else 0
    slots = num_experts + hot * (_replicas(num_shards, max_replicas) - 1)
    return max(1, -(-slots // num_shards))


def plan_placement(load: np.ndarray, num_shards: int, *,
                   replicate_hot: int = 0,
                   max_replicas: Optional[int] = None,
                   max_per_shard: Optional[int] = None,
                   version: int = 0) -> Placement:
    """Assign experts to shards minimizing predicted peak load.

    load: (E,) predicted per-expert load (gate-histogram mass or
    measured segment sizes — only ratios matter). replicate_hot: the
    top-``replicate_hot`` experts by load are replicated onto
    ``max_replicas`` shards (default: all of them), splitting their
    rows ~evenly across replicas.

    max_per_shard: the most experts a shard may hold (its weight
    memory); a full shard takes no more. None leaves it unbounded, the
    JAX package's planner, which puts every expert of load 0 on the one
    least-loaded shard: from raw counts of a decode step (most experts
    unrouted) that is nearly the whole layer on one shard. Below
    ``even_cap`` it raises.

    Deterministic: ties in load break by expert id; ties in shard load
    break by shard id. Same inputs => identical placement on every host.
    """
    load = np.asarray(load, np.float64)
    E = load.shape[0]
    S = num_shards
    r = _replicas(S, max_replicas)
    if max_per_shard is not None:
        need = even_cap(E, S, replicate_hot=replicate_hot,
                        max_replicas=max_replicas)
        if max_per_shard < need:
            raise ValueError(f"max_per_shard {max_per_shard}: {E} experts "
                             f"and their replicas need {need} a shard")
    hot = set()
    if replicate_hot > 0 and E:
        # stable: by (-load, expert id)
        order = np.lexsort((np.arange(E), -load))
        hot = set(int(e) for e in order[:min(replicate_hot, E)])
    # LPT over *effective* loads: a replicated expert contributes
    # load/r to each of its r hosts
    order = np.lexsort((np.arange(E), -load))
    shard_load = np.zeros(S, np.float64)
    held = np.zeros(S, np.int64)
    host_sets = [None] * E
    for e in order:
        e = int(e)
        # full shards sort last (none is full without max_per_shard)
        free = shard_load if max_per_shard is None else \
            np.where(held < max_per_shard, shard_load, np.inf)
        if e in hot:
            # replicas on the r least-loaded shards (ids break ties)
            picks = np.lexsort((np.arange(S), free))[:r]
            picks = sorted(int(s) for s in picks)
            for s in picks:
                shard_load[s] += load[e] / len(picks)
            host_sets[e] = picks
        else:
            s = int(np.lexsort((np.arange(S), free))[0])
            shard_load[s] += load[e]
            host_sets[e] = [s]
        held[host_sets[e]] += 1
    return _tables(host_sets, E, S, version=version)


def placement_peak(placement: Placement, load: np.ndarray) -> float:
    """Predicted peak per-shard load under a placement: each expert
    contributes load/nhosts to every host (the executor splits rows
    across replicas ~evenly)."""
    load = np.asarray(load, np.float64)
    shard = np.zeros(placement.num_shards, np.float64)
    for e in range(placement.num_experts):
        n = int(placement.nhosts[e])
        for j in range(n):
            shard[int(placement.hosts[e, j])] += load[e] / n
    return float(shard.max()) if len(shard) else 0.0


def rebalance(prev: Placement, load: np.ndarray, *,
              replicate_hot: int = 0,
              max_replicas: Optional[int] = None,
              max_per_shard: Optional[int] = None,
              hysteresis: float = 0.1) -> Tuple[Placement, bool]:
    """Between-batch rebalancing with hysteresis.

    Returns (placement, changed). The candidate placement is adopted
    only when its predicted peak improves on the incumbent's by more
    than ``hysteresis`` (relative), so statistically identical traffic
    never causes a weight re-shard — placement churn must never stall
    decode.
    """
    cand = plan_placement(load, prev.num_shards,
                          replicate_hot=replicate_hot,
                          max_replicas=max_replicas,
                          max_per_shard=max_per_shard,
                          version=prev.version + 1)
    p_prev = placement_peak(prev, load)
    p_cand = placement_peak(cand, load)
    if p_cand < p_prev * (1.0 - hysteresis):
        return cand, True
    return prev, False
