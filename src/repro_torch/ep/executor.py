"""Expert-parallel execution of sorted dispatch: S shards held by one
process on one device.

The JAX package runs one program per shard under ``shard_map`` and
exchanges rows with ``all_to_all``. Here the S shards' work is batched
over a leading S axis, and the exchange is a transpose of the (S, S, M)
send buffers: ``recv[dst, src] = send[src, dst]``. Per MoE layer call:

  1. route pairs to shards: each (token, expert) pair goes to
     ``placement.hosts[e, gtok % nhosts[e]]``, with gtok the token's
     global id after T is padded to a multiple of S, so a replicated
     expert's rows split across its replicas by token id;
  2. per shard, a stable sort by destination, the send counts and each
     pair's rank within its destination; a rank at or past ``max_rows``
     (M) is dropped, first tokens kept;
  3. the exchange: the (S, S·M) payload and expert-id buffers are
     transposed to their destinations (counts are never moved: the
     (S, S) count matrix is the send side's and its transpose);
  4. the grouped GEMM: one plan over the S·cap (shard, local slot)
     groups, each tile's group mapped to its global expert through
     ``local_eids``, and ONE ``grouped_ffn`` launch on the layer's own
     (E, d, f) weights. A replica reads the weights its copy would hold,
     so no per-shard weight gather is made;
  5. the reverse exchange brings each pair's row back to its source,
     which sums a token's k pairs in slot order, as
     ``models.dispatch.combine_scatter`` does, so EP equals the sorted
     dispatch bit for bit at every top_k.

The JAX package drops out-of-range writes (mode="drop"); here each
such write goes to a spare row one past the end, cut off after.

``ffn`` makes no host sync and no host-to-device copy: the placement
tables live in device buffers uploaded once per placement, one set per
table shape (expert_cap, replica width), overwritten in place when a
placement of the same shape replaces it, so a captured CUDA graph reads
the new tables on its next replay.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ep.placement import (Placement, contiguous_placement,
                                      placement_peak, plan_placement,
                                      rebalance)
from repro_torch.models.dispatch import (default_block_t, dispatch_plan,
                                         gather_tokens, grouped_ffn_apply)


class EPStats(NamedTuple):
    """Measured per-layer EP execution profile (host numpy).

    computed_rows[s] — real token-assignment rows sent to shard s's
                       grouped GEMM (segment sizes, no tile padding). The
                       max over shards is the paper's "peak GPU load".
    tile_rows[s]     — rows shard s's own tiles cover: occupied tiles ·
                       block_t. At decode sizes this is set by the number
                       of active experts on the shard, which Algorithm 6
                       bounds.
    sent_rows[s]     — rows shard s shipped to *other* shards.
    a2a_bytes[s]     — bytes shard s would put on an interconnect:
                       payload forward + reverse, expert ids forward, and
                       the count vectors both ways.
    count_matrix     — (S, S) rows, [src, dst] routed rows.
    max_rows         — the per-peer payload padding this call used.
    """
    computed_rows: np.ndarray
    tile_rows: np.ndarray
    sent_rows: np.ndarray
    a2a_bytes: np.ndarray
    count_matrix: np.ndarray
    max_rows: int

    @property
    def peak_rows(self) -> int:
        return int(self.computed_rows.max())

    @property
    def peak_tile_rows(self) -> int:
        return int(self.tile_rows.max())

    @property
    def total_a2a_bytes(self) -> int:
        return int(self.a2a_bytes.sum())


def _route_pairs(idx, w, hosts, nhosts, num_experts: int, num_shards: int):
    """(S, T_loc, k) routing -> per-shard pairs (S, N = T_loc·k): clipped
    expert id, f32 gate weight, local token of each pair, liveness, and
    the destination shard (S for dead pairs)."""
    S, T_loc, k = idx.shape
    N = T_loc * k
    dev = idx.device
    e = idx.reshape(S, N).to(torch.int32)
    wf = w.reshape(S, N).float()
    tokl = torch.arange(N, dtype=torch.int64, device=dev) // k
    live = (e >= 0) & (e < num_experts) & (wf != 0.0)
    ec = e.clamp(0, num_experts - 1).long()
    gtok = torch.arange(S, dtype=torch.int64, device=dev)[:, None] * T_loc \
        + tokl
    nrep = nhosts[ec].clamp_min(1).long()
    dest = torch.where(live, hosts[ec, gtok % nrep].long(), num_shards)
    return ec, wf, tokl, live, dest


def _send_counts(dest, live, num_shards: int):
    """(S, S) int32 rows shard src sends shard dst (dead pairs, dest = S,
    land in a spare column that is cut off)."""
    S = num_shards
    c = torch.zeros((dest.shape[0], S + 1), dtype=torch.int32,
                    device=dest.device)
    c.scatter_add_(1, dest, live.to(torch.int32))
    return c[:, :S]


def _pad_tokens(x, idx, w, num_shards: int):
    """Pad T to a multiple of S with dead tokens (idx -1, w 0)."""
    T, k = idx.shape
    pad = (-T) % num_shards
    if pad:
        if x is not None:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        idx = torch.cat([idx, idx.new_full((pad, k), -1)])
        w = torch.cat([w, w.new_zeros((pad, k))])
    return x, idx, w


def _counts(idx, w, hosts, nhosts, num_experts: int, num_shards: int):
    """The counts phase on padded (T, k) routing: the (S, S) matrix."""
    S = num_shards
    T, k = idx.shape
    _, _, _, live, dest = _route_pairs(
        idx.reshape(S, T // S, k), w.reshape(S, T // S, k), hosts, nhosts,
        num_experts, S)
    return _send_counts(dest, live, S)


def _device_tables(pl: Placement, device) -> Dict[str, torch.Tensor]:
    E = pl.num_experts
    return {"hosts": torch.from_numpy(pl.hosts).to(device),
            "nhosts": torch.from_numpy(pl.nhosts).to(device),
            "local_slot": torch.from_numpy(pl.local_slot).to(device),
            # padding slots (-1) read expert 0's weights, as jnp.clip does
            "local_eids": torch.from_numpy(
                np.clip(pl.local_eids, 0, max(E - 1, 0))).to(device)}


def exchange_counts(idx: torch.Tensor, w: torch.Tensor,
                    placement: Placement) -> np.ndarray:
    """The counts phase alone, on idx's device: (S, S) matrix of rows each
    shard would send each peer this round. Drives ``max_rows="auto"``
    payload sizing and placement-quality probes without moving any
    rows."""
    S = placement.num_shards
    _, idx, w = _pad_tokens(None, idx, w, S)
    tabs = _device_tables(placement, idx.device)
    return _counts(idx, w, tabs["hosts"], tabs["nhosts"],
                   placement.num_experts, S).cpu().numpy()


def _ep_layer(x, idx, w, w1, w3, w2, tabs, *, num_shards: int,
              expert_cap: int, max_rows: int, block_t: int):
    """The EP layer on padded (T, ·) inputs, every shard at once.
    Returns (y (T, k, d) f32 per pair, send counts (S, S), and the
    grouped_ffn call's plan and rows: shard s's tiles are the contiguous
    run of groups s·cap .. (s+1)·cap - 1)."""
    S, cap, M, bt = num_shards, expert_cap, max_rows, block_t
    E = w1.shape[0]
    T, d = x.shape
    k = idx.shape[1]
    T_loc = T // S
    N = T_loc * k
    dev = x.device
    ec, wf, tokl, live, dest = _route_pairs(
        idx.reshape(S, T_loc, k), w.reshape(S, T_loc, k), tabs["hosts"],
        tabs["nhosts"], E, S)
    # --- per-shard sort by destination, ranks, capacity clamp ----------
    order = torch.argsort(dest, dim=1, stable=True)     # token order kept
    s_dest = dest.gather(1, order)
    send = _send_counts(dest, live, S)
    start = (torch.cumsum(send, 1, dtype=torch.int32) - send).long()
    dclip = s_dest.clamp(0, S - 1)
    rank = torch.arange(N, dtype=torch.int64, device=dev) - \
        start.gather(1, dclip)
    kept_s = live.gather(1, order) & (rank < M)
    pos_s = torch.where(kept_s, dclip * M + rank, S * M)
    # back to pair order: a kept pair's slot in its shard's send buffer
    pos = torch.empty_like(pos_s).scatter_(1, order, pos_s)
    kept = torch.empty_like(kept_s).scatter_(1, order, kept_s)
    sidx = torch.arange(S, device=dev)[:, None]
    xbuf = x.new_zeros((S, S * M + 1, d))
    xbuf[sidx, pos] = x.reshape(S, T_loc, d)[sidx, tokl]
    ebuf = torch.full((S, S * M + 1), -1, dtype=torch.int64, device=dev)
    ebuf[sidx, pos] = ec
    # --- the exchange: recv[dst, src] = send[src, dst] -----------------
    recv_x = xbuf[:, :S * M].reshape(S, S, M, d).transpose(0, 1)
    recv_e = ebuf[:, :S * M].reshape(S, S, M).transpose(0, 1)
    # --- one grouped GEMM over the S·cap (shard, local slot) groups ----
    lsl = tabs["local_slot"][sidx[:, :, None], recv_e.clamp(0, E - 1)]
    grp = torch.where(recv_e >= 0, sidx[:, :, None] * cap + lsl, -1)
    grp = grp.reshape(S * S * M, 1)
    plan = dispatch_plan(grp, (grp >= 0).float(), S * cap, block_t=bt,
                         pad_shards=1)
    plan = plan._replace(
        tile_eid=tabs["local_eids"].reshape(S * cap)[plan.tile_eid.long()])
    xs = gather_tokens(recv_x.reshape(S * S * M, d), plan)
    ys = grouped_ffn_apply(xs, w1, w3, w2, plan)
    P = plan.padded_rows
    rows = torch.empty((S * S * M, d), dtype=ys.dtype, device=dev)
    rows[plan.order] = ys[plan.dest.clamp(max=P - 1).long()]
    # --- reverse exchange, source-side combine in slot order -----------
    back = rows.reshape(S, S, M, d).transpose(0, 1).reshape(S, S * M, d)
    val = back[sidx, pos.clamp(max=S * M - 1)].float()
    val = torch.where(kept[..., None], val, 0.0)
    contrib = torch.where(kept, wf, 0.0)[..., None] * val
    return contrib.reshape(T, k, d), send, plan, xs


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class EPExecutor:
    """Runs the EP layer: owns the placement and its device tables,
    and rebalances placement between batches with hysteresis.

    ``__call__`` returns (y, EPStats); ``ffn`` returns y alone (the
    ``expert_ffn(dispatch="ep")`` entry: no host sync, so a CUDA graph
    can capture it). ``device`` is the card unless the caller names
    another; a tensor on any other device raises.
    """

    def __init__(self, num_shards: int, placement: Placement, *,
                 device: DeviceLike = None,
                 block_t: Optional[int] = None,
                 max_rows=None,
                 replicate_hot: int = 0,
                 max_replicas: Optional[int] = None,
                 hysteresis: float = 0.1):
        if placement.num_shards != num_shards:
            raise ValueError(
                f"{num_shards} shards, placement expects "
                f"{placement.num_shards}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.num_shards = num_shards
        self.block_t = block_t
        self.max_rows = max_rows
        self.replicate_hot = replicate_hot
        self.max_replicas = max_replicas
        self.hysteresis = hysteresis
        self.rebalances = 0
        self.rebalances_skipped = 0
        self._bufs: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._set_placement(placement)

    @classmethod
    def from_config(cls, ep_cfg, num_experts: int, *,
                    device: DeviceLike = None,
                    load: Optional[np.ndarray] = None) -> "EPExecutor":
        """Build an executor from ``configs.base.EPConfig``, planning the
        initial placement from ``load`` (gate-histogram priors) when
        given, contiguous otherwise."""
        if load is None:
            pl = contiguous_placement(num_experts, ep_cfg.num_shards)
            if ep_cfg.replicate_hot:
                pl = plan_placement(np.ones(num_experts),
                                    ep_cfg.num_shards,
                                    replicate_hot=ep_cfg.replicate_hot,
                                    max_replicas=ep_cfg.max_replicas)
        else:
            pl = plan_placement(np.asarray(load, np.float64),
                                ep_cfg.num_shards,
                                replicate_hot=ep_cfg.replicate_hot,
                                max_replicas=ep_cfg.max_replicas)
        return cls(ep_cfg.num_shards, pl, device=device,
                   block_t=ep_cfg.block_t, max_rows=ep_cfg.max_rows,
                   replicate_hot=ep_cfg.replicate_hot,
                   max_replicas=ep_cfg.max_replicas,
                   hysteresis=ep_cfg.rebalance_hysteresis)

    # -------------------------------------------------- placement ----

    def _set_placement(self, pl: Placement) -> None:
        """Adopt a placement and upload its tables: into the buffers of
        its table shape, in place, when that shape was seen before (a
        graph captured over them replays the new tables), else into new
        ones (a graph of another shape never reads them)."""
        new = _device_tables(pl, self.device)
        shape = (pl.expert_cap, pl.hosts.shape[1])
        bufs = self._bufs.get(shape)
        if bufs is None:
            self._bufs[shape] = new
        else:
            for name, t in new.items():
                bufs[name].copy_(t)
        self.placement = pl

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        """The current placement's device tables (hosts, nhosts,
        local_slot, local_eids clipped to 0), read by every call."""
        pl = self.placement
        return self._bufs[(pl.expert_cap, pl.hosts.shape[1])]

    def graph_key(self) -> tuple:
        """What a captured call depends on besides its inputs: this
        executor's buffers and the table shape (expert_cap, replica
        width) that fixes its shapes."""
        return (self, self.placement.expert_cap,
                self.placement.hosts.shape[1])

    def update_placement(self, load: np.ndarray) -> bool:
        """Between-batch rebalance from fresh load predictions (e.g.
        ``Scheduler.gate_priors().sum(0)``). Hysteresis means most calls
        are no-ops; a True return means the next layer call reads the new
        tables (a new graph only if expert_cap or the replica width
        changed)."""
        new, changed = rebalance(self.placement, load,
                                 replicate_hot=self.replicate_hot,
                                 max_replicas=self.max_replicas,
                                 hysteresis=self.hysteresis)
        if changed:
            self._set_placement(new)
            self.rebalances += 1
        else:
            self.rebalances_skipped += 1
        return changed

    def predicted_peak(self, load: np.ndarray) -> float:
        return placement_peak(self.placement, load)

    # -------------------------------------------------- execution ----

    def _check(self, **tensors) -> None:
        for name, t in tensors.items():
            if t.device != self.device:
                raise ValueError(f"EPExecutor on {self.device}: {name} on "
                                 f"{t.device}")

    def _resolve_max_rows(self, idx, w, max_rows, n_loc: int, *,
                          sync: bool) -> int:
        mr = self.max_rows if max_rows is None else max_rows
        if mr is None or (mr == "auto" and not sync):
            return n_loc                      # worst case, always exact
        if mr == "auto":
            pl = self.placement
            counts = _counts(idx, w, self.tables["hosts"],
                             self.tables["nhosts"], pl.num_experts,
                             pl.num_shards)
            return min(n_loc, _pow2_bucket(max(1, int(counts.max()))))
        return min(n_loc, int(mr))

    def _run(self, x, w1, w3, w2, idx, w, max_rows, *, sync: bool):
        self._check(x=x, w1=w1, w3=w3, w2=w2, idx=idx, w=w)
        pl = self.placement
        S = pl.num_shards
        T = x.shape[0]
        xp, idx, w = _pad_tokens(x, idx, w, S)
        n_loc = xp.shape[0] // S * idx.shape[1]
        M = self._resolve_max_rows(idx, w, max_rows, n_loc, sync=sync)
        bt = self.block_t or default_block_t(S * M, pl.expert_cap)
        contrib, send, plan, xs = _ep_layer(
            xp, idx, w, w1, w3, w2, self.tables, num_shards=S,
            expert_cap=pl.expert_cap, max_rows=M, block_t=bt)
        # the k slots of a token summed in slot order, on the same (T, k,
        # d) shape as combine_scatter's sum: the same bits
        y = contrib[:T].sum(dim=1).to(x.dtype)
        return y, send, plan, xs, M

    def __call__(self, x, w1, w3, w2, idx, w, *,
                 max_rows=None) -> Tuple[torch.Tensor, EPStats]:
        y, send, plan, _, M = self._run(x, w1, w3, w2, idx, w, max_rows,
                                        sync=True)
        S, cap = self.placement.num_shards, self.placement.expert_cap
        bt = plan.block_t
        d = x.shape[1]
        cm = send.cpu().numpy().astype(np.int64)
        off = ~np.eye(S, dtype=bool)
        sent = (cm * off).sum(1)
        recv_off = (cm * off).sum(0)
        counts = plan.counts.cpu().numpy().astype(np.int64).reshape(S, cap)
        stats = EPStats(
            computed_rows=cm.sum(0),
            tile_rows=((counts + bt - 1) // bt * bt).sum(1),
            sent_rows=sent,
            a2a_bytes=(sent + recv_off) * d * x.element_size()
            + sent * 4 + 2 * S * 4,     # payloads + expert ids + counts
            count_matrix=cm, max_rows=M)
        return y, stats

    def ffn(self, x, w1, w3, w2, idx, w) -> torch.Tensor:
        """y alone, with no host sync (the ``dispatch="ep"`` model path,
        captured in the decode graphs). max_rows resolves statically:
        "auto" counts as the worst case, since it needs the counts on
        the host."""
        return self._run(x, w1, w3, w2, idx, w, None, sync=False)[0]
