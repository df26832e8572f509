"""Expert-parallel execution of sorted dispatch, two ways:

* ``EPExecutor``: S shards held by one process on one device;
* ``DistEPExecutor``: one process per shard (``ep/dist.py`` starts
  them), each holding only its own experts' weights and exchanging rows
  with ``torch.distributed.all_to_all_single``: the JAX package's
  ``shard_map`` program, step by step (its class doc).

The JAX package runs one program per shard under ``shard_map`` and
exchanges rows with ``all_to_all``. In ``EPExecutor`` the S shards' work
is batched over a leading S axis, and the exchange is a transpose of the
(S, S, M) send buffers: ``recv[dst, src] = send[src, dst]``. Per MoE
layer call:

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

import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ep.placement import (Placement, contiguous_placement,
                                      even_cap, placement_peak,
                                      plan_placement, rebalance)
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
    a2a_bytes[s]     — bytes shard s's occupied rows would put on an
                       interconnect: payload forward + reverse, expert
                       ids forward, and the count vectors both ways. An
                       exchange in blocks of M rows a peer moves more
                       (``launch.roofline.ep_padded_exchange_bytes``).
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


def _route_pairs(idx, w, hosts, nhosts, num_experts: int, num_shards: int,
                 first: int = 0):
    """(n, T_loc, k) routing of shards first .. first + n - 1 -> their
    pairs (n, N = T_loc·k): clipped expert id, f32 gate weight, local
    token of each pair, liveness, and the destination shard (S for dead
    pairs)."""
    n, T_loc, k = idx.shape
    N = T_loc * k
    dev = idx.device
    e = idx.reshape(n, N).to(torch.int32)
    wf = w.reshape(n, N).float()
    tokl = torch.arange(N, dtype=torch.int64, device=dev) // k
    live = (e >= 0) & (e < num_experts) & (wf != 0.0)
    ec = e.clamp(0, num_experts - 1).long()
    gtok = torch.arange(first, first + n, dtype=torch.int64,
                        device=dev)[:, None] * T_loc + tokl
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


def _counts(idx, w, hosts, nhosts, num_experts: int, num_shards: int,
            first: int = 0, n: Optional[int] = None):
    """The counts phase on padded (T, k) routing: the (n, S) rows shards
    first .. first + n - 1 (all S by default) send each peer."""
    S = num_shards
    n = S if n is None else n
    T, k = idx.shape
    T_loc = T // S
    rows = slice(first * T_loc, (first + n) * T_loc)
    _, _, _, live, dest = _route_pairs(
        idx[rows].reshape(n, T_loc, k), w[rows].reshape(n, T_loc, k), hosts,
        nhosts, num_experts, S, first)
    return _send_counts(dest, live, S)


def _pack(x, ec, tokl, live, dest, num_shards: int, max_rows: int):
    """Each of n shards' send side, on its (n, T_loc, d) tokens and (n, N)
    routed pairs: a stable sort by destination, the (n, S) send counts,
    each pair's rank within its destination, the ``max_rows`` (M) clamp
    (first tokens kept). Returns the counts; each pair's row in its
    shard's send buffer (S·M when dropped) and whether it was kept, in
    pair order; and the (n, S·M, d) payload and (n, S·M) int32 expert-id
    buffers, M rows per peer, -1 ids in padding rows."""
    S, M = num_shards, max_rows
    n, N = dest.shape
    d = x.shape[-1]
    dev = dest.device
    order = torch.argsort(dest, dim=1, stable=True)     # token order kept
    send = _send_counts(dest, live, S)
    start = (torch.cumsum(send, 1, dtype=torch.int32) - send).long()
    dclip = dest.gather(1, order).clamp(0, S - 1)
    rank = torch.arange(N, dtype=torch.int64, device=dev) - \
        start.gather(1, dclip)
    kept_s = live.gather(1, order) & (rank < M)
    pos_s = torch.where(kept_s, dclip * M + rank, S * M)
    # back to pair order: a kept pair's slot in its shard's send buffer
    pos = torch.empty_like(pos_s).scatter_(1, order, pos_s)
    kept = torch.empty_like(kept_s).scatter_(1, order, kept_s)
    sidx = torch.arange(n, device=dev)[:, None]
    xbuf = x.new_zeros((n, S * M + 1, d))
    xbuf[sidx, pos] = x[sidx, tokl]
    ebuf = torch.full((n, S * M + 1), -1, dtype=torch.int32, device=dev)
    ebuf[sidx, pos] = ec.to(torch.int32)
    return send, pos, kept, xbuf[:, :S * M], ebuf[:, :S * M]


def _slot_groups(recv_e, local_slot, num_experts: int):
    """(n, R) expert ids received by n shards -> each row's local slot on
    its shard (``local_slot`` rows (n, E)), -1 for padding rows."""
    sidx = torch.arange(recv_e.shape[0], device=recv_e.device)[:, None]
    lsl = local_slot[sidx, recv_e.clamp(0, num_experts - 1)]
    return torch.where(recv_e >= 0, lsl, -1)


def _expert_rows(xr, grp, num_groups: int, w1, w3, w2, block_t: int,
                 group_eid=None):
    """ONE grouped_ffn launch over the received rows xr (R, d), row i in
    group grp[i] (-1: a padding row); ``group_eid`` maps a group to its
    expert's index in the stacks (the group itself when None). Returns
    the output rows in xr's order, the plan and the rows it gathered."""
    plan = dispatch_plan(grp[:, None], (grp >= 0).float()[:, None],
                         num_groups, block_t=block_t, pad_shards=1)
    if group_eid is not None:
        plan = plan._replace(tile_eid=group_eid[plan.tile_eid.long()])
    xs = gather_tokens(xr, plan)
    ys = grouped_ffn_apply(xs, w1, w3, w2, plan)
    rows = torch.empty(xr.shape, dtype=ys.dtype, device=xr.device)
    rows[plan.order] = ys[plan.dest.clamp(max=plan.padded_rows - 1).long()]
    return rows, plan, xs


def _combine(back, pos, kept, wf):
    """Each of n shards' rows come back (n, S·M, d) -> the (n, N, d) f32
    per-pair values times their gate weights, 0 for dropped pairs; the
    caller sums a token's k pairs in slot order."""
    sidx = torch.arange(back.shape[0], device=back.device)[:, None]
    val = back[sidx, pos.clamp(max=back.shape[1] - 1)].float()
    val = torch.where(kept[..., None], val, 0.0)
    return torch.where(kept, wf, 0.0)[..., None] * val


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
    S, cap, M = num_shards, expert_cap, max_rows
    E = w1.shape[0]
    T, d = x.shape
    k = idx.shape[1]
    T_loc = T // S
    ec, wf, tokl, live, dest = _route_pairs(
        idx.reshape(S, T_loc, k), w.reshape(S, T_loc, k), tabs["hosts"],
        tabs["nhosts"], E, S)
    send, pos, kept, xbuf, ebuf = _pack(x.reshape(S, T_loc, d), ec, tokl,
                                        live, dest, S, M)
    # --- the exchange: recv[dst, src] = send[src, dst] -----------------
    recv_x = xbuf.reshape(S, S, M, d).transpose(0, 1)
    recv_e = ebuf.reshape(S, S, M).transpose(0, 1).reshape(S, S * M).long()
    # --- one grouped GEMM over the S·cap (shard, local slot) groups ----
    lsl = _slot_groups(recv_e, tabs["local_slot"], E)
    sidx = torch.arange(S, device=x.device)[:, None]
    grp = torch.where(lsl >= 0, sidx * cap + lsl, -1).reshape(S * S * M)
    rows, plan, xs = _expert_rows(recv_x.reshape(S * S * M, d), grp,
                                  S * cap, w1, w3, w2, block_t,
                                  tabs["local_eids"].reshape(S * cap))
    # --- reverse exchange, source-side combine in slot order -----------
    back = rows.reshape(S, S, M, d).transpose(0, 1).reshape(S, S * M, d)
    contrib = _combine(back, pos, kept, wf)
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
    another; a tensor on any other device raises. ``max_expert_cap``
    bounds the experts ``update_placement`` puts on one shard
    (``plan_placement``'s ``max_per_shard``); None leaves it unbounded.
    """

    def __init__(self, num_shards: int, placement: Placement, *,
                 device: DeviceLike = None,
                 block_t: Optional[int] = None,
                 max_rows=None,
                 replicate_hot: int = 0,
                 max_replicas: Optional[int] = None,
                 max_expert_cap: Optional[int] = None,
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
        self.max_expert_cap = max_expert_cap
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
                                 max_per_shard=self.max_expert_cap,
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
        if w1.shape[0] != pl.num_experts:
            raise ValueError(
                f"EPExecutor reads the layer's {pl.num_experts} experts; "
                f"got stacks of {w1.shape[0]} (a rank's own experts go to "
                f"a DistEPExecutor)")
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


# ------------------------------------------------- one process per shard --

def _crc(*arrays: np.ndarray) -> int:
    """crc32 of the arrays' bytes: a placement's fingerprint."""
    c = 0
    for a in arrays:
        c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
    return c


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class DistEPExecutor(EPExecutor):
    """The EP layer with one process per shard (the JAX package's
    ``shard_map`` body, ``repro.ep.executor._build_ep_fn``): this rank of
    the default process group holds shard ``rank``. The model's other
    parts run replicated on every rank, so each call takes the full
    (T, d) x and (T, k) routing, and returns the full (T, d) y, rebuilt
    by an ``all_gather`` of each rank's rows.

    Per call, on this rank: its tokens [r·T/S, (r+1)·T/S) of the batch
    padded to a multiple of S; the pairs routed and packed as the
    one-process executor packs each shard's (``_pack``); the (S,) send
    counts exchanged first, then the payload and the expert ids, M rows
    per peer, each by one ``all_to_all_single``; ONE ``grouped_ffn``
    launch over the rank's ``expert_cap`` local slots on its own
    (cap, d, f) stacks (``bridge.cut_experts``); the rows sent back the
    same way and combined as the one-process executor combines
    (``_combine``). So y equals the one-process executor's and the
    sorted dispatch's bit for bit. Tensors cross as bytes, whatever
    their dtype.

    ``expert_cap`` is the rank's weight memory, so ``update_placement``
    plans within ``max_expert_cap`` experts a rank: by default the
    larger of the first placement's expert_cap and the even split
    (``placement.even_cap``). ``update_placement`` is otherwise the
    one-process executor's (deterministic numpy on every rank, given
    the same load), then every rank checks that all hold the same
    version and tables; the caller then cuts its experts again
    (``bridge.cut_experts`` from the host copy).

    The exchange cannot be captured in a CUDA graph: gloo stages CUDA
    tensors through host memory, and NCCL's capture waits for a host
    with a card per rank. A call under capture raises.
    """

    def __init__(self, placement: Placement, *, device: DeviceLike = None,
                 block_t: Optional[int] = None, max_rows=None,
                 replicate_hot: int = 0,
                 max_replicas: Optional[int] = None,
                 max_expert_cap: Optional[int] = None,
                 hysteresis: float = 0.1):
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        S = dist.get_world_size()
        if max_expert_cap is None:
            max_expert_cap = max(placement.expert_cap, even_cap(
                placement.num_experts, S, replicate_hot=replicate_hot,
                max_replicas=max_replicas))
        elif placement.expert_cap > max_expert_cap:
            raise ValueError(
                f"DistEPExecutor: the placement puts {placement.expert_cap} "
                f"experts on a rank, max_expert_cap {max_expert_cap}")
        super().__init__(S, placement, device=device, block_t=block_t,
                         max_rows=max_rows, replicate_hot=replicate_hot,
                         max_replicas=max_replicas,
                         max_expert_cap=max_expert_cap,
                         hysteresis=hysteresis)

    @property
    def local_eids(self) -> np.ndarray:
        """This rank's (cap,) global expert ids, -1 padding."""
        return self.placement.local_eids[self.rank]

    # ------------------------------------------------- collectives ----

    def _collective(self, what: str) -> None:
        if _capturing():
            why = ("gloo stages CUDA tensors through host memory" if
                   self.backend == "gloo" else
                   f"capturing {self.backend} waits for a host with a card "
                   f"per rank")
            raise RuntimeError(
                f"DistEPExecutor: the {what} cannot be captured in a CUDA "
                f"graph ({why}); serve with Engine.generate("
                f"lockstep=True)")

    def _exchange(self, t: torch.Tensor) -> torch.Tensor:
        """all_to_all_single over the rank axis: t's rows in S equal
        blocks, block j to rank j; returns the blocks received, by
        source."""
        self._collective("exchange")
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out.view(torch.uint8), src.view(torch.uint8))
        return out

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """all_gather: every rank's t, stacked by rank along dim 0."""
        self._collective("gather")
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.num_shards)]
        dist.all_gather([p.view(torch.uint8) for p in parts],
                        src.view(torch.uint8))
        return torch.cat(parts)

    def _max(self, n: torch.Tensor) -> int:
        self._collective("all_reduce")
        n = n.to(torch.int64).reshape(1).clone()
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        return int(n.item())

    # --------------------------------------------------- placement ----

    def update_placement(self, load: np.ndarray) -> bool:
        changed = super().update_placement(load)
        pl = self.placement
        mine = torch.tensor(
            [pl.version, pl.expert_cap, pl.hosts.shape[1],
             _crc(pl.hosts, pl.local_eids)], dtype=torch.int64,
            device=self.device)
        every = self._gather(mine[None]).cpu()
        if not bool((every == every[0]).all()):
            raise RuntimeError(
                f"DistEPExecutor rank {self.rank}: the ranks hold "
                f"different placements after update_placement (version, "
                f"expert_cap, replica width, tables' crc by rank): "
                f"{every.tolist()}")
        return changed

    # --------------------------------------------------- execution ----

    def _send_row(self, idx, w) -> torch.Tensor:
        """(S,) rows this rank sends each peer, on padded (T, k)
        routing."""
        pl = self.placement
        return _counts(idx, w, self.tables["hosts"], self.tables["nhosts"],
                       pl.num_experts, self.num_shards, self.rank, 1)[0]

    def exchange_counts(self, idx: torch.Tensor,
                        w: torch.Tensor) -> np.ndarray:
        """The counts phase alone, across the ranks: the (S, S) matrix of
        rows each rank would send each peer (every rank gets all of
        it)."""
        _, idx, w = _pad_tokens(None, idx, w, self.num_shards)
        return self._gather(self._send_row(idx, w)[None]).cpu().numpy()

    def _resolve_max_rows(self, idx, w, max_rows, n_loc: int, *,
                          sync: bool) -> int:
        mr = self.max_rows if max_rows is None else max_rows
        if mr is None or (mr == "auto" and not sync):
            return n_loc
        if mr == "auto":
            top = self._max(self._send_row(idx, w).max())
            return min(n_loc, _pow2_bucket(max(1, top)))
        return min(n_loc, int(mr))

    def _run(self, x, w1, w3, w2, idx, w, max_rows, *, sync: bool):
        self._check(x=x, w1=w1, w3=w3, w2=w2, idx=idx, w=w)
        pl = self.placement
        S, r, cap, E = self.num_shards, self.rank, pl.expert_cap, \
            pl.num_experts
        if w1.shape[0] != cap:
            raise ValueError(
                f"DistEPExecutor rank {r}: expert stacks of {w1.shape[0]}, "
                f"its placement holds {cap} (bridge.cut_experts)")
        T, d = x.shape
        xp, idx, w = _pad_tokens(x, idx, w, S)
        k = idx.shape[1]
        T_loc = xp.shape[0] // S
        M = self._resolve_max_rows(idx, w, max_rows, T_loc * k, sync=sync)
        bt = self.block_t or default_block_t(S * M, cap)
        tabs = self.tables
        mine = slice(r * T_loc, (r + 1) * T_loc)
        ec, wf, tokl, live, dest = _route_pairs(
            idx[mine][None], w[mine][None], tabs["hosts"], tabs["nhosts"],
            E, S, first=r)
        send, pos, kept, xbuf, ebuf = _pack(xp[mine][None], ec, tokl, live,
                                            dest, S, M)
        # --- the exchange: counts first, then payload and expert ids --
        send = send[0]
        recv_counts = self._exchange(send)
        recv_x = self._exchange(xbuf[0])
        recv_e = self._exchange(ebuf[0]).long()
        # --- one grouped GEMM over the rank's own expert slots --------
        grp = _slot_groups(recv_e[None], tabs["local_slot"][r][None], E)[0]
        rows, plan, xs = _expert_rows(recv_x, grp, cap, w1, w3, w2, bt)
        # --- reverse exchange, combine in slot order, gather y --------
        contrib = _combine(self._exchange(rows)[None], pos, kept, wf)
        y_loc = contrib.reshape(T_loc, k, d).sum(dim=1).to(x.dtype)
        y = self._gather(y_loc)[:T]
        return y, send, recv_counts, plan, xs, M

    def __call__(self, x, w1, w3, w2, idx, w, *,
                 max_rows=None) -> Tuple[torch.Tensor, EPStats]:
        """(y, EPStats): the stats gathered from every rank to (S,)
        arrays, the JAX package's formulas. a2a_bytes counts the occupied
        rows only (payload out and back, expert ids out, counts both
        ways); the exchange pads each peer's block to M rows and moves
        those too (``launch.roofline.ep_padded_exchange_bytes``)."""
        y, send, recv, plan, _, M = self._run(x, w1, w3, w2, idx, w,
                                              max_rows, sync=True)
        S, d = self.num_shards, x.shape[1]
        off = torch.arange(S, device=send.device) != self.rank
        sent = (send.long() * off).sum()
        recv_off = (recv.long() * off).sum()
        a2a = (sent + recv_off) * d * x.element_size() + sent * 4 + 2 * S * 4
        tile_rows = plan.tile_valid.long().sum() * plan.block_t
        mine = torch.cat([torch.stack([recv.long().sum(), tile_rows, sent,
                                       a2a]), send.long()])
        every = self._gather(mine[None]).cpu().numpy().astype(np.int64)
        stats = EPStats(computed_rows=every[:, 0], tile_rows=every[:, 1],
                        sent_rows=every[:, 2], a2a_bytes=every[:, 3],
                        count_matrix=every[:, 4:], max_rows=M)
        return y, stats

    def ffn(self, x, w1, w3, w2, idx, w) -> torch.Tensor:
        """y alone, with no host sync of its own (under gloo the backend
        stages through host memory). max_rows "auto" counts as the worst
        case."""
        return self._run(x, w1, w3, w2, idx, w, None, sync=False)[0]
