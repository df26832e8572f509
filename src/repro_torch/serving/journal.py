"""Durable request journal + engine snapshots for crash-tolerant serving.

The front door (serving/frontdoor.py) survives a process kill with two
on-disk artifacts:

  * **journal** — an append-only write-ahead log of request lifecycle
    records (``submit`` / ``admit`` / ``token`` / ``finish`` / ``cancel``
    / ``snapshot`` / ``drain``). Each record is framed as

        [u32 payload length][u32 crc32(payload)][payload (compact JSON)]

    so the reader can detect — and cleanly stop at — a torn final
    record after a crash. Writes are **fsync-batched**: token records
    buffer in memory and hit the disk every ``fsync_every`` records;
    lifecycle records (submit/finish/cancel/snapshot/drain) are synced
    immediately. ``abandon()`` models the crash itself: the buffered
    tail is *lost* (optionally leaving a torn prefix of the next
    record, as a real torn write would), which is exactly the loss
    profile recovery must tolerate.

  * **snapshot** — a periodic checkpoint of the *logical* engine state
    built on checkpoint/ckpt.py: per-request prompts + durably emitted
    tokens, queue order, the scheduler's RNG (``torch_rng_state``, the
    port's ``torch.Generator`` state; the JAX package writes its PRNG
    key as ``rng_key``), per-slot rid/cur_len table, and counters.
    Model params are referenced (by the recovering engine), never
    copied. Snapshots are written to a temp file and
    ``os.replace``d so a crash mid-snapshot never corrupts the last
    good one.

Recovery folds the snapshot and then the journal tail into one request
table (``fold_records``). Token records carry their absolute start
index, so applying them is idempotent — replaying the full journal over
a snapshot (or over a previous recovery's re-journaled tokens) always
converges to the same table.
"""
from __future__ import annotations

import json
import logging
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<II")          # (payload length, crc32)

# record types that fsync immediately (token records batch)
DURABLE_NOW = frozenset({"submit", "finish", "cancel", "snapshot", "drain"})


# ------------------------------------------------------------- writer ------

class JournalWriter:
    """Append-only CRC-framed journal with batched fsync.

    ``append()`` buffers the encoded record; the buffer is written +
    fsync'd when it holds ``fsync_every`` records or when a
    lifecycle-critical record type (DURABLE_NOW) lands. A record is
    **durable** only once flushed — ``abandon()`` (simulated crash)
    drops the buffered tail exactly like a real kill would.

    Thread-safe: the front door appends from caller threads (submit /
    cancel) and from the serving thread (token / finish / snapshot)
    concurrently, so every mutation holds an internal lock — without it
    an append landing between flush()'s write and its buffer clear
    would be silently dropped even though append() reported it durable.
    """

    def __init__(self, path: str, *, fsync_every: int = 8,
                 start_seq: int = 0):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.fsync_every = fsync_every
        self._lock = threading.RLock()      # append() flushes re-entrantly
        self._f: Optional[Any] = open(path, "ab")
        self._pending: List[bytes] = []
        self._seq = start_seq
        self.records_flushed = 0
        self.syncs = 0

    @property
    def seq(self) -> int:
        """Sequence number the next record will carry."""
        with self._lock:
            return self._seq

    @property
    def closed(self) -> bool:
        return self._f is None

    def append(self, rtype: str, **fields) -> int:
        """Buffer one record; flush per the fsync policy. Returns seq."""
        with self._lock:
            if self._f is None:
                raise ValueError("journal is closed")
            rec = {"seq": self._seq, "t": rtype, **fields}
            seq = self._seq
            self._seq += 1
            payload = json.dumps(rec, separators=(",", ":")).encode()
            self._pending.append(
                _HEADER.pack(len(payload), zlib.crc32(payload)) + payload)
            if rtype in DURABLE_NOW or len(self._pending) >= self.fsync_every:
                self.flush()
            return seq

    def flush(self) -> None:
        """Write + fsync everything buffered (records become durable)."""
        with self._lock:
            if self._f is None:
                return
            if self._pending:
                self._f.write(b"".join(self._pending))
                self.records_flushed += len(self._pending)
                self._pending.clear()
            self._f.flush()
            os.fsync(self._f.fileno())
            self.syncs += 1

    def abandon(self, *, torn_bytes: int = 0) -> int:
        """Simulated crash: the buffered tail is LOST. With
        ``torn_bytes > 0`` a strict prefix of the first unflushed record
        is left on disk — the torn-write the reader must tolerate.
        Returns the number of records dropped."""
        with self._lock:
            dropped = len(self._pending)
            if self._f is not None:
                if torn_bytes > 0 and self._pending:
                    frag = self._pending[0][:max(
                        1, min(torn_bytes, len(self._pending[0]) - 1))]
                    self._f.write(frag)
                    self._f.flush()
                    os.fsync(self._f.fileno())
                self._pending.clear()
                self._f.close()
                self._f = None
            return dropped

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self.flush()
                self._f.close()
                self._f = None


# ------------------------------------------------------------- reader ------

@dataclass
class JournalTail:
    """Everything recoverable from a journal file."""
    records: List[Dict]
    torn: bool = False            # file ended in a truncated/corrupt record
    valid_bytes: int = 0          # offset of the last intact record's end

    @property
    def last_seq(self) -> int:
        return self.records[-1]["seq"] if self.records else -1


def read_journal(path: str) -> JournalTail:
    """Read every intact record; tolerate a torn tail.

    A truncated header, truncated payload, CRC mismatch, or undecodable
    payload in the FINAL position is the signature of a crash mid-write:
    it is logged and skipped (``torn=True``) instead of crashing
    recovery. Everything before it is returned.
    """
    if not os.path.exists(path):
        return JournalTail(records=[])
    with open(path, "rb") as f:
        data = f.read()
    records: List[Dict] = []
    off, torn = 0, False
    while off < len(data):
        if off + _HEADER.size > len(data):
            torn = True
            break
        length, crc = _HEADER.unpack_from(data, off)
        start, end = off + _HEADER.size, off + _HEADER.size + length
        if end > len(data):
            torn = True
            break
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            torn = True
            break
        try:
            records.append(json.loads(payload))
        except (ValueError, UnicodeDecodeError):
            torn = True
            break
        off = end
    if torn:
        logger.warning(
            "journal %s: torn tail at byte %d/%d — %d intact records "
            "recovered, truncated final record skipped",
            path, off, len(data), len(records))
    return JournalTail(records=records, torn=torn, valid_bytes=off)


# ----------------------------------------------------------- snapshots -----

@dataclass
class Snapshot:
    """Logical engine state at a point in time (params NOT included —
    they are referenced by the recovering engine)."""
    requests: Dict[int, Dict] = field(default_factory=dict)
    # rid -> {"prompt": np.ndarray, "tokens": list, "max_new": int,
    #         "reason": Optional[str], "arrival_s": float}
    queue: List[int] = field(default_factory=list)     # non-terminal rids
    rng_key: Optional[np.ndarray] = None               # JAX PRNG key
    torch_rng_state: Optional[np.ndarray] = None       # Generator state
    slot_rids: Optional[np.ndarray] = None             # (S,) int, -1 empty
    slot_cur_len: Optional[np.ndarray] = None          # (S,) int
    next_rid: int = 0
    seq: int = 0                # journal seq this snapshot subsumes
    total_steps: int = 0
    round_idx: int = 0


def save_snapshot(path: str, snap: Snapshot) -> None:
    """Atomic snapshot write via checkpoint/ckpt.py (tmp + os.replace):
    a crash mid-write never clobbers the previous good snapshot."""
    arrays: Dict[str, np.ndarray] = {}
    meta_reqs: Dict[str, Dict] = {}
    for rid, r in snap.requests.items():
        arrays[f"prompt_{rid}"] = np.asarray(r["prompt"])
        arrays[f"tokens_{rid}"] = np.asarray(r["tokens"], np.int32) \
            if len(r["tokens"]) else np.zeros((0,), np.int32)
        meta_reqs[str(rid)] = {
            "max_new": int(r["max_new"]),
            "reason": r.get("reason"),
            "arrival_s": float(r.get("arrival_s", 0.0)),
            "spec": bool(r.get("spec", False)),
        }
    if snap.rng_key is not None:
        arrays["rng_key"] = np.asarray(snap.rng_key)
    if snap.torch_rng_state is not None:
        arrays["torch_rng_state"] = np.asarray(snap.torch_rng_state,
                                               np.uint8)
    if snap.slot_rids is not None:
        arrays["slot_rids"] = np.asarray(snap.slot_rids, np.int64)
        arrays["slot_cur_len"] = np.asarray(snap.slot_cur_len, np.int64)
    extra = {
        "kind": "xshare-serving-snapshot",
        "requests": meta_reqs,
        "queue": [int(r) for r in snap.queue],
        "next_rid": int(snap.next_rid),
        "seq": int(snap.seq),
        "total_steps": int(snap.total_steps),
        "round_idx": int(snap.round_idx),
    }
    base = path[:-4] if path.endswith(".npz") else path
    tmp = base + ".tmp"
    save_checkpoint(tmp, arrays, step=snap.round_idx, extra=extra)
    os.replace(tmp + ".npz", base + ".npz")
    os.replace(tmp + ".json", base + ".json")


def load_snapshot(path: str) -> Optional[Snapshot]:
    """Load a snapshot; None (logged) if absent or unreadable — recovery
    then proceeds from the journal alone."""
    base = path[:-4] if path.endswith(".npz") else path
    if not os.path.exists(base + ".npz"):
        return None
    try:
        arrays, meta = load_checkpoint(base)
    except Exception as e:                     # corrupt snapshot: skip it
        logger.warning("snapshot %s unreadable (%s) — recovering from "
                       "the journal alone", path, e)
        return None
    extra = meta.get("extra", {})
    snap = Snapshot(
        queue=[int(r) for r in extra.get("queue", [])],
        next_rid=int(extra.get("next_rid", 0)),
        seq=int(extra.get("seq", 0)),
        total_steps=int(extra.get("total_steps", 0)),
        round_idx=int(extra.get("round_idx", 0)),
        rng_key=arrays.get("rng_key"),
        torch_rng_state=arrays.get("torch_rng_state"),
        slot_rids=arrays.get("slot_rids"),
        slot_cur_len=arrays.get("slot_cur_len"),
    )
    for rid_s, m in extra.get("requests", {}).items():
        rid = int(rid_s)
        toks = arrays.get(f"tokens_{rid}")
        snap.requests[rid] = {
            "prompt": arrays[f"prompt_{rid}"],
            "tokens": [] if toks is None or toks.size == 0
            else [t for t in np.asarray(toks)],
            "max_new": int(m["max_new"]),
            "reason": m.get("reason"),
            "arrival_s": float(m.get("arrival_s", 0.0)),
            "spec": bool(m.get("spec", False)),
        }
    return snap


# ------------------------------------------------------------- folding -----

def fold_records(records: List[Dict],
                 base: Optional[Snapshot] = None) -> Dict[int, Dict]:
    """Fold journal records (over an optional snapshot base) into one
    request table: rid -> {prompt, max_new, arrival_s, tokens, reason}.

    Application is idempotent: token records assign at their absolute
    start index, submit records only create missing entries, finish
    records overwrite the reason. Replaying the whole journal over any
    snapshot therefore converges to the same table.

    A token record whose start index lies beyond the tokens accumulated
    so far is **mid-file corruption**, not a torn tail: fsync batching
    flushes earlier tokens before later ones, so an intact journal can
    never produce a gap. The rid keeps its consistent prefix, every
    later token record for it is ignored (applying past the gap would
    fabricate an inconsistent stream), and the entry is flagged with
    ``token_gap=True`` so recovery can report it instead of silently
    replaying a short prefix as durable truth.
    """
    table: Dict[int, Dict] = {}
    if base is not None:
        for rid, r in base.requests.items():
            table[rid] = {"prompt": np.asarray(r["prompt"]),
                          "tokens": list(r["tokens"]),
                          "max_new": r["max_new"],
                          "reason": r.get("reason"),
                          "arrival_s": r.get("arrival_s", 0.0),
                          "spec": r.get("spec", False)}
    for rec in records:
        t = rec["t"]
        if t == "submit":
            rid = rec["rid"]
            if rid not in table:
                table[rid] = {"prompt": np.asarray(rec["prompt"], np.int32),
                              "tokens": [],
                              "max_new": rec["max_new"],
                              "reason": None,
                              "arrival_s": rec.get("arrival_s", 0.0),
                              "spec": rec.get("spec", False)}
        elif t == "token":
            r = table.get(rec["rid"])
            if r is None:          # token for an unjournaled submit: skip
                logger.warning("journal: token record for unknown rid %s",
                               rec["rid"])
                continue
            if r.get("token_gap"):     # rid poisoned by an earlier gap
                continue
            i, toks = rec["i"], rec["tok"]
            if len(r["tokens"]) < i:   # mid-file corruption (see above)
                logger.error(
                    "journal: token gap for rid %s at index %d (have %d "
                    "tokens) — mid-file corruption; keeping the consistent "
                    "prefix and ignoring this rid's later token records",
                    rec["rid"], i, len(r["tokens"]))
                r["token_gap"] = True
                continue
            r["tokens"][i:i + len(toks)] = toks
        elif t == "finish":
            r = table.get(rec["rid"])
            if r is not None:
                r["reason"] = rec["reason"]
        elif t == "cancel":
            r = table.get(rec["rid"])
            if r is not None and r["reason"] is None:
                r["cancel_requested"] = True
        # "admit" / "snapshot" / "drain" records carry no table state
    return table


def last_snapshot_record(records: List[Dict]) -> Optional[Dict]:
    for rec in reversed(records):
        if rec["t"] == "snapshot":
            return rec
    return None
