"""Crash-tolerant async streaming front door over the Scheduler.

The missing layer between the hardened scheduler and a wire
protocol: requests are submitted from any thread and consumed as
**token streams**; every scheduler guarantee (deadlines, cancellation,
bounded-queue shed, degradation, quarantine) surfaces here through the
serving/errors.py taxonomy; and every admitted request survives a process kill through the durable journal +
snapshot pair (serving/journal.py) and deterministic replay.

Architecture (one serving thread, lock-free scheduler):

    caller threads                 serving thread
    --------------                 --------------------------------
    submit()  ──┐ lock ┌──►  _tick() pump (Scheduler.run keep_alive):
    cancel()  ──┴──────┤       drain inbox -> sched.submit / cancel
                       │       publish new tokens -> TokenStream queues
    TokenStream ◄──────┤       journal token/finish records (fsync-
      iteration        │         batched; lifecycle records sync now)
      .result()        └──     periodic snapshot (atomic tmp+replace)

The scheduler itself stays single-threaded: callers never touch it —
they append to an inbox the pump drains between fused rounds, and read
per-request queues the pump feeds. ``drain()`` closes admissions
(further submits raise ShuttingDown), lets the batch run dry, then
joins the thread and seals the journal.

Crash + recovery contract:

  * A crash (SimulatedCrash from the fault injector, or any real
    exception escaping the serve loop) loses the scheduler's device
    state and the journal's *unflushed* tail — never flushed records.
  * ``recover()`` folds snapshot + journal tail into a request table,
    reports terminal requests as-is (their tokens are durable), and
    **resubmits every unfinished request** to a fresh engine
    incarnation. Already-durable tokens are re-delivered to the new
    stream instantly; the decode prefix is regenerated and *verified*
    against the journal (replay fidelity) but not re-emitted — the
    stream continues where it left off.
  * Under greedy sampling with the default (batch-independent) decode
    path, the regenerated stream is bit-identical to the uninterrupted
    run. Under temperature sampling, recovery restores the snapshot's
    scheduler RNG (the ``torch.Generator`` state it saved), so two
    recoveries from the same artifacts are seed-identical (the
    interrupted run's future is not replayable — its draws depended on
    lost batch composition). A snapshot written by the JAX package holds
    a PRNG key instead: the generator is seeded from that key's bits, so
    recoveries from those files are seed-identical too, but the JAX
    package's random stream is not reproduced.

On the card: the serving thread enters ``torch.no_grad()`` and the
engine's CUDA device itself (both are per thread in PyTorch) and
captures the scheduler's loops there (serving/graphs.py); a round's
tokens reach the host once, in the scheduler's harvest, never one
``.item()`` per token; and a drained or crashed incarnation hands its
running batch back to the engine (``Scheduler.release``), so a recovery
on the same engine borrows it, graphs included: recoveries neither pile
up caches nor capture again.
"""
from __future__ import annotations

import contextlib
import hashlib
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.errors import (REASON_WALL, DeadlineUnmeetable,
                                  QueueFull, ShuttingDown, error_for_reason,
                                  validate_request)
from repro_torch.serving.journal import (JournalWriter, Snapshot, fold_records,
                                   load_snapshot, read_journal,
                                   save_snapshot)
from repro_torch.serving.scheduler import DONE, SHED

_END = "__end__"


def _tok_py(tok):
    """Scheduler token -> JSON-able (int, or list for audio frames)."""
    arr = np.asarray(tok)
    return int(arr) if arr.ndim == 0 else arr.tolist()


def _tok_eq(a, b) -> bool:
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


class TokenStream:
    """One request's token stream. Single-consumer: iterate for tokens
    as they become durable-visible, or block on ``result()`` for the
    full greedy-ordered array. Terminal state carries the structured
    finish reason; ``result()``/``raise_for_status()`` map non-completed
    reasons onto the serving error taxonomy."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
                 spec: bool = False):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.spec = spec
        self.tokens: List = []            # published (durable-visible)
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.replayed = 0                 # tokens restored from journal
        self.replay_mismatch = 0          # replay-fidelity violations
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._done = threading.Event()

    # ------------------------------------------------- producer side ----

    def _push(self, tok) -> None:
        self.tokens.append(tok)
        self._q.put(tok)

    def _finish(self, reason: str) -> None:
        if self.finish_reason is None:
            self.finish_reason = reason
            self._done.set()
            self._q.put(_END)

    def _abort(self, exc: BaseException) -> None:
        """Crash path: no terminal reason — the stream ends with the
        crash exception so consumers never hang on a dead engine."""
        if self.finish_reason is None and self.error is None:
            self.error = exc
            self._done.set()
            self._q.put(_END)

    # ------------------------------------------------- consumer side ----

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def __iter__(self):
        while True:
            item = self._q.get()
            if isinstance(item, str) and item == _END:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until terminal; return the full token array for a
        completed request, else raise the taxonomy error for the finish
        reason (or the crash exception for an aborted stream)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"rid {self.rid} still streaming after "
                               f"{timeout}s")
        self.raise_for_status()
        return np.asarray(self.tokens)

    def raise_for_status(self) -> None:
        if self.error is not None:
            raise self.error
        exc = error_for_reason(self.finish_reason)
        if exc is not None:
            raise exc(f"rid {self.rid}: {self.finish_reason} "
                      f"after {len(self.tokens)} tokens")


@dataclass
class RecoveryReport:
    """What recover() found and did."""
    requests: int = 0            # journaled submits (admitted intents)
    terminal: int = 0            # already finished — reported, not replayed
    resumed: int = 0             # unfinished — resubmitted for replay
    torn_tail: bool = False      # journal ended in a truncated record
    corrupt_gaps: int = 0        # rids with a mid-file token gap (corrupt
                                 # journal; resumed from consistent prefix)
    snapshot_used: bool = False
    snapshot_round: int = -1
    journal_records: int = 0


class FrontDoor:
    """Async streaming front door over one Engine.

    Parameters beyond the engine/scheduler ones:

    journal_path       — WAL file; None disables durability.
    snapshot_path      — snapshot base path (``.npz``/``.json`` pair);
                         None disables snapshots (journal-only recovery).
    snapshot_every_rounds — snapshot cadence in fused decode rounds
                         (0 = never).
    fsync_every        — token-record fsync batch size.
    max_wall_s         — safety bound passed to Scheduler.run.

    Remaining keyword arguments go to Engine.make_scheduler (admission,
    deadlines infrastructure, faults, degrade, invariants, ...).
    """

    def __init__(self, engine, *, num_slots: int,
                 journal_path: Optional[str] = None,
                 snapshot_path: Optional[str] = None,
                 snapshot_every_rounds: int = 0,
                 fsync_every: int = 8,
                 max_wall_s: Optional[float] = None,
                 _journal_start_seq: int = 0,
                 **sched_kw):
        self._engine = engine
        self._faults = sched_kw.get("faults")
        self._sched = engine.make_scheduler(
            num_slots=num_slots, on_round=self._on_round, **sched_kw)
        self._max_wall_s = max_wall_s
        # the device the serving thread makes current: the engine's,
        # its index fixed here in the caller's thread
        self._device = self._sched.device
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._lock = threading.Lock()
        self._inbox: deque = deque()       # ("submit", stream) | ("cancel", rid)
        self.streams: Dict[int, TokenStream] = {}
        self._next_rid = 0                 # door/journal rid namespace
        self._alias: Dict[int, int] = {}   # scheduler rid -> door rid
        self._by_door_rid: Dict[int, object] = {}   # door rid -> RequestState
        self._consumed: Dict[int, int] = {}         # door rid -> sched toks seen
        self._replay: Dict[int, List] = {}          # door rid -> journaled prefix
        self._admitted: set = set()
        self._open = True
        self.crashed: Optional[BaseException] = None
        self.journal: Optional[JournalWriter] = None
        if journal_path is not None:
            self.journal = JournalWriter(journal_path,
                                         fsync_every=fsync_every,
                                         start_seq=_journal_start_seq)
        self._snap_path = snapshot_path
        self._snap_every = snapshot_every_rounds
        self._snap_idx = 0
        self._last_snap_round = 0
        self.snapshots_written = 0
        self._thread = threading.Thread(
            target=self._serve, name="frontdoor-serve", daemon=True)

    # ----------------------------------------------------- caller API ----

    def start(self) -> "FrontDoor":
        self._thread.start()
        return self

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               spec: Optional[bool] = None) -> TokenStream:
        """Submit a request; returns its TokenStream immediately.

        InvalidRequest raises synchronously (nothing journaled).
        Overload refusals (bounded queue / wait budget) surface on the
        stream: overload="reject" turns into QueueFull /
        DeadlineUnmeetable from ``result()``; overload="shed" into the
        structured shed reason. After drain() begins, raises
        ShuttingDown.

        ``spec`` opts the request into speculative decoding (requires a
        SpecScheduler; None = scheduler default). Resolved here so the
        journaled record carries a concrete bool — a spec=True submit on
        a non-spec scheduler raises synchronously, nothing journaled."""
        prompt = np.asarray(prompt)
        validate_request(
            int(prompt.shape[0]) if prompt.ndim else 0, max_new_tokens,
            cache_len=self._sched.cache_len, window=self._sched._window)
        spec = self._sched._resolve_spec(spec)
        with self._lock:
            if not self._open:
                raise ShuttingDown("front door is draining — admissions "
                                   "closed")
            rid = self._next_rid
            self._next_rid += 1
            stream = TokenStream(rid, prompt, max_new_tokens, spec=spec)
            self.streams[rid] = stream
            self._consumed[rid] = 0
            if self.journal is not None:
                self.journal.append(
                    "submit", rid=rid, prompt=prompt.tolist(),
                    max_new=max_new_tokens,
                    deadline_s=deadline_s,
                    ttft_deadline_s=ttft_deadline_s,
                    spec=spec)
            self._inbox.append(("submit", stream,
                                {"deadline_s": deadline_s,
                                 "ttft_deadline_s": ttft_deadline_s,
                                 "spec": spec}))
        return stream

    def cancel(self, rid: int) -> bool:
        """Request cancellation of a door rid (journaled; applied by the
        pump between fused rounds). False if already terminal."""
        with self._lock:
            stream = self.streams.get(rid)
            if stream is None or stream.done:
                return False
            # the crash path abandons (closes) the journal outside this
            # lock — a cancel racing it must not append to a dead WAL
            if self.journal is not None and not self.journal.closed:
                self.journal.append("cancel", rid=rid)
            self._inbox.append(("cancel", rid))
        return True

    def drain(self, timeout: Optional[float] = None) -> List[TokenStream]:
        """Graceful shutdown: stop admissions, run the batch (and queue)
        dry, seal the journal. Returns every stream, all terminal —
        unless the serve loop crashed, in which case unfinished streams
        are aborted with the crash exception (``self.crashed``)."""
        with self._lock:
            self._open = False
        if self._thread.is_alive() or not self._thread.ident:
            try:
                self._thread.join(timeout)
            except RuntimeError:          # never started: nothing to drain
                pass
        if self._thread.is_alive():
            raise TimeoutError(f"drain incomplete after {timeout}s")
        if self.journal is not None and not self.journal.closed:
            self.journal.append("drain", reason="graceful")
            self.journal.close()
        return [s for _, s in self._streams_items()]

    def replay_stats(self) -> Dict[str, float]:
        """Replay-fidelity census across recovered streams."""
        streams = [s for _, s in self._streams_items()]
        replayed = sum(s.replayed for s in streams)
        mism = sum(s.replay_mismatch for s in streams)
        return {"replayed_tokens": replayed, "mismatches": mism,
                "fidelity": 1.0 if replayed == 0
                else 1.0 - mism / replayed}

    # -------------------------------------------------- serving thread ----

    def _streams_items(self) -> List[Tuple[int, TokenStream]]:
        """Point-in-time copy of the stream table, rid-sorted. Caller
        threads insert under the lock, so every iteration — serving
        thread or census — must copy under it too (a bare iteration
        races dict resize)."""
        with self._lock:
            return sorted(self.streams.items())

    def _device_scope(self):
        """Per-thread state the serving thread must set itself: no
        autograd, and the engine's CUDA device as the current one."""
        scope = contextlib.ExitStack()
        scope.enter_context(torch.no_grad())
        if self._device.type == "cuda":
            scope.enter_context(torch.cuda.device(self._device))
        return scope

    def _serve(self) -> None:
        try:
            with self._device_scope():
                self._sched.run(max_wall_s=self._max_wall_s,
                                keep_alive=self._tick)
                with self._lock:
                    # close admissions BEFORE the final pump: a submit
                    # accepted after it would sit in the inbox unserved
                    # and its consumer would block forever
                    self._open = False
                self._tick()               # final publish + finish sweep
            # run() only returns with live streams via the max_wall_s
            # guard (or a final-tick admit the loop never decoded):
            # finish them as wall-shed so consumers never hang
            for rid, stream in self._streams_items():
                if not stream.done:
                    if self.journal is not None and not self.journal.closed:
                        self.journal.append("finish", rid=rid,
                                            reason=REASON_WALL,
                                            n_tokens=len(stream.tokens))
                    stream._finish(REASON_WALL)
        except BaseException as e:         # noqa: BLE001 — crash path
            self.crashed = e
            with self._lock:
                self._open = False         # dead engine: refuse admissions
            if self.journal is not None and not self.journal.closed:
                torn = self._faults.torn_tail_bytes() \
                    if self._faults is not None else 0
                # a real SIGKILL loses the buffered tail; a torn write
                # additionally leaves a partial record on disk
                self.journal.abandon(torn_bytes=torn)
            # the running batch died with this incarnation: hand it back
            # before any consumer learns of the crash and recovers
            self._sched.release()
            for _rid, stream in self._streams_items():
                stream._abort(e)
        finally:
            with self._lock:
                self._open = False
            self._sched.release()        # drained: back to the engine

    def _tick(self) -> bool:
        """The pump: runs in the serving thread once per scheduler loop
        (keep_alive) and after every fused round (on_round)."""
        with self._lock:
            items = list(self._inbox)
            self._inbox.clear()
        for item in items:
            if item[0] == "submit":
                _, stream, kw = item
                try:
                    st = self._sched.submit(
                        stream.prompt, stream.max_new_tokens,
                        arrival_s=self._sched._now(), **kw)
                except (QueueFull, DeadlineUnmeetable) as e:
                    # overload="reject": surface the refusal on the
                    # stream (its taxonomy class survives via reason)
                    stream.error = e
                    stream._finish(
                        "shed_queue" if isinstance(e, QueueFull)
                        else "shed_est_wait")
                    if self.journal is not None:
                        self.journal.append("finish", rid=stream.rid,
                                            reason=stream.finish_reason,
                                            n_tokens=0)
                    continue
                self._alias[st.req.rid] = stream.rid
                self._by_door_rid[stream.rid] = st
            else:
                _, rid = item
                st = self._by_door_rid.get(rid)
                if st is not None:
                    self._sched.cancel(st.req.rid)
        self._publish()
        self._maybe_snapshot()
        return self._open

    def _on_round(self, sched, round_idx: int) -> None:
        self._tick()

    def _publish(self) -> None:
        """Diff scheduler states against streams: push fresh tokens
        (suppressing + verifying the replayed prefix), journal them,
        finish terminal streams."""
        for door_rid, st in self._by_door_rid.items():
            stream = self.streams[door_rid]
            if stream.done:
                continue
            seen = self._consumed[door_rid]
            fresh = st.tokens[seen:]
            if fresh:
                if door_rid not in self._admitted:
                    self._admitted.add(door_rid)
                    if self.journal is not None:
                        self.journal.append("admit", rid=door_rid)
                replay = self._replay.get(door_rid)
                out = []
                for tok in fresh:
                    i = seen
                    seen += 1
                    if replay is not None and i < len(replay):
                        # regenerated prefix: verify, do not re-emit
                        if not _tok_eq(tok, replay[i]):
                            stream.replay_mismatch += 1
                        continue
                    stream._push(np.asarray(tok))
                    out.append(_tok_py(tok))
                self._consumed[door_rid] = seen
                if out and self.journal is not None:
                    self.journal.append(
                        "token", rid=door_rid,
                        i=len(stream.tokens) - len(out), tok=out)
            if st.status in (DONE, SHED):
                if self.journal is not None:
                    self.journal.append("finish", rid=door_rid,
                                        reason=st.finish_reason,
                                        n_tokens=len(stream.tokens))
                stream._finish(st.finish_reason)

    def _maybe_snapshot(self) -> None:
        if self._snap_path is None or self._snap_every <= 0:
            return
        if self._sched._round_idx - self._last_snap_round < self._snap_every:
            return
        self._last_snap_round = self._sched._round_idx
        if self._faults is not None:
            self._faults.before_snapshot(self._snap_idx)   # may crash
        self._snap_idx += 1
        # flush first: the snapshot must only subsume DURABLE records
        if self.journal is not None:
            self.journal.flush()
        snap = self._gather_snapshot()
        save_snapshot(self._snap_path, snap)
        self.snapshots_written += 1
        if self.journal is not None:
            self.journal.append("snapshot", path=self._snap_path,
                                covers_seq=snap.seq, idx=self._snap_idx - 1)

    def _gather_snapshot(self) -> Snapshot:
        snap = Snapshot(next_rid=self._next_rid,
                        seq=self.journal.seq if self.journal else 0,
                        total_steps=self._sched.total_steps,
                        round_idx=self._sched._round_idx,
                        torch_rng_state=self._sched._gen.get_state()
                        .numpy())
        for rid, s in self._streams_items():
            snap.requests[rid] = {"prompt": s.prompt,
                                  "tokens": list(s.tokens),
                                  "max_new": s.max_new_tokens,
                                  "reason": s.finish_reason,
                                  "arrival_s": 0.0,
                                  "spec": s.spec}
            if s.finish_reason is None:
                snap.queue.append(rid)
        slot_rids = np.full(self._sched.num_slots, -1, np.int64)
        for i, st in enumerate(self._sched._slots):
            if st is not None:
                slot_rids[i] = self._alias.get(st.req.rid, -1)
        snap.slot_rids = slot_rids
        snap.slot_cur_len = self._sched._cache["cur_len"].cpu().numpy() \
            .astype(np.int64)
        return snap


# ------------------------------------------------------------ recovery ----

def _restore_rng(gen: torch.Generator, snap: Snapshot) -> None:
    """Put the scheduler's generator where the snapshot left it: the
    port's saved ``torch_rng_state``, or, for a JAX package snapshot
    that holds only its PRNG key, a seed drawn from that key's bits
    (deterministic, so two recoveries agree; the JAX stream itself is
    not reproduced). Greedy decoding reads neither."""
    if snap.torch_rng_state is not None:
        gen.set_state(torch.from_numpy(
            np.asarray(snap.torch_rng_state, np.uint8).copy()))
    elif snap.rng_key is not None:
        bits = np.ascontiguousarray(snap.rng_key).tobytes()
        gen.manual_seed(int.from_bytes(
            hashlib.sha256(bits).digest()[:8], "little"))


def recover(engine, *, journal_path: str,
            snapshot_path: Optional[str] = None,
            num_slots: int,
            **door_kw) -> Tuple[FrontDoor, RecoveryReport]:
    """Cold-start a FrontDoor from a crashed incarnation's journal (+
    optional snapshot). Terminal requests are reported with their
    durable tokens; every unfinished admitted request is resubmitted
    for deterministic replay — its journaled tokens are re-delivered to
    the new stream immediately, the regenerated prefix is verified
    (replay fidelity) and fresh tokens continue the stream. The door is
    returned STARTED; callers stream/drain as usual.

    Deadlines are not re-armed on replay: the original budgets were
    relative to a wall clock that died with the process, and shedding a
    half-delivered stream on a stale deadline would turn one crash into
    two failures."""
    tail = read_journal(journal_path)
    if tail.torn:
        # repair: drop the torn fragment so the new incarnation's
        # appended records are reachable (the reader stops at the first
        # corrupt frame — anything after it would be invisible)
        with open(journal_path, "r+b") as f:
            f.truncate(tail.valid_bytes)
    snap = load_snapshot(snapshot_path) if snapshot_path else None
    table = fold_records(tail.records, base=snap)
    report = RecoveryReport(
        requests=len(table), torn_tail=tail.torn,
        corrupt_gaps=sum(1 for r in table.values() if r.get("token_gap")),
        snapshot_used=snap is not None,
        snapshot_round=snap.round_idx if snap else -1,
        journal_records=len(tail.records))
    door = FrontDoor(engine, num_slots=num_slots,
                     journal_path=journal_path,
                     snapshot_path=snapshot_path,
                     _journal_start_seq=tail.last_seq + 1,
                     **door_kw)
    if snap is not None:
        _restore_rng(door._sched._gen, snap)
    # a journaled spec request can only be replayed speculatively if the
    # new incarnation has a spec scheduler; otherwise degrade to plain
    # decode — greedy speculation is token-exact, so the regenerated
    # stream is bit-identical either way
    spec_capable = hasattr(door._sched, "_dcache")
    for rid in sorted(table):
        r = table[rid]
        spec = bool(r.get("spec", False)) and spec_capable
        stream = TokenStream(rid, np.asarray(r["prompt"]), r["max_new"],
                             spec=spec)
        door.streams[rid] = stream
        door._consumed[rid] = 0
        door._next_rid = max(door._next_rid, rid + 1)
        for tok in r["tokens"]:          # durable tokens: re-deliver now
            stream._push(np.asarray(tok))
        if r["reason"] is not None:      # terminal before the crash
            stream._finish(r["reason"])
            report.terminal += 1
            continue
        report.resumed += 1
        stream.replayed = len(r["tokens"])   # prefix to verify-regenerate
        door._replay[rid] = list(r["tokens"])
        door._inbox.append(("submit", stream,
                            {"deadline_s": None, "ttft_deadline_s": None,
                             "spec": spec}))
        if r.get("cancel_requested"):    # journaled but unapplied cancel
            door._inbox.append(("cancel", rid))
    return door.start(), report
