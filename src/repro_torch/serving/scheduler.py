"""Continuous-batching scheduler with XShare-aware admission and a
serving robustness layer.

The serving substrate the paper's batch-composition premise actually
needs: requests arrive and finish at different times, and the scheduler
keeps a fixed-size running batch (static shapes) whose slots
have independent lifetimes.

Request lifecycle:  waiting -> prefill -> decode -> done | shed.

  * waiting  — submitted; not yet visible (future arrival) or queued.
  * prefill  — a single-request prefill builds its cache row, the first
               token is sampled from the prefill logits, and the row is
               spliced into the running batch cache (insert_request).
  * decode   — the slot participates in N-token decode loops
               (serving/step.py; on the card, replays of a captured
               CUDA graph, serving/graphs.py); the scheduler harvests
               tokens between loops.
  * done     — reached max_new_tokens; the slot is evicted and refilled
               from the queue.
  * shed     — any non-success terminal state (cancelled, deadline
               expiry, admission shed, numerics quarantine, fault);
               ``finish_reason`` (serving/errors.py) says which.

Admission policies:

  * "fcfs"     — first come, first served.
  * "affinity" — the paper's correlation-aware selection lifted to the
                 scheduling layer: each request carries a gate histogram
                 (cheap router probe at submit time); admission greedily
                 picks the waiting request whose histogram maximally
                 overlaps the running batch's aggregated gate mass
                 (core/selection.py rank_by_affinity). Batches then
                 share experts *by construction*, shrinking the
                 activated set every XShare policy works against.

Robustness layer (all opt-in, zero-cost when off):

  * deadlines  — per-request TTFT and end-to-end budgets; expired
                 queued requests are shed before they stall admission,
                 expired running requests are evicted mid-decode.
  * cancel(rid) — abort a queued or mid-decode request; its slot is
                 evicted and refilled on the next admission pass.
  * bounded queue — ``max_queue`` depth plus an estimated-wait budget
                 (``admit_wait_budget_s`` against an observed-throughput
                 EMA); over budget either raises (overload="reject") or
                 sheds with a structured reason (overload="shed").
  * graceful degradation — a pressure ladder (queue depth / slots, and
                 watchdog stalls): each level falls back from affinity
                 to FCFS admission and tightens the XShare
                 policy_max_active budget (tighten_policy below), so
                 throughput degrades smoothly under load and recovers
                 with hysteresis when pressure clears.
  * numerics quarantine — the decode loop flags slots whose logits went
                 non-finite; only that request is terminated (evicted
                 with a scrubbed cache row), the rest of the batch is
                 bit-exact with a fault-free run.
  * watchdog   — per-step wall-time budget (``watchdog_s``) counts
                 stalls into the pressure signal; transient step faults
                 (serving/faults.py) are retried with exponential
                 backoff before the request is shed.
  * invariants — ``check_invariants()`` validates the slot-state
                 machine, cur_len ↔ active-mask consistency, and
                 batch-mass accounting after every scheduler
                 intervention when ``invariants=True``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MoEConfig, XSharePolicy
from repro_torch.core.selection import rank_by_affinity
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import effective_window, init_cache, params_to
from repro_torch.models.moe import OFF
from repro_torch.serving.errors import (REASON_CANCELLED, REASON_COMPLETED,
                                  REASON_DEADLINE_E2E, REASON_DEADLINE_TTFT,
                                  REASON_FAULT, REASON_NUMERICS,
                                  REASON_SHED_QUEUE, REASON_SHED_WAIT,
                                  REASON_WALL, DeadlineUnmeetable,
                                  InvariantViolation, QueueFull,
                                  TransientFault, WatchdogTimeout,
                                  validate_request)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.graphs import GraphLoop, LoopPool, LoopState
from repro_torch.serving.sampler import sample_step
from repro_torch.serving.step import (NO_FAULT, StepFns, build_step_fns,
                                      make_fused)

WAITING, PREFILL, DECODE, DONE, SHED = \
    "waiting", "prefill", "decode", "done", "shed"

# legal slot-state machine edges (enforced by _set_status / invariants)
_TRANSITIONS = {
    WAITING: (PREFILL, SHED),
    PREFILL: (DECODE, DONE, SHED),
    DECODE: (DONE, SHED),
    DONE: (),
    SHED: (),
}

MAX_DEGRADE = 2  # degradation-ladder depth (level 0 = healthy)


def tighten_policy(policy: XSharePolicy, level: int,
                   moe: Optional[MoEConfig]) -> XSharePolicy:
    """Degradation ladder for the XShare budget: each level halves the
    policy's headroom so policy_max_active — and with it the sorted
    dispatch's padded layout and expert weight traffic — shrinks under
    load. An OFF policy gains a batch budget (there is nothing to
    tighten otherwise); floors keep at least top_k-ish experts live so
    routing never degenerates to an empty set."""
    if level <= 0 or moe is None:
        return policy
    if policy.mode == "off":
        m = max(moe.top_k, moe.num_experts >> (level + 1))
        return XSharePolicy(mode="batch", k0=1, m_l=m)
    if policy.mode == "batch":
        return dataclasses.replace(policy, m_l=policy.m_l >> level)
    if policy.mode == "ep":
        return dataclasses.replace(policy, m_g=max(1, policy.m_g >> level))
    if policy.mode == "spec":
        return dataclasses.replace(policy, m_l=policy.m_l >> level,
                                   m_r=max(1, policy.m_r >> level))
    return policy


@dataclass
class Request:
    """One generation request. prompt: (S,) int32 ((S, K) audio).
    deadline_s / ttft_deadline_s are budgets relative to arrival_s."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0  # relative to Scheduler.run() start
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None
    spec: bool = False      # decode speculatively (SpecScheduler only)


@dataclass
class RequestState:
    """Lifecycle + per-request accounting (stats tagged per request)."""
    req: Request
    status: str = WAITING
    slot: int = -1
    tokens: List = field(default_factory=list)
    gate_hist: Optional[np.ndarray] = None
    finish_reason: Optional[str] = None
    cancel_requested: bool = False
    history: List[str] = field(default_factory=lambda: [WAITING])
    mass_counted: bool = False   # gate_hist currently in _batch_mass
    t_admitted: float = float("nan")
    t_first_token: float = float("nan")
    t_done: float = float("nan")
    # batch-level XShare aux for every fused step this request was live in
    layer_aux: List[Dict] = field(default_factory=list)
    # speculative-decoding accounting (SpecScheduler)
    drafted: int = 0             # draft tokens proposed for this request
    accepted_drafts: int = 0     # draft tokens the target accepted
    spec_budget_exhausted: bool = False

    @property
    def latency_s(self) -> float:
        return self.t_done - self.req.arrival_s

    @property
    def ttft_s(self) -> float:
        return self.t_first_token - self.req.arrival_s


class Scheduler:
    """Continuous-batching scheduler over a fixed-size slot array.

    Drives the StepFns bundle: per-request prefill + cache insert on
    admission, N-token decode loops over the running batch, eviction +
    re-admission as requests finish. The robustness knobs (see module
    docstring) all default off, leaving the healthy path bit-identical
    to the plain scheduler.

    The running batch (``tok``, the cache, the generator) is a
    LoopState borrowed from ``loop_pool`` (an engine's, so its captured
    loops serve the next scheduler too; by default one of its own) and
    written in place; ``release()`` hands it back.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 num_slots: int,
                 cache_len: int = 512,
                 policy: XSharePolicy = OFF,
                 admission: str = "fcfs",
                 decode_chunk: int = 8,
                 temperature: float = 0.0,
                 force_window: Optional[int] = None,
                 capacity_factor: float = 8.0,
                 dispatch: str = "auto",
                 seed: int = 0,
                 fns: Optional[StepFns] = None,
                 max_queue: Optional[int] = None,
                 overload: str = "reject",
                 admit_wait_budget_s: Optional[float] = None,
                 watchdog_s: Optional[float] = None,
                 max_retries: int = 2,
                 retry_backoff_s: float = 0.02,
                 degrade: bool = False,
                 degrade_hi: float = 2.0,
                 degrade_lo: float = 0.5,
                 invariants: bool = False,
                 faults: Optional[FaultInjector] = None,
                 on_round: Optional[Callable] = None,
                 loop_pool: Optional[LoopPool] = None,
                 device: DeviceLike = None):
        if admission not in ("fcfs", "affinity"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if overload not in ("reject", "shed"):
            raise ValueError(f"unknown overload policy {overload!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.admission = admission
        self.temperature = temperature
        self.policy = policy
        self.max_queue = max_queue
        self.overload = overload
        self.admit_wait_budget_s = admit_wait_budget_s
        self.watchdog_s = watchdog_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.degrade = degrade
        self.degrade_hi = degrade_hi
        self.degrade_lo = degrade_lo
        self.invariants = invariants
        self.faults = faults
        self.on_round = on_round
        self._force_window = force_window
        self._capacity_factor = capacity_factor
        self._dispatch = dispatch
        self._window = effective_window(cfg, force_window=force_window)
        self.fns = fns or build_step_fns(
            cfg, policy=policy, cache_len=cache_len,
            decode_chunk=decode_chunk, temperature=temperature,
            force_window=force_window, capacity_factor=capacity_factor,
            dispatch=dispatch)
        self._next_rid = 0
        self._incoming: List[RequestState] = []   # not yet arrived
        self._queue: List[RequestState] = []      # arrived, waiting
        self._slots: List[Optional[RequestState]] = [None] * num_slots
        self._states: List[RequestState] = []     # submission order
        self._by_rid: Dict[int, RequestState] = {}
        # device-side running-batch state, borrowed from the pool
        self._pool = loop_pool if loop_pool is not None else LoopPool()
        self._state: Optional[LoopState] = self._pool.acquire(
            self._state_key(), self, self._new_state)
        self._gen = self._state.gen
        self._gen.manual_seed(seed)
        self._active = np.zeros(num_slots, bool)
        # host-side aggregated gate mass of the running batch (affinity)
        E = cfg.moe.num_experts if cfg.moe else 0
        self._batch_mass = np.zeros(E, np.float64)
        self.total_steps = 0          # fused decode steps executed
        self.step_aux: List[Dict] = []  # batch-level aux per decode step
        self._t0: Optional[float] = None
        self.wall_s = 0.0             # frozen at the end of run()
        # robustness accounting
        self.level = 0                                # degradation level
        self.degrade_events: List = []                # (t, new level)
        self.stall_events = 0                         # watchdog overruns
        self.retries = 0                              # transient retries
        self._stalls_acked = 0
        self._round_idx = 0
        self._otps_ema: Optional[float] = None

    # ------------------------------------------------------ batch state --

    def _state_key(self) -> tuple:
        return ("plain", self.num_slots, self.cache_len,
                self.params["embed"].dtype, self.fns.decode_chunk)

    def _new_state(self) -> LoopState:
        dtype = self.params["embed"].dtype
        return LoopState(
            {"tok": torch.zeros((self.num_slots,), dtype=torch.int32,
                                device=self.device),
             "cache": init_cache(self.cfg, self.num_slots, self.cache_len,
                                 dtype, force_window=self._force_window,
                                 device=self.device)},
            torch.Generator(device=self.device))

    @property
    def _cache(self) -> Optional[Dict]:
        return None if self._state is None else self._state.tensors["cache"]

    @property
    def _tok(self) -> Optional[torch.Tensor]:
        return None if self._state is None else self._state.tensors["tok"]

    def _resolve_spec(self, spec: Optional[bool]) -> bool:
        """Plain scheduler: speculative requests are not supported —
        spec=None/False is accepted (and means plain decode) so callers
        can use one submit signature; spec=True is a caller error.
        SpecScheduler overrides this with its own default."""
        if spec:
            raise ValueError(
                "spec=True needs a SpecScheduler (engine draft model + "
                "spec_len > 0)")
        return False

    # ------------------------------------------------------------- time --

    def _now(self) -> float:
        return time.perf_counter() - self._t0 if self._t0 is not None \
            else 0.0

    # -------------------------------------------------------- submission --

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               arrival_s: float = 0.0,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               spec: Optional[bool] = None) -> RequestState:
        prompt = np.asarray(prompt)
        validate_request(int(prompt.shape[0]) if prompt.ndim else 0,
                         max_new_tokens, cache_len=self.cache_len,
                         window=self._window)
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, arrival_s=arrival_s,
                      deadline_s=deadline_s,
                      ttft_deadline_s=ttft_deadline_s,
                      spec=self._resolve_spec(spec))
        self._next_rid += 1
        st = RequestState(req=req)
        # --- bounded-queue admission control -----------------------------
        pending = len(self._incoming) + len(self._queue)
        if self.max_queue is not None and pending >= self.max_queue:
            return self._refuse(st, REASON_SHED_QUEUE, QueueFull(
                f"queue at capacity ({pending}/{self.max_queue})"))
        est = self._estimated_wait_s()
        if (self.admit_wait_budget_s is not None and est is not None
                and est > self.admit_wait_budget_s):
            return self._refuse(st, REASON_SHED_WAIT, DeadlineUnmeetable(
                f"estimated wait {est:.3f}s exceeds admission budget "
                f"{self.admit_wait_budget_s:.3f}s"))
        if self.admission == "affinity" and self.fns.probe is not None:
            hist = self.fns.probe(self.params, torch.tensor(
                req.prompt[None], device=self.device))
            st.gate_hist = hist.cpu().numpy().astype(np.float64)
        self._states.append(st)
        self._by_rid[req.rid] = st
        self._incoming.append(st)
        return st

    def _refuse(self, st: RequestState, reason: str, exc: Exception):
        """Admission control refusal: raise (overload="reject") or
        record the request as shed (overload="shed")."""
        if self.overload == "reject":
            raise exc
        self._states.append(st)
        self._by_rid[st.req.rid] = st
        self._finish(st, slot=None, reason=reason)
        return st

    def _estimated_wait_s(self) -> Optional[float]:
        """Outstanding token debt over the observed throughput EMA —
        None until the first decode round calibrates the rate."""
        if not self._otps_ema:
            return None
        owed = sum(s.req.max_new_tokens - len(s.tokens)
                   for s in self._queue)
        owed += sum(s.req.max_new_tokens - len(s.tokens)
                    for s in self._slots if s is not None)
        return owed / self._otps_ema

    # ------------------------------------------------------ cancellation --

    def cancel(self, rid: int) -> bool:
        """Abort a request: queued requests leave the queue immediately;
        a mid-decode request's slot is evicted on the spot (the
        scheduler is single-threaded — callers reach this between fused
        rounds, e.g. from the on_round hook). Returns False if the
        request is unknown or already terminal."""
        st = self._by_rid.get(rid)
        if st is None or st.status in (DONE, SHED):
            return False
        st.cancel_requested = True
        if st.status == WAITING:
            if st in self._incoming:
                self._incoming.remove(st)
            if st in self._queue:
                self._queue.remove(st)
            self._finish(st, slot=None, reason=REASON_CANCELLED)
        elif st.slot >= 0:
            self._finish(st, slot=st.slot, reason=REASON_CANCELLED)
        return True

    # --------------------------------------------------------- lifecycle --

    def _set_status(self, st: RequestState, new: str) -> None:
        if new not in _TRANSITIONS[st.status]:
            raise InvariantViolation(
                f"illegal transition {st.status} -> {new} "
                f"(rid {st.req.rid}, history {st.history})")
        st.status = new
        st.history.append(new)

    # ----------------------------------------------------- expert priors --

    def gate_priors(self) -> np.ndarray:
        """Per-slot expert-affinity priors of the running batch:
        (num_slots, E) float64, row s = slot s's best current gate-
        histogram estimate (zeros for empty slots; E == 0 columns for
        router-free models). The stable read API for expert-affinity
        consumers — EP placement feeds the batch-aggregate
        ``gate_priors().sum(0)`` into ``ep.plan_placement`` /
        ``EPExecutor.update_placement``, and SpecScheduler's override
        supplies Algorithm-4's correlation priors — instead of each
        consumer poking at slot internals (``_slots[s].gate_hist``,
        ``_slot_spec[s].prior``).

        Base scheduler: the admission-time prompt gate histograms
        (``RequestState.gate_hist``), static per request.
        """
        E = self.cfg.moe.num_experts if self.cfg.moe else 0
        out = np.zeros((self.num_slots, E), np.float64)
        if E:
            for s, st in enumerate(self._slots):
                if st is not None and st.gate_hist is not None:
                    out[s] = st.gate_hist
        return out

    # --------------------------------------------------------- admission --

    @property
    def admission_effective(self) -> str:
        """Degradation ladder level >= 1 falls back to FCFS (skips the
        affinity ranking work and its batch-composition constraint)."""
        return "fcfs" if self.level > 0 else self.admission

    def _pick_next(self) -> RequestState:
        """Greedy XShare-aware admission: the queued request whose gate
        histogram maximally overlaps the running batch's aggregated gate
        mass. FIFO when configured so, when the model has no router, or
        when the batch is empty (all scores 0, argmax -> head)."""
        if self.admission_effective == "fcfs" or not len(self._batch_mass) \
                or any(s.gate_hist is None for s in self._queue):
            return self._queue.pop(0)
        # scored in f32, as the JAX package does
        hists = torch.as_tensor(np.stack([s.gate_hist for s in self._queue]),
                                dtype=torch.float32)
        mass = torch.as_tensor(self._batch_mass, dtype=torch.float32)
        scores = rank_by_affinity(hists, mass).numpy()
        return self._queue.pop(int(scores.argmax()))

    def _first_token(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_step(logits, self._gen, temperature=self.temperature)

    def _retry(self, what: str, rid: int, call: Callable):
        """Watchdog retry loop: transient faults (injected or wrapped)
        back off exponentially; exhaustion raises WatchdogTimeout and
        the caller sheds just that request."""
        delay = self.retry_backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                if self.faults is not None and what == "insert":
                    self.faults.before_insert(rid)
                return call()
            except TransientFault as e:
                self.retries += 1
                if attempt == self.max_retries:
                    raise WatchdogTimeout(
                        f"{what} rid={rid} failed after "
                        f"{self.max_retries + 1} attempts: {e}") from e
                time.sleep(delay)
                delay *= 2

    def _admit_group(self, group, now: float) -> None:
        """Prefill a group of same-shape admissions as ONE batched
        prefill and splice each row into its slot. Simultaneous arrivals
        (the all-at-t=0 case) therefore pay a single prefill dispatch —
        and run through the numerically identical computation the
        lockstep engine's batched prefill performs."""
        t_pre = time.perf_counter()   # watchdog window includes host stalls
        if self.faults is not None:
            self.faults.before_prefill([st.req.rid for st, _ in group])
        prompts = torch.as_tensor(np.stack([st.req.prompt for st, _ in group]),
                                  device=self.device)
        lg, req_cache, _ = self.fns.prefill(self.params, prompts)
        toks0 = self._first_token(lg)              # (G,)
        toks0_np = toks0.cpu().numpy()   # blocks: TTFT must include device time
        if self.watchdog_s is not None and \
                time.perf_counter() - t_pre > self.watchdog_s:
            self.stall_events += 1
        t_first = time.perf_counter() - self._t0
        if (len(group) == self.num_slots
                and [slot for _, slot in group] == list(range(len(group)))
                and not self._active.any()
                and all(st.req.max_new_tokens > 1 for st, _ in group)):
            # whole-batch admission into an empty machine (the all-at-t=0
            # case): the group prefill cache becomes the running cache in
            # one copy per tensor, no per-slot insert dispatches
            for k, v in self._cache.items():
                v.copy_(req_cache[k])
            self._tok.copy_(toks0)
            for i, (st, slot) in enumerate(group):
                self._set_status(st, PREFILL)
                self._set_status(st, DECODE)
                st.t_admitted = now
                st.tokens.append(toks0_np[i])
                st.t_first_token = t_first
                st.slot = slot
                self._slots[slot] = st
                self._active[slot] = True
            return
        for i, (st, slot) in enumerate(group):
            self._set_status(st, PREFILL)
            st.t_admitted = now
            st.tokens.append(toks0_np[i])
            st.t_first_token = t_first
            if len(st.tokens) >= st.req.max_new_tokens:
                self._finish(st, slot=None)
                continue
            try:
                self._retry(
                    "insert", st.req.rid,
                    lambda: self.fns.insert(self._cache, req_cache, slot, i))
            except WatchdogTimeout:
                # the splice itself is the casualty: shed this request,
                # leave the slot free for the next admission pass
                self._finish(st, slot=None, reason=REASON_FAULT)
                continue
            self._tok[slot] = toks0[i]
            self._slots[slot] = st
            self._active[slot] = True
            st.slot = slot
            self._set_status(st, DECODE)

    def _finish(self, st: RequestState, slot: Optional[int],
                reason: str = REASON_COMPLETED, scrub: bool = False) -> None:
        self._set_status(st, DONE if reason == REASON_COMPLETED else SHED)
        st.finish_reason = reason
        st.t_done = self._now()
        if st.mass_counted and st.gate_hist is not None:
            self._batch_mass -= st.gate_hist
            st.mass_counted = False
        if slot is not None:
            evict = self.fns.evict_scrub if scrub else self.fns.evict
            evict(self._cache, slot)
            self._slots[slot] = None
            self._active[slot] = False
            st.slot = -1

    def _fill_slots(self, now: float) -> None:
        # shed queued requests that can no longer meet their deadline —
        # BEFORE they occupy a slot, so expiry never stalls admission
        still = []
        for st in self._queue:
            r = st.req
            if st.cancel_requested:
                self._finish(st, slot=None, reason=REASON_CANCELLED)
            elif r.ttft_deadline_s is not None and \
                    now > r.arrival_s + r.ttft_deadline_s:
                self._finish(st, slot=None, reason=REASON_DEADLINE_TTFT)
            elif r.deadline_s is not None and \
                    now > r.arrival_s + r.deadline_s:
                self._finish(st, slot=None, reason=REASON_DEADLINE_E2E)
            else:
                still.append(st)
        self._queue[:] = still
        free = [s for s in range(self.num_slots) if self._slots[s] is None]
        picks = []
        while free and self._queue:
            st = self._pick_next()         # greedy: sees mass so far
            if st.gate_hist is not None:
                self._batch_mass += st.gate_hist
                st.mass_counted = True
            picks.append((st, free.pop(0)))
        # batch same-shape prompts into one prefill dispatch
        by_shape: Dict = {}
        for st, slot in picks:
            by_shape.setdefault(st.req.prompt.shape, []).append((st, slot))
        for group in by_shape.values():
            self._admit_group(group, now)

    # ------------------------------------------------------------ decode --

    def _loop_at(self, level: int) -> GraphLoop:
        """The decode loop for a degradation level over the borrowed
        state — level 0 runs the configured bundle, higher levels a
        variant with a tightened XShare policy (everything else
        identical); each is built, and on the card captured, at its
        first use."""
        level = level if self.cfg.moe is not None else 0
        return self._state.loop(level, lambda: self._make_loop(level))

    def _make_loop(self, level: int):
        fused = self.fns.fused
        if level:
            fused = make_fused(
                self.cfg, policy=tighten_policy(self.policy, level,
                                                self.cfg.moe),
                decode_chunk=self.fns.decode_chunk,
                temperature=self.temperature,
                force_window=self._force_window,
                capacity_factor=self._capacity_factor,
                dispatch=self._dispatch)
        params = self.params

        def run(t, gen, i):
            return fused(params, t["tok"], t["cache"], i["remaining"], gen,
                         i["fault"])
        return run, {
            "remaining": torch.zeros((self.num_slots,), dtype=torch.int32,
                                     device=self.device),
            "fault": torch.tensor(NO_FAULT, dtype=torch.int32,
                                  device=self.device)}

    def _decode_round(self) -> None:
        """One N-token decode loop + harvest. Slots carry their remaining
        token budget on device, so a request that finishes mid-chunk
        stops computing (and influencing XShare selection) on the next
        step, not at the chunk boundary. Poisoned slots (non-finite
        logits) are quarantined: their request is shed and the slot
        evicted with a scrubbed cache row; the co-batched slots'
        tokens are bit-exact with a fault-free round."""
        t_round = time.perf_counter()
        if self.faults is not None:
            self.faults.before_round(self._round_idx)
            fault = self.faults.nan_fault(
                self.total_steps, self.total_steps + self.fns.decode_chunk)
        else:
            fault = NO_FAULT
        remaining = np.asarray(
            [st.req.max_new_tokens - len(st.tokens) if st else 0
             for st in self._slots], np.int32)
        _, _, toks, aux, ok, poisoned = self._loop_at(self.level)(
            remaining=remaining, fault=fault)
        toks = toks.cpu().numpy()                  # sync point: (N, B)
        ok = ok.cpu().numpy()                      # (N, B)
        poisoned = poisoned.cpu().numpy()          # (B,)
        dt = time.perf_counter() - t_round
        if self.watchdog_s is not None and dt > self.watchdog_s:
            self.stall_events += 1
        now = self._now()
        N = toks.shape[0]
        self.total_steps += N
        self._round_idx += 1
        aux_np = {kk: v.cpu().numpy() for kk, v in aux.items()}
        step_auxs = [{kk: v[i] for kk, v in aux_np.items()}
                     for i in range(N)]
        self.step_aux.extend(step_auxs)
        valid = ok.sum(axis=0)                     # real tokens per slot
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            take = min(int(valid[slot]),
                       st.req.max_new_tokens - len(st.tokens))
            st.tokens.extend(toks[i, slot] for i in range(take))
            st.layer_aux.extend(step_auxs[:take])
            if poisoned[slot]:
                self._finish(st, slot=slot, reason=REASON_NUMERICS,
                             scrub=True)
            elif len(st.tokens) >= st.req.max_new_tokens:
                self._finish(st, slot=slot)
        harvested = int(valid.sum())
        if harvested and dt > 0:
            rate = harvested / dt
            self._otps_ema = rate if self._otps_ema is None \
                else 0.5 * self._otps_ema + 0.5 * rate
        # end-to-end deadlines for still-running requests
        for slot, st in enumerate(self._slots):
            if st is not None and st.req.deadline_s is not None and \
                    now > st.req.arrival_s + st.req.deadline_s:
                self._finish(st, slot=slot, reason=REASON_DEADLINE_E2E)
        if self.on_round is not None:
            self.on_round(self, self._round_idx)

    def release(self) -> None:
        """Hand the running-batch state (the KV / SSM cache, the last
        tokens, the generator and its captured loops) back to the pool,
        for a scheduler that will not run again: a finished
        ``Engine.generate``'s, a drained or crashed front door's, whose
        recovery on the same engine then borrows it."""
        if self._state is not None:
            self._pool.release(self._state)
            self._state = None

    # -------------------------------------------------------- degradation --

    def _update_degradation(self, now: float) -> None:
        """Pressure ladder with hysteresis: queue depth per slot (and
        fresh watchdog stalls) escalate one level; calm recovers one."""
        if not self.degrade:
            return
        new_stalls = self.stall_events - self._stalls_acked
        self._stalls_acked = self.stall_events
        p = len(self._queue) / max(1, self.num_slots)
        lvl = self.level
        if (p >= self.degrade_hi or new_stalls) and lvl < MAX_DEGRADE:
            lvl += 1
        elif p <= self.degrade_lo and not new_stalls and lvl > 0:
            lvl -= 1
        if lvl != self.level:
            self.level = lvl
            self.degrade_events.append((now, lvl))

    # --------------------------------------------------------------- run --

    def _shed_all(self, reason: str) -> None:
        """Terminal sweep: everything not yet finished is shed."""
        for st in list(self._incoming) + list(self._queue):
            self._finish(st, slot=None, reason=reason)
        self._incoming.clear()
        self._queue.clear()
        for slot, st in enumerate(self._slots):
            if st is not None:
                self._finish(st, slot=slot, reason=reason)

    def run(self, *, max_wall_s: Optional[float] = None,
            keep_alive: Optional[Callable[[], bool]] = None
            ) -> List[RequestState]:
        """Serve every submitted request to a terminal state. Arrival
        times are honored against the wall clock (arrival_s is relative
        to this call). max_wall_s bounds the serve loop: on expiry every
        unfinished request is shed (reason "run_wall_timeout") so run()
        is guaranteed to return even under a fault campaign. Returns
        RequestStates in submission order.

        keep_alive — the front door's pump (serving/frontdoor.py):
        called once per loop iteration BEFORE admission, it may submit
        or cancel requests (the scheduler is single-threaded; this is
        the one sanctioned re-entry point alongside on_round) and its
        return value keeps the loop alive while True even with nothing
        queued or running, so an open door can idle-wait for traffic.
        Without it the loop exits exactly as before — when all
        submitted work is terminal."""
        self._t0 = time.perf_counter()
        self.wall_s = 0.0
        self._incoming.sort(key=lambda s: s.req.arrival_s)
        while True:
            alive = bool(keep_alive()) if keep_alive is not None else False
            if not (self._incoming or self._queue or self._active.any()
                    or alive):
                break
            now = self._now()
            if max_wall_s is not None and now > max_wall_s:
                self._shed_all(REASON_WALL)
                break
            if self._incoming:
                # keep_alive() may have appended out of arrival order;
                # promote every due request (a filter preserves the
                # sorted order of the initial batch)
                due = [s for s in self._incoming if s.req.arrival_s <= now]
                if due:
                    self._incoming = [s for s in self._incoming
                                      if s.req.arrival_s > now]
                    self._queue.extend(due)
            self._update_degradation(now)
            self._fill_slots(now)
            if self._active.any():
                self._decode_round()
            elif self._incoming:
                time.sleep(min(0.01, max(0.0, min(
                    s.req.arrival_s for s in self._incoming) - now)))
            elif alive:
                time.sleep(0.001)     # open door, no traffic: idle poll
            if self.invariants:
                self.check_invariants()
        self.wall_s = time.perf_counter() - self._t0
        return self._states

    @property
    def elapsed_s(self) -> float:
        """Serve wall clock: live while run() is in flight, frozen at its
        end, 0.0 before the first run()."""
        if self._t0 is None:
            return 0.0
        return self.wall_s or (time.perf_counter() - self._t0)

    # --------------------------------------------------------- reporting --

    def reason_counts(self) -> Dict[str, int]:
        """Terminal-state census: finish_reason -> count."""
        out: Dict[str, int] = {}
        for st in self._states:
            if st.finish_reason is not None:
                out[st.finish_reason] = out.get(st.finish_reason, 0) + 1
        return out

    # -------------------------------------------------------- invariants --

    def check_invariants(self) -> None:
        """Slot-state machine, cur_len ↔ active-mask consistency, and
        batch-mass accounting. Raises InvariantViolation on the first
        breach; cheap enough to run after every scheduler intervention
        under tests and fault campaigns (one device sync per call)."""
        cur = self._cache["cur_len"].cpu().numpy()
        mass = np.zeros_like(self._batch_mass)
        for s in range(self.num_slots):
            st = self._slots[s]
            if st is None:
                if self._active[s]:
                    raise InvariantViolation(f"empty slot {s} marked active")
                if cur[s] != 0:
                    raise InvariantViolation(
                        f"empty slot {s} has cur_len {cur[s]} != 0")
                continue
            if not self._active[s]:
                raise InvariantViolation(
                    f"occupied slot {s} (rid {st.req.rid}) inactive")
            if st.status != DECODE or st.slot != s:
                raise InvariantViolation(
                    f"slot {s}: status {st.status!r} slot-field {st.slot}")
            expect = int(st.req.prompt.shape[0]) + len(st.tokens) - 1
            if cur[s] != expect:
                raise InvariantViolation(
                    f"slot {s} (rid {st.req.rid}): cur_len {cur[s]} != "
                    f"prompt+tokens-1 = {expect}")
            if st.mass_counted and st.gate_hist is not None:
                mass += st.gate_hist
        if len(mass) and not np.allclose(mass, self._batch_mass, atol=1e-6):
            raise InvariantViolation(
                f"batch gate-mass drift: |Δ|={np.abs(mass - self._batch_mass).max()}")
        for st in self._states:
            for a, b in zip(st.history, st.history[1:]):
                if b not in _TRANSITIONS[a]:
                    raise InvariantViolation(
                        f"rid {st.req.rid}: illegal recorded transition "
                        f"{a} -> {b} in {st.history}")
            if st.status in (DONE, SHED) and st.finish_reason is None:
                raise InvariantViolation(
                    f"rid {st.req.rid}: terminal without finish_reason")
