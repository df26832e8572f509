"""Speculative decoding as a scheduler subsystem.

SpecScheduler extends the continuous-batching Scheduler with a draft
model whose cache rows live and die with the target's slots, so
speculative and plain requests share ONE running batch under the
existing lifecycle (waiting -> prefill -> decode -> done | shed):

  * admission  — a speculative request pays one extra batched draft
                 prefill; its draft cache row is spliced next to the
                 target row and both advance in step thereafter (draft
                 cur_len == target cur_len is an invariant).
  * decode     — rounds go through serving/step.py spec_steps_fused
                 (on the card, replays of a captured CUDA graph,
                 serving/graphs.py): an inner draft loop plus a single
                 verify pass over (B, 1+L_s) tokens, ragged acceptance
                 via greedy_accept and per-slot rollback. Plain
                 requests ride the same loop with a zero draft limit
                 (their round is exactly plain greedy decode).
  * finish     — eviction (completion, cancel, deadline, numerics
                 quarantine) evicts BOTH cache rows; poisoned slots
                 scrub both.

Per-slot speculative state (host side, adjusted between dispatches):

  * adaptive draft length — an acceptance-rate EMA per slot grows the
    draft window toward spec_len while drafts keep landing and shrinks
    it toward 1 when the target keeps rejecting.
  * spec budget — each request may spend at most `budget` draft tokens;
    an exhausted slot keeps its draft cache in step (the loop still
    drafts) but accepts nothing, degrading to plain decode mid-request.
  * correlation priors — per-request gate histograms, seeded from the
    admission router probe and EMA-updated from every verify pass's
    per-request histogram (route() aux "req_gate_hist"), fed back into
    Algorithm-4 spec selection as `spec_priors`.

Greedy-only: acceptance is exact under argmax, so the scheduler path is
token-identical to the lockstep Engine._generate_spec reference and to
plain greedy decode. Targets and drafts of the SSM and hybrid families
are refused: a rejected draft would need their recurrent state and conv
tails rolled back, and rolling back cur_len alone (what the JAX package
does) gives wrong tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import init_cache, params_to
from repro_torch.serving.errors import (REASON_COMPLETED, REASON_DEADLINE_E2E,
                                        REASON_NUMERICS, InvariantViolation)
from repro_torch.serving.graphs import LoopState
from repro_torch.serving.scheduler import (DECODE, RequestState, Scheduler,
                                           tighten_policy)
from repro_torch.serving.step import (NO_FAULT, SpecStepFns, build_spec_fns,
                                      make_spec_fused)

_RECURRENT = ("ssm", "hybrid")


def check_spec_pair(cfg: ArchConfig, dcfg: ArchConfig) -> None:
    """Refuse what speculative decoding cannot serve exactly: a target
    or draft with recurrent state (the SSM and hybrid families), and a
    draft whose vocabulary differs from the target's."""
    for role, c in (("target", cfg), ("draft", dcfg)):
        if c.family in _RECURRENT:
            raise NotImplementedError(
                f"speculative decoding with a {c.family!r} {role} "
                f"({c.name}): a rejected draft leaves its SSM state and "
                f"conv tails stepped over the whole verify block, and "
                f"rolling back cur_len alone does not undo that")
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocabulary {dcfg.vocab_size} != target vocabulary "
            f"{cfg.vocab_size}: target tokens would index past the "
            f"draft's embedding")


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for the SpecScheduler."""
    spec_len: int                 # max draft tokens per round
    num_rounds: int = 4           # draft-verify rounds per dispatch
    budget: Optional[int] = None  # draft tokens a request may spend
    #                               (None = unlimited)
    adapt: bool = True            # adaptive per-slot draft length
    min_draft: int = 1            # floor (0 could never recover: the
    #                               acceptance EMA stops updating)
    ema_beta: float = 0.5         # acceptance-EMA smoothing
    grow_above: float = 0.8       # EMA >= this -> draft_len += 1
    shrink_below: float = 0.4     # EMA <  this -> draft_len -= 1
    prior_beta: float = 0.3       # correlation-prior EMA step size

    def __post_init__(self):
        if self.spec_len < 1:
            raise ValueError(f"spec_len must be >= 1, got {self.spec_len}")
        if not 1 <= self.min_draft <= self.spec_len:
            raise ValueError(
                f"min_draft must be in [1, spec_len], got {self.min_draft}")


@dataclass
class _SlotSpec:
    """Host-side speculative state of one occupied slot."""
    draft_len: int
    acc_ema: float = 1.0          # optimistic start: first round drafts
    budget_left: int = 2 ** 30    # effectively unlimited unless set
    prior: Optional[np.ndarray] = None   # (E,) float64 gate histogram


# budget handed to the loop for slots without one: large enough never to
# clamp, small enough that int32 arithmetic cannot wrap
_NO_BUDGET = 2 ** 30


class SpecScheduler(Scheduler):
    """Continuous-batching scheduler with a resident draft model.

    Accepts every Scheduler knob; adds the (draft config, draft params)
    pair, a SpecConfig, and a SpecStepFns bundle. Requests opt in per
    submit() (spec=None defaults to speculative); spec=False rides along
    as a plain request in the same batch.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 draft: Tuple[ArchConfig, dict],
                 spec_cfg: SpecConfig,
                 spec_fns: Optional[SpecStepFns] = None,
                 **sched_kw):
        check_spec_pair(cfg, draft[0])
        # read by _state_key / _new_state in the base constructor
        self.dcfg = draft[0]
        self.dparams = params_to(draft[1],
                                 resolve_device(sched_kw.get("device")))
        self.spec_cfg = spec_cfg
        super().__init__(cfg, params, **sched_kw)
        if self.temperature != 0.0:
            raise ValueError(
                "SpecScheduler is greedy-only (temperature == 0): "
                "speculative acceptance is exact under argmax")
        if self.policy.mode not in ("off", "spec"):
            raise ValueError(
                f"SpecScheduler verify policy must be mode 'off' or "
                f"'spec', got {self.policy.mode!r} (the Engine maps "
                f"other modes to OFF before building the bundle)")
        self.spec_fns = spec_fns or build_spec_fns(
            cfg, self.dcfg, policy=self.policy,
            spec_len=spec_cfg.spec_len, num_rounds=spec_cfg.num_rounds,
            cache_len=self.cache_len, force_window=self._force_window,
            capacity_factor=self._capacity_factor, dispatch=self._dispatch)
        self._slot_spec: List[Optional[_SlotSpec]] = [None] * self.num_slots
        # aggregate counters (mirrored per request on RequestState)
        self.total_drafted = 0
        self.total_accepted = 0
        self.budget_exhausted_events = 0
        # per-round mean accepted drafts over slots that drafted — the
        # continuous-path analogue of GenStats.accepted_hist
        self.round_accept_hist: List[float] = []

    # ------------------------------------------------------ batch state --

    def _state_key(self) -> tuple:
        return ("spec", self.num_slots, self.cache_len,
                self.params["embed"].dtype, self.spec_cfg.spec_len,
                self.spec_cfg.num_rounds)

    def _new_state(self) -> LoopState:
        state = super()._new_state()
        state.tensors["dcache"] = init_cache(
            self.dcfg, self.num_slots, self.cache_len,
            self.dparams["embed"].dtype, device=self.device)
        return state

    @property
    def _dcache(self):
        return None if self._state is None else \
            self._state.tensors["dcache"]

    # ------------------------------------------------------- submission --

    def _resolve_spec(self, spec: Optional[bool]) -> bool:
        return True if spec is None else bool(spec)

    # -------------------------------------------------------- admission --

    def _admit_group(self, group, now: float) -> None:
        """Target-side admission first (batched prefill + splice, or the
        whole-batch fast path), then one batched DRAFT prefill for the
        group's speculative members and a per-slot splice into the draft
        cache. The draft row starts at cur_len == prompt length == the
        target row's cur_len, which the loop then keeps."""
        super()._admit_group(group, now)
        spec_members = [(st, st.slot) for st, _ in group
                        if st.req.spec and st.slot >= 0
                        and st.status == DECODE]
        for st, slot in group:
            if st.slot >= 0 and st.status == DECODE:
                self._slot_spec[st.slot] = None   # plain default
        if not spec_members:
            return
        prompts = torch.as_tensor(
            np.stack([st.req.prompt for st, _ in spec_members]),
            device=self.device)
        _, dreq_cache, _ = self.spec_fns.dprefill(self.dparams, prompts)
        for i, (st, slot) in enumerate(spec_members):
            self.fns.insert(self._dcache, dreq_cache, slot, i)
            prior = None
            if st.gate_hist is not None:
                prior = np.asarray(st.gate_hist, np.float64).copy()
            elif self.fns.probe is not None:
                prior = self.fns.probe(self.params, prompts[i:i + 1]) \
                    .cpu().numpy().astype(np.float64)
            self._slot_spec[slot] = _SlotSpec(
                draft_len=self.spec_cfg.spec_len,
                budget_left=(self.spec_cfg.budget
                             if self.spec_cfg.budget is not None
                             else _NO_BUDGET),
                prior=prior)

    # --------------------------------------------------------- lifecycle --

    def _finish(self, st: RequestState, slot: Optional[int],
                reason: str = REASON_COMPLETED, scrub: bool = False) -> None:
        if slot is not None and self._slot_spec[slot] is not None:
            evict = self.fns.evict_scrub if scrub else self.fns.evict
            evict(self._dcache, slot)
            self._slot_spec[slot] = None
        super()._finish(st, slot, reason=reason, scrub=scrub)

    # ----------------------------------------------------- expert priors --

    def gate_priors(self) -> np.ndarray:
        """The EMA-maintained verify-pass priors (``_SlotSpec.prior``),
        fresher than the base class's admission-time histograms. Plain
        members of the batch stay zero, as Algorithm-4 selection
        expects."""
        E = self.cfg.moe.num_experts if self.cfg.moe else 0
        out = np.zeros((self.num_slots, E), np.float64)
        if E:
            for s, sp in enumerate(self._slot_spec):
                if sp is not None and sp.prior is not None:
                    out[s] = sp.prior
        return out

    # ------------------------------------------------------------ decode --

    def _make_loop(self, level: int):
        fused = self.spec_fns.fused
        if level:
            fused = make_spec_fused(
                self.cfg, self.dcfg,
                policy=tighten_policy(self.policy, level, self.cfg.moe),
                spec_len=self.spec_fns.spec_len,
                num_rounds=self.spec_fns.num_rounds,
                force_window=self._force_window,
                capacity_factor=self._capacity_factor,
                dispatch=self._dispatch)
        params, dparams = self.params, self.dparams
        B, dev = self.num_slots, self.device
        E = self.cfg.moe.num_experts if self.cfg.moe else 0

        def run(t, gen, i):
            return fused(params, dparams, t["tok"], t["cache"], t["dcache"],
                         i["remaining"], i["budget"], i["draft_len"],
                         i["spec_on"], i["priors"], i["fault"])

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return run, {
            "remaining": zeros(B), "budget": zeros(B), "draft_len": zeros(B),
            "spec_on": zeros(B, dtype=torch.bool),
            "priors": zeros(B, E, dtype=torch.float32),
            "fault": torch.tensor(NO_FAULT, dtype=torch.int32, device=dev)}

    def _decode_round(self) -> None:
        """One dispatch of `num_rounds` draft-verify rounds + harvest.
        total_steps counts ROUNDS (each emits 1..spec_len+1 tokens per
        live slot), so fault campaigns address rounds the way they
        address steps on the plain path. Between dispatches the host
        adapts per-slot draft lengths from the acceptance EMA, charges
        spec budgets, and folds the verify pass's per-request gate
        histograms into the correlation priors."""
        t_round = time.perf_counter()
        sc = self.spec_cfg
        R = self.spec_fns.num_rounds
        if self.faults is not None:
            self.faults.before_round(self._round_idx)
            fault = self.faults.nan_fault(self.total_steps,
                                          self.total_steps + R)
        else:
            fault = NO_FAULT

        remaining = [st.req.max_new_tokens - len(st.tokens) if st else 0
                     for st in self._slots]
        spec_on = [sp is not None for sp in self._slot_spec]
        draft_len = [sp.draft_len if sp else 0 for sp in self._slot_spec]
        budget = [min(sp.budget_left, _NO_BUDGET) if sp else 0
                  for sp in self._slot_spec]
        (_, _, _, _, _, new_tokens, num_new, accepted, drafted, aux,
         poisoned) = self._loop_at(self.level)(
            remaining=np.asarray(remaining, np.int32),
            budget=np.asarray(budget, np.int32),
            draft_len=np.asarray(draft_len, np.int32),
            spec_on=np.asarray(spec_on, bool),
            priors=self.gate_priors().astype(np.float32), fault=fault)
        new_tokens = new_tokens.cpu().numpy()      # sync: (R, B, Ls+1)
        num_new = num_new.cpu().numpy()            # (R, B)
        accepted = accepted.cpu().numpy()          # (R, B)
        drafted = drafted.cpu().numpy()            # (R, B) = lim
        poisoned = poisoned.cpu().numpy()          # (B,)
        dt = time.perf_counter() - t_round
        if self.watchdog_s is not None and dt > self.watchdog_s:
            self.stall_events += 1
        now = self._now()
        self.total_steps += R
        self._round_idx += 1
        aux_np = {k: v.cpu().numpy() for k, v in aux.items()}
        hist = aux_np.pop("req_gate_hist", None)   # (R, L, B, E) | None
        step_auxs = [{k: v[r] for k, v in aux_np.items()}
                     for r in range(R)]
        self.step_aux.extend(step_auxs)
        for r in range(R):
            dmask = drafted[r] > 0
            if dmask.any():
                self.round_accept_hist.append(
                    float(accepted[r][dmask].mean()))
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            sp = self._slot_spec[slot]
            for r in range(R):
                n = min(int(num_new[r, slot]),
                        st.req.max_new_tokens - len(st.tokens))
                if n > 0:
                    st.tokens.extend(new_tokens[r, slot, :n])
                    st.layer_aux.append(step_auxs[r])
                d = int(drafted[r, slot])
                if d > 0:
                    a = int(accepted[r, slot])
                    st.drafted += d
                    st.accepted_drafts += a
                    self.total_drafted += d
                    self.total_accepted += a
                    if sp is not None:
                        sp.acc_ema = (sc.ema_beta * sp.acc_ema
                                      + (1.0 - sc.ema_beta) * (a / d))
                        sp.budget_left -= d
                if (sp is not None and hist is not None and n > 0
                        and hist.shape[-1]):
                    h = hist[r, :, slot].mean(axis=0)      # (E,) over layers
                    sp.prior = h if sp.prior is None else \
                        (1.0 - sc.prior_beta) * sp.prior + sc.prior_beta * h
            if sp is not None:
                if sp.budget_left <= 0 and not st.spec_budget_exhausted:
                    st.spec_budget_exhausted = True
                    self.budget_exhausted_events += 1
                    sp.budget_left = 0
                if sc.adapt:
                    if sp.acc_ema >= sc.grow_above:
                        sp.draft_len = min(sp.draft_len + 1,
                                           self.spec_fns.spec_len)
                    elif sp.acc_ema < sc.shrink_below:
                        sp.draft_len = max(sp.draft_len - 1, sc.min_draft)
            if poisoned[slot]:
                self._finish(st, slot=slot, reason=REASON_NUMERICS,
                             scrub=True)
            elif len(st.tokens) >= st.req.max_new_tokens:
                self._finish(st, slot=slot)
        harvested = int(num_new.sum())
        if harvested and dt > 0:
            rate = harvested / dt
            self._otps_ema = rate if self._otps_ema is None \
                else 0.5 * self._otps_ema + 0.5 * rate
        for slot, st in enumerate(self._slots):
            if st is not None and st.req.deadline_s is not None and \
                    now > st.req.arrival_s + st.req.deadline_s:
                self._finish(st, slot=slot, reason=REASON_DEADLINE_E2E)
        if self.on_round is not None:
            self.on_round(self, self._round_idx)

    # -------------------------------------------------------- reporting --

    @property
    def acceptance_rate(self) -> float:
        """Accepted / drafted over the whole serve (0.0 before any
        draft was proposed)."""
        return self.total_accepted / self.total_drafted \
            if self.total_drafted else 0.0

    # -------------------------------------------------------- invariants --

    def check_invariants(self) -> None:
        super().check_invariants()
        dcur = self._dcache["cur_len"].cpu().numpy()
        cur = self._cache["cur_len"].cpu().numpy()
        for s in range(self.num_slots):
            sp = self._slot_spec[s]
            st = self._slots[s]
            if sp is not None and (st is None or not st.req.spec):
                raise InvariantViolation(
                    f"slot {s}: speculative state without a speculative "
                    f"occupant")
            if sp is not None:
                if dcur[s] != cur[s]:
                    raise InvariantViolation(
                        f"slot {s}: draft cur_len {dcur[s]} != target "
                        f"cur_len {cur[s]}")
                if not (self.spec_cfg.min_draft <= sp.draft_len
                        <= self.spec_fns.spec_len):
                    raise InvariantViolation(
                        f"slot {s}: draft_len {sp.draft_len} outside "
                        f"[{self.spec_cfg.min_draft}, "
                        f"{self.spec_fns.spec_len}]")
                if sp.budget_left < 0:
                    raise InvariantViolation(
                        f"slot {s}: negative spec budget {sp.budget_left}")
            elif st is None and dcur[s] != 0:
                raise InvariantViolation(
                    f"empty slot {s} has draft cur_len {dcur[s]} != 0")
