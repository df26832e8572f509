"""Deterministic, seeded fault-injection harness for the serving stack.

Step-level fault classes, mirroring the failure modes a production MoE
deployment actually sees (host hiccups, device numerics, cache-surgery
races, stalled dispatch):

  slow_prefill  — host-side delay before the prefill of request `rid`
                  (slow tokenizer / weight paging / noisy neighbor).
  nan_logits    — non-finite logits on slot `slot` at global decode step
                  `step`, injected as an operand of the decode loop
                  (serving/step.py) so the quarantine path is exercised
                  in the loop production runs.
  insert_fail   — the cache splice (insert_request) for request `rid`
                  raises a TransientFault for its first `times`
                  attempts; the scheduler's retry/backoff either
                  recovers (times <= max_retries) or sheds the request.
  stall_decode  — host-side delay before fused decode round `step`
                  (device preemption / collective stall); trips the
                  step-time watchdog.

Process-level fault classes (the crash-tolerance layer's adversaries —
serving/frontdoor.py + serving/journal.py):

  crash_before_snapshot — the process dies just before snapshot number
                  `step` is written (SimulatedCrash raised from the
                  front door's before_snapshot hook): recovery must
                  come from an OLDER snapshot + journal tail, or from
                  the journal alone.
  crash_mid_round — the process dies entering fused decode round
                  `step`: every in-flight request's device state is
                  lost; only the journal + last snapshot survive.
  journal_torn_write — the crash tears the journal's final record:
                  `nbytes` bytes of the first unflushed record land on
                  disk (JournalWriter.abandon). The journal reader must
                  log-and-skip the torn tail, not crash.

A SimulatedCrash deliberately subclasses ServingError but NOT
TransientFault: the watchdog must never retry it — it propagates out of
the serve loop like the process death it stands in for.

Faults are specified explicitly (fully deterministic) or drawn from a
seeded RNG (`sample_campaign`) — either way a campaign replays
bit-identically, which is what lets tests assert that co-batched
requests are token-exact against a fault-free run and that two runs of
the same campaign seed produce identical survival/reason counts.

Every delivered fault is appended to ``injector.log`` as
``(kind, target, detail)`` so campaigns can assert delivery.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.serving.errors import ServingError, TransientFault

STEP_KINDS = ("slow_prefill", "nan_logits", "insert_fail", "stall_decode")
PROCESS_KINDS = ("crash_before_snapshot", "crash_mid_round",
                 "journal_torn_write")
KINDS = STEP_KINDS + PROCESS_KINDS


class InjectedFault(TransientFault):
    """A fault raised by the injector (retryable by the watchdog)."""
    code = "injected_fault"


class SimulatedCrash(ServingError):
    """Process death, delivered as an exception: NOT retryable (not a
    TransientFault) — it unwinds the serve loop the way a SIGKILL
    unwinds the process. The front door's crash path (journal abandon,
    stream abort) is exercised by catching exactly this."""
    code = "simulated_crash"


@dataclass
class Fault:
    """One planned fault. Targeting fields by kind:

    slow_prefill: rid, delay_s
    nan_logits:   slot, step (global decode-step index)
    insert_fail:  rid, times (attempts that fail)
    stall_decode: step (fused round index), delay_s
    crash_before_snapshot: step (snapshot index)
    crash_mid_round:       step (fused round index)
    journal_torn_write:    nbytes (bytes of the torn record left on disk)
    """
    kind: str
    rid: int = -1
    slot: int = -1
    step: int = -1
    delay_s: float = 0.0
    times: int = 1
    nbytes: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclass
class FaultInjector:
    """Delivers a planned fault campaign into the scheduler's (and
    front door's) hooks. Crash faults fire at most once per injector,
    so a recovered incarnation reusing the plan does not re-die."""
    faults: List[Fault] = field(default_factory=list)
    log: List[Tuple[str, int, float]] = field(default_factory=list)
    _insert_attempts: dict = field(default_factory=dict)
    _crashed: Set[str] = field(default_factory=set)

    # ----------------------------------------------------------- hooks ----

    def before_prefill(self, rids: List[int]) -> None:
        """Called with the rids of one admission group, pre-prefill."""
        delay = sum(f.delay_s for f in self.faults
                    if f.kind == "slow_prefill" and f.rid in rids)
        if delay:
            self.log.append(("slow_prefill", rids[0], delay))
            time.sleep(delay)

    def before_insert(self, rid: int) -> None:
        """Called before each insert_request attempt; raises to fail it."""
        for f in self.faults:
            if f.kind == "insert_fail" and f.rid == rid:
                n = self._insert_attempts.get(rid, 0)
                self._insert_attempts[rid] = n + 1
                if n < f.times:
                    self.log.append(("insert_fail", rid, float(n)))
                    raise InjectedFault(
                        f"injected insert failure rid={rid} attempt={n}")

    def before_round(self, round_idx: int) -> None:
        """Called before fused decode round `round_idx`. Raises
        SimulatedCrash when a crash_mid_round fault targets it."""
        for f in self.faults:
            if f.kind == "stall_decode" and f.step == round_idx:
                self.log.append(("stall_decode", round_idx, f.delay_s))
                time.sleep(f.delay_s)
        for f in self.faults:
            if f.kind == "crash_mid_round" and f.step == round_idx \
                    and "crash_mid_round" not in self._crashed:
                self._crashed.add("crash_mid_round")
                self.log.append(("crash_mid_round", round_idx, 0.0))
                raise SimulatedCrash(
                    f"injected process crash entering round {round_idx}")

    def before_snapshot(self, snap_idx: int) -> None:
        """Called by the front door before writing snapshot `snap_idx`."""
        for f in self.faults:
            if f.kind == "crash_before_snapshot" and f.step == snap_idx \
                    and "crash_before_snapshot" not in self._crashed:
                self._crashed.add("crash_before_snapshot")
                self.log.append(("crash_before_snapshot", snap_idx, 0.0))
                raise SimulatedCrash(
                    f"injected process crash before snapshot {snap_idx}")

    def nan_fault(self, step_lo: int, step_hi: int) -> Tuple[int, int]:
        """(slot, step-in-chunk) of the first nan_logits fault whose
        global step falls in [step_lo, step_hi), else (-1, -1). The pair
        goes to the decode loop as host ints that it compares with its
        own step counter, so asking costs no device sync."""
        for f in self.faults:
            if f.kind == "nan_logits" and step_lo <= f.step < step_hi:
                self.log.append(("nan_logits", f.slot, float(f.step)))
                return f.slot, f.step - step_lo
        return -1, -1

    def torn_tail_bytes(self) -> int:
        """Bytes of torn journal prefix a crash leaves behind (0 = the
        buffered tail vanishes cleanly). Consulted by the front door's
        crash path when abandoning the journal."""
        for f in self.faults:
            if f.kind == "journal_torn_write":
                self.log.append(("journal_torn_write", -1,
                                 float(f.nbytes)))
                return f.nbytes
        return 0


def sample_campaign(seed: int, *, num_requests: int, num_slots: int,
                    horizon_steps: int,
                    p_slow: float = 0.25, p_nan: float = 0.5,
                    p_insert: float = 0.25, p_stall: float = 0.5,
                    p_crash: float = 0.0,
                    delay_s: float = 0.02,
                    insert_times: Optional[int] = None) -> FaultInjector:
    """A reproducible mixed campaign drawn from one seeded RNG.

    Each fault class fires independently with its probability; targets
    (rid / slot / step) are drawn uniformly over the campaign extent.
    The same seed always yields the same campaign. Crash faults
    (p_crash; drawn AFTER the step-level classes so pre-existing seeds
    keep their exact plans) pair a crash_mid_round with a 50% chance of
    a journal_torn_write.
    """
    rng = np.random.default_rng(seed)
    faults: List[Fault] = []
    if rng.random() < p_slow:
        faults.append(Fault("slow_prefill",
                            rid=int(rng.integers(num_requests)),
                            delay_s=delay_s))
    if rng.random() < p_nan:
        faults.append(Fault("nan_logits",
                            slot=int(rng.integers(num_slots)),
                            step=int(rng.integers(1, horizon_steps))))
    if rng.random() < p_insert:
        faults.append(Fault("insert_fail",
                            rid=int(rng.integers(num_requests)),
                            times=insert_times if insert_times is not None
                            else int(rng.integers(1, 4))))
    if rng.random() < p_stall:
        faults.append(Fault("stall_decode",
                            step=int(rng.integers(1, max(
                                2, horizon_steps // 4))),
                            delay_s=delay_s))
    if rng.random() < p_crash:
        faults.append(Fault("crash_mid_round",
                            step=int(rng.integers(1, max(
                                2, horizon_steps // 2)))))
        if rng.random() < 0.5:
            faults.append(Fault("journal_torn_write",
                                nbytes=int(rng.integers(1, 16))))
    return FaultInjector(faults=faults)
