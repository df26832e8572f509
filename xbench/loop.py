"""The closed loop that drives the window: one client a slot, each
sending its next request the moment its last one finishes, through the
program's public pump (``Engine.make_scheduler`` and ``Scheduler.run``
with its ``keep_alive`` and ``on_round`` hooks).

The slots start with staggered answer lengths and the loop serves for
the mix's ``warmup_s`` before the window opens, so it opens on a full
batch in its steady mix. A traced run serves on after the window for a
traced window of its own (the profiler slows the host and the device,
so nothing else is read there). When the last window closes no client
sends again; requests sent inside it are served to their first token,
then whatever is in flight is cancelled. Only what was delivered inside
a window counts.

Everything here is the benchmark's own record around public calls:
send times, each request's deliveries (a round's tokens arrive at the
round's end, as the scheduler hands them out), the scheduler's
``RequestState`` timestamps and its ``step_aux`` counters, and which
requests took how many tokens in each round (what the reference needs
to rebuild each decode step's batch).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from xbench.traffic import Request, client_request

DONE, SHED = "done", "shed"


@dataclass
class Served:
    """One request as the benchmark saw it; times in seconds on the
    scheduler's clock (zero when ``Scheduler.run`` started)."""
    rid: int
    client: int
    prompt: np.ndarray
    max_new: int
    arrival: float
    state: object = None                 # the scheduler's RequestState
    deliveries: List[Tuple[float, int]] = field(default_factory=list)
    seen: int = 0                        # tokens already delivered

    @property
    def tokens(self) -> np.ndarray:
        return np.asarray([int(t) for t in self.state.tokens], np.int64)

    @property
    def t_first(self) -> float:
        return float(self.state.t_first_token)

    @property
    def t_admitted(self) -> float:
        return float(self.state.t_admitted)

    @property
    def completed(self) -> bool:
        return self.state.status == DONE


@dataclass
class Round:
    """One decode round: its end, and for each request in it (rid,
    tokens it had before, tokens it took: it was live in the round's
    first ``take`` steps)."""
    index: int
    t_end: float
    entries: List[Tuple[int, int, int]]
    activated: Optional[np.ndarray] = None   # (steps, layers) counter


@dataclass
class Run:
    """What a run recorded, for the metric readers and the check."""
    cfg: Dict
    policy: Dict
    t_open: float
    t_close: float
    chunk: int
    requests: Dict[int, Served]
    rounds: List[Round]
    setup_s: float = float("nan")
    setup_parts: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Dict] = None
    trace_open: float = float("nan")     # the traced window
    trace_close: float = float("nan")
    rounds_before_trace: int = 0

    def in_window(self, t: float) -> bool:
        return self.t_open < t <= self.t_close


class ClosedLoop:
    """Serve ``table`` from ``mix['clients']`` clients through
    ``engine`` for ``seconds`` after the warm-up, then for
    ``trace_seconds`` more. ``on_open`` runs just before the window
    opens, ``on_trace`` just before the traced window opens (the traced
    run starts its profiler there); ``mark`` wraps the hooks' bodies
    (the traced run's host markers)."""

    def __init__(self, engine, table: List[Request], mix: Dict,
                 seconds: float, *, trace_seconds: float = 0.0,
                 on_open: Optional[Callable] = None,
                 on_trace: Optional[Callable] = None,
                 mark: Optional[Callable] = None):
        self.engine = engine
        self.table = table
        self.mix = mix
        self.clients = int(mix["clients"])
        self.seconds = float(seconds)
        self.warmup_s = float(mix["warmup_s"])
        self.trace_seconds = float(trace_seconds)
        self.on_open = on_open
        self.on_trace = on_trace
        self.mark = mark
        self.requests: Dict[int, Served] = {}
        self.inflight: List[Served] = []
        self.rounds: List[Round] = []
        self.sent = [0] * self.clients
        self.t_open: Optional[float] = None
        self.t_close = math.inf
        self.trace_open = math.nan
        self.trace_close = math.nan
        self.rounds_before_trace = 0
        self.t_stop = math.inf        # no client sends after this
        self.sched = None
        self.host_t0: Optional[float] = None   # perf_counter at the clock's 0
        self.t_scheduler = math.nan   # perf_counter: scheduler made
        self.t_first_pump: Optional[float] = None

    def clock(self) -> float:
        """The scheduler's clock, live also after ``Scheduler.run`` has
        returned (the scheduler's own stops there)."""
        return time.perf_counter() - self.host_t0

    def _send(self, client: int, arrival: float, stagger: bool = False):
        req = client_request(self.table, self.clients, client,
                             self.sent[client])
        self.sent[client] += 1
        max_new = req.answer_len
        if stagger:
            max_new = max(2, math.ceil(max_new * (client + 1)
                                       / self.clients))
        st = self.sched.submit(req.prompt, max_new, arrival_s=arrival)
        s = Served(st.req.rid, client, req.prompt, max_new, arrival, st)
        self.requests[s.rid] = s
        self.inflight.append(s)

    def _on_round(self, sched, index: int) -> None:
        if self.mark is not None:
            with self.mark("on_round"):
                self._harvest(sched, index)
        else:
            self._harvest(sched, index)

    def _harvest(self, sched, index: int) -> None:
        t = sched.elapsed_s
        entries = []
        still = []
        current = list(self.inflight)
        for s in current:
            n = len(s.state.tokens)
            if s.seen == 0 and n > 0:
                s.deliveries.append((s.t_first, 1))
                s.seen = 1
            if n > s.seen:
                entries.append((s.rid, s.seen, n - s.seen))
                s.deliveries.append((t, n - s.seen))
                s.seen = n
            if s.state.status in (DONE, SHED):
                if s.state.status == DONE and t <= self.t_stop:
                    self._send(s.client, float(s.state.t_done))
            else:
                still.append(s)
        self.inflight = still + self.inflight[len(current):]
        self.rounds.append(Round(index, t, entries))

    def _keep_alive(self) -> bool:
        if self.mark is not None:
            with self.mark("keep_alive"):
                return self._pump()
        return self._pump()

    def _pump(self) -> bool:
        now = self.sched.elapsed_s
        if self.host_t0 is None:
            self.host_t0 = time.perf_counter() - now
        if self.t_open is None:
            if self.t_first_pump is None:
                self.t_first_pump = time.perf_counter()
            if now >= self.warmup_s:
                if self.on_open is not None:
                    self.on_open()
                self.t_open = self.sched.elapsed_s
                self.t_close = self.t_open + self.seconds
                self.t_stop = self.t_close + self.trace_seconds
            return True
        if now < self.t_close:
            return True
        if self.trace_seconds and math.isnan(self.trace_open):
            if self.on_trace is not None:
                self.on_trace()
            self.trace_open = self.sched.elapsed_s
            self.trace_close = self.trace_open + self.trace_seconds
            self.t_stop = self.trace_close
            self.rounds_before_trace = len(self.rounds)
        if now < self.t_stop:
            return True
        if any(s.arrival <= self.t_stop and math.isnan(s.t_first)
               for s in self.inflight):
            return True          # sent in the window: serve its first token
        for s in self.inflight:
            self.sched.cancel(s.rid)
        return False

    def run(self) -> Run:
        self.sched = self.engine.make_scheduler(num_slots=self.clients,
                                                on_round=self._on_round)
        self.t_scheduler = time.perf_counter()
        try:
            for c in range(self.clients):
                self._send(c, 0.0, stagger=True)
            self.sched.run(keep_alive=self._keep_alive)
            aux = self.sched.step_aux
        finally:
            self.sched.release()
        chunk = self.sched.fns.decode_chunk
        for r in self.rounds:
            lo = (r.index - 1) * chunk
            steps = aux[lo:lo + chunk]
            if steps and "activated_experts" in steps[0]:
                r.activated = np.stack([np.asarray(a["activated_experts"])
                                        for a in steps])
        return Run(cfg={}, policy={}, t_open=self.t_open,
                   t_close=self.t_close, chunk=chunk,
                   requests=self.requests, rounds=self.rounds,
                   trace_open=self.trace_open, trace_close=self.trace_close,
                   rounds_before_trace=self.rounds_before_trace)
