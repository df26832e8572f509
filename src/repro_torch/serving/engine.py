"""Serving engine facade over the continuous-batching scheduler.

  serving/scheduler.py  request queue, slot lifecycle, XShare-aware
                        admission
  serving/step.py       the decode loop: sampling on the device, N tokens
                        per scheduler intervention, per-slot active masks
  serving/graphs.py     the loops captured as CUDA graphs on the card,
                        with the running batch they replay over
  serving/engine.py     this facade: ``generate()`` and GenStats

  serving/spec_scheduler.py  with a draft model (``draft=``,
                        ``spec_len`` > 0): draft-then-verify rounds,
                        speculative and plain requests in one batch
  serving/frontdoor.py  ``make_frontdoor``: token streams over a
                        scheduler, with a journal, snapshots and
                        ``recover()`` (serving/journal.py,
                        serving/faults.py)

``generate`` serves a batch through the scheduler with every request
arriving at t=0, which under greedy sampling is token-exact with the
retained per-token lockstep loop (``lockstep=True``); with a draft model
the lockstep reference is the host-side draft / verify loop
(``_generate_spec``), and both equal plain greedy decoding. Both
references stay eager on purpose: on the card the continuous paths
replay captured graphs, so continuous == lockstep holds graph against
eager. The engine's LoopPool keeps the running batches and their graphs
across schedulers: a second ``generate`` (or a front door's recovery)
captures nothing new.

A request with prefix embeddings (the VLM and audio families' stubbed
frontends) is served by the lockstep loop, as in the JAX package, whose
scheduler takes no prefix; its cache positions count in the request's
validation. Audio prompts are (B, S, K) codebook frames and come back as
(B, new, K); ``new_tokens`` counts K per frame.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, XSharePolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import (Model, decode_step, effective_window,
                                      params_to, prefill)
from repro_torch.models.moe import OFF
from repro_torch.serving.errors import InvalidRequest, validate_request
from repro_torch.serving.graphs import LoopPool
from repro_torch.serving.sampler import greedy, sample_step
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.spec_decode import greedy_accept, rollback_cur_len
from repro_torch.serving.spec_scheduler import (SpecConfig, SpecScheduler,
                                                check_spec_pair)
from repro_torch.serving.step import build_spec_fns, build_step_fns


@dataclass
class GenStats:
    prompt_len: int = 0
    steps: int = 0
    new_tokens: int = 0
    wall_s: float = 0.0
    capture_s: float = 0.0        # CUDA graph capture inside wall_s
    accepted_hist: List[float] = field(default_factory=list)
    layer_aux: List[Dict] = field(default_factory=list)
    # speculative-decoding counters
    drafted: int = 0              # draft tokens proposed
    accepted: int = 0             # draft tokens the target accepted
    spec_budget_exhausted: int = 0  # requests that ran out of budget

    @property
    def otps(self) -> float:
        return self.new_tokens / max(self.wall_s, 1e-9)

    @property
    def mean_accepted(self) -> float:
        return float(np.mean(self.accepted_hist)) if self.accepted_hist \
            else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Accepted / drafted (0.0 when nothing was drafted)."""
        return self.accepted / self.drafted if self.drafted else 0.0

    def mean_aux(self, key: str) -> float:
        vals = [float(np.mean(a[key])) for a in self.layer_aux if key in a]
        return float(np.mean(vals)) if vals else float("nan")


class Engine:
    """Serving engine for one model and an optional draft model.
    ``params`` is the parameter tree (or a ``models.Model``), ``draft`` a
    (config, tree) pair; both are placed on ``device`` — CUDA unless the
    caller asks for another device."""

    def __init__(self, cfg: ArchConfig, params, *,
                 policy: XSharePolicy = OFF,
                 cache_len: int = 512,
                 force_window: Optional[int] = None,
                 capacity_factor: float = 8.0,
                 draft: Optional[Tuple[ArchConfig, dict]] = None,
                 spec_len: int = 0,
                 spec_rounds: int = 4,
                 spec_budget: Optional[int] = None,
                 spec_adapt: bool = True,
                 temperature: float = 0.0,
                 decode_chunk: int = 8,
                 dispatch: str = "auto",
                 seed: int = 0,
                 device: DeviceLike = None):
        if spec_len and not draft:
            raise ValueError("spec_len > 0 requires a draft model")
        if draft and spec_len:
            check_spec_pair(cfg, draft[0])
        self.device = resolve_device(device)
        model = params if isinstance(params, Model) else Model(cfg, params)
        self.model = model.to(self.device)
        self.cfg, self.params = cfg, self.model.params
        self.draft = (draft[0], params_to(draft[1], self.device)) \
            if draft else None
        self.spec_len = spec_len
        self.spec_rounds = spec_rounds
        self.spec_budget = spec_budget
        self.spec_adapt = spec_adapt
        self.policy = policy
        self.temperature = temperature
        self.cache_len = cache_len
        self.force_window = force_window
        self.capacity_factor = capacity_factor
        self.decode_chunk = decode_chunk
        self.dispatch = dispatch
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._seed = seed
        self._fns = build_step_fns(
            cfg, policy=policy, cache_len=cache_len,
            decode_chunk=decode_chunk, temperature=temperature,
            force_window=force_window, capacity_factor=capacity_factor,
            dispatch=dispatch)
        self.loops = LoopPool()   # running batches and captured loops
        self._schedulers = 0
        # the verify pass routes with Algorithm 4 or not at all
        self._spec_policy = policy if policy.mode in ("off", "spec") \
            else OFF
        self._spec_fns = None
        if self.draft and spec_len:
            self._spec_fns = build_spec_fns(
                cfg, self.draft[0], policy=self._spec_policy,
                spec_len=spec_len, num_rounds=spec_rounds,
                cache_len=cache_len, force_window=force_window,
                capacity_factor=capacity_factor, dispatch=dispatch)

    def _prefill(self, params, tokens, prefix_embeds=None):
        return prefill(self.cfg, params, tokens, cache_len=self.cache_len,
                       prefix_embeds=prefix_embeds,
                       policy=OFF, force_window=self.force_window,
                       capacity_factor=self.capacity_factor,
                       dispatch=self.dispatch)

    def _decode(self, params, tokens, cache):
        return decode_step(self.cfg, params, tokens, cache,
                           policy=self.policy,
                           force_window=self.force_window,
                           capacity_factor=self.capacity_factor,
                           dispatch=self.dispatch)

    def _verify(self, params, tokens, cache):
        return decode_step(self.cfg, params, tokens, cache,
                           policy=self._spec_policy,
                           spec_shape=(tokens.shape[0], tokens.shape[1]),
                           force_window=self.force_window,
                           capacity_factor=self.capacity_factor,
                           dispatch=self.dispatch)

    def _dprefill(self, dparams, tokens):
        return prefill(self.draft[0], dparams, tokens,
                       cache_len=self.cache_len,
                       capacity_factor=self.capacity_factor)

    def _ddecode(self, dparams, tokens, dcache):
        return decode_step(self.draft[0], dparams, tokens, dcache,
                           capacity_factor=self.capacity_factor)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_step(logits, self._gen, temperature=self.temperature)

    def make_scheduler(self, *, num_slots: int, admission: str = "fcfs",
                       spec_cfg: Optional[SpecConfig] = None,
                       **robustness) -> Scheduler:
        """A Scheduler sharing this engine's functions and device — the
        entry point for open-ended (arrival-process) serving. An engine
        with a draft model and spec_len > 0 gets a SpecScheduler
        (submit(spec=False) opts a request out; spec_cfg overrides the
        engine's SpecConfig). Extra keyword args pass through to the
        Scheduler's robustness layer."""
        self._schedulers += 1
        common = dict(
            num_slots=num_slots, cache_len=self.cache_len,
            policy=self.policy, admission=admission,
            decode_chunk=self.decode_chunk, temperature=self.temperature,
            force_window=self.force_window,
            capacity_factor=self.capacity_factor, dispatch=self.dispatch,
            seed=self._seed + self._schedulers, fns=self._fns,
            loop_pool=self.loops, device=self.device, **robustness)
        if self._spec_fns is None:
            return Scheduler(self.cfg, self.params, **common)
        sc = spec_cfg or SpecConfig(
            spec_len=self.spec_len, num_rounds=self.spec_rounds,
            budget=self.spec_budget, adapt=self.spec_adapt)
        spec_fns = self._spec_fns
        if (sc.spec_len != spec_fns.spec_len
                or sc.num_rounds != spec_fns.num_rounds):
            spec_fns = None        # the SpecScheduler builds its own
        common["policy"] = self._spec_policy
        return SpecScheduler(
            self.cfg, self.params, draft=self.draft, spec_cfg=sc,
            spec_fns=spec_fns, **common)

    def make_frontdoor(self, *, num_slots: int, **door_kw):
        """A started crash-tolerant streaming FrontDoor over this engine
        (serving/frontdoor.py): per-request token streams, mid-stream
        cancel, graceful drain, and — with journal_path / snapshot_path
        set — durable recovery via recover()."""
        from repro_torch.serving.frontdoor import FrontDoor
        return FrontDoor(self, num_slots=num_slots, **door_kw).start()

    def generate(self, prompts: np.ndarray, max_new_tokens: int, *,
                 prefix_embeds=None,
                 lockstep: bool = False) -> Tuple[np.ndarray, GenStats]:
        """prompts: (B, S) integer ((B, S, K) audio). Returns (tokens (B,
        max_new_tokens[, K]), stats). Greedy unless temperature > 0.
        lockstep=True runs the per-token host loop kept as the reference,
        which also serves prefix_embeds (B, P, d). With a draft model
        (spec_len > 0) the default path is the SpecScheduler and
        lockstep=True (or temperature > 0) the host-side draft / verify
        reference loop, which is greedy; it takes no prefix (the JAX
        package drops one there unread; the port raises)."""
        prompts = np.asarray(prompts)
        P = 0
        if prefix_embeds is not None:
            if self.spec_len:
                raise ValueError(
                    "prefix_embeds with a draft model: speculative "
                    "decoding serves no prefix")
            prefix_embeds = torch.as_tensor(prefix_embeds,
                                            device=self.device)
            want = (prompts.shape[0], self.cfg.d_model)
            if prefix_embeds.ndim != 3 or \
                    (prefix_embeds.shape[0], prefix_embeds.shape[2]) != want:
                raise InvalidRequest(
                    f"prefix_embeds of shape {tuple(prefix_embeds.shape)}; "
                    f"want ({want[0]}, P, {want[1]})")
            P = int(prefix_embeds.shape[1])
        validate_request(
            int(prompts.shape[1]), max_new_tokens,
            cache_len=self.cache_len,
            window=effective_window(self.cfg,
                                    force_window=self.force_window),
            prefix_len=P)
        with torch.no_grad():
            if self.spec_len and (lockstep or self.temperature != 0.0):
                return self._generate_spec(prompts, max_new_tokens)
            if lockstep or prefix_embeds is not None:
                return self._generate_lockstep(prompts, max_new_tokens,
                                               prefix_embeds)
            return self._generate_continuous(prompts, max_new_tokens)

    # ------------------------------------------------------- continuous --

    def _generate_continuous(self, prompts, max_new_tokens):
        B = prompts.shape[0]
        stats = GenStats(prompt_len=prompts.shape[1])
        t0 = time.perf_counter()
        capture0 = self.loops.capture_s
        sched = self.make_scheduler(num_slots=B, admission="fcfs")
        try:
            for b in range(B):
                sched.submit(prompts[b], max_new_tokens)
            states = sched.run()
        finally:
            sched.release()
        toks = np.stack([np.stack(st.tokens[:max_new_tokens])
                         for st in states])
        # per-request accounting is trimmed to each request's horizon;
        # the batch-level step count includes chunk overshoot past it
        stats.steps = max(len(st.tokens) for st in states) - 1
        stats.layer_aux = max((st.layer_aux for st in states), key=len)
        stats.new_tokens = int(np.prod(toks.shape))   # audio: K per frame
        if isinstance(sched, SpecScheduler):
            stats.steps = sched.total_steps       # draft-verify rounds
            stats.accepted_hist = list(sched.round_accept_hist)
            stats.drafted = sched.total_drafted
            stats.accepted = sched.total_accepted
            stats.spec_budget_exhausted = sched.budget_exhausted_events
        stats.capture_s = self.loops.capture_s - capture0
        stats.wall_s = time.perf_counter() - t0
        return toks, stats

    # ------------------------------------------- lockstep (reference) ----

    def _generate_lockstep(self, prompts, max_new_tokens,
                           prefix_embeds=None):
        """Per-token host loop: one decode step and one device->host read
        per token. The reference for the continuous path, and the path
        that serves prefix embeddings."""
        stats = GenStats(prompt_len=prompts.shape[1])
        t0 = time.perf_counter()
        lg, cache, _ = self._prefill(
            self.params, torch.tensor(prompts, device=self.device),
            prefix_embeds)
        tok = self._pick(lg)                                # (B[, K])
        outs = [tok.cpu().numpy()]
        for _ in range(max_new_tokens - 1):
            lg, cache, aux = self._decode(self.params, tok[:, None], cache)
            tok = self._pick(lg[:, -1])
            outs.append(tok.cpu().numpy())
            stats.steps += 1
            if aux:
                stats.layer_aux.append(
                    {k: v.cpu().numpy() for k, v in aux.items()})
        toks = np.stack(outs, axis=1)
        stats.new_tokens = int(np.prod(toks.shape))   # audio: K per frame
        stats.wall_s = time.perf_counter() - t0
        return toks, stats

    # ------------------------------------------------------------- spec --

    def _generate_spec(self, prompts, max_new_tokens):
        """Host-side draft / verify loop, one device->host read per
        round: the reference for the SpecScheduler path."""
        dcfg, dparams = self.draft
        B, S = prompts.shape
        Ls = self.spec_len
        stats = GenStats(prompt_len=S)
        t0 = time.perf_counter()
        toks_in = torch.tensor(prompts, device=self.device)
        lg, cache, _ = self._prefill(self.params, toks_in)
        _, dcache, _ = self._dprefill(dparams, toks_in)
        x0 = greedy(lg)                                     # (B,)
        out_tok = [[int(t)] for t in x0.cpu().numpy()]
        while min(len(o) for o in out_tok) < max_new_tokens:
            # draft Ls tokens (one extra step writes the last KV)
            drafts = []
            dtok = x0
            for i in range(Ls + 1):
                dlg, dcache, _ = self._ddecode(dparams, dtok[:, None],
                                               dcache)
                dtok = greedy(dlg[:, -1])
                if i < Ls:
                    drafts.append(dtok)
            drafts = torch.stack(drafts, dim=1)             # (B, Ls)
            # verify on the target: the (B, 1 + Ls) batch
            verify_in = torch.cat([x0[:, None], drafts], dim=1)
            old_cur = cache["cur_len"]
            vlg, cache, aux = self._verify(self.params, verify_in, cache)
            res = greedy_accept(vlg, drafts)
            # ragged rollback
            new_cur = rollback_cur_len(old_cur, res)
            cache["cur_len"] = new_cur
            dcache["cur_len"] = new_cur.clone()
            x0 = torch.gather(res.new_tokens, 1,
                              res.accepted[:, None].long())[:, 0]
            nt = res.new_tokens.cpu().numpy()
            nn = res.num_new.cpu().numpy()
            acc = res.accepted.cpu().numpy()
            for b in range(B):
                out_tok[b].extend(int(t) for t in nt[b, :nn[b]])
            stats.steps += 1
            stats.accepted_hist.append(float(np.mean(acc)))
            stats.drafted += Ls * B
            stats.accepted += int(acc.sum())
            if aux:
                stats.layer_aux.append(
                    {k: v.cpu().numpy() for k, v in aux.items()})
        stats.new_tokens = sum(min(len(o), max_new_tokens)
                               for o in out_tok)
        stats.wall_s = time.perf_counter() - t0
        toks = np.full((B, max_new_tokens), -1, np.int32)
        for b in range(B):
            row = out_tok[b][:max_new_tokens]
            toks[b, :len(row)] = row
        return toks, stats
