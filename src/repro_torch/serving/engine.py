"""Serving engine facade over the continuous-batching scheduler.

  serving/scheduler.py  request queue, slot lifecycle, XShare-aware
                        admission
  serving/step.py       the decode loop: sampling on the device, N tokens
                        per scheduler intervention, per-slot active masks
  serving/engine.py     this facade: ``generate()`` and GenStats

``generate`` serves a batch through the scheduler with every request
arriving at t=0, which under greedy sampling is token-exact with the
retained per-token lockstep loop (``lockstep=True``). Speculative
decoding (``draft=``, ``spec_len``) and prefix embeddings are not ported
yet and raise.
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
                                      prefill)
from repro_torch.models.moe import OFF
from repro_torch.serving.errors import validate_request
from repro_torch.serving.sampler import sample_step
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.step import build_step_fns


@dataclass
class GenStats:
    prompt_len: int = 0
    steps: int = 0
    new_tokens: int = 0
    wall_s: float = 0.0
    layer_aux: List[Dict] = field(default_factory=list)

    @property
    def otps(self) -> float:
        return self.new_tokens / max(self.wall_s, 1e-9)

    def mean_aux(self, key: str) -> float:
        vals = [float(np.mean(a[key])) for a in self.layer_aux if key in a]
        return float(np.mean(vals)) if vals else float("nan")


class Engine:
    """Serving engine for one model. ``params`` is the parameter tree (or
    a ``models.Model``); it is placed on ``device`` — CUDA unless the
    caller asks for another device."""

    def __init__(self, cfg: ArchConfig, params, *,
                 policy: XSharePolicy = OFF,
                 cache_len: int = 512,
                 force_window: Optional[int] = None,
                 capacity_factor: float = 8.0,
                 draft=None,
                 spec_len: int = 0,
                 temperature: float = 0.0,
                 decode_chunk: int = 8,
                 dispatch: str = "auto",
                 seed: int = 0,
                 device: DeviceLike = None):
        if draft is not None or spec_len:
            raise NotImplementedError(
                "speculative decoding is not ported yet")
        self.device = resolve_device(device)
        model = params if isinstance(params, Model) else Model(cfg, params)
        self.model = model.to(self.device)
        self.cfg, self.params = cfg, self.model.params
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
        self._fused_levels = {}   # degradation-level decode loops
        self._schedulers = 0

    def _prefill(self, params, tokens):
        return prefill(self.cfg, params, tokens, cache_len=self.cache_len,
                       policy=OFF, force_window=self.force_window,
                       capacity_factor=self.capacity_factor,
                       dispatch=self.dispatch)

    def _decode(self, params, tokens, cache):
        return decode_step(self.cfg, params, tokens, cache,
                           policy=self.policy,
                           force_window=self.force_window,
                           capacity_factor=self.capacity_factor,
                           dispatch=self.dispatch)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_step(logits, self._gen, temperature=self.temperature)

    def make_scheduler(self, *, num_slots: int, admission: str = "fcfs",
                       **robustness) -> Scheduler:
        """A Scheduler sharing this engine's functions and device — the
        entry point for open-ended (arrival-process) serving. Extra
        keyword args pass through to the Scheduler's robustness layer."""
        self._schedulers += 1
        return Scheduler(
            self.cfg, self.params, num_slots=num_slots,
            cache_len=self.cache_len, policy=self.policy,
            admission=admission, decode_chunk=self.decode_chunk,
            temperature=self.temperature, force_window=self.force_window,
            capacity_factor=self.capacity_factor, dispatch=self.dispatch,
            seed=self._seed + self._schedulers, fns=self._fns,
            fused_cache=self._fused_levels, device=self.device,
            **robustness)

    def generate(self, prompts: np.ndarray, max_new_tokens: int, *,
                 prefix_embeds=None,
                 lockstep: bool = False) -> Tuple[np.ndarray, GenStats]:
        """prompts: (B, S) integer. Returns (tokens (B, max_new_tokens),
        stats). Greedy unless temperature > 0. lockstep=True runs the
        per-token host loop kept as the reference."""
        if prefix_embeds is not None:
            raise NotImplementedError("prefix embeddings are not ported yet")
        prompts = np.asarray(prompts)
        validate_request(
            int(prompts.shape[1]), max_new_tokens,
            cache_len=self.cache_len,
            window=effective_window(self.cfg,
                                    force_window=self.force_window))
        with torch.no_grad():
            if lockstep:
                return self._generate_lockstep(prompts, max_new_tokens)
            return self._generate_continuous(prompts, max_new_tokens)

    # ------------------------------------------------------- continuous --

    def _generate_continuous(self, prompts, max_new_tokens):
        B = prompts.shape[0]
        stats = GenStats(prompt_len=prompts.shape[1])
        t0 = time.perf_counter()
        sched = self.make_scheduler(num_slots=B, admission="fcfs")
        for b in range(B):
            sched.submit(prompts[b], max_new_tokens)
        states = sched.run()
        toks = np.stack([np.stack(st.tokens[:max_new_tokens])
                         for st in states])
        # per-request accounting is trimmed to each request's horizon;
        # the batch-level step count includes chunk overshoot past it
        stats.steps = max(len(st.tokens) for st in states) - 1
        stats.layer_aux = max((st.layer_aux for st in states), key=len)
        stats.new_tokens = int(np.prod(toks.shape))
        stats.wall_s = time.perf_counter() - t0
        return toks, stats

    # ------------------------------------------- lockstep (reference) ----

    def _generate_lockstep(self, prompts, max_new_tokens):
        """Per-token host loop: one decode step and one device->host read
        per token. The reference for the continuous path."""
        stats = GenStats(prompt_len=prompts.shape[1])
        t0 = time.perf_counter()
        lg, cache, _ = self._prefill(
            self.params, torch.tensor(prompts, device=self.device))
        tok = self._pick(lg)                                # (B,)
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
        stats.new_tokens = int(np.prod(toks.shape))
        stats.wall_s = time.perf_counter() - t0
        return toks, stats
