"""The one traffic generator: a mix file (``xbench/traffic/<mix>.json``)
and a seed give the requests every client sends.

A mix names its clients, the bounds of its prompt and answer lengths,
the cache they need, the synthetic datasets its prompts come from, and
how many distinct requests (``table``) a run draws. Lengths are
log-uniform between the bounds, taken at fixed quantiles and paired by a
fixed permutation, so every seed serves the same set of sizes; the seed
orders them and draws the prompts' tokens. Datasets alternate along the
table, so each running batch mixes them (the paper's heterogeneous
traffic).

Client c's k-th request is entry (k * clients + c) of the table, modulo
its length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from xbench.synthetic import SyntheticLM

_PAIRING_SEED = 20251018   # fixed: the pairing of prompt and answer lengths


@dataclass(frozen=True)
class Request:
    prompt: np.ndarray      # (S,) int32
    answer_len: int


def log_uniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths in [lo, hi] at the midpoints of n equal slices of a
    log-uniform distribution, ascending."""
    u = (np.arange(n) + 0.5) / n
    vals = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return np.clip(np.rint(vals).astype(np.int64), lo, hi)


def lengths(mix: Dict) -> np.ndarray:
    """(table, 2) prompt and answer lengths, independent of the seed."""
    n = int(mix["table"])
    p = log_uniform_quantiles(*mix["prompt_len"], n)
    a = log_uniform_quantiles(*mix["answer_len"], n)
    a = a[np.random.default_rng(_PAIRING_SEED).permutation(n)]
    return np.stack([p, a], axis=1)


def make_table(mix: Dict, vocab_size: int, seed: int) -> List[Request]:
    """The seed's table of requests."""
    lens = lengths(mix)
    n = len(lens)
    lens = lens[np.random.default_rng([seed, 0]).permutation(n)]
    names = list(mix["datasets"])
    prompts: List[np.ndarray] = [None] * n
    for d, name in enumerate(names):
        rows = np.arange(d, n, len(names))
        if not len(rows):
            continue
        lm = SyntheticLM(vocab_size, name=name)
        toks = lm.sample(np.random.default_rng([seed, 1 + d]), len(rows),
                         int(lens[rows, 0].max()))
        for i, r in enumerate(rows):
            prompts[r] = toks[i, :lens[r, 0]].astype(np.int32)
    return [Request(prompts[i], int(lens[i, 1])) for i in range(n)]


def client_request(table: List[Request], clients: int, client: int,
                   k: int) -> Request:
    """Client ``client``'s k-th request."""
    return table[(k * clients + client) % len(table)]


def check_mix(mix: Dict, cache_len: int) -> None:
    """Refuse a mix whose longest prompt and answer do not fit the
    cache: no request of the traffic may fail."""
    need = mix["prompt_len"][1] + mix["answer_len"][1]
    if need > cache_len:
        raise ValueError(f"prompt {mix['prompt_len'][1]} + answer "
                         f"{mix['answer_len'][1]} exceed cache {cache_len}")
