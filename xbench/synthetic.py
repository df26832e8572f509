"""Frozen copy of the synthetic token generator the traffic draws prompts
from: ``SyntheticLM`` of ``src/repro_torch/data/synthetic.py`` at commit
42b2fa7, copied unchanged so that a later change to the program cannot
change the benchmark's prompts. Numpy only.
"""
from __future__ import annotations

import hashlib

import numpy as np


def _seed_of(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")


class SyntheticLM:
    """First-order Markov LM over a zipf vocabulary.

    Sparse transitions: each token has `branch` plausible successors, so
    sequences carry real structure a small model can learn (needed for the
    accuracy-proxy benchmarks).
    """

    def __init__(self, vocab_size: int, *, name: str = "default",
                 branch: int = 16, zipf_a: float = 1.2):
        self.vocab_size = vocab_size
        self.name = name
        rng = np.random.default_rng(_seed_of(name))
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        base = ranks ** (-zipf_a)
        base /= base.sum()
        # dataset-specific marginal: permute which tokens are frequent —
        # heterogeneous "domains" then activate distinct expert sets
        # (the Sec 6.3 / Fig 3 structure)
        base = base[rng.permutation(vocab_size)]
        # per-token successor sets + weights
        self.succ = rng.choice(vocab_size, size=(vocab_size, branch),
                               p=base)
        w = rng.dirichlet(np.ones(branch) * 0.5, size=vocab_size)
        self.succ_w = w
        self.base = base

    def sample(self, rng: np.random.Generator, batch: int,
               seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        cur = rng.choice(self.vocab_size, size=batch, p=self.base)
        out[:, 0] = cur
        for t in range(1, seq_len):
            rows = self.succ[cur]                       # (B, branch)
            ws = self.succ_w[cur]
            pick = (ws.cumsum(-1) > rng.random((batch, 1))).argmax(-1)
            cur = rows[np.arange(batch), pick].astype(np.int32)
            out[:, t] = cur
        return out
