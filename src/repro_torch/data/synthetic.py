"""Synthetic language-modeling data pipeline (numpy only; a copy of the
JAX package's ``repro.data.synthetic``, so the same seeds give the same
arrays on either side).

No AIME/GPQA/etc. data ships with the repository. To reproduce the paper's
*heterogeneous dataset* experiments (Sec 6.3, Fig 3) we need token streams
whose distributions differ systematically between "datasets" while staying
learnable: each named dataset is a distinct first-order Markov chain over
a zipf-weighted vocabulary, seeded deterministically from the dataset
name. Tokens within one request are correlated (same chain state), tokens
across datasets use different transition structure — mirroring "requests
drawn from heterogeneous datasets".
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Sequence

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


def make_dataset_family(vocab_size: int,
                        names: Sequence[str]) -> Dict[str, SyntheticLM]:
    """Named heterogeneous "datasets" (gpqa/aime/mmlu-pro/aa-lcr stand-ins)."""
    return {n: SyntheticLM(vocab_size, name=n) for n in names}


def batches(lm: SyntheticLM, *, batch: int, seq_len: int, seed: int = 0,
            num_codebooks: int = 1) -> Iterator[np.ndarray]:
    """Endless stream of (B, S) int32 batches ((B, S, K) for audio)."""
    rng = np.random.default_rng(seed)
    while True:
        if num_codebooks == 1:
            yield lm.sample(rng, batch, seq_len)
        else:
            yield np.stack([lm.sample(rng, batch, seq_len)
                            for _ in range(num_codebooks)], axis=-1)


def mixed_request_batch(lms: Dict[str, SyntheticLM], *, seq_len: int,
                        seed: int = 0) -> np.ndarray:
    """One request per dataset — the paper's Sec 6.3 mixed batch."""
    rng = np.random.default_rng(seed)
    return np.concatenate([lm.sample(rng, 1, seq_len)
                           for lm in lms.values()], axis=0)
