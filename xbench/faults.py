"""Faults planted underneath the timed path, to see the check come out
false: the CPU tests plant them at a small size, ``control.py
--fault`` at a cell's own size on the card. Each takes ``patch(obj,
name, value)``, which replaces an attribute (pytest's
``monkeypatch.setattr``, or plain ``setattr``), and the cell's slot
count, and is planted before the engine is built, so a captured decode
graph holds it.

- ``cache_left_unchanged``: the step returns the cache as it was.
- ``half_batch_left_out``: the experts run on the first half of the
  rows; the rest get that half's mean.
- ``token_altered``: the first row's sampled token is moved by one.
- ``one_slot_corrupted``: slot 0 of the decode batch loses its routed
  experts' output, every other slot is served right.

One card, so there is no exchange between chips to leave out.
"""
from __future__ import annotations

import torch


def cache_left_unchanged(patch, slots: int) -> None:
    import repro_torch.models.attention as attention
    patch(attention, "update_cache",
          lambda cache, new, cur_len, window=None: cache)


def half_batch_left_out(patch, slots: int) -> None:
    import repro_torch.models.moe as moe
    real = moe.expert_ffn

    def half(p, x, idx, w, m, **kw):
        T = x.shape[0]
        if T < 2:
            return real(p, x, idx, w, m, **kw)
        y = real(p, x[:T // 2], idx[:T // 2], w[:T // 2], m,
                 **{**kw, "combine": None})
        rest = y.mean(0, keepdim=True).expand(T - T // 2, -1)
        return torch.cat([y, rest], 0)
    patch(moe, "expert_ffn", half)


def token_altered(patch, slots: int) -> None:
    import repro_torch.serving.step as step
    real = step.sample_step

    def bumped(logits, gen, **kw):
        t = real(logits, gen, **kw)
        first = torch.arange(t.shape[0], device=t.device) == 0
        return torch.where(first, (t + 1) % 500, t)
    patch(step, "sample_step", bumped)


def one_slot_corrupted(patch, slots: int) -> None:
    import repro_torch.models.moe as moe
    real = moe.expert_ffn

    def one(p, x, idx, w, m, **kw):
        y = real(p, x, idx, w, m, **kw)
        if x.shape[0] != slots:                  # a prefill
            return y
        keep = torch.arange(y.shape[0], device=y.device) != 0
        return y * keep[:, None].to(y.dtype)
    patch(moe, "expert_ffn", one)


FAULTS = {f.__name__: f for f in (cache_left_unchanged, half_batch_left_out,
                                  token_altered, one_slot_corrupted)}
