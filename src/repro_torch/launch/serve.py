"""Serving step factories and the serving CLI (the JAX package's
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --reduced --batch 4 --prompt-len 32 \\
        --new-tokens 32 --policy batch --m-l 8 --k0 1 --device cpu

(``--device`` defaults to the card.) The weights are random, drawn by
``bridge.init_params`` from ``--seed`` in f32 (the draft's from seed
1); the prompts come from ``SyntheticLM(vocab, name=arch)`` and
``numpy.random.default_rng(seed)``, as in the reference. The reference's
numbers come from ``jax.random``, which torch cannot repeat, so the two
CLIs print the same lines over other tokens.

``--spec-len N`` serves with a draft model of 2 layers and d_model 128,
as the reference's does, but with the target's vocabulary: the reference
cuts the draft's to 1024 under a target of 49 155 and JAX clamps the
ids, while the port refuses a draft with another vocabulary
(``serving/spec_scheduler.check_spec_pair``). With ``--reduced`` both
have 1024, as in the reference.

``main`` returns (tokens, stats) so that callers can read them; the
reference's returns None.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.configs.base import ArchConfig, XSharePolicy
from repro_torch.models import decode_step, prefill
from repro_torch.models.moe import OFF


def make_prefill(cfg: ArchConfig, *, cache_len: int,
                 force_window: Optional[int] = None,
                 capacity_factor: float = 2.0):
    """(params, tokens, prefix_embeds=None) -> (logits, cache, aux)."""
    def fn(params, tokens, prefix_embeds=None):
        return prefill(cfg, params, tokens, cache_len=cache_len,
                       prefix_embeds=prefix_embeds,
                       force_window=force_window,
                       capacity_factor=capacity_factor)
    return fn


def make_serve_step(cfg: ArchConfig, *, policy: XSharePolicy = OFF,
                    force_window: Optional[int] = None,
                    capacity_factor: float = 2.0):
    """One decode step: (params, tokens (B, 1), cache) -> (logits, cache,
    aux), T = 1 new token against the cache."""
    def fn(params, tokens, cache):
        return decode_step(cfg, params, tokens, cache, policy=policy,
                           force_window=force_window,
                           capacity_factor=capacity_factor)
    return fn


def draft_config(cfg: ArchConfig) -> ArchConfig:
    """The CLI's draft: 2 layers, d_model 128, the target's vocabulary."""
    return cfg.reduced(num_layers=2, max_d_model=128,
                       max_vocab=cfg.vocab_size)


def main(argv: Optional[list] = None):
    import numpy as np

    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.serving import Engine

    ap = argparse.ArgumentParser(description="Serve a batch of synthetic "
                                 "prompts with random weights.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--policy", default="off",
                    choices=["off", "batch", "spec", "ep"])
    ap.add_argument("--k0", type=int, default=1)
    ap.add_argument("--m-l", type=int, default=8)
    ap.add_argument("--m-r", type=int, default=4)
    ap.add_argument("--m-g", type=int, default=4)
    ap.add_argument("--spec-len", type=int, default=0,
                    help="draft tokens per round; the draft has 2 layers, "
                         "d_model 128 and the target's vocabulary")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=dev)
    policy = XSharePolicy(mode=args.policy, k0=args.k0, m_l=args.m_l,
                          m_r=args.m_r, m_g=args.m_g)
    lm = SyntheticLM(cfg.vocab_size, name=args.arch)
    rng = np.random.default_rng(args.seed)
    prompts = lm.sample(rng, args.batch, args.prompt_len)

    draft = None
    if args.spec_len:
        dcfg = draft_config(cfg)
        draft = (dcfg, init_params(dcfg, seed=1, device=dev))

    eng = Engine(cfg, params, policy=policy,
                 cache_len=args.prompt_len + args.new_tokens + 16,
                 draft=draft, spec_len=args.spec_len, device=dev)
    toks, stats = eng.generate(prompts, args.new_tokens)
    print("generated:", toks.shape)
    print(f"OTPS {stats.otps:.1f}  steps {stats.steps}")
    if stats.accepted_hist:
        print(f"mean accepted drafts/step: {stats.mean_accepted:.2f}")
    if stats.layer_aux:
        print(f"mean activated experts/layer: "
              f"{stats.mean_aux('activated_experts'):.2f} "
              f"(selected set {stats.mean_aux('selected_set'):.2f}, "
              f"gate mass {stats.mean_aux('gate_mass'):.3f})")
    return toks, stats


if __name__ == "__main__":
    main()
