"""Training step and launcher (the JAX package's ``repro.launch.train``).

``make_train_step`` builds the (params, opt, tokens) -> (params, opt,
metrics) step: forward and backward of ``models.model.loss_fn`` through
``torch.autograd.grad``, global-norm clipping and AdamW. On the card the
sorted expert FFN runs the ``grouped_ffn`` kernel forward and its
hand-written gradient backward, and an SSM layer (mamba2, zamba2) the
``ssd_scan`` kernel forward and ``ssd_scan_bwd`` backward, and a
decode-sized drop-free batch (T <= 32, the dense expert path) the
``moe_ffn`` kernel forward and ``moe_ffn_bwd`` backward;
decode_attention, which has no backward, refuses to run under autograd.
No ``torch.compile``.

The CLI trains on the synthetic Markov data (``repro_torch.data``), in
(B, S, K) frames for the audio family, and after a seeded prefix
(``cli_prefix``) for a config with ``prefix_len``, as the reference's
CLI does:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --reduced --steps 50 --batch 8 \\
        --seq 128 --device cpu

(``--device`` defaults to the card.) ``--ckpt PATH`` saves the params
through ``repro_torch.checkpoint``, whose npz layout the JAX package's
``restore_checkpoint`` reads.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs.base import ArchConfig, XSharePolicy
from repro_torch.models.model import loss_fn
from repro_torch.models.moe import OFF
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule)


def loss_and_grads(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
                   prefix_embeds: Optional[torch.Tensor] = None,
                   policy: XSharePolicy = OFF, remat: bool = True,
                   capacity_factor: float = 1.25):
    """(loss, grads shaped like params) of loss_fn on one batch (after
    prefix_embeds (B, P, d) when given, which get no gradient). The
    params are taken as fresh leaves that require grad, so the caller's
    tensors are never marked; a leaf the loss does not reach gets a zero
    gradient."""
    flat = {k: p.detach().requires_grad_(True)
            for k, p in flatten(params).items()}
    with torch.enable_grad():
        loss, _ = loss_fn(cfg, unflatten(flat), tokens,
                          prefix_embeds=prefix_embeds, policy=policy,
                          remat=remat, capacity_factor=capacity_factor)
        got = torch.autograd.grad(loss, list(flat.values()),
                                  allow_unused=True)
    return loss.detach(), unflatten({
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(flat.items(), got)})


def make_train_step(cfg: ArchConfig, *, policy: XSharePolicy = OFF,
                    lr=None, remat: bool = True,
                    capacity_factor: float = 1.25,
                    weight_decay: float = 0.1, clip: float = 1.0,
                    accum_steps: int = 1):
    """fwd + bwd + clip + AdamW. accum_steps > 1 splits the batch into
    that many microbatches and sums their gradients in f32 (activation
    memory scales with the microbatch; the optimizer sees the whole
    batch; prefix_embeds are split with the tokens). lr is a float or a
    schedule of the step; the default is cosine_schedule(3e-4, 100,
    10000). The step returns (params, opt, {"loss", "grad_norm"}) and
    leaves its inputs as they were."""
    lr = lr or cosine_schedule(3e-4, 100, 10000)
    kw = dict(policy=policy, remat=remat, capacity_factor=capacity_factor)

    def train_step(params: Dict, opt_state, tokens,
                   prefix_embeds: Optional[torch.Tensor] = None):
        dev = next(iter(flatten(params).values())).device
        tokens = torch.as_tensor(tokens, device=dev)
        if prefix_embeds is not None:
            prefix_embeds = torch.as_tensor(prefix_embeds, device=dev)
        if accum_steps == 1:
            loss, grads = loss_and_grads(cfg, params, tokens,
                                         prefix_embeds=prefix_embeds, **kw)
        else:
            B = tokens.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"accum_steps {accum_steps}")
            mb = B // accum_steps
            pe_mbs = [None] * accum_steps if prefix_embeds is None else \
                prefix_embeds.reshape(accum_steps, mb,
                                      *prefix_embeds.shape[1:])
            g_acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in flatten(params).items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for t_mb, pe_mb in zip(tokens.reshape(accum_steps, mb,
                                                  *tokens.shape[1:]),
                                   pe_mbs):
                l_mb, g = loss_and_grads(cfg, params, t_mb,
                                         prefix_embeds=pe_mb, **kw)
                for k, gk in flatten(g).items():
                    g_acc[k] += gk.float()
                loss = loss + l_mb
            grads = unflatten({k: g / accum_steps for k, g in g_acc.items()})
            loss = loss / accum_steps
        grads, gnorm = clip_by_global_norm(grads, clip)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         weight_decay=weight_decay)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def cli_prefix(cfg: ArchConfig, batch: int, seed: int,
               params: Dict) -> Optional[torch.Tensor]:
    """The CLI's prefix embeddings when ``cfg.prefix_len`` is set: one
    (batch, prefix_len, d_model) N(0, 1) draw from a torch.Generator
    seeded with ``seed``, on the params' device and in their dtype, given
    to every step (the reference draws its prefix once with
    ``jax.random.normal``, whose numbers a torch generator cannot give).
    None otherwise."""
    if not cfg.prefix_len:
        return None
    emb = params["embed"]
    g = torch.Generator(device=emb.device).manual_seed(seed)
    return torch.randn((batch, cfg.prefix_len, cfg.d_model), generator=g,
                       device=emb.device).to(emb.dtype)


def main(argv: Optional[list] = None) -> None:
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticLM, batches
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description="Train on synthetic data.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr=cosine_schedule(args.lr, 10,
                                                      args.steps),
                              remat=False)
    stream = batches(SyntheticLM(cfg.vocab_size, name=args.arch),
                     batch=args.batch, seq_len=args.seq, seed=args.seed,
                     num_codebooks=(cfg.num_codebooks
                                    if cfg.family == "audio" else 1))
    prefix = cli_prefix(cfg, args.batch, args.seed, params)

    t0 = time.perf_counter()
    for step in range(args.steps):
        params, opt, m = step_fn(params, opt, next(stream), prefix)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}", flush=True)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s on "
          f"{dev})")
    if args.ckpt:
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt, params, step=args.steps)
        print("saved", args.ckpt)


if __name__ == "__main__":
    main()
