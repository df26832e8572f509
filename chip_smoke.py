#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

  1. setup      build the CUDA kernels from src/repro_torch/kernels/csrc,
                switch TF32 off, print the card's name and power limit;
  2. kernels    each hand-written kernel against its plain PyTorch
                version on the card, at the main path's shapes, in f32
                and bf16, timed with CUDA events beside its bound and a
                PyTorch library call where one computes the same thing;
  3. parity     the full-width model cut to 2 layers in f32, prefill of
                4 x 64 tokens then 8 greedy decode steps, on the CPU
                (plain versions) and on the card (kernels): tokens equal,
                logits close;
  4. main path  granite-moe-1b-a400m, all 24 layers, bf16, random
                weights from a seed: Engine.generate serves 8 requests
                of 128 prompt tokens, 32 new tokens each, under XShare
                policy off and batch; continuous equals lockstep, and
                every kernel was launched during each policy's continuous
                run (counters set to 0 just before it, read just after).

Prints a JSON line {"kernels": [...]}, the card's name and power limit,
and last {"ok": true, "device": {...}}. Exits non-zero without a result
when CUDA is absent. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 rate,
# bf16 tensor-core rate, f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the same inputs: the repo's kernel-test
# tolerances (tests/test_kernels.py), atol = rtol
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# path parity, f32 CPU vs f32 GPU: sums over d = 1024 run in another order
PARITY_LOGIT_TOL = 1e-3
ARCH = "granite-moe-1b-a400m"


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------ timing ---

_FLUSH = None
CUDA = torch.device("cuda")


def time_ms(fn, iters: int = 20, warmup: int = 3):
    """Median time of one call in ms (CUDA events), the L2 cache flushed
    before each call so weights and KV come from device memory."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, dtype) -> bool:
    return bool(torch.allclose(a.float(), b.float(), atol=TOL[dtype],
                               rtol=TOL[dtype]))


# ----------------------------------------------------- kernel phase ---

def kernel_cases(cfg):
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel name: [case dicts]}."""
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.core.routing import topk_route
    from repro_torch.kernels import (decode_attention,
                                     decode_attention_plain, grouped_ffn,
                                     grouped_ffn_plain, moe_ffn,
                                     moe_ffn_plain)
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens
    from repro_torch.models.moe import OFF, policy_max_active, route

    dev = CUDA
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    d, E, f, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert, \
        cfg.moe.top_k
    a = cfg.attn
    out = {"grouped_ffn": [], "moe_ffn": [], "decode_attention": []}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    wg = randn(d, E, scale=0.02)
    moe_p = {"wg": wg}
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.finfo(dtype).bits // 8
        w1 = randn(E, d, f, scale=0.02, dtype=dtype)
        w3 = randn(E, d, f, scale=0.02, dtype=dtype)
        w2 = randn(E, f, d, scale=0.02, dtype=dtype)

        # grouped_ffn: a prefill of 8 x 128 tokens, top-8 of 32 experts
        x = randn(8 * 128, d, dtype=dtype)
        idx, w = topk_route(x.float() @ wg, k)
        plan = dispatch_plan(idx, w, E)
        xs = gather_tokens(x, plan)
        args = (xs, w1, w3, w2, plan.tile_eid, plan.tile_valid)
        ker = grouped_ffn(*args, block_t=plan.block_t)
        ref = grouped_ffn_plain(*args, block_t=plan.block_t)
        n_rows = int(plan.counts.sum())
        occupied = int(torch.unique(plan.tile_eid[plan.tile_valid > 0])
                       .numel())
        # the function reads only the rows of valid tiles, writes all P
        # rows (zeros for invalid tiles) and each occupied expert's weights
        nbytes = ((int(plan.tile_valid.sum()) * plan.block_t + xs.shape[0])
                  * d * sz + occupied * 3 * d * f * sz
                  + 2 * plan.tile_eid.numel() * 4)
        bms, by = bound_ms(nbytes, 6.0 * n_rows * d * f, dtype)
        out["grouped_ffn"].append(dict(
            dtype=str(dtype).replace("torch.", ""),
            shape=f"P={xs.shape[0]} d={d} f={f} E={E} "
                  f"block_t={plan.block_t} rows={n_rows}",
            max_abs_err=max_err(ker, ref), ok=close(ker, ref, dtype),
            ref_max_abs=float(ref.float().abs().max()),
            ms=time_ms(lambda: grouped_ffn(*args, block_t=plan.block_t)),
            plain_ms=time_ms(lambda: grouped_ffn_plain(
                *args, block_t=plan.block_t), iters=5),
            bound_ms=bms, bound_by=by, library_ms=None))

        # moe_ffn: one decode step's FFN, 8 tokens, policy off and batch
        xt = randn(8, d, dtype=dtype)
        for pol in (OFF, XSharePolicy(mode="batch", k0=1, m_l=8)):
            _, _, combine, _ = route(moe_p, xt, cfg.moe, pol)
            active = (combine != 0).any(0)
            ma = policy_max_active(pol, 8, E)
            margs = (xt, w1, w3, w2, combine, active)
            ker = moe_ffn(*margs, max_active=ma)
            ref = moe_ffn_plain(*margs)
            n_act = int(active.sum())
            if n_act > ma:
                fail(f"moe_ffn: {n_act} active experts > max_active {ma}")
            nnz = int((combine != 0).sum())
            nbytes = (2 * xt.numel() * sz + combine.numel() * 4 + E
                      + n_act * 3 * d * f * sz)
            bms, by = bound_ms(nbytes, 6.0 * nnz * d * f, dtype)
            out["moe_ffn"].append(dict(
                dtype=str(dtype).replace("torch.", ""), policy=pol.mode,
                shape=f"T=8 d={d} f={f} E={E} active={n_act} "
                      f"max_active={ma}",
                max_abs_err=max_err(ker, ref), ok=close(ker, ref, dtype),
                ref_max_abs=float(ref.float().abs().max()),
                ms=time_ms(lambda: moe_ffn(*margs, max_active=ma)),
                plain_ms=time_ms(lambda: moe_ffn_plain(*margs)),
                bound_ms=bms, bound_by=by, library_ms=None))

        # decode_attention: 8 rows, cache 512, ragged lengths
        B, S = 8, 512
        q = randn(B, a.num_heads, a.head_dim, dtype=dtype)
        kc = randn(B, S, a.num_kv_heads, a.head_dim, dtype=dtype)
        vc = randn(B, S, a.num_kv_heads, a.head_dim, dtype=dtype)
        lengths = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                                dtype=torch.int32)
        ker = decode_attention(q, kc, vc, lengths)
        ref = decode_attention_plain(q, kc, vc, lengths)
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = max_err(sdpa()[:, :, 0], ref)
        live = int(lengths.clamp(max=S).sum())
        nbytes = (2 * q.numel() * sz + 2 * live * a.num_kv_heads
                  * a.head_dim * sz + B * 4)
        bms, by = bound_ms(nbytes, 4.0 * live * a.num_heads * a.head_dim,
                           dtype)
        out["decode_attention"].append(dict(
            dtype=str(dtype).replace("torch.", ""),
            shape=f"B={B} S={S} H={a.num_heads} Hkv={a.num_kv_heads} "
                  f"dh={a.head_dim} live={live}",
            max_abs_err=max_err(ker, ref), ok=close(ker, ref, dtype),
            ref_max_abs=float(ref.float().abs().max()),
            library_max_abs_err=lib_err,
            ms=time_ms(lambda: decode_attention(q, kc, vc, lengths)),
            plain_ms=time_ms(lambda: decode_attention_plain(q, kc, vc,
                                                            lengths)),
            bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa)))
        del w1, w3, w2
    return out


# ------------------------------------------------------ parity phase ---

def path_parity(cfg):
    """Same seeded weights, f32: CPU (plain versions) vs GPU (kernels)."""
    from repro_torch.bridge import init_params
    from repro_torch.models.model import decode_step, params_to, prefill
    from repro_torch.serving.sampler import greedy

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = init_params(cfg2, seed=0, dtype=torch.float32, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 64)).astype(np.int32)
    runs = []
    for dev in ("cpu", CUDA):
        p = params_to(params, dev)
        lg, cache, _ = prefill(cfg2, p, torch.as_tensor(prompts, device=dev),
                               cache_len=128, capacity_factor=8.0)
        logits, toks = [lg.cpu()], []
        tok = greedy(lg)
        for _ in range(8):
            toks.append(tok.cpu())
            lg, cache, _ = decode_step(cfg2, p, tok[:, None], cache,
                                       capacity_factor=8.0)
            lg = lg[:, -1]
            logits.append(lg.cpu())
            tok = greedy(lg)
        toks.append(tok.cpu())
        runs.append((torch.stack(logits), torch.stack(toks)))
    (lc, tc), (lg_, tg) = runs
    if not torch.isfinite(lg_).all():
        fail("parity: non-finite logits on the GPU")
    err = max_err(lc, lg_)
    same = bool((tc == tg).all())
    log(f"parity: 2 layers f32, prefill 4x64 + 8 decode steps: "
        f"tokens equal={same}, max |logit diff|={err:.3e} "
        f"(tol {PARITY_LOGIT_TOL})")
    if not same or err > PARITY_LOGIT_TOL:
        fail("parity: CPU and GPU disagree")


# --------------------------------------------------------- main path ---

def main_path(cfg, kernel_names):
    """Engine.generate, continuous batching, under policy off and batch.
    The launch counters are set to 0 just before each policy's continuous
    run and read just after it; the lockstep run and the prefill check
    lie outside that window."""
    from repro_torch import kernels as K
    from repro_torch.bridge import init_params, param_count
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.model import prefill
    from repro_torch.models.moe import OFF
    from repro_torch.serving import Engine

    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CUDA)
    log(f"main path: {cfg.name} {cfg.num_layers} layers, "
        f"{param_count(params) / 1e9:.3f} B parameters, bf16")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(8, 128)).astype(np.int32)
    new = 32
    results = {}
    for pol in (OFF, XSharePolicy(mode="batch", k0=1, m_l=8)):
        eng = Engine(cfg, params, policy=pol, cache_len=512, device=CUDA)
        lock, _ = eng.generate(prompts, new, lockstep=True)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        cont, st = eng.generate(prompts, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        log(f"main path policy={pol.mode} launches: {counts}")
        missing = [n for n in kernel_names if counts[n] <= 0]
        if missing:
            fail(f"main path ({pol.mode}) never launched {missing}")
        if cont.shape != (8, new) or not np.array_equal(cont, lock):
            fail(f"main path ({pol.mode}): continuous != lockstep")
        if cont.min() < 0 or cont.max() >= cfg.vocab_size:
            fail(f"main path ({pol.mode}): token out of vocabulary")
        with torch.no_grad():
            lg, _, _ = prefill(cfg, eng.params,
                               torch.as_tensor(prompts, device=CUDA),
                               cache_len=512, capacity_factor=8.0)
        if lg.shape != (8, cfg.padded_vocab) or \
                not torch.isfinite(lg[:, :cfg.vocab_size]).all():
            fail(f"main path ({pol.mode}): bad prefill logits")
        results[pol.mode] = dict(
            tokens_per_s=8 * new / wall, wall_s=wall, launches=counts,
            activated_experts=st.mean_aux("activated_experts"),
            selected_set=st.mean_aux("selected_set"))
        log(f"main path policy={pol.mode}: continuous == lockstep, "
            f"{8 * new} tokens in {wall:.3f} s = "
            f"{8 * new / wall:.1f} tokens/s, activated experts per layer "
            f"{results[pol.mode]['activated_experts']:.2f}")
    return results, eng.params, prompts


# ------------------------------------------------------ profile phase ---

def profile_phase(cfg, params, prompts, steps: int = 8):
    """Where a decode step's time goes, policy off: host wall per step
    (no profiler), then torch.profiler over the same steps for the
    device's busy time by kernel. Device numbers are "not measured" if
    the profiler sees no CUDA kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import prefill
    from repro_torch.serving.sampler import greedy
    from repro_torch.serving.step import decode_steps_fused

    toks = torch.as_tensor(prompts, device=CUDA)
    B = toks.shape[0]

    def prefilled():
        lg, cache, _ = prefill(cfg, params, toks, cache_len=512,
                               capacity_factor=8.0)
        return greedy(lg), cache

    def decode(tok, cache):
        return decode_steps_fused(
            cfg, params, tok, cache,
            torch.full((B,), 1000, dtype=torch.int32, device=CUDA), None,
            num_steps=steps, capacity_factor=8.0)

    out = {}
    for name in ("prefill", "decode"):
        runs = []
        for use_prof in (False, True):
            tok, cache = prefilled()
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if use_prof else None
            if prof is not None:
                prof.__enter__()
            t0 = time.perf_counter()
            if name == "prefill":
                prefilled()
            else:
                decode(tok, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
            runs.append((wall, prof))
        per = 1 if name == "prefill" else steps
        wall_ms = runs[0][0] * 1e3 / per
        kern = [e for e in runs[1][1].key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / per
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = dict(
            wall_ms=wall_ms, profiled_wall_ms=runs[1][0] * 1e3 / per,
            device_busy_ms=busy_ms if kern else "not measured",
            device_idle_share=(1 - busy_ms / (runs[1][0] * 1e3 / per))
            if kern else "not measured",
            kernels_per_call=sum(e.count for e in kern) / per,
            top=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3
                      / per, calls=e.count / per) for e in top])
        log(f"profile {name}: {json.dumps(out[name])}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = gpu_name_power()
    log(f"card: {card}")
    t0 = time.perf_counter()
    build.build()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    cfg = ARCHS[ARCH]
    with torch.no_grad():
        cases = kernel_cases(cfg)
    bad = [(n, c["dtype"], c.get("policy")) for n, cs in cases.items()
           for c in cs if not c["ok"]]
    for n, cs in cases.items():
        for c in cs:
            log(f"kernel {n}: {json.dumps(c)}")
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    with torch.no_grad():
        path_parity(cfg)
    results, params, prompts = main_path(cfg, list(cases))
    with torch.no_grad():
        prof = profile_phase(cfg, params, prompts)

    sources = {"grouped_ffn": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                               "src/repro/kernels/moe_ffn.py:155"),
               "moe_ffn": ("src/repro_torch/kernels/csrc/moe_ffn.cu",
                           "src/repro/kernels/moe_ffn.py:77"),
               "decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attn.cu",
                   "src/repro/kernels/decode_attn.py:67")}
    line = []
    for name, cs in cases.items():
        main_case = next(c for c in cs if c["dtype"] == "bfloat16")
        f32 = next(c for c in cs if c["dtype"] == "float32")
        line.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1],  # both policies' continuous runs
            launches=sum(r["launches"][name] for r in results.values()),
            max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"],
            dtype="bfloat16", shape=main_case["shape"],
            tol=TOL[torch.bfloat16], max_abs_err_f32=f32["max_abs_err"],
            tol_f32=TOL[torch.float32], cases=cs))
    print(json.dumps({"kernels": line, "main_path": results,
                      "profile": prof, "card": card}), flush=True)
    print(gpu_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
