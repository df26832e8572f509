#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed;
each prints its wall time):

  1. setup      build the CUDA kernels from src/repro_torch/kernels/csrc,
                switch TF32 off, print the card's name and power limit;
  2. kernels    each hand-written kernel against its plain PyTorch
                version on the card, at the main paths' shapes, in f32
                and bf16, timed with CUDA events beside its bound and a
                PyTorch library call where one computes the same thing
                (decode_attention at granite-moe's and zamba2-1.2b's
                decode shapes, with ragged lengths and with the lengths
                each main path serves, and at granite's verify shape,
                8 rows x (1 + L_s = 5) queries, with cur_len ragged, at
                the served 128-160, and under a rolling window of 128
                in a cache of 640 that wraps, beside SDPA with the same
                boolean mask; grouped_ffn at granite's prefill and
                verify shapes with its achieved TFLOP/s, beside
                torch._grouped_mm where the card's PyTorch has it; all
                three at the shapes of granite's 2-layer draft (d 128,
                4 experts top-2, 2 / 2 heads of 64): its 8 x 128
                prefill, its 8-token decode steps, one query per row at
                cur_len 128-160; decode_attention also at h2o-danube-1.8b's
                decode and verify shapes: 4 rows, T = 1 and 5, 32 / 8
                heads of 80, its window of 4096 in a 4608-slot cache,
                cur_len past the cache so it wraps, beside SDPA with the
                same mask; its bf16 cases at a max abs error of 4e-3, and
                every bf16 decode_attention case of this cached contract
                also against f32 math on its bf16 inputs);
                ssd_scan at mamba2-370m's and zamba2-1.2b's prefill
                shapes, once more from a nonzero initial state, and
                with dt ~ 0.01, where the state carried across chunks
                dominates, with its achieved TFLOP/s); moe_ffn under
                policy off and batch, failing if one call runs more
                than 3 CUDA kernels (torch.profiler) or if, in bf16,
                its time ratio batch / off exceeds the active-expert
                ratio by more than 0.2; failing if one decode_attention
                or grouped_ffn call runs more than 2;
  3. parity     each full-width model cut to 2 layers in f32 (zamba2: one
                shared-block application), prefill of 4 x 64 tokens
                (granite-moe) or 4 x 300 (mamba2, zamba2) then 8 greedy
                decode steps, on the CPU (plain versions) and on the card
                (kernels): tokens equal, logits close; and granite-moe's
                speculative decoding (spec_len 3, 16 new; the self-draft
                and the target's params + 0.05 N(0, 1), which must be
                rejected at least once): continuous == lockstep == plain
                greedy on each device, CPU == GPU;
  4. main path  random weights from a seed, bf16, all layers, through
                Engine.generate, twice: cold (the decode loops captured
                as CUDA graphs on the way, serving/graphs.py) and warm
                (replays only), each with tokens/s; continuous (replayed
                graphs) equals lockstep (eager), and each kernel of the
                path was launched in each continuous run, the same
                number of times in both (counters set to 0 just before
                a run, read just after):
                granite-moe-1b-a400m (24 layers), 8 requests of 128
                prompt tokens, 32 new each, XShare policy off and batch;
                mamba2-370m (48 layers) and zamba2-1.2b (38), 8
                requests of 500 prompt tokens, 32 new each, policy off:
                ssd_scan once per SSM layer per prefill, decode_attention
                once per shared-block application per decode round;
                h2o-danube-1.8b (24 layers, head dim 80, sliding window
                4096), 4 requests of 4600 prompt tokens, 32 new, so its
                rolling cache of 4608 wraps 8 tokens into decoding:
                decode_attention once per layer per decode step;
     graphs     granite-moe at full width, bf16: one decode chunk (8
                steps) and one speculative dispatch (4 rounds, small
                draft) captured over a prefilled state and replayed,
                against the same functions run eagerly on clones of that
                state: every output, tok and every cache tensor bit-equal,
                launch counts equal; capture time per loop;
  5. profile    torch.profiler over a prefill and 8 decode steps of
                granite-moe (8 x 128 tokens) and of mamba2-370m (8 x 500),
                eager and replayed (granite also replayed under the batch
                policy): wall per step, device busy, idle share, kernels
                per step, each port kernel's ms per call (summed and as a
                call's span), with ssd_scan's share of the mamba2 device
                time; and (CUDA activity only) over one speculative
                dispatch of granite-moe (4 rounds, small draft), eager
                and replayed, per round;
  6. bf16 check granite-moe's prefill logits (24 layers, 8 x 128) with
                the grouped_ffn kernel, and mamba2-370m's (48 layers,
                8 x 500) with the ssd_scan kernel, each also with the
                kernel's plain version, all in bf16, against f32: the
                kernel's logit error at most twice the plain bf16
                path's;
  7. spec       granite-moe speculative decoding at full width: in f32
                (spec_len 4, 8 x 128 prompts, 16 new; the self-draft and
                the perturbed draft, which must be rejected at least
                once) the continuous, lockstep and mixed spec / plain
                tokens equal plain greedy; in bf16 (32 new, spec_len 4, 4 rounds per
                dispatch) with the self-draft and with the serve CLI's
                2-layer draft at the target's vocabulary, under policy
                off and Algorithm 4, exact launch counts of the three
                kernels from the rounds each run reports, with tokens/s,
                acceptance and activated experts printed;
  8. durability granite-moe through the crash-tolerant FrontDoor at full
                width, bf16, 8 x 128 prompts, 32 new, 8 slots, journal
                and snapshots every 2 rounds: (a) fault-free; (b) killed
                entering round 3 with a torn journal write, then
                recover(); (c) the seeded chaos campaign
                sample_campaign(10, ..., p_crash=1.0), rids 6 and 7
                arriving one at a time into the running batch, then
                recover(): NaN, insert failure, stall and crash all
                delivered, one request quarantined;
                (d) speculative requests (small draft, spec_len 4)
                killed and recovered. Streams equal Engine.generate's
                tokens (a quarantined one a prefix), no request lost,
                replay fidelity 1.0, every rid finished in a whole
                journal; the recovered incarnation launches all three
                kernels, holds no second cache and captures nothing (it
                borrows the crashed one's graph). Prints survival,
                chaos / fault-free tokens/s, recovery wall time (to the
                first fresh token), durable and replayed tokens.

Prints a JSON line {"kernels": [...]}, the card's name and power limit,
and last {"ok": true, "device": {...}}. Exits non-zero without a result
when CUDA is absent. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import itertools
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
# danube's bf16 decode_attention against its plain bf16 version: at 4096
# live positions an output's rms is ~sqrt(e / 4096) = 0.026, so TOL's
# 2e-2 would pass a wrong kernel; the plain version's own rounding gives
# 1.5e-3, and the limit is about three times that
DANUBE_BF16_ABS = 4e-3
# (atol, rtol) of a bf16 output against f32 math on its bf16 inputs: one
# rounding to bf16 is within 2^-9 of the value
EXACT_BF16 = (1e-5, 2.0 ** -8)
# the SSD scan's (tests/test_kernels.py: chunked vs sequential), atol = rtol
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# path parity, f32 CPU vs f32 GPU: sums over d = 1024 / 2048 run in
# another order
PARITY_LOGIT_TOL = 1e-3
ARCH = "granite-moe-1b-a400m"
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
DANUBE = "h2o-danube-1.8b"
SSD_KERNELS = ("chunk_state_kernel", "state_pass_kernel",
               "chunk_scan_kernel")   # the three passes of ssd_scan
# every __global__ function of src/repro_torch/kernels/csrc (name prefixes)
PORT_KERNELS = SSD_KERNELS + ("grouped_tc_kernel", "grouped_f32_kernel",
                              "moe_up_kernel", "moe_down_kernel",
                              "moe_reduce_kernel", "decode_split_kernel",
                              "decode_merge_kernel")


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
    before each call so weights and KV come from device memory. A spin
    kernel after the flush keeps the card busy while the host enqueues
    the call, so a call shorter than its own host overhead is timed by
    its device work, not by the host's: it spins at least ~0.5 ms, and
    twice the host's enqueue time of the last warm-up call (a plain
    version's dozens of eager ops can take the host longer than that)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # ~2e9 cycles a second; at most ~50 ms
    spin = int(min(1e8, max(1e6, 4e9 * host_s)))
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(spin)
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


def cuda_kernels(prof):
    """The CUDA kernels a torch.profiler run saw, one averaged event per
    kernel name (``count`` calls, ``self_device_time_total`` us)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def port_kernels_ms(kern, per):
    """Device ms of the port's kernels (csrc/*.cu) in a profiler's CUDA
    events, by name and template, divided by ``per``."""
    ours = {}
    for e in kern:
        kname = e.key.replace("(anonymous namespace)::", "").split(
            "(")[0].removeprefix("void ")
        if kname.startswith(PORT_KERNELS):
            ours[kname] = ours.get(kname, 0.0) + \
                e.self_device_time_total / 1e3 / per
    return ours


def cuda_kernels_of(fn, calls: int = 3, tries: int = 5):
    """(count, {name: device us}) of the CUDA kernels one call of fn
    runs, by torch.profiler over ``calls`` calls after a warm-up call.
    The tracer can lose records (seen on an H100: a session with none of
    its call's 2 kernels, or 1 of them), never invent one, so the count
    per call is rounded up, and a session that sees no kernel is
    repeated, up to ``tries`` sessions."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = cuda_kernels(prof)
        if kern:
            break
    us = {}
    for e in kern:   # names cut to 72 characters keep template arguments
        us[e.key[:72]] = us.get(e.key[:72], 0.0) + \
            e.self_device_time_total / calls
    return -(-sum(e.count for e in kern) // calls), us


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, dtype, tol=TOL) -> bool:
    return bool(torch.allclose(a.float(), b.float(), atol=tol[dtype],
                               rtol=tol[dtype]))


class Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        log(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s"
            + (" (failed)" if exc[0] is not None else ""))


# ----------------------------------------------------- kernel phase ---

def kernel_cases(archs):
    """Each kernel against its plain version at the main paths' shapes
    (decode_attention at granite-moe's and at zamba2-1.2b's shared block;
    all three of granite's kernels also at its verify pass's and at its
    small draft's shapes). Returns {kernel name: [case dicts]}."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.kernels import decode_attention, decode_attention_plain
    from repro_torch.models.moe import OFF

    dev = CUDA
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    cfg = archs[ARCH]
    d, E, f, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert, \
        cfg.moe.top_k
    # (model, cache length, lengths served) of each main path that runs
    # decode_attention: 128 or 500 prompt tokens, then up to 32 new
    attn_paths = ((ARCH, 512, (129, 160)), ("zamba2-1.2b", 1024, (501, 532)))
    out = {"grouped_ffn": [], "moe_ffn": [], "decode_attention": []}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    wg = randn(d, E, scale=0.02)
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.finfo(dtype).bits // 8
        w1 = randn(E, d, f, scale=0.02, dtype=dtype)
        w3 = randn(E, d, f, scale=0.02, dtype=dtype)
        w2 = randn(E, f, d, scale=0.02, dtype=dtype)

        # grouped_ffn: a prefill of 8 x 128 tokens, and a verify pass of 8
        # rows x (1 + L_s = 5) tokens, top-8 of 32 experts
        for label, n_tok in (("prefill", 8 * 128), ("verify", 8 * 5)):
            x = randn(n_tok, d, dtype=dtype)
            out["grouped_ffn"].append(grouped_case(
                label, x, wg, w1, w3, w2, E, k, dtype, sz))

        # moe_ffn: one decode step's FFN, 8 tokens, policy off and batch
        xt = randn(8, d, dtype=dtype)
        moe_cases = [moe_case(xt, wg, w1, w3, w2, cfg.moe, pol, dtype)
                     for pol in (OFF, XSharePolicy(mode="batch", k0=1,
                                                   m_l=8))]
        # XShare's saving at kernel level: time follows the selected set
        off, bat = moe_cases
        t_ratio, a_ratio = bat["ms"] / off["ms"], bat["active"] / off["active"]
        log(f"moe_ffn {dtype}: time batch / off = {t_ratio:.3f}, active "
            f"batch / off = {a_ratio:.3f} ({bat['active']} / "
            f"{off['active']})")
        for c in moe_cases:
            c.update(time_ratio_batch_off=t_ratio,
                     active_ratio_batch_off=a_ratio)
        out["moe_ffn"] += moe_cases

        # decode_attention: 8 rows, each path's cache, ragged lengths and
        # the lengths its main path serves (prompt + up to 32 new)
        for (model, S, served), lengths_kind in itertools.product(
                attn_paths, ("ragged", "served")):
            a, B = archs[model].attn, 8
            q = randn(B, a.num_heads, a.head_dim, dtype=dtype)
            kc = randn(B, S, a.num_kv_heads, a.head_dim, dtype=dtype)
            vc = randn(B, S, a.num_kv_heads, a.head_dim, dtype=dtype)
            lo, hi = (1, S) if lengths_kind == "ragged" else served
            lengths = torch.randint(lo, hi + 1, (B,), generator=g,
                                    device=dev, dtype=torch.int32)
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
            bms, by = bound_ms(nbytes, 4.0 * live * a.num_heads
                               * a.head_dim, dtype)
            n_kern, kern_us = cuda_kernels_of(
                lambda: decode_attention(q, kc, vc, lengths))
            case = dict(
                dtype=str(dtype).replace("torch.", ""), model=model,
                lengths=f"{lengths_kind} {lo}-{hi}",
                shape=f"B={B} S={S} H={a.num_heads} Hkv={a.num_kv_heads} "
                      f"dh={a.head_dim} live={live}",
                max_abs_err=max_err(ker, ref), ok=close(ker, ref, dtype),
                ref_max_abs=float(ref.float().abs().max()),
                library_max_abs_err=lib_err,
                kernels_per_call=n_kern, kernel_device_us=kern_us,
                ms=time_ms(lambda: decode_attention(q, kc, vc, lengths)),
                plain_ms=time_ms(lambda: decode_attention_plain(
                    q, kc, vc, lengths)),
                bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa))
            case["ms_over_sdpa"] = case["ms"] / case["library_ms"]
            log(f"decode_attention {dtype} {model} lengths {lo}-{hi}: "
                f"{case['ms']:.4f} ms, SDPA {case['library_ms']:.4f} ms, "
                f"kernel / SDPA = {case['ms_over_sdpa']:.3f} (bound "
                f"{bms:.4f}), {n_kern} CUDA kernels per call")
            out["decode_attention"].append(case)
            del q, kc, vc, kt, vt
        del w1, w3, w2
    # the verify pass and the small draft, last and on their own
    # generators, so the cases above get the same inputs and allocations
    # in a tree without them (an older commit's, timed by kernel_times.py)
    cached = hasattr(K, "decode_attention_cached")
    if cached:
        gv = torch.Generator(device=dev)
        gv.manual_seed(4242)
        for dtype, kind in itertools.product(
                (torch.float32, torch.bfloat16),
                ("ragged", "served", "window")):
            out["decode_attention"].append(verify_attention_case(
                cfg.attn, kind, dtype, gv))
    for kernel, cases in draft_cases(cfg, cached).items():
        out[kernel] += cases
    out["decode_attention"] += danube_attention_cases(archs)
    return out


def danube_attention_cases(archs):
    """decode_attention at h2o-danube-1.8b's decode and verify shapes:
    4 rows, 32 / 8 heads of 80 (a head dim that is not a power of two),
    its sliding window of 4096 in a rolling cache of 4096 +
    WINDOW_MARGIN = 4608 slots, cur_len past C (the cache has wrapped),
    T = 1 and T = 5, in f32 and bf16. Last and on their own generator;
    none in a tree whose kernel has no head dim 80 (an older commit's,
    timed by kernel_times.py)."""
    from repro_torch.kernels import decode_attn
    from repro_torch.models.model import WINDOW_MARGIN
    if 80 not in decode_attn._HEAD_DIMS:
        return []
    a = archs[DANUBE].attn
    g = torch.Generator(device=CUDA)
    g.manual_seed(8080)
    wc = (a.sliding_window, a.sliding_window + WINDOW_MARGIN)
    return [verify_attention_case(a, "window", dtype, g, T=T, label=DANUBE,
                                  B=4, window_cache=wc,
                                  bf16_abs=DANUBE_BF16_ABS)
            for dtype, T in itertools.product(
                (torch.float32, torch.bfloat16), (1, 5))]


def draft_cases(cfg, cached: bool):
    """The kernels at the shapes small_draft(cfg) gives them in the served
    spec runs (d_model 128, 4 experts top-2 of width 128, 2 / 2 heads of
    64): grouped_ffn on its prefill of 8 x 128 tokens, moe_ffn on its
    decode steps of 8 tokens (the draft runs policy off), and
    decode_attention on those steps (one query per row at cur_len
    128-160 in a cache of 512), in f32 and bf16."""
    from repro_torch.models.moe import OFF

    dcfg = draft_config(cfg)
    d, m = dcfg.d_model, dcfg.moe
    g = torch.Generator(device=CUDA)
    g.manual_seed(4343)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=CUDA)
                ).to(dtype)

    label = f"{ARCH} draft"
    out = {"grouped_ffn": [], "moe_ffn": [], "decode_attention": []}
    wg = randn(d, m.num_experts, scale=0.02)
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.finfo(dtype).bits // 8
        w1, w3 = (randn(m.num_experts, d, m.d_ff_expert, scale=0.02,
                        dtype=dtype) for _ in range(2))
        w2 = randn(m.num_experts, m.d_ff_expert, d, scale=0.02, dtype=dtype)
        c = grouped_case("draft prefill", randn(8 * 128, d, dtype=dtype), wg,
                         w1, w3, w2, m.num_experts, m.top_k, dtype, sz)
        out["grouped_ffn"].append(dict(c, model=label))
        out["moe_ffn"].append(moe_case(randn(8, d, dtype=dtype), wg, w1, w3,
                                       w2, m, OFF, dtype, label=label))
        if cached:
            out["decode_attention"].append(verify_attention_case(
                dcfg.attn, "served", dtype, g, T=1, label=label))
    return out


def cached_mask(cur, T: int, C: int, window):
    """(B, T, C) bool: the slots query t of each row sees under
    cached_attention's contract (the mask of its plain version)."""
    slot = torch.arange(C, device=cur.device)[None, None, :]
    q_pos = (cur.long()[:, None]
             + torch.arange(T, device=cur.device)[None, :])[..., None]
    slot_pos = slot.expand(cur.shape[0], T, C) if window is None \
        else q_pos - torch.remainder(q_pos - slot, C)
    mask = (slot_pos <= q_pos) & (slot_pos >= 0)
    if window is not None:
        mask &= slot_pos > q_pos - window
    return mask


def verify_attention_case(a, kind, dtype, g, T=5, label=ARCH, B=8,
                          window_cache=None, bf16_abs=None):
    """decode_attention under the cached_attention contract, B rows of T
    queries (granite's verify shape: 8 x (1 + L_s = 5)) at heads ``a``:
    cur_len ragged over [0, C - T] or at the served lengths 128-160 in a
    cache of 512, or a rolling window of 128 in a cache of 640 with
    cur_len over [0, 3C), so the cache wraps; ``window_cache`` =
    (window, C) gives another window, cur_len then over [C, 3C), past C.
    Beside its bound (the live positions' bytes) and SDPA with the same
    boolean mask.

    Held against its plain version at TOL, or in bf16 at a max abs error
    of ``bf16_abs`` where that is given; a bf16 output also against the
    plain version's f32 math on the same (bf16) inputs at EXACT_BF16: the
    kernel computes in f32 and rounds once, so a slot dropped or counted
    twice (~p_i |v_i|, 2e-4 at 4096 live positions) shows there even
    where it hides in the plain bf16 version's own rounding."""
    from repro_torch.kernels import (decode_attention_cached,
                                     decode_attention_cached_plain)
    H, Hkv, dh = a.num_heads, a.num_kv_heads, a.head_dim
    sz = torch.finfo(dtype).bits // 8
    if window_cache is not None:
        window, C = window_cache
        lo, hi = C, 3 * C - 1
    else:
        window = 128 if kind == "window" else None
        C = 640 if kind == "window" else 512
        lo, hi = {"ragged": (0, C - T), "served": (128, 160),
                  "window": (0, 3 * C - 1)}[kind]
    cur = torch.randint(lo, hi + 1, (B,), generator=g, device=CUDA,
                        dtype=torch.int32)
    q = (torch.randn((B, T, H, dh), generator=g, device=CUDA)).to(dtype)
    kc = (torch.randn((B, C, Hkv, dh), generator=g, device=CUDA)).to(dtype)
    vc = (torch.randn((B, C, Hkv, dh), generator=g, device=CUDA)).to(dtype)

    def kernel():
        return decode_attention_cached(q, kc, vc, cur, window=window)

    def plain():
        return decode_attention_cached_plain(q, kc, vc, cur, window=window)
    mask = cached_mask(cur, T, C, window)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
    ker, ref = kernel(), plain()
    err = max_err(ker, ref)
    ok = err <= bf16_abs if bf16_abs is not None and \
        dtype == torch.bfloat16 else close(ker, ref, dtype)
    exact = {}
    if dtype == torch.bfloat16:
        ref32 = decode_attention_cached_plain(q.float(), kc.float(),
                                              vc.float(), cur, window=window)
        atol, rtol = EXACT_BF16
        exact = dict(exact_max_abs_err=max_err(ker, ref32),
                     exact_ok=bool(torch.allclose(ker.float(), ref32,
                                                  atol=atol, rtol=rtol)))
        ok = ok and exact["exact_ok"]
    # each live slot (seen by any query of its row) read once per KV
    # head; q read and out written once; QK and PV: 4 dh per (query
    # head, live pair)
    live = int(mask.any(1).sum())
    nbytes = 2 * q.numel() * sz + 2 * live * Hkv * dh * sz + B * 4
    bms, by = bound_ms(nbytes, 4.0 * int(mask.sum()) * H * dh, dtype)
    n_kern, kern_us = cuda_kernels_of(kernel)
    case = dict(
        dtype=str(dtype).replace("torch.", ""), model=label,
        case=f"{'verify' if T > 1 else 'decode'} {kind}",
        lengths=f"cur_len {lo}-{hi}",
        shape=f"B={B} T={T} C={C} H={H} Hkv={Hkv} dh={dh} "
              f"window={window} live={live}",
        max_abs_err=err, ok=ok,
        tol=bf16_abs if bf16_abs is not None and dtype == torch.bfloat16
        else TOL[dtype], **exact,
        ref_max_abs=float(ref.float().abs().max()),
        ref_rms=float(ref.float().square().mean().sqrt()),
        library_max_abs_err=max_err(sdpa().transpose(1, 2), ref),
        kernels_per_call=n_kern, kernel_device_us=kern_us,
        ms=time_ms(kernel), plain_ms=time_ms(plain), bound_ms=bms,
        bound_by=by, library_ms=time_ms(sdpa))
    case["ms_over_sdpa"] = case["ms"] / case["library_ms"]
    log(f"decode_attention {label} T={T} {kind} {dtype}: max abs err "
        f"{err:.3g} (limit {case['tol']}; ref rms {case['ref_rms']:.3g}, "
        f"max {case['ref_max_abs']:.3g}; vs f32 math "
        f"{case.get('exact_max_abs_err')}), {case['ms']:.4f} ms, "
        f"SDPA {case['library_ms']:.4f} ms, kernel / SDPA = "
        f"{case['ms_over_sdpa']:.3f} (bound {bms:.4f}), {n_kern} CUDA "
        f"kernels per call")
    return case


def moe_case(xt, wg, w1, w3, w2, mcfg, pol, dtype, label=ARCH):
    """moe_ffn against its plain version on one decode step's tokens xt
    routed under policy pol, timed beside its bound."""
    from repro_torch.kernels import moe_ffn, moe_ffn_plain
    from repro_torch.models.moe import policy_max_active, route

    sz = torch.finfo(dtype).bits // 8
    (T, d), (E, _, f) = xt.shape, w1.shape
    _, _, combine, _ = route({"wg": wg}, xt, mcfg, pol)
    active = (combine != 0).any(0)
    ma = policy_max_active(pol, T, E)
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
    n_kern, kern_us = cuda_kernels_of(lambda: moe_ffn(*margs, max_active=ma))
    case = dict(
        dtype=str(dtype).replace("torch.", ""), model=label,
        policy=pol.mode,
        shape=f"T={T} d={d} f={f} E={E} active={n_act} max_active={ma}",
        active=n_act, max_active=ma, kernels_per_call=n_kern,
        kernel_device_us=kern_us,
        max_abs_err=max_err(ker, ref), ok=close(ker, ref, dtype),
        ref_max_abs=float(ref.float().abs().max()),
        ms=time_ms(lambda: moe_ffn(*margs, max_active=ma)),
        plain_ms=time_ms(lambda: moe_ffn_plain(*margs)),
        bound_ms=bms, bound_by=by, library_ms=None)
    log(f"moe_ffn {label} {dtype} policy={pol.mode}: active={n_act} "
        f"max_active={ma}, {case['ms']:.4f} ms (bound {bms:.4f}), "
        f"{n_kern} CUDA kernels per call: {kern_us}")
    return case


def grouped_case(label, x, wg, w1, w3, w2, E, k, dtype, sz):
    """grouped_ffn against its plain version on the sorted dispatch of x
    (top-k of E experts), timed beside its bound and, in bf16, the
    torch._grouped_mm yardstick."""
    from repro_torch.core.routing import topk_route
    from repro_torch.kernels import grouped_ffn, grouped_ffn_plain
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens

    d, f = w1.shape[1], w1.shape[2]
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
    n_kern, kern_us = cuda_kernels_of(
        lambda: grouped_ffn(*args, block_t=plan.block_t))
    case = dict(
        dtype=str(dtype).replace("torch.", ""), case=label,
        shape=f"P={xs.shape[0]} d={d} f={f} E={E} "
              f"block_t={plan.block_t} rows={n_rows}",
        max_abs_err=max_err(ker, ref), ok=close(ker, ref, dtype),
        ref_max_abs=float(ref.float().abs().max()),
        kernels_per_call=n_kern, kernel_device_us=kern_us,
        ms=time_ms(lambda: grouped_ffn(*args, block_t=plan.block_t)),
        plain_ms=time_ms(lambda: grouped_ffn_plain(
            *args, block_t=plan.block_t), iters=5),
        bound_ms=bms, bound_by=by, library_ms=None)
    case["tflops"] = 6.0 * n_rows * d * f / case["ms"] / 1e9
    if dtype == torch.bfloat16:
        case.update(grouped_mm_yardstick(plan, *args[:4]))
    log(f"grouped_ffn {label} {dtype}: {case['ms']:.4f} ms (bound "
        f"{bms:.4f}), {case['tflops']:.1f} TFLOP/s on the real rows, "
        f"{n_kern} CUDA kernels per call: {kern_us}; torch._grouped_mm "
        f"yardstick (several calls): {case.get('grouped_mm_ms')}")
    return case


def check_moe_cases(cases):
    """moe_ffn's design goals: at most 3 CUDA kernels per call, and in
    bf16 a batch / off time ratio within 0.2 of the active-expert ratio
    (time follows the selected set)."""
    for c in cases:
        if not 1 <= c["kernels_per_call"] <= 3:
            fail(f"moe_ffn {c['model']} {c['dtype']} {c['policy']}: one "
                 f"call ran {c['kernels_per_call']} CUDA kernels, want 1..3")
        if c["dtype"] == "bfloat16" and "time_ratio_batch_off" in c and \
                c["time_ratio_batch_off"] > c["active_ratio_batch_off"] + 0.2:
            fail(f"moe_ffn: time ratio {c['time_ratio_batch_off']:.3f} "
                 f"exceeds the active ratio "
                 f"{c['active_ratio_batch_off']:.3f} by more than 0.2")


def grouped_mm_yardstick(plan, xs, w1, w3, w2):
    """grouped_ffn's two products through torch._grouped_mm on the same
    padded rows (each expert's segment, padded to block_t, as one group),
    with silu·g between them: several calls, a yardstick of speed only,
    used nowhere in the port and kept out of the library column."""
    if not hasattr(torch, "_grouped_mm"):
        return dict(grouped_mm_ms=None, grouped_mm_note="no torch._grouped_mm")
    bt = plan.block_t
    offs = torch.cumsum((plan.counts + bt - 1) // bt * bt, 0,
                        dtype=torch.int32)

    def run():
        h = torch.nn.functional.silu(torch._grouped_mm(xs, w1, offs=offs)) \
            * torch._grouped_mm(xs, w3, offs=offs)
        return torch._grouped_mm(h, w2, offs=offs)
    from repro_torch.kernels import grouped_ffn_plain
    try:
        rows = int(offs[-1])
        ref = grouped_ffn_plain(xs, w1, w3, w2, plan.tile_eid,
                                plan.tile_valid, block_t=bt)
        return dict(grouped_mm_ms=time_ms(run),
                    grouped_mm_max_abs_err=max_err(run()[:rows], ref[:rows]),
                    grouped_mm_note="3 torch._grouped_mm calls + silu, mul")
    except (RuntimeError, TypeError) as e:   # not built for this card
        return dict(grouped_mm_ms=None, grouped_mm_note=str(e)[:200])


def check_kernel_counts(cases):
    """decode_attention's and grouped_ffn's design: at most 2 CUDA
    kernels per call (split + merge; up + down)."""
    for name in ("decode_attention", "grouped_ffn"):
        for c in cases[name]:
            if not 1 <= c["kernels_per_call"] <= 2:
                fail(f"{name} {c['dtype']} {c.get('model', '')}: one call "
                     f"ran {c['kernels_per_call']} CUDA kernels, want 1..2: "
                     f"{c['kernel_device_us']}")


def ssd_work(B, S, nh, hd, g, ds, l, sz, init):
    """(bytes, operations) of one SSD scan: each input read once and each
    output written once; per (row, head) and chunk of n positions, the
    causal half of C·Bᵀ and of the masked scores times x (n(n+1)/2 pairs,
    2·ds + 2·hd operations each) and the chunk's own state (2·n·hd·ds),
    and where a state enters the chunk, its term (2·n·hd·ds) and its
    carry (2·hd·ds)."""
    nbytes = (2 * B * S * nh * hd * sz + 2 * B * S * g * ds * sz
              + B * S * nh * 4 + nh * 4
              + B * nh * hd * ds * 4 * (2 if init else 1))
    flops = 0
    for c, t0 in enumerate(range(0, S, l)):
        n = min(l, S - t0)
        flops += n * (n + 1) // 2 * 2 * (ds + hd) + 2 * n * hd * ds
        if c > 0 or init:
            flops += 2 * n * hd * ds + 2 * hd * ds
    return nbytes, float(flops * B * nh)


def ssd_cases(archs):
    """ssd_scan against ssd_scan_plain at the SSM main paths' prefill
    shapes (8 requests x 500 tokens, one group), f32 and bf16, from a
    nonzero initial state in f32, and with dt ~ 0.01 in f32 and bf16
    (bf16 also from a nonzero initial state); each case prints its
    achieved TFLOP/s (ssd_work's operations over its time).
    dt = softplus(randn + shift): shift 0 gives dt ~ 0.8, so a chunk
    decays by exp(-100) or less and almost nothing is carried to the
    next one; shift -5 gives dt in real Mamba2's range, where a chunk
    decays by ~0.06 (256 positions) or ~0.25 (128) and the carried state
    dominates the later chunks (each case records its mean decay)."""
    from repro_torch.kernels import ssd_scan, ssd_scan_plain
    from repro_torch.models.ssm import dims

    g = torch.Generator(device=CUDA)
    g.manual_seed(4321)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=CUDA)
                ).to(dtype)

    out = []
    for name in SSM_ARCHS:
        s = archs[name].ssm
        _, nh, _ = dims(s, archs[name].d_model)
        B, S, hd, grp, ds = 8, 500, s.head_dim, s.n_groups, s.d_state
        l = min(s.chunk_size, S)
        for dtype, init, shift in ((torch.float32, False, 0.0),
                                   (torch.bfloat16, False, 0.0),
                                   (torch.float32, True, 0.0),
                                   (torch.float32, False, -5.0),
                                   (torch.bfloat16, False, -5.0),
                                   (torch.bfloat16, True, -5.0)):
            sz = torch.finfo(dtype).bits // 8
            x = randn(B, S, nh, hd, scale=0.5, dtype=dtype)
            dt = torch.nn.functional.softplus(randn(B, S, nh) + shift)
            A = -torch.exp(randn(nh, scale=0.3))
            Bm = randn(B, S, grp, ds, scale=0.3, dtype=dtype)
            Cm = randn(B, S, grp, ds, scale=0.3, dtype=dtype)
            st0 = randn(B, nh, hd, ds, scale=0.2) if init else None
            args = (x, dt, A, Bm, Cm)
            kw = dict(chunk=s.chunk_size, init_state=st0)
            y, st = ssd_scan(*args, **kw)
            yr, sr = ssd_scan_plain(*args, **kw)
            if not (torch.isfinite(y.float()).all()
                    and torch.isfinite(st).all()):
                fail(f"ssd_scan {name}: non-finite output")
            nbytes, flops = ssd_work(B, S, nh, hd, grp, ds, l, sz, init)
            bms, by = bound_ms(nbytes, flops, dtype)
            ms = time_ms(lambda: ssd_scan(*args, **kw))
            _, pass_us = cuda_kernels_of(lambda: ssd_scan(*args, **kw))
            log(f"ssd_scan {name} {dtype} init={init} dt_shift={shift}: "
                f"{ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s achieved; "
                f"device us by pass {pass_us}")
            out.append(dict(
                dtype=str(dtype).replace("torch.", ""), model=name,
                init_state=init, dt_shift=shift,
                dt_mean=float(dt.mean()),
                chunk_decay_mean=float(torch.exp(
                    (dt[:, :l] * A).sum(1)).mean()),
                shape=f"B={B} S={S} nh={nh} hd={hd} g={grp} ds={ds} "
                      f"chunk={l}",
                max_abs_err=max(max_err(y, yr), max_err(st, sr)),
                max_abs_err_y=max_err(y, yr), max_abs_err_state=max_err(st, sr),
                ok=close(y, yr, dtype, SCAN_TOL)
                and close(st, sr, torch.float32, SCAN_TOL),
                ref_max_abs=float(yr.float().abs().max()),
                ms=ms, tflops=flops / ms / 1e9, pass_device_us=pass_us,
                plain_ms=time_ms(lambda: ssd_scan_plain(*args, **kw),
                                 iters=5),
                bound_ms=bms, bound_by=by, library_ms=None,
                bytes=nbytes, flops=flops))
            del x, Bm, Cm, y, yr
    return out


# ------------------------------------------------------ parity phase ---

def path_parity(cfg, prompt_len: int, cache_len: int):
    """Same seeded weights, f32, 2 layers: CPU (plain versions) vs GPU
    (kernels)."""
    from repro_torch.bridge import init_params
    from repro_torch.models.model import decode_step, params_to, prefill
    from repro_torch.serving.sampler import greedy

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = init_params(cfg2, seed=0, dtype=torch.float32, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, prompt_len)).astype(np.int32)
    runs = []
    for dev in ("cpu", CUDA):
        p = params_to(params, dev)
        lg, cache, _ = prefill(cfg2, p, torch.as_tensor(prompts, device=dev),
                               cache_len=cache_len, capacity_factor=8.0)
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
    if not torch.isfinite(lg_[..., :cfg.vocab_size]).all():
        fail(f"parity {cfg.name}: non-finite logits on the GPU")
    err = max_err(lc, lg_)
    same = bool((tc == tg).all())
    log(f"parity {cfg.name}: 2 layers f32, prefill 4x{prompt_len} + 8 "
        f"decode steps: tokens equal={same}, max |logit diff|={err:.3e} "
        f"(tol {PARITY_LOGIT_TOL})")
    if not same or err > PARITY_LOGIT_TOL:
        fail(f"parity {cfg.name}: CPU and GPU disagree")
    return dict(tokens_equal=same, max_abs_logit_diff=err)


def perturbed(params, scale: float = 0.05, seed: int = 7):
    """The parameters plus scale * N(0, 1) noise drawn on their device
    from a seed: a draft that the target rejects now and then (random
    weights make every untrained draft echo the target's last token)."""
    g = None

    def walk(tree):
        nonlocal g
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            if g is None:
                g = torch.Generator(device=v.device)
                g.manual_seed(seed)
            out[k] = v + scale * torch.randn(v.shape, generator=g,
                                             device=v.device, dtype=v.dtype)
        return out
    return walk(params)


def check_rejects(name: str, stats):
    """A perturbed draft's run must have rejected a draft token, so the
    rollback over dead verify KV ran."""
    for st in stats:
        if not 0 < st.drafted or st.acceptance_rate >= 1.0:
            fail(f"{name}: perturbed draft accepted {st.accepted} of "
                 f"{st.drafted}; the run needs a rejection")


def spec_parity(cfg, prompt_len: int, cache_len: int):
    """Speculative decoding at 2 layers in f32 (spec_len 3, 16 new
    tokens) with the self-draft and with the target's params plus
    0.05 N(0, 1), on the CPU (plain versions) and on the card (kernels):
    the continuous (SpecScheduler) and lockstep tokens equal plain greedy
    decoding on each device, the two devices agree, and the perturbed
    draft is rejected at least once on each."""
    from repro_torch.bridge import init_params
    from repro_torch.models.model import params_to
    from repro_torch.serving import Engine

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = init_params(cfg2, seed=0, dtype=torch.float32, device="cpu")
    drafts = {"self": params, "perturbed": perturbed(params)}
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, prompt_len)).astype(np.int32)
    toks, res = {}, {}
    for dev in ("cpu", CUDA):
        p = params_to(params, dev)
        plain, _ = Engine(cfg2, p, cache_len=cache_len,
                          device=dev).generate(prompts, 16)
        for dname, dp in drafts.items():
            eng = Engine(cfg2, p, cache_len=cache_len,
                         draft=(cfg2, params_to(dp, dev)), spec_len=3,
                         device=dev)
            cont, st = eng.generate(prompts, 16)
            lock, lst = eng.generate(prompts, 16, lockstep=True)
            if not (np.array_equal(cont, plain)
                    and np.array_equal(lock, plain)):
                fail(f"spec parity {cfg.name} on {dev}, {dname} draft: "
                     f"spec tokens != plain")
            if dname == "perturbed":
                check_rejects(f"spec parity {cfg.name} on {dev}", (st, lst))
            toks[str(dev), dname] = cont
            res[f"{dev} {dname} acceptance"] = [st.acceptance_rate,
                                                lst.acceptance_rate]
    same = all(np.array_equal(toks["cpu", n], toks[str(CUDA), n])
               for n in drafts)
    log(f"spec parity {cfg.name}: 2 layers f32, 4x{prompt_len}, 16 new, "
        f"spec_len 3, self and perturbed drafts: continuous == lockstep "
        f"== plain on CPU and GPU, CPU == GPU {same}; acceptance "
        f"(continuous, lockstep) {json.dumps(res)}")
    if not same:
        fail(f"spec parity {cfg.name}: CPU and GPU spec tokens disagree")
    return dict(tokens_equal=same, **res)


def spec_lossless(cfg, *, prompt_len=128, new=16, cache_len=512,
                  spec_len=4):
    """Speculative decoding is lossless at full width (f32, all layers,
    policy off), with the self-draft and with the target's params plus
    0.05 N(0, 1) (which must be rejected at least once, so rows roll back
    over dead verify KV): Engine.generate continuous and lockstep, and a
    SpecScheduler serving 4 speculative and 4 plain requests in one batch
    of 8 slots (rows advancing by 1 and by up to spec_len + 1 side by
    side), each give the plain greedy tokens."""
    from repro_torch.bridge import init_params
    from repro_torch.serving import Engine

    params = init_params(cfg, seed=0, dtype=torch.float32, device=CUDA)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(8, prompt_len)).astype(np.int32)
    plain, _ = Engine(cfg, params, cache_len=cache_len,
                      device=CUDA).generate(prompts, new)
    out = {}
    for dname in ("self", "perturbed"):
        dp = params if dname == "self" else perturbed(params)
        eng = Engine(cfg, params, cache_len=cache_len, draft=(cfg, dp),
                     spec_len=spec_len, device=CUDA)
        cont, st = eng.generate(prompts, new)
        lock, lst = eng.generate(prompts, new, lockstep=True)
        sched = eng.make_scheduler(num_slots=8, invariants=True)
        sts = [sched.submit(prompts[b], new, spec=b % 2 == 0)
               for b in range(8)]
        sched.run()
        mixed = np.stack([np.asarray(s.tokens) for s in sts])
        res = dict(continuous_equal=bool(np.array_equal(cont, plain)),
                   lockstep_equal=bool(np.array_equal(lock, plain)),
                   mixed_equal=bool(np.array_equal(mixed, plain)),
                   acceptance_rate=st.acceptance_rate,
                   mean_accepted=st.mean_accepted, rounds=st.steps,
                   lockstep_acceptance_rate=lst.acceptance_rate,
                   lockstep_mean_accepted=lst.mean_accepted,
                   mixed_acceptance_rate=sched.acceptance_rate,
                   mixed_drafted=[s.drafted for s in sts])
        name = f"spec lossless {cfg.name} {dname} draft"
        log(f"{name} ({cfg.num_layers} layers, f32, 8x{prompt_len}, {new} "
            f"new, spec_len {spec_len}): {json.dumps(res)}")
        if not (res["continuous_equal"] and res["lockstep_equal"]
                and res["mixed_equal"]):
            fail(f"{name}: speculative tokens != plain greedy")
        if any(s.drafted for s in sts[1::2]) or not all(s.drafted
                                                       for s in sts[::2]):
            fail(f"{name}: plain requests drafted or spec ones did not")
        if dname == "perturbed":
            check_rejects(name, (st, lst))
            if sched.acceptance_rate >= 1.0:
                fail(f"{name}: the mixed batch rejected no draft token")
        out[dname] = res
        del dp, eng, sched
    return out


def draft_config(cfg):
    """The serve CLI's draft (2 layers, d_model 128) with the target's
    vocabulary."""
    return cfg.reduced(num_layers=2, max_d_model=128,
                       max_vocab=cfg.vocab_size)


def small_draft(cfg, dtype):
    """draft_config(cfg) with random weights from seed 1."""
    from repro_torch.bridge import init_params
    dcfg = draft_config(cfg)
    return dcfg, init_params(dcfg, seed=1, dtype=dtype, device=CUDA)


def spec_expect(cfg, dcfg, rounds: int, spec_len: int):
    """Exact launches of a continuous spec run of 8 requests admitted
    together: one target and one draft prefill (grouped_ffn once per MoE
    layer), then per round spec_len + 1 draft decode steps (8 tokens:
    moe_ffn, decode_attention once per draft layer) and one verify pass
    (8 x (1 + spec_len) tokens: decode_attention, and grouped_ffn above
    32 tokens, moe_ffn at or below, once per target layer)."""
    L, Ld = cfg.num_layers, dcfg.num_layers
    sorted_verify = 8 * (1 + spec_len) > 32
    return {"grouped_ffn": L + Ld + (rounds * L if sorted_verify else 0),
            "moe_ffn": rounds * ((spec_len + 1) * Ld
                                 + (0 if sorted_verify else L)),
            "decode_attention": rounds * ((spec_len + 1) * Ld + L),
            "ssd_scan": 0}


def spec_served(cfg, params, prompts, plain_tokens, *, new=32,
                cache_len=512, spec_len=4, rounds=4):
    """The served spec path in bf16 at full width: Engine.generate with
    the self-draft and the small draft, policy off and Algorithm 4
    (XSharePolicy(mode="spec", k0=1, m_l=2, m_r=1, corr=1.0)). Launch
    counters set to 0 just before each continuous run and read just
    after; the counts must be exactly spec_expect's for the rounds the
    run reports."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.moe import OFF
    from repro_torch.serving import Engine

    drafts = {"self": (cfg, params), "small": small_draft(cfg, torch.bfloat16)}
    out = {}
    for dname, draft in drafts.items():
        for pol in (OFF, XSharePolicy(mode="spec", k0=1, m_l=2, m_r=1,
                                      corr=1.0)):
            eng = Engine(cfg, params, policy=pol, cache_len=cache_len,
                         draft=draft, spec_len=spec_len, spec_rounds=rounds,
                         device=CUDA)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            toks, st = eng.generate(prompts, new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
            want = spec_expect(cfg, draft[0], st.steps, spec_len)
            name = f"{dname} draft, policy {pol.mode}"
            if counts != want:
                fail(f"spec served {name}: launches {counts}, expected "
                     f"{want} for {st.steps} rounds")
            if toks.shape != (8, new) or toks.min() < 0 or \
                    toks.max() >= cfg.vocab_size:
                fail(f"spec served {name}: bad tokens")
            res = dict(tokens_per_s=8 * new / wall, wall_s=wall,
                       rounds=st.steps, launches=counts,
                       acceptance_rate=st.acceptance_rate,
                       mean_accepted=st.mean_accepted,
                       activated_experts=st.mean_aux("activated_experts"),
                       selected_set=st.mean_aux("selected_set"),
                       equal_to_plain_bf16=float(
                           (toks == plain_tokens).mean()))
            out[name] = res
            log(f"spec served {cfg.name} {name}: {json.dumps(res)}")
    return out


def spec_profile(cfg, params, prompts, *, cache_len=512, spec_len=4,
                 rounds=4):
    """torch.profiler (CUDA activity only, so the host is slowed little)
    over one spec dispatch (4 rounds, small draft, policy off) after one
    prefill of both models, run eagerly (spec_steps_fused as it is) and
    replayed from a captured graph (the serving path on the card): host
    wall and device busy time per round, kernels per round and each port
    kernel's device ms per round and per call. The replay's unprofiled
    wall is the median of 5."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.models.model import prefill
    from repro_torch.serving.sampler import greedy
    from repro_torch.serving.step import NO_FAULT

    dcfg, dparams = small_draft(cfg, torch.bfloat16)
    toks = torch.as_tensor(prompts, device=CUDA)
    B = toks.shape[0]
    ops = spec_ops(B, cfg.moe.num_experts, spec_len)
    lg, cache0, _ = prefill(cfg, params, toks, cache_len=cache_len,
                            capacity_factor=8.0)
    _, dcache0, _ = prefill(dcfg, dparams, toks, cache_len=cache_len,
                            capacity_factor=8.0)
    tok0 = greedy(lg)
    loop, fused = spec_graph(cfg, params, dcfg, dparams, tok0.clone(),
                             clone_tree(cache0), clone_tree(dcache0),
                             spec_len=spec_len, rounds=rounds)
    state = loop.tensors

    def from_prefill():
        state["tok"].copy_(tok0)
        for key, src in (("cache", cache0), ("dcache", dcache0)):
            for k, v in src.items():
                state[key][k].copy_(v)

    def dispatch(name):
        from_prefill()
        if name == "replay":
            return lambda: loop(**ops, fault=NO_FAULT)
        t = state
        return lambda: fused(params, dparams, t["tok"], t["cache"],
                             t["dcache"], *(torch.as_tensor(ops[n],
                                                            device=CUDA)
                                            for n in SPEC_OPS), NO_FAULT)

    out = {}
    for name in ("eager", "replay"):
        walls = []
        for _ in range(5 if name == "replay" else 0):
            go = dispatch(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        go = dispatch(name)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / rounds
        launches = K.launch_counts()
        t0 = time.perf_counter()
        kern = cuda_kernels(prof)
        post_s = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in kern) / 1e3 / rounds
        ours = port_kernels_ms(kern, rounds)
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        wall = float(np.median(walls)) * 1e3 / rounds if walls else prof_ms
        res = dict(profiled_wall_ms_per_round=prof_ms,
                   wall_ms_per_round=wall,
                   profiler_postprocess_s=post_s,
                   device_busy_ms_per_round=busy if kern else "not measured",
                   device_idle_share=max(0.0, 1 - busy / wall) if kern
                   else "not measured",
                   device_idle_share_profiled=(1 - busy / prof_ms) if kern
                   else "not measured",
                   kernels_per_round=sum(e.count for e in kern) / rounds
                   if kern else "not measured",
                   top=[dict(name=e.key[:60],
                             ms=e.self_device_time_total / 1e3 / rounds,
                             calls=e.count / rounds) for e in top],
                   port_kernels_ms_per_round=ours,
                   port_kernel_ms_per_call=per_call_ms(ours, launches,
                                                       rounds),
                   port_call_span_ms=call_spans_ms(prof) if kern
                   else "not measured",
                   launches_per_round={k: v / rounds
                                       for k, v in launches.items()})
        if name == "replay":
            res["capture_s"] = loop.capture_s
        out[name] = res
        log(f"profile {cfg.name} spec dispatch {name} (small draft, "
            f"spec_len {spec_len}, {rounds} rounds): {json.dumps(res)}")
    return out


# ------------------------------------------------- bf16 model check ---

def bf16_model_check(cfg, params, prompts, *, cache_len: int, module,
                     attr: str, plain):
    """One kernel's bf16 rounding seen past every layer: prefill logits
    of the full model at its main-path shape, with the kernel and with
    its plain version in its place (``module.attr`` swapped for
    ``plain``; same bf16 weights), each against the same weights in f32
    through the plain version. The kernel must stay as close to the f32
    logits as the bf16 path's own rounding allows: its max |logit error|
    at most twice the plain bf16 path's. mamba2: ssd_scan rounds the
    decay-masked scores and the state to bf16 for its products;
    granite-moe: grouped_ffn rounds H to bf16 between its products."""
    from repro_torch.models.model import prefill

    toks = torch.as_tensor(prompts, device=CUDA)

    def logits(p):
        lg, _, _ = prefill(cfg, p, toks, cache_len=cache_len,
                           capacity_factor=8.0)
        return lg[:, :cfg.vocab_size].float()

    def to_f32(p):
        return {k: to_f32(v) if isinstance(v, dict) else v.float()
                for k, v in p.items()}

    kernel = logits(params)
    kernel_fn = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        plain_lg = logits(params)
        ref = logits(to_f32(params))
    finally:
        setattr(module, attr, kernel_fn)
    if not torch.isfinite(kernel).all():
        fail(f"bf16 check {cfg.name}: non-finite kernel logits")
    err_k, err_p = max_err(kernel, ref), max_err(plain_lg, ref)
    res = dict(kernel=attr, max_abs_err_kernel=err_k,
               max_abs_err_plain=err_p, ratio=err_k / err_p,
               max_abs_kernel_vs_plain=max_err(kernel, plain_lg),
               ref_max_abs=float(ref.abs().max()),
               argmax_equal_kernel=int((kernel.argmax(-1)
                                        == ref.argmax(-1)).sum()),
               argmax_equal_plain=int((plain_lg.argmax(-1)
                                       == ref.argmax(-1)).sum()),
               rows=int(ref.shape[0]))
    log(f"bf16 check {cfg.name}: {json.dumps(res)}")
    if err_k > 2 * err_p:
        fail(f"bf16 check {cfg.name}: {attr} kernel logit error "
             f"{err_k:.3e} > 2 x the plain bf16 path's {err_p:.3e}")
    return res


# --------------------------------------------------------- main path ---

def main_path(cfg, *, kernels, prompt_len: int, new: int, cache_len: int,
              policies, expect=None, requests: int = 8):
    """Engine.generate, continuous batching, ``requests`` requests, under
    each policy. The launch counters are set to 0 just before each policy's
    continuous run and read just after it; the lockstep run and the
    prefill check lie outside that window. Every kernel in ``kernels``
    must have launched; ``expect(engine)`` gives exact counts to hold."""
    from repro_torch import kernels as K
    from repro_torch.bridge import init_params, param_count
    from repro_torch.models.model import prefill
    from repro_torch.serving import Engine

    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CUDA)
    log(f"main path: {cfg.name} {cfg.num_layers} layers, "
        f"{param_count(params) / 1e9:.3f} B parameters, bf16")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(requests, prompt_len)).astype(np.int32)
    results, tokens = {}, {}
    for pol in policies:
        eng = Engine(cfg, params, policy=pol, cache_len=cache_len,
                     device=CUDA)
        lock, _ = eng.generate(prompts, new, lockstep=True)
        runs = []
        for temp in ("cold", "warm"):   # cold: the loops' capture included
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            cont, st = eng.generate(prompts, new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
            runs.append((cont, st, wall, counts))
            log(f"main path {cfg.name} policy={pol.mode} {temp} launches: "
                f"{counts}")
            missing = [n for n in kernels if counts[n] <= 0]
            if missing:
                fail(f"main path {cfg.name} ({pol.mode}) never launched "
                     f"{missing}")
            wrong = {n: (counts[n], want)
                     for n, want in (expect(eng) if expect else {}).items()
                     if counts[n] != want}
            if wrong:
                fail(f"main path {cfg.name} ({pol.mode}): launches "
                     f"(counted, expected) {wrong}")
            if cont.shape != (requests, new) or \
                    not np.array_equal(cont, lock):
                fail(f"main path {cfg.name} ({pol.mode}, {temp}): "
                     f"continuous (replayed graphs) != lockstep (eager)")
        (cont, st, wall, counts), (_, wst, wall_warm, wcounts) = runs
        if wcounts != counts or wst.capture_s != 0.0:
            fail(f"main path {cfg.name} ({pol.mode}): the warm run "
                 f"launched {wcounts} (cold {counts}) or captured again "
                 f"({wst.capture_s} s)")
        if cont.min() < 0 or cont.max() >= cfg.vocab_size:
            fail(f"main path {cfg.name} ({pol.mode}): token out of "
                 f"vocabulary")
        with torch.no_grad():
            lg, _, _ = prefill(cfg, eng.params,
                               torch.as_tensor(prompts, device=CUDA),
                               cache_len=cache_len, capacity_factor=8.0)
        if lg.shape != (requests, cfg.padded_vocab) or \
                not torch.isfinite(lg[:, :cfg.vocab_size]).all():
            fail(f"main path {cfg.name} ({pol.mode}): bad prefill logits")
        res = dict(tokens_per_s=requests * new / wall, wall_s=wall,
                   tokens_per_s_warm=requests * new / wall_warm,
                   wall_s_warm=wall_warm, capture_s=st.capture_s,
                   launches=counts, prompt_len=prompt_len, new_tokens=new,
                   requests=requests)
        msg = ""
        if cfg.moe is not None:
            res.update(activated_experts=st.mean_aux("activated_experts"),
                       selected_set=st.mean_aux("selected_set"))
            msg = (f", activated experts per layer "
                   f"{res['activated_experts']:.2f}")
        results[pol.mode] = res
        tokens[pol.mode] = cont
        log(f"main path {cfg.name} policy={pol.mode}: continuous == "
            f"lockstep, {requests * new} tokens in {wall:.3f} s = "
            f"{requests * new / wall:.1f} tokens/s cold (capture "
            f"{st.capture_s:.3f} s), {wall_warm:.3f} s = "
            f"{requests * new / wall_warm:.1f} tokens/s warm{msg}")
    return results, eng.params, prompts, tokens


def ssm_expect(cfg, new: int):
    """Exact launches of an SSM / hybrid continuous run: one prefill of
    all 8 requests (ssd_scan once per layer), then decode rounds of
    decode_chunk steps until the last of the new-1 tokens after the
    first (decode_attention once per shared-block application)."""
    from repro_torch.models.model import _num_shared_apps

    def expect(eng):
        rounds = -(-(new - 1) // eng.decode_chunk) * eng.decode_chunk
        return {"ssd_scan": cfg.num_layers, "grouped_ffn": 0, "moe_ffn": 0,
                "decode_attention": _num_shared_apps(cfg) * rounds}
    return expect


def dense_expect(cfg, new: int):
    """Exact launches of a dense continuous run: decode_attention once
    per layer per decode step (decode_chunk steps a round, until the
    last of the new-1 tokens after the first); nothing else."""
    def expect(eng):
        steps = -(-(new - 1) // eng.decode_chunk) * eng.decode_chunk
        return {"ssd_scan": 0, "grouped_ffn": 0, "moe_ffn": 0,
                "decode_attention": cfg.num_layers * steps}
    return expect


# --------------------------------------------------- durability phase ---

def submit_all(door, prompts, new: int):
    """Submit every prompt, then start the door: one admission group, so
    the prefill has Engine.generate's shape and its bits."""
    streams = [door.submit(p, new) for p in prompts]
    door.start()
    return streams


def submit_staggered(door, prompts, new: int, late: int):
    """Submit all but the last ``late`` prompts, start the door, then each
    of the last ones alone once the request before it has its first
    token: each is spliced into the running batch (insert_request), where
    a campaign's insert_fail lands."""
    streams = [door.submit(p, new) for p in prompts[:-late]]
    door.start()
    for p in prompts[-late:]:
        while not streams[-1].tokens and not streams[-1].done:
            time.sleep(0.001)
        streams.append(door.submit(p, new))
    return streams


def stream_tokens(stream):
    return np.asarray([int(t) for t in stream.tokens])


def durable_tokens(jp: str, sp: str) -> int:
    """Tokens the journal and the snapshot hold, as recover() folds them."""
    from repro_torch.serving.journal import (fold_records, load_snapshot,
                                             read_journal)
    table = fold_records(read_journal(jp).records, base=load_snapshot(sp))
    return sum(len(r["tokens"]) for r in table.values())


def recover_timed(eng, jp, sp, n: int, **kw):
    """recover(), then the wall time until the first fresh token (one
    past the replayed prefix of any resumed stream), then drain."""
    from repro_torch.serving import recover
    t0 = time.perf_counter()
    door, report = recover(eng, journal_path=jp, snapshot_path=sp,
                           num_slots=n, **kw)
    resumed = [s for s in door.streams.values() if not s.done]
    first = None
    while first is None and not all(s.done for s in resumed):
        if any(len(s.tokens) > s.replayed for s in resumed):
            first = time.perf_counter() - t0
        else:
            time.sleep(0.001)
    door.drain(timeout=600.0)
    if first is None:
        first = time.perf_counter() - t0
    return door, report, first


def check_recovered(name, door, report, want, jp, n, *, quarantine=False):
    """Nothing lost, fidelity 1.0, the journal whole with a finish per
    rid; each stream equal to ``want`` (or, under quarantine, shed as
    numerics_nonfinite with a prefix of it)."""
    from repro_torch.serving import read_journal
    if door.crashed is not None:
        fail(f"{name}: the recovered incarnation crashed: {door.crashed!r}")
    lost = report.requests - report.resumed - report.terminal
    stats = door.replay_stats()
    tail = read_journal(jp)
    finished = {r["rid"] for r in tail.records if r["t"] == "finish"}
    if report.requests != n or lost or stats["fidelity"] != 1.0 \
            or tail.torn or finished != set(range(n)):
        fail(f"{name}: report {report}, replay {stats}, journal torn "
             f"{tail.torn}, finished {sorted(finished)}")
    quarantined = 0
    for b in range(n):
        s, toks = door.streams[b], stream_tokens(door.streams[b])
        if quarantine and s.finish_reason == "numerics_nonfinite":
            quarantined += 1
            ok = np.array_equal(toks, want[b][:len(toks)])
        else:
            ok = s.finish_reason == "completed" and \
                np.array_equal(toks, want[b])
        if not ok:
            fail(f"{name}: stream {b} ({s.finish_reason}) != the "
                 f"uninterrupted run")
    return dict(lost=lost, replay=stats, quarantined=quarantined,
                resumed=report.resumed, terminal=report.terminal,
                snapshot_used=report.snapshot_used,
                torn_tail_at_recovery=report.torn_tail)


def durability_phase(cfg, params, prompts, plain_tokens, *, new=32,
                     cache_len=512, decode_chunk=2):
    """The crash-tolerant front door at full width (bf16, 8 requests in
    8 slots, admitted together): (a) a fault-free run with journal
    and snapshots; (b) a crash entering round 3 with a torn journal
    write, recovered from snapshot + journal tail on the same engine;
    (c) the seeded chaos campaign sample_campaign(10, ...) through the
    door and recover(): its plan holds a NaN on slot 6, an insert
    failure of rid 6 (twice, inside the retry budget), a stall and a
    crash, and all four must be delivered; rids 6 and 7 arrive one at a
    time after the first six are decoding, so rid 6 takes the insert
    path; (d) speculative requests (small draft, spec_len 4) killed
    and recovered. Every stream must equal Engine.generate's continuous
    tokens (quarantined ones a prefix, ending numerics_nonfinite), no
    request is lost, replay fidelity 1.0; the recovered incarnation must
    launch all three kernels and hold no more device memory than (a).
    decode_chunk 2 makes the campaign's 32-step horizon 16 rounds, so
    its crash (round 11) lands inside the run."""
    import gc
    import tempfile

    from repro_torch import kernels as K
    from repro_torch.serving import (Engine, Fault, FaultInjector,
                                     FrontDoor, SimulatedCrash,
                                     sample_campaign)

    n = len(prompts)
    eng = Engine(cfg, params, cache_len=cache_len, decode_chunk=decode_chunk,
                 device=CUDA)
    out, tmp = {}, tempfile.TemporaryDirectory()

    def paths(tag):
        return (str(Path(tmp.name) / f"{tag}.journal"),
                str(Path(tmp.name) / f"{tag}-snap"))

    def door_for(e, tag, faults=None, fsync_every=12):
        # a crash run syncs token records every 12: each round journals
        # 8, so the crash finds some unflushed for its torn write
        jp, sp = paths(tag)
        return FrontDoor(e, num_slots=n, journal_path=jp, snapshot_path=sp,
                         snapshot_every_rounds=2, fsync_every=fsync_every,
                         faults=faults)

    def crashed(name, door):
        if not isinstance(door.crashed, SimulatedCrash):
            fail(f"{name}: expected a simulated crash, got "
                 f"{door.crashed!r}")

    with tmp:
        # (a) fault-free
        door = door_for(eng, "a", fsync_every=8)
        t0 = time.perf_counter()
        streams = submit_all(door, prompts, new)
        door.drain(timeout=600.0)
        wall_a = time.perf_counter() - t0
        if door.crashed is not None or not all(
                np.array_equal(stream_tokens(s), plain_tokens[b])
                for b, s in enumerate(streams)):
            fail("durability (a): streams != Engine.generate's tokens")
        gc.collect()    # earlier phases' engines, before the reading
        torch.cuda.synchronize()
        mem_a = torch.cuda.memory_allocated()
        # the drained door handed its running batch (and its captured
        # loop) back to the engine, which lends it to every door below
        states = eng.loops.states()
        cache_bytes = sum(v.numel() * v.element_size()
                          for v in states[0].tensors["cache"].values())
        capture_a = eng.loops.capture_s
        if len(states) != 1 or door._sched._cache is not None:
            fail(f"durability (a): {len(states)} running batches in the "
                 f"engine, or the drained door kept its own")
        out["a"] = dict(tokens_per_s=n * new / wall_a, wall_s=wall_a,
                        snapshots=door.snapshots_written,
                        memory_allocated=mem_a, capture_s=capture_a)
        del door, streams
        gc.collect()

        # (b) kill and recover
        jp, sp = paths("b")
        door = door_for(eng, "b", FaultInjector(
            [Fault("crash_mid_round", step=3),
             Fault("journal_torn_write", nbytes=7)]))
        submit_all(door, prompts, new)
        door.drain(timeout=600.0)
        crashed("durability (b)", door)
        if door._sched._cache is not None:
            fail("durability (b): the dead incarnation kept its cache")
        durable = durable_tokens(jp, sp)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        door2, report, rec_s = recover_timed(eng, jp, sp, n)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        mem_b = torch.cuda.memory_allocated()
        res = check_recovered("durability (b)", door2, report, plain_tokens,
                              jp, n)
        if not report.torn_tail:
            fail("durability (b): the crash left no torn record to skip")
        missing = [k for k in ("grouped_ffn", "moe_ffn", "decode_attention")
                   if counts[k] <= 0]
        if missing:
            fail(f"durability (b): the recovered incarnation never "
                 f"launched {missing}: {counts}")
        if mem_b > mem_a + cache_bytes // 2:
            fail(f"durability (b): {mem_b} bytes allocated after recovery, "
                 f"{mem_a} after (a): a second cache ({cache_bytes}) lives")
        if eng.loops.capture_s != capture_a or len(eng.loops.states()) != 1:
            fail(f"durability (b): the crashed and recovered incarnations "
                 f"captured {eng.loops.capture_s - capture_a} s more, "
                 f"{len(eng.loops.states())} running batches")
        out["b"] = dict(res, recovery_wall_s=rec_s, durable_tokens=durable,
                        launches=counts, memory_allocated=mem_b,
                        memory_over_a=mem_b - mem_a, cache_bytes=cache_bytes)
        del door, door2
        gc.collect()

        # (c) the seeded chaos campaign
        jp, sp = paths("c")
        inj = sample_campaign(10, num_requests=n, num_slots=n,
                              horizon_steps=32, p_crash=1.0)
        plan = [f.kind for f in inj.faults]
        t0 = time.perf_counter()
        door = door_for(eng, "c", inj)
        submit_staggered(door, prompts, new, late=2)
        door.drain(timeout=600.0)
        crashed("durability (c)", door)
        chaos_durable = durable_tokens(jp, sp)
        door2, report, chaos_rec_s = recover_timed(eng, jp, sp, n,
                                                   faults=inj)
        wall_c = time.perf_counter() - t0
        res = check_recovered("durability (c)", door2, report, plain_tokens,
                              jp, n, quarantine=True)
        delivered = sorted({e[0] for e in inj.log})
        survival = (n - res["quarantined"]) / n
        chaos_tokens = sum(len(s.tokens) for s in door2.streams.values())
        out["c"] = dict(res, plan=plan, delivered=delivered,
                        survival_rate=survival, wall_s=wall_c,
                        tokens=chaos_tokens,
                        tokens_per_s=chaos_tokens / wall_c,
                        recovery_wall_s=chaos_rec_s,
                        durable_tokens=chaos_durable)
        undelivered = {"nan_logits", "insert_fail", "stall_decode",
                       "crash_mid_round"} - set(delivered)
        if undelivered or res["quarantined"] < 1:
            fail(f"durability (c): faults {sorted(undelivered)} never "
                 f"fired or nothing was quarantined "
                 f"({res['quarantined']}): {inj.log}")
        del door, door2
        gc.collect()

        # (d) speculative kill and recover (small draft)
        jp, sp = paths("d")
        seng = Engine(cfg, params, cache_len=cache_len,
                      draft=small_draft(cfg, torch.bfloat16), spec_len=4,
                      device=CUDA)
        door = door_for(seng, "d", FaultInjector(
            [Fault("crash_mid_round", step=1),
             Fault("journal_torn_write", nbytes=7)]))
        submit_all(door, prompts, new)
        door.drain(timeout=600.0)
        crashed("durability (d)", door)
        door2, report, spec_rec_s = recover_timed(seng, jp, sp, n)
        res = check_recovered("durability (d)", door2, report, plain_tokens,
                              jp, n)
        if not all(door2.streams[b].spec for b in range(n)):
            fail("durability (d): recovery dropped the spec flag")
        out["d"] = dict(res, recovery_wall_s=spec_rec_s)
        del door, door2, seng
    summary = dict(survival_rate=out["c"]["survival_rate"],
                   chaos_over_fault_free_tokens_per_s=out["c"]["tokens_per_s"]
                   / out["a"]["tokens_per_s"],
                   recovery_wall_s=out["b"]["recovery_wall_s"],
                   durable_tokens_at_crash=out["b"]["durable_tokens"],
                   replayed_tokens=out["b"]["replay"]["replayed_tokens"],
                   lost_requests=out["b"]["lost"] + out["c"]["lost"]
                   + out["d"]["lost"],
                   card=gpu_name_power())
    log(f"durability {cfg.name}: {json.dumps(out)}")
    log(f"durability summary: {json.dumps(summary)}")
    out["summary"] = summary
    return out


# -------------------------------------------------------- graph phase ---

SPEC_OPS = ("remaining", "budget", "draft_len", "spec_on", "priors")
# the port's kernels (csrc/*.cu) by name prefix -> their wrapper
WRAPPER_OF = (("moe_", "moe_ffn"), ("decode_", "decode_attention"),
              ("grouped_", "grouped_ffn"), ("chunk_", "ssd_scan"),
              ("state_pass", "ssd_scan"))


def clone_tree(tree):
    return {k: v.clone() for k, v in tree.items()}


def plain_graph(cfg, params, tok, cache, *, steps: int, policy=None):
    """decode_steps_fused over ``steps`` steps (policy off unless given)
    captured over (tok, cache) as the schedulers capture it
    (serving/graphs.py), and the eager closure it captured."""
    from repro_torch.models.moe import OFF
    from repro_torch.serving.graphs import LoopState
    from repro_torch.serving.step import NO_FAULT, make_fused

    fused = make_fused(cfg, decode_chunk=steps, policy=policy or OFF)
    state = LoopState({"tok": tok, "cache": cache},
                      torch.Generator(device=CUDA))

    def run(t, g, i):
        return fused(params, t["tok"], t["cache"], i["remaining"], g,
                     i["fault"])
    inputs = {"remaining": torch.zeros(tok.shape[0], dtype=torch.int32,
                                       device=CUDA),
              "fault": torch.tensor(NO_FAULT, dtype=torch.int32,
                                    device=CUDA)}
    return state.loop(0, lambda: (run, inputs)), fused


def spec_ops(B: int, E: int, spec_len: int):
    """Per-slot operands of a speculative dispatch: every slot drafts
    spec_len tokens, nothing runs out."""
    return dict(remaining=np.full(B, 1000, np.int32),
                budget=np.full(B, 2 ** 30, np.int32),
                draft_len=np.full(B, spec_len, np.int32),
                spec_on=np.ones(B, bool),
                priors=np.zeros((B, E), np.float32))


def spec_graph(cfg, params, dcfg, dparams, tok, cache, dcache, *,
               spec_len: int, rounds: int):
    """spec_steps_fused (policy off) captured over (tok, cache, dcache),
    and the eager closure it captured."""
    from repro_torch.serving.graphs import LoopState
    from repro_torch.serving.step import NO_FAULT, make_spec_fused

    fused = make_spec_fused(cfg, dcfg, spec_len=spec_len, num_rounds=rounds)
    state = LoopState({"tok": tok, "cache": cache, "dcache": dcache},
                      torch.Generator(device=CUDA))

    def run(t, g, i):
        return fused(params, dparams, t["tok"], t["cache"], t["dcache"],
                     *(i[n] for n in SPEC_OPS), i["fault"])
    ops = spec_ops(tok.shape[0], cfg.moe.num_experts, spec_len)
    inputs = {n: torch.zeros(ops[n].shape, dtype=torch.as_tensor(
        ops[n]).dtype, device=CUDA) for n in SPEC_OPS}
    inputs["fault"] = torch.tensor(NO_FAULT, dtype=torch.int32, device=CUDA)
    return state.loop(0, lambda: (run, inputs)), fused


def per_call_ms(ours, launches, per: int):
    """Device ms per call of each wrapper, from its kernels' ms per step
    (``port_kernels_ms``) and its launches in ``per`` steps."""
    sums = {}
    for name, ms in ours.items():
        w = next((w for pre, w in WRAPPER_OF if name.startswith(pre)), None)
        if w is not None:
            sums[w] = sums.get(w, 0.0) + ms
    return {w: ms * per / launches[w] for w, ms in sums.items()
            if launches.get(w)}


def _starts_call(name: str) -> bool:
    """The first kernel of a wrapper's call (moe_ffn: up, down, reduce;
    decode_attention: split, merge; grouped_ffn: up, down; ssd_scan:
    chunk state, state pass, chunk scan)."""
    return name.startswith(("moe_up", "decode_split", "chunk_state")) or \
        (name.startswith("grouped_") and "true>" in name)


def call_spans_ms(prof):
    """Device ms of one call of each wrapper inside a profiled run: from
    its first kernel's start to its last kernel's end (a call's kernels
    run back to back, overlapping under PDL, so their durations' sum
    overstates it), the mean over the run's calls; "not measured" when
    the profiler gives no kernel timestamps."""
    from torch.autograd import DeviceType
    try:
        kern = sorted(((e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda k: k[1])
    except AttributeError:
        return "not measured"
    spans, cur = {}, None
    for name, t0, t1 in kern + [("", 0.0, 0.0)]:
        name = name.replace("(anonymous namespace)::", "").removeprefix(
            "void ")
        w = next((w for pre, w in WRAPPER_OF if name.startswith(pre)), None)
        if cur is not None and (w != cur[0] or _starts_call(name)):
            spans.setdefault(cur[0], []).append(cur[2] - cur[1])
            cur = None
        if w is not None:
            cur = (w, t0, t1) if cur is None else (w, cur[1], max(cur[2], t1))
    return {w: float(np.mean(v)) / 1e3 for w, v in spans.items()}


def graph_phase(cfg, params, prompts, *, cache_len=512, steps=8,
                spec_len=4, rounds=4):
    """Replay == eager, exactly, at full width in bf16: one decode chunk
    of ``steps`` steps and one speculative dispatch (small draft,
    ``rounds`` rounds of spec_len drafts), each captured over a prefilled
    state, replayed once and run eagerly on clones of that state: tokens,
    ok / accepted / drafted, poisoned, aux, tok and every cache tensor
    bit-equal, and each kernel's launch count the same. Prints each
    loop's capture time (warm-up run included)."""
    from repro_torch import kernels as K
    from repro_torch.models.model import prefill
    from repro_torch.serving.sampler import greedy
    from repro_torch.serving.step import NO_FAULT

    toks = torch.as_tensor(prompts, device=CUDA)
    B = toks.shape[0]

    def compare(loop, out, ref, n_out, n_ref, state, eager, outputs, aux):
        """Mismatches of a replay against the eager run: the named
        outputs, aux, the state tensors, the launch counts."""
        mism = [o for o, i in outputs if not torch.equal(out[i], ref[i])]
        mism += [f"aux/{k}" for k in ref[aux]
                 if not torch.equal(out[aux][k], ref[aux][k])]
        for key, t in state.items():
            if isinstance(t, dict):
                mism += [f"{key}/{k}" for k, v in t.items()
                         if not torch.equal(v, eager[key][k])]
            elif not torch.equal(t, eager[key]):
                mism.append(key)
        if n_out != n_ref:
            mism.append(f"launches {n_out} != {n_ref}")
        return dict(capture_s=loop.capture_s, exact=not mism,
                    mismatches=mism, launches_per_replay=loop.launches)

    def run_both(loop, eager_call, ops):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = loop(**ops, fault=NO_FAULT)
        torch.cuda.synchronize()
        replayed = K.launch_counts()
        K.reset_launch_counts()
        ref = eager_call()
        torch.cuda.synchronize()
        return out, ref, replayed, K.launch_counts()

    res = {}
    lg, cache, _ = prefill(cfg, params, toks, cache_len=cache_len,
                           capacity_factor=8.0)
    tok = greedy(lg)
    eager = {"tok": tok.clone(), "cache": clone_tree(cache)}
    loop, fused = plain_graph(cfg, params, tok, cache, steps=steps)
    rem = np.full(B, 1000, np.int32)
    out, ref, n_out, n_ref = run_both(
        loop, lambda: fused(params, eager["tok"], eager["cache"],
                            torch.as_tensor(rem, device=CUDA), None,
                            NO_FAULT), dict(remaining=rem))
    r = compare(loop, out, ref, n_out, n_ref, {"tok": tok, "cache": cache},
                eager, (("toks", 2), ("ok", 4), ("poisoned", 5)), 3)
    r.update(steps=steps)
    res["decode"] = r
    del loop, out, ref, eager, cache

    dcfg, dparams = small_draft(cfg, torch.bfloat16)
    lg, cache, _ = prefill(cfg, params, toks, cache_len=cache_len,
                           capacity_factor=8.0)
    _, dcache, _ = prefill(dcfg, dparams, toks, cache_len=cache_len,
                           capacity_factor=8.0)
    tok = greedy(lg)
    eager = {"tok": tok.clone(), "cache": clone_tree(cache),
             "dcache": clone_tree(dcache)}
    loop, fused = spec_graph(cfg, params, dcfg, dparams, tok, cache, dcache,
                             spec_len=spec_len, rounds=rounds)
    ops = spec_ops(B, cfg.moe.num_experts, spec_len)
    out, ref, n_out, n_ref = run_both(
        loop, lambda: fused(params, dparams, eager["tok"], eager["cache"],
                            eager["dcache"],
                            *(torch.as_tensor(ops[n], device=CUDA)
                              for n in SPEC_OPS), NO_FAULT), ops)
    r = compare(loop, out, ref, n_out, n_ref,
                {"tok": tok, "cache": cache, "dcache": dcache}, eager,
                (("remaining", 3), ("budget", 4), ("new_tokens", 5),
                 ("num_new", 6), ("accepted", 7), ("drafted", 8),
                 ("poisoned", 10)), 9)
    r.update(rounds=rounds, spec_len=spec_len, accepted=int(ref[7].sum()),
             drafted=int(ref[8].sum()))
    res["spec"] = r
    log(f"graphs {cfg.name} (bf16, {B} slots): {json.dumps(res)}")
    bad = {k: v["mismatches"] for k, v in res.items() if not v["exact"]}
    if bad:
        fail(f"graphs {cfg.name}: replay != eager in {bad}")
    return res


# ------------------------------------------------------ profile phase ---

def profile_phase(cfg, params, prompts, *, cache_len: int, steps: int = 8,
                  batch=None):
    """Where a prefill's or a decode step's time goes, policy off, for a
    prefill, ``steps`` eager decode steps (decode_steps_fused run as it
    is) and the same steps replayed from a captured graph (the serving
    path on the card; with ``batch``, an XShare policy, also replayed
    under it): host wall per call (no profiler; a replay's the median of
    5), then torch.profiler over the same calls for the device's busy
    time by kernel, and each port kernel's device ms per call, summed
    over its kernels and as the span of a call. The idle share is taken
    against the wall without the profiler (the step as served) and
    against the profiled wall. Device numbers are "not measured" if the
    profiler sees no CUDA kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.models.model import prefill
    from repro_torch.serving.sampler import greedy
    from repro_torch.serving.step import NO_FAULT, decode_steps_fused

    toks = torch.as_tensor(prompts, device=CUDA)
    B = toks.shape[0]
    rem = np.full(B, 1000, np.int32)

    def prefilled():
        lg, cache, _ = prefill(cfg, params, toks, cache_len=cache_len,
                               capacity_factor=8.0)
        return greedy(lg), cache

    tok0, cache0 = prefilled()
    loops = {"replay": plain_graph(cfg, params, tok0.clone(),
                                   clone_tree(cache0), steps=steps)[0]}
    if batch is not None:
        loops["replay batch"] = plain_graph(
            cfg, params, tok0.clone(), clone_tree(cache0), steps=steps,
            policy=batch)[0]

    def from_prefill(loop):
        loop.tensors["tok"].copy_(tok0)
        for k, v in cache0.items():
            loop.tensors["cache"][k].copy_(v)

    out = {}
    for name in ("prefill", "decode", *loops):
        runs = []
        for use_prof in (False, True):
            walls = []
            for _ in range(5 if name in loops and not use_prof else 1):
                if name == "decode":
                    tok, cache = prefilled()
                if name in loops:
                    from_prefill(loops[name])
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) \
                    if use_prof else None
                if prof is not None:
                    prof.__enter__()
                K.reset_launch_counts()
                t0 = time.perf_counter()
                if name == "prefill":
                    prefilled()
                elif name == "decode":
                    decode_steps_fused(
                        cfg, params, tok, cache,
                        torch.as_tensor(rem, device=CUDA), None,
                        num_steps=steps, capacity_factor=8.0)
                else:
                    loops[name](remaining=rem, fault=NO_FAULT)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                launches = K.launch_counts()
                if prof is not None:
                    prof.__exit__(None, None, None)
            runs.append((float(np.median(walls)), prof))
        per = 1 if name == "prefill" else steps
        wall_ms = runs[0][0] * 1e3 / per
        kern = cuda_kernels(runs[1][1])
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / per
        ssd_ms = sum(e.self_device_time_total for e in kern
                     if any(k in e.key for k in SSD_KERNELS)) / 1e3 / per
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        ours = port_kernels_ms(kern, per)
        prof_ms = runs[1][0] * 1e3 / per
        out[name] = dict(
            wall_ms=wall_ms, profiled_wall_ms=prof_ms,
            device_busy_ms=busy_ms if kern else "not measured",
            device_idle_share=max(0.0, 1 - busy_ms / wall_ms)
            if kern else "not measured",
            device_idle_share_profiled=(1 - busy_ms / prof_ms)
            if kern else "not measured",
            kernels_per_call=sum(e.count for e in kern) / per
            if kern else "not measured",
            top=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3
                      / per, calls=e.count / per) for e in top],
            port_kernels_ms=ours,
            port_kernel_ms_per_call=per_call_ms(ours, launches, per),
            port_call_span_ms=call_spans_ms(runs[1][1]) if kern
            else "not measured",
            launches_per_call={k: v / per for k, v in launches.items()})
        if name in loops:
            out[name]["capture_s"] = loops[name].capture_s
        if cfg.ssm is not None:
            out[name].update(ssd_scan_ms=ssd_ms if kern else "not measured",
                             ssd_scan_share_of_busy=ssd_ms / busy_ms
                             if kern and busy_ms else "not measured")
        log(f"profile {cfg.name} {name}: {json.dumps(out[name])}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import build
    from repro_torch.models.moe import OFF

    t_start = time.perf_counter()
    with Phase("setup"):
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
    with Phase("kernels"), torch.no_grad():
        cases = kernel_cases(ARCHS)
        cases["ssd_scan"] = ssd_cases(ARCHS)
    bad = [(n, c["dtype"], c.get("policy"), c.get("model"),
            c.get("init_state"), c.get("dt_shift"))
           for n, cs in cases.items() for c in cs if not c["ok"]]
    for n, cs in cases.items():
        for c in cs:
            log(f"kernel {n}: {json.dumps(c)}")
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    check_moe_cases(cases["moe_ffn"])
    check_kernel_counts(cases)

    with Phase("parity"), torch.no_grad():
        parity = {ARCH: path_parity(cfg, 64, 128)}
        for name in SSM_ARCHS:
            parity[name] = path_parity(ARCHS[name], 300, 320)
        parity[f"{ARCH} spec"] = spec_parity(cfg, 64, 128)

    results, prof = {}, {}
    with Phase(f"main path {ARCH}"):
        results[ARCH], params, prompts, plain_tokens = main_path(
            cfg, kernels=("grouped_ffn", "moe_ffn", "decode_attention"),
            prompt_len=128, new=32, cache_len=512,
            policies=(OFF, XSharePolicy(mode="batch", k0=1, m_l=8)))
    tps = {pol: {t: results[ARCH][pol][k] for t, k in
                 (("cold", "tokens_per_s"), ("warm", "tokens_per_s_warm"))}
           for pol in results[ARCH]}
    log(f"tokens/s {ARCH} 8 x 32 new, one call, off vs batch (cold: the "
        f"capture included): {json.dumps(tps)}; card {card}")
    with Phase(f"graphs {ARCH}"), torch.no_grad():
        graphs = graph_phase(cfg, params, prompts)
    with Phase(f"profile {ARCH}"), torch.no_grad():
        prof[ARCH] = profile_phase(cfg, params, prompts, cache_len=512,
                                   batch=XSharePolicy(mode="batch", k0=1,
                                                      m_l=8))
    bf16_check = {}
    with Phase(f"bf16 check {ARCH}"), torch.no_grad():
        from repro_torch.kernels import grouped_ffn_plain
        from repro_torch.models import dispatch
        bf16_check[ARCH] = bf16_model_check(
            cfg, params, prompts, cache_len=512, module=dispatch,
            attr="grouped_ffn", plain=grouped_ffn_plain)
    with Phase(f"spec lossless {ARCH}"), torch.no_grad():
        lossless = spec_lossless(cfg)
        torch.cuda.empty_cache()
    with Phase(f"spec served {ARCH}"), torch.no_grad():
        results[f"{ARCH} spec"] = spec_served(cfg, params, prompts,
                                              plain_tokens["off"])
    with Phase(f"profile {ARCH} spec"), torch.no_grad():
        prof[f"{ARCH} spec"] = spec_profile(cfg, params, prompts)
    with Phase(f"durability {ARCH}"):
        durability = durability_phase(cfg, params, prompts,
                                      plain_tokens["off"])
    del params
    torch.cuda.empty_cache()
    for name in SSM_ARCHS:
        scfg = ARCHS[name]
        kernels = ("ssd_scan",) + (("decode_attention",)
                                   if scfg.family == "hybrid" else ())
        with Phase(f"main path {name}"):
            results[name], params, prompts, _ = main_path(
                scfg, kernels=kernels, prompt_len=500, new=32,
                cache_len=1024, policies=(OFF,),
                expect=ssm_expect(scfg, 32))
        if name == "mamba2-370m":
            with Phase(f"profile {name}"), torch.no_grad():
                prof[name] = profile_phase(scfg, params, prompts,
                                           cache_len=1024)
            with Phase(f"bf16 check {name}"), torch.no_grad():
                from repro_torch.kernels import ssd_scan_plain
                from repro_torch.models import ssm
                bf16_check[name] = bf16_model_check(
                    scfg, params, prompts, cache_len=1024, module=ssm,
                    attr="ssd_scan", plain=ssd_scan_plain)
        del params
        torch.cuda.empty_cache()
    # the repo's one sliding-window model: 4600-token prompts, so the
    # 4608-slot rolling cache wraps 8 tokens into decoding
    dcfg = ARCHS[DANUBE]
    with Phase(f"main path {DANUBE}"):
        results[DANUBE], params, _, _ = main_path(
            dcfg, kernels=("decode_attention",), prompt_len=4600, new=32,
            cache_len=4608, policies=(OFF,), expect=dense_expect(dcfg, 32),
            requests=4)
    del params
    torch.cuda.empty_cache()

    sources = {"grouped_ffn": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                               "src/repro/kernels/moe_ffn.py:155"),
               "moe_ffn": ("src/repro_torch/kernels/csrc/moe_ffn.cu",
                           "src/repro/kernels/moe_ffn.py:77"),
               "decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attn.cuh",
                   "src/repro/kernels/decode_attn.py:67"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:66")}
    line = []
    for name, cs in cases.items():
        main_case = next(c for c in cs if c["dtype"] == "bfloat16")
        f32 = next(c for c in cs if c["dtype"] == "float32")
        tol = SCAN_TOL if name == "ssd_scan" else TOL
        line.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1],
            # summed over every main path's continuous runs
            launches=sum(r["launches"][name] for runs in results.values()
                         for r in runs.values()),
            max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"],
            dtype="bfloat16", shape=main_case["shape"],
            tol=tol[torch.bfloat16], max_abs_err_f32=f32["max_abs_err"],
            tol_f32=tol[torch.float32], cases=cs))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": line, "main_path": results,
                      "parity": parity, "spec_lossless": lossless,
                      "bf16_check": bf16_check, "profile": prof,
                      "graphs": graphs, "durability": durability,
                      "card": card}),
          flush=True)
    print(gpu_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
