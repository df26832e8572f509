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
                or grouped_ffn call runs more than 2; decode_attention
                also at the trained speculation's head dim 16 (8 rows,
                4 / 2 and 2 / 1 heads, T = 1 and 4, a 75-slot cache,
                f32); grouped_ffn_bwd (the gradient) at granite's
                training plan (8 x 128 tokens, top-8 of 32, expert 31
                without rows, invalid tail tiles, block_t 128) in f32
                and bf16, each gradient within TOL of its largest
                magnitude, two calls bit-equal, at most 3 CUDA kernels
                per call, each pass's device us and TFLOP/s on the real
                rows, beside the torch._grouped_mm yardstick;
                ssd_scan_bwd (the scan's gradient) at mamba2-370m's and
                zamba2-1.2b's widths, dt shift 0 and -5: the train
                phases' 8 x 512 tokens in f32, then 8 x 500 (a ragged
                last chunk) in f32 and bf16, init_state and d_final in
                the -5 cases:
                each gradient within 1e-4 (f32) / 2e-2 (bf16) of its
                largest magnitude, two calls bit-equal, at most 5 CUDA
                kernels a call, each pass's device us;
                moe_ffn_bwd (moe_ffn's gradient) at granite's decode
                shape (8 tokens, 32 experts) and its draft's (d 128, 4
                experts top-2), f32 and bf16, policy off and batch (k0
                1, m_l 8), combine route()'s column slice: each gradient
                within TOL of its largest magnitude, the experts outside
                the slots exactly zero, two calls bit-equal, exactly 3
                CUDA kernels a call;
                decode_attention also at the families phase's decode
                shapes, T = 1, cur_len drawn per row over the served
                lengths in a cache of 512: paligemma-3b (8 rows, 8 query
                heads on 1 KV head of 256, cur_len 384-415) and
                musicgen-large (8 rows, 32 / 32 heads of 64, 128-159);
                decode_attention's e4m3 instance (bf16 q over a
                float8_e4m3fn cache) at granite-moe's decode shape and
                at musicgen-large's and qwen3-moe-235b-a22b's decode_32k
                shapes (8 rows, a cache of 33 280, cur_len 32768-32775),
                within TOL of the plain version and EXACT_BF16 of f32
                math on the dequantized cache, beside the bf16 instance
                on that cache and a dequantize + SDPA yardstick;
                the serving kernels at gpt-oss-120b-proxy's shapes (d =
                f = 2880, 128 experts top-4): moe_ffn on a decode step's
                8 tokens, policy off and batch (its time ratio gated as
                granite's), grouped_ffn on the 8 x 128 prefill's plan
                (block_t 16, the dispatch default there, and 128), an
                8 x 5 verify pass and an 8-token decode step (block_t 8)
                beside torch._grouped_mm,
                decode_attention at 8 rows of 64 / 8 heads of 64 and at
                llama3-8b's 32 / 8 of 128, cur_len 128-159 in a cache of
                512, beside SDPA;
  3. parity     each full-width model cut to 2 layers in f32 (zamba2: one
                shared-block application), prefill of 4 x 64 tokens
                (granite-moe; paligemma-3b after 256 prefix embeddings;
                musicgen-large: 64 frames of 4 codebooks) or 4 x 300
                (mamba2, zamba2) then 8 greedy
                decode steps, on the CPU (plain versions) and on the card
                (kernels): tokens equal, logits close; and granite-moe's
                speculative decoding (spec_len 3, 16 new; the self-draft
                and the target's params + 0.05 N(0, 1), which must be
                rejected at least once): continuous == lockstep == plain
                greedy on each device, CPU == GPU; gpt-oss-120b-proxy at
                1 layer (its f32 weights take 17.5 GB) and llama3-8b at
                2, 4 x 64 tokens, as above;
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
                gpt-oss-120b-proxy (after the ep phases) at its own
                widths cut to 8 of its 36 layers (53.7 GB; all 36 take
                233.6 GB), 8 x 128 prompts, 32 new, cache 512, the engine
                at capacity_factor 32 (= E / k, so a decode step's 8
                tokens take moe_ffn), policy off and batch (k0 1, m_l
                8): grouped_ffn once per layer per prefill, moe_ffn and
                decode_attention once per layer per decode step,
                exactly; then policy off at the engine's default 8,
                whose decode takes grouped_ffn (the same drop-free
                function), grouped_ffn once per layer per prefill and
                per decode step, exactly; batch activating fewer experts
                per layer per decode step than off (a random router);
                each replayed step beside launch/roofline.py's one-card
                bound; then grouped_ffn's
                bf16 check (phase 6) at 1 layer; llama3-8b (32 layers,
                head dim 128), 8 x 128 prompts, 32 new, cache 512:
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
  5b. serve cli the public wrappers of kernels/ops.py (xshare_moe_ffn,
                xshare_grouped_ffn, flash_decode at granite-moe's decode
                and prefill shapes; ssd_chunk_scan at mamba2-370m's
                prefill, B and C pre-broadcast to the heads), f32 and
                bf16, each once against its kernel's plain version
                (TOL; the scan SCAN_TOL), each call one launch; then the
                serve CLI, repro_torch.launch.serve.main, at
                granite-moe's full width (f32 weights from seed 0, 8 x
                128 SyntheticLM prompts, 32 new): policy off, batch (k0
                1, m_l 8) and --spec-len 4 (2-layer draft at the
                target's vocabulary), each with exact launches from the
                rounds it ran (counters set to 0 just before a run,
                read just after) and the reference's printed lines; off
                == Engine.generate on the same weights and prompts, spec
                == off, batch activates fewer experts than off; then
                launch/roofline.py's one-card bounds (model_shards 1) of
                the bf16 decode step (B 8, cache 512; off and batch)
                beside the profile phase's replayed steps, and of the 8
                x 128 prefill beside its eager prefill (printed only);
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
  7b. families  random weights from seed 0, bf16, every layer, one model
                at a time: paligemma-3b (18 layers, tied vocabulary of
                257 216), 8 requests of 256 N(0, 1) prefix embeddings +
                128 prompt tokens, 32 new, cache 512, through
                Engine.generate(prompts, 32, prefix_embeds=pe) (the
                lockstep loop, as the JAX package serves a prefix),
                twice: the first token is the argmax of forward(...,
                prefix_embeds=pe) at the last position, decode_attention
                launched exactly 18 x 31 times a call, both calls' tokens
                equal, tokens/s and an eager decode step's wall;
                musicgen-large (48 layers, 4 codebooks of 2048), 8
                requests of 128 frames, 32 new, cache 512, as a main path
                (cold and warm, continuous == lockstep, tokens (8, 32, 4),
                48 decode_attention launches a decode step, new_tokens 8 x
                32 x 4), a replayed step's wall and device time, then
                with its 64 conditioning embeddings through the lockstep
                loop: shape and launches;
  7c. f8 cache  musicgen-large at decode_32k's cache of 33 280 slots with
                an e4m3 cache: the dry run's records (bf16 and e4m3
                cache) and the rows each fits in 90 % of the card; at the
                e4m3 batch, 8 greedy steps through make_serve_step with
                the full-width bf16 weights (step ms, decode_attention's
                share, peak memory against the record, the record's
                byte bound, tokens/s; 48 decode_attention launches a
                step, nothing else); then at 2 rows the e4m3 step
                against a bf16 step on the dequantized cache whose
                writes round each new row through e4m3: logits bit-equal
                at each of 8 teacher-forced steps (the gap to a bf16
                step writing bf16 rows printed beside);
  7d. dryrun    (host only) repro_torch.launch.dryrun --all: 10 archs x
                4 shapes x 2 production meshes traced on meta in parallel
                processes, all must trace; report.py's tables;
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
  8b. ep        expert parallelism. (a) granite-moe at full width,
                bf16, 8 x 128 prompts, 32 new, served by
                Engine(dispatch="ep") under an 8-shard EPExecutor (4
                experts a shard): policy off on the contiguous placement,
                Algorithm 6 (k0 1, m_g 2, 8 groups) on plan_placement from
                the prompts' gate histogram, and the same with the
                hottest expert replicated twice and update_placement
                between two generate calls; tokens equal
                dispatch="sorted"'s and the EP lockstep run's, exact
                launches (grouped_ffn once per MoE layer call, no
                moe_ffn), one layer of an eager decode step bit-equal to
                sorted_expert_ffn, the update's tables and version read
                by the next call; tokens/s cold and warm for ep, sorted
                and auto, a replayed decode step's wall and device time,
                EPStats over one decode step's 24 layers. (b) the
                executor alone at one MoE layer of deepseek-r1-proxy's
                routed experts (E 256, top-8, d 7168, f 2048, bf16),
                benchmarks/table2_ep.py's methods off / alg6 / alg6_rep
                at 16 tokens and 16 x (1 + 3), 8 steps each: every y
                bit-equal to sorted_expert_ffn(block_t=8), counts
                consistent, peak-row ratios, the EP layer's and the
                sorted path's times, and each shard's own tiles timed as
                a grouped_ffn call alone (the slowest shard's time).
  8c. ep ranks  one process per shard (repro_torch.ep.dist.spawn), each
                holding only its experts, rows exchanged by
                torch.distributed.all_to_all_single; the backend and rank
                count printed on a line of their own. (a) 4 ranks over
                gloo on the one card at deepseek-r1-proxy's routed
                experts, one layer (64 experts, 5.6 GB, a rank), the
                methods of 8b (Algorithm 6 over 4 groups) at 16 tokens
                and 16 x (1 + 3), 4 steps each: the gathered y bit-equal
                to the one-process EPExecutor's (itself bit-equal to
                sorted_expert_ffn(block_t=8)), every EPStats field
                equal, one grouped_ffn launch per layer call on each
                rank, each rank's own grouped_ffn call within TOL of its
                plain version and timed alone (ranks take turns behind a
                barrier): the slowest rank's ms, the peak-rows ratios,
                each rank's expert bytes on the card against cap / E of
                the layer's, the exchange's NVLink bound per layer call
                on a four-card host (a bound, not a measurement); (b)
                granite-moe at full width, bf16, 8 x 128 prompts, 32
                new, served by the 4 ranks (8 experts each, cut from a
                host copy) through the lockstep loop, policy off and
                Algorithm 6: tokens equal the one-process
                dispatch="sorted" run's, exact launches on each rank,
                one decode step's per-rank EPStats, and the continuous
                loop's graph capture refused with a clear error on
                every rank; (c) one rank over NCCL: (a)'s layer at S 1
                and one granite decode step bit-equal to the
                one-process executor at S 1.
  9. train      (a) granite-moe cut to 2 layers, f32, 4 x 64 synthetic
                tokens, on the CPU (plain versions) and on the card
                (grouped_ffn and grouped_ffn_bwd): every gradient leaf
                and, after one make_train_step, every updated leaf within
                1e-4 of its largest magnitude, the loss within 2e-5;
                (b) granite-moe at all 24 layers, f32, remat, 8 x 128
                tokens from SyntheticLM: every expert that received rows
                has nonzero w1 / w3 / w2 gradients and no other one, then
                10 steps whose loss must fall, with the step time,
                tokens/s, peak memory and grouped_ffn's forward and
                backward launches per step (one backward per layer),
                and the backward's share of a step's device time;
                (c) benchmarks/fig5_table4_spec.py's setting trained on
                the card (the bench target 150 steps, the dense draft 300
                and 10 / 20 / 40), served 8 x 16 prompts, 48 new,
                spec_len 3 under Algorithm 4 (HIER) and the naive
                per-request top-k (NAIVE): tokens equal plain greedy with
                every draft, a short draft's acceptance strictly in
                (0, 1), HIER's activated experts per verify pass below
                NAIVE's; acceptance, accepted per round, activated
                experts and tokens/s printed; (d), run before (c):
                mamba2-370m and zamba2-1.2b cut to 2 layers, f32,
                4 x 500 synthetic tokens, on the CPU (plain versions)
                and on the card (ssd_scan and ssd_scan_bwd): as (a), with
                ssd_scan_bwd launched once per layer and the leaves
                that start at zero (conv biases, A_log, dt_bias)
                printed after the step, not gated; (e) both at all
                their layers (48, 38), f32, remat, 8 x 512 tokens: every
                SSM layer's weights get a nonzero gradient, then 10
                steps whose loss must fall, with exact launches
                (ssd_scan_bwd once per layer per step, ssd_scan twice),
                step time, tokens/s, peak memory and the backward
                kernel's share of a step's device time; (f), after (b):
                the dense path (moe_ffn and moe_ffn_bwd): 4 x 8 tokens
                at capacity_factor 4, so every MoE layer's 32 tokens
                take it: as (a) on granite's 2 layers, moe_ffn_bwd once
                per layer and grouped_ffn never, then all 24 layers, f32,
                remat, 10 steps whose loss must fall, moe_ffn_bwd
                exactly 24 x 10 times (moe_ffn twice that), the step's
                device ms and the backward's share, then the train CLI
                (python -m repro_torch.launch.train --arch
                granite-moe-1b-a400m --reduced --batch 1 --seq 4) in a
                subprocess, which must exit 0; (g), last: trained claims,
                tests/test_system.py's 2-layer MoE (d 64, 16 experts
                top-4) trained on the card for 60 steps of 8 x 64 tokens
                (grouped_ffn and grouped_ffn_bwd once per layer per step,
                exactly; the loss must fall), then the paper's five
                claims held as that test states them, each claim's
                moe_ffn (forwards of <= 32 tokens) and grouped_ffn
                launches exact, the measured values printed.

Prints a JSON line {"kernels": [...]}, the card's name and power limit,
and last {"ok": true, "device": {...}}. Exits non-zero without a result
when CUDA is absent. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
VLM, AUDIO = "paligemma-3b", "musicgen-large"
# the families phase's requests: paligemma's 256 image-patch embeddings
# (its config's prefix_len), 128 prompt tokens (musicgen: frames), 32 new
FAMILY_PREFIX, FAMILY_PROMPT, FAMILY_NEW = 256, 128, 32
# the paper's evaluation model: 36 layers of 128 experts top-4 at d = f =
# 2880 take 116.8 B parameters, 233.6 GB in bf16; 8 layers (3.21 B each,
# plus 1.16 B of the two vocabulary matrices) take 53.7 GB of the card's
# 80. Its CPU == GPU parity runs 1 layer in f32: 17.5 GB on the host and
# on the card (2 layers would be 30 GB)
GPT_OSS = "gpt-oss-120b-proxy"
GPT_OSS_LAYERS, GPT_OSS_PARITY_LAYERS = 8, 1
# its decode steps' 8 tokens at top-4 of 128 experts: the capacity
# factor only picks the path, since both paths `auto` chooses between
# drop nothing. At the engine's default 8 the einsum capacity is 4 < 8
# tokens, so `auto` sends decode to the sorted path (grouped_ffn, tiles
# of 8 rows); at 32 (= E / k, the least that covers every token, as
# granite's E / k = 4 is covered by the default) it takes the dense
# path, XShare's masked FFN (moe_ffn), that granite's default serves.
# The phase serves both: off and batch at 32, off at the default 8. The
# prefill's 1024 tokens take the sorted path either way
GPT_OSS_CF, ENGINE_CF = 32.0, 8.0
# the dense family at head dim 128
LLAMA = "llama3-8b"
SSD_KERNELS = ("chunk_state_kernel", "state_pass_kernel",
               "chunk_scan_kernel")   # the three passes of ssd_scan
# grouped_ffn_bwd's three passes (tc: bf16 on the tensor cores; f32),
# and each pass's share of 16 rows d f operations
BWD_KERNELS = ("bwd_act_tc_kernel", "bwd_act_f32_kernel",
               "bwd_dx_tc_kernel", "bwd_dx_f32_kernel", "bwd_dw_tc_kernel",
               "bwd_dw_f32_kernel")
BWD_PASS_FLOPS = {"bwd_act": 6, "bwd_dx": 4, "bwd_dw": 6}
# ssd_scan_bwd's five passes (csrc/ssd_scan_bwd.cu)
SSD_BWD_KERNELS = ("ssd_bwd_chunk_state_kernel", "ssd_bwd_state_pass_kernel",
                   "ssd_bwd_chunk_kernel", "ssd_bwd_dcum_kernel",
                   "ssd_bwd_group_kernel")
# ssd_scan_bwd against its plain version, of each gradient's largest
# magnitude: the scan's f32 bar (dcum's row and column sums cancel), and
# one rounding of dx, dB, dC to bf16 on either side
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# moe_ffn_bwd's two passes (csrc/moe_ffn_bwd.cu)
MOE_BWD_KERNELS = ("moe_bwd_strip_kernel", "moe_bwd_reduce_kernel")
# the dense path's training phases: capacity_factor 4 keeps every token of
# a 32-token MoE layer (granite's top-8 of 32 experts), so T <= 32 and
# expert_ffn takes moe_ffn
DENSE_CF = 4.0
# every __global__ function of src/repro_torch/kernels/csrc (name prefixes)
PORT_KERNELS = SSD_KERNELS + ("grouped_tc_kernel", "grouped_f32_kernel",
                              "moe_up_kernel", "moe_down_kernel",
                              "moe_reduce_kernel", "decode_split_kernel",
                              "decode_merge_kernel") + BWD_KERNELS \
    + SSD_BWD_KERNELS + MOE_BWD_KERNELS


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
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the dtype's peak, from the H100's
    published peaks in ``repro_torch.launch.roofline``."""
    from repro_torch.launch import roofline as R
    t_bytes = nbytes / R.HBM_BW
    t_ops = flops / {torch.bfloat16: R.PEAK_FLOPS,
                     torch.float32: R.PEAK_FLOPS_F32}[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_tc_ms(nbytes: float, flops: float) -> float:
    """The least ms of f32 work done as 3xTF32 products on the tensor
    cores (three TF32 products for each f32 one, ssd_scan_bwd's route):
    the larger of the bytes over the HBM rate and 3 · flops over the
    TF32 peak of ``repro_torch.launch.roofline``."""
    from repro_torch.launch import roofline as R
    return max(nbytes / R.HBM_BW, 3 * flops / R.PEAK_FLOPS_TF32) * 1e3


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
    its call's 2 kernels, or 1 of them; at most 6 of the 9 of three
    grouped_ffn_bwd calls), never invent one, so the count per call is
    rounded up and is at least the number of kernel names seen, and a
    session that sees no kernel is repeated, up to ``tries`` sessions."""
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
    return max(-(-sum(e.count for e in kern) // calls), len(us)), us


def ptxas_report(build_log: str):
    """Each compiled kernel's source, (mangled) name, registers and
    spilled bytes (stores + loads) from nvcc's -Xptxas -v output, whose
    sources the build log heads with "== name"."""
    out, src, cur = [], "", None
    for line in build_log.splitlines():
        if line.startswith("== "):       # "== name (seconds s)"
            src = line[3:].split(" (")[0].strip()
        elif "Compiling entry function" in line:
            cur = dict(source=src, function=line.split("'")[1],
                       registers=None, spill_bytes=0)
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill_bytes"] += sum(int(n) for n in re.findall(
                r"(\d+) bytes spill", line))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return out


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
    from repro_torch.kernels import decode_attention, decode_attention_plain

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
        out["moe_ffn"] += moe_policy_cases(randn(8, d, dtype=dtype), wg, w1,
                                           w3, w2, cfg.moe, dtype)

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
    out["decode_attention"] += bench_attention_cases()
    out["decode_attention"] += family_attention_cases(archs)
    out["decode_attention"] += e4m3_attention_cases(archs)
    return out


# decode_32k's cache: 32768 positions + the dry run's CACHE_MARGIN of 512
DECODE_32K_CACHE = 32768 + 512
F8 = torch.float8_e4m3fn


def e4m3_attention_cases(archs):
    """decode_attention's e4m3 instance: bf16 queries over a
    float8_e4m3fn cache (drawn N(0, 1) in bf16 from a seeded generator
    and rounded to e4m3), one query per row, at granite-moe's decode
    shape (8 rows, 16 / 8 heads of 64, a cache of 512, cur_len 128-159)
    and at the two decode_32k shapes the planning experiments put an
    e4m3 cache under: musicgen-large's (8 rows, 32 / 32 heads of 64) and
    qwen3-moe-235b-a22b's (8 rows, 64 / 4 heads of 128), in a cache of
    33 280 slots with cur_len 32768-32775.

    Held against the plain version on the same e4m3 cache at the bf16
    TOL, and against f32 math on the dequantized inputs at EXACT_BF16.
    Timed beside: the bound (the live positions' bytes at 1 byte a cache
    element), the bf16 instance on the dequantized (bf16) cache, and
    the library yardstick, which dequantizes to bf16 and then calls
    SDPA. Last and on their own generator; none in a tree without the
    instance (an older commit's, timed by kernel_times.py)."""
    from repro_torch.kernels import decode_attn
    if not hasattr(decode_attn, "_E4M3_HEAD_DIMS"):
        return []
    g = torch.Generator(device=CUDA)
    g.manual_seed(8484)
    bf = torch.bfloat16
    cases = []
    for label, a, C, lo in (
            (ARCH, archs[ARCH].attn, 512, FAMILY_PROMPT),
            (AUDIO, archs[AUDIO].attn, DECODE_32K_CACHE, 32768),
            ("qwen3-moe-235b-a22b", archs["qwen3-moe-235b-a22b"].attn,
             DECODE_32K_CACHE, 32768)):
        B, T, hi = 8, 1, lo + 31 if C == 512 else lo + 7
        H, Hkv, dh = a.num_heads, a.num_kv_heads, a.head_dim
        cur = torch.randint(lo, hi + 1, (B,), generator=g, device=CUDA,
                            dtype=torch.int32)
        q = torch.randn((B, T, H, dh), generator=g, device=CUDA).to(bf)
        k8 = torch.randn((B, C, Hkv, dh), generator=g, device=CUDA).to(F8)
        v8 = torch.randn((B, C, Hkv, dh), generator=g, device=CUDA).to(F8)
        cases.append(e4m3_case(label, q, k8, v8, cur, f"cur_len {lo}-{hi}"))
        del q, k8, v8
        torch.cuda.empty_cache()
    return cases


def e4m3_case(label, q, k8, v8, cur, lengths: str) -> dict:
    """One e4m3 case of decode_attention (see e4m3_attention_cases): q
    (B, T, H, dh) in bf16 over the e4m3 cache k8 / v8 (B, C, Hkv, dh) at
    per-row lengths ``cur``. The f32 math runs row by row and the
    dequantized copies are made after it, so a case on the f8 phase's
    served cache needs at most a few GB beside it."""
    from repro_torch.kernels import (decode_attention_cached,
                                     decode_attention_cached_plain)
    bf = torch.bfloat16
    B, T, H, dh = q.shape
    C, Hkv = k8.shape[1], k8.shape[2]

    def kernel():
        return decode_attention_cached(q, k8, v8, cur)

    def plain():
        return decode_attention_cached_plain(q, k8, v8, cur)
    ker, ref = kernel(), plain()
    err = max_err(ker, ref)
    atol, rtol = EXACT_BF16
    exact_err, exact_ok = 0.0, True
    for b in range(B):
        ref32 = decode_attention_cached_plain(
            q[b:b + 1].float(), k8[b:b + 1].float(), v8[b:b + 1].float(),
            cur[b:b + 1])
        exact_err = max(exact_err, max_err(ker[b:b + 1], ref32))
        exact_ok &= bool(torch.allclose(ker[b:b + 1].float(), ref32,
                                        atol=atol, rtol=rtol))
        del ref32
    kb, vb = k8.to(bf), v8.to(bf)

    def bf16_instance():
        return decode_attention_cached(q, kb, vb, cur)
    same_as_bf16 = bool(torch.equal(ker, bf16_instance()))
    mask = cached_mask(cur, T, C, None)
    qt = q.transpose(1, 2)

    def library():   # dequantize, then SDPA
        return torch.nn.functional.scaled_dot_product_attention(
            qt, k8.to(bf).transpose(1, 2), v8.to(bf).transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=True)
    live = int(mask.any(1).sum())
    nbytes = 2 * q.numel() * 2 + 2 * live * Hkv * dh * 1 + B * 4
    bms, by = bound_ms(nbytes, 4.0 * int(mask.sum()) * H * dh, bf)
    n_kern, kern_us = cuda_kernels_of(kernel)
    case = dict(
        dtype="float8_e4m3fn", q_dtype="bfloat16",
        cache_dtype="float8_e4m3fn", model=label, case="decode e4m3",
        lengths=lengths,
        shape=f"B={B} T={T} C={C} H={H} Hkv={Hkv} dh={dh} "
              f"window=None live={live}",
        max_abs_err=err, tol=TOL[bf], ok=close(ker, ref, bf) and
        exact_ok, exact_max_abs_err=exact_err, exact_ok=exact_ok,
        exact_tol=EXACT_BF16, equals_bf16_instance=same_as_bf16,
        ref_max_abs=float(ref.float().abs().max()),
        ref_rms=float(ref.float().square().mean().sqrt()),
        library_max_abs_err=max_err(library().transpose(1, 2), ref),
        kernels_per_call=n_kern, kernel_device_us=kern_us,
        ms=time_ms(kernel), plain_ms=time_ms(plain),
        bf16_instance_ms=time_ms(bf16_instance), bound_ms=bms,
        bound_by=by, library_ms=time_ms(library))
    case["ms_over_bf16_instance"] = case["ms"] / case["bf16_instance_ms"]
    case["ms_over_library"] = case["ms"] / case["library_ms"]
    log(f"decode_attention e4m3 {label} {case['shape']}: max abs err "
        f"{err:.3g} (limit {TOL[bf]}), vs f32 math {exact_err:.3g} "
        f"(limit atol {atol} rtol {rtol}), equals the bf16 instance "
        f"on the dequantized cache: {same_as_bf16}; {case['ms']:.4f} "
        f"ms, bf16 instance {case['bf16_instance_ms']:.4f} ms, "
        f"dequantize + SDPA {case['library_ms']:.4f} ms, plain "
        f"{case['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{n_kern} CUDA kernels per call")
    del ker, ref, kb, vb, mask
    torch.cuda.empty_cache()
    return case


def family_attention_cases(archs):
    """decode_attention at the decode shapes the families phase serves,
    one query per row (T = 1), cur_len drawn per row over the served
    lengths in a cache of 512: paligemma-3b's MQA (8 rows, 8 query heads
    on 1 KV head of 256; 256 prefix embeddings + 128 prompt tokens, then
    up to 32 new: 384-415) and musicgen-large's MHA (8 rows, 32 / 32
    heads of 64; 128 frames, then up to 32: 128-159), in f32 and bf16.
    Last and on their own generator."""
    g = torch.Generator(device=CUDA)
    g.manual_seed(2560)
    return [verify_attention_case(archs[name].attn, "served", dtype, g,
                                  T=1, label=name, cache=(512, lo, hi))
            for (name, lo, hi), dtype in itertools.product(
                ((VLM, FAMILY_PREFIX + FAMILY_PROMPT,
                  FAMILY_PREFIX + FAMILY_PROMPT + FAMILY_NEW - 1),
                 (AUDIO, FAMILY_PROMPT, FAMILY_PROMPT + FAMILY_NEW - 1)),
                (torch.float32, torch.bfloat16))]


def bench_attention_cases():
    """decode_attention at the trained speculation's shapes (train
    phase d): bench_cfg's target (4 / 2 heads of 16) and draft_cfg's (2 /
    1) over 8 rows, a decode step (T = 1) and a verify pass (T = 1 + L_s
    = 4), in the 75-slot cache of 16 prompt + 48 new + L_s + 8, cur_len
    16-64, f32. Last and on their own generator; none in a tree whose
    kernel has no head dim 16 (an older commit's)."""
    from repro_torch.kernels import decode_attn
    if 16 not in decode_attn._HEAD_DIMS:
        return []
    g = torch.Generator(device=CUDA)
    g.manual_seed(1616)
    cases = []
    for label, a in (("bench target", bench_cfg(32, 4).attn),
                     ("bench draft", draft_cfg().attn)):
        for T in (1, 1 + BENCH_SPEC_LEN):
            cases.append(verify_attention_case(
                a, "served", torch.float32, g, T=T, label=label,
                cache=(BENCH_CACHE, BENCH_PROMPT, BENCH_PROMPT + BENCH_NEW)))
    return cases


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
                          window_cache=None, bf16_abs=None, cache=None):
    """decode_attention under the cached_attention contract, B rows of T
    queries (granite's verify shape: 8 x (1 + L_s = 5)) at heads ``a``:
    cur_len ragged over [0, C - T] or at the served lengths 128-160 in a
    cache of 512, or a rolling window of 128 in a cache of 640 with
    cur_len over [0, 3C), so the cache wraps; ``window_cache`` =
    (window, C) gives another window, cur_len then over [C, 3C), past C;
    ``cache`` = (C, lo, hi) another full cache, cur_len over [lo, hi].
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
    elif cache is not None:
        window, (C, lo, hi) = None, cache
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


def moe_policy_cases(xt, wg, w1, w3, w2, mcfg, dtype, label=ARCH):
    """moe_case under policy off and batch (k0 1, m_l 8) on the same
    tokens, each with the two policies' time and active-expert ratios:
    XShare's saving at kernel level, time following the selected set
    (check_moe_cases holds it)."""
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.moe import OFF

    off, bat = (moe_case(xt, wg, w1, w3, w2, mcfg, pol, dtype, label=label)
                for pol in (OFF, XSharePolicy(mode="batch", k0=1, m_l=8)))
    t_ratio, a_ratio = bat["ms"] / off["ms"], bat["active"] / off["active"]
    log(f"moe_ffn {label} {dtype}: time batch / off = {t_ratio:.3f}, "
        f"active batch / off = {a_ratio:.3f} ({bat['active']} / "
        f"{off['active']})")
    for c in (off, bat):
        c.update(time_ratio_batch_off=t_ratio,
                 active_ratio_batch_off=a_ratio)
    return [off, bat]


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


def grouped_case(label, x, wg, w1, w3, w2, E, k, dtype, sz, block_t=None):
    """grouped_ffn against its plain version on the sorted dispatch of x
    (top-k of E experts; tiles of ``block_t`` rows, the dispatch's
    default when None), timed beside its bound and, in bf16, the
    torch._grouped_mm yardstick."""
    from repro_torch.core.routing import topk_route
    from repro_torch.kernels import grouped_ffn, grouped_ffn_plain
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens

    d, f = w1.shape[1], w1.shape[2]
    idx, w = topk_route(x.float() @ wg, k)
    plan = dispatch_plan(idx, w, E, block_t=block_t)
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


def paper_model_cases(archs):
    """The serving kernels at the shapes the gpt-oss-120b-proxy and
    llama3-8b phases give them, f32 and bf16, each against its plain
    version: moe_ffn on one decode step of 8 tokens at d 2880, f 2880,
    128 experts top-4 with normalized gates, policy off and batch (k0 1,
    m_l 8); grouped_ffn on the 8 x 128 prefill's plan (top-4 of 128;
    block_t 16, the dispatch's default there), on the same tokens in
    tiles of 128, on an 8 x 5 verify pass (block_t 8) and on an 8-token
    decode step (block_t 8: the engine's default capacity factor sends
    gpt-oss's decode there);
    decode_attention at one query per row, cur_len 128-159 in a cache of
    512, at gpt-oss's 64 / 8 heads of 64 and llama3-8b's 32 / 8 of 128.
    On their own generator. Returns {kernel name: [case dicts]}."""
    cfg = archs[GPT_OSS]
    m, d = cfg.moe, cfg.d_model
    E, f, k = m.num_experts, m.d_ff_expert, m.top_k
    g = torch.Generator(device=CUDA)
    g.manual_seed(2880)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=CUDA)
                ).to(dtype)

    out = {"grouped_ffn": [], "moe_ffn": [], "decode_attention": []}
    wg = randn(d, E, scale=0.02)
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.finfo(dtype).bits // 8
        w1, w3 = (randn(E, d, f, scale=0.02, dtype=dtype) for _ in range(2))
        w2 = randn(E, f, d, scale=0.02, dtype=dtype)
        prefill = randn(8 * 128, d, dtype=dtype)
        for label, x, bt in (("prefill", prefill, None),
                             ("prefill block_t 128", prefill, 128),
                             ("verify", randn(8 * 5, d, dtype=dtype), None),
                             ("decode", randn(8, d, dtype=dtype), None)):
            c = grouped_case(label, x, wg, w1, w3, w2, E, k, dtype, sz,
                             block_t=bt)
            out["grouped_ffn"].append(dict(c, model=GPT_OSS))
        out["moe_ffn"] += moe_policy_cases(randn(8, d, dtype=dtype), wg, w1,
                                           w3, w2, m, dtype, label=GPT_OSS)
        del w1, w3, w2, prefill
        torch.cuda.empty_cache()
    for name, dtype in itertools.product((GPT_OSS, LLAMA),
                                         (torch.float32, torch.bfloat16)):
        out["decode_attention"].append(verify_attention_case(
            archs[name].attn, "served", dtype, g, T=1, label=name,
            cache=(512, 128, 159)))
    return out


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
    kernels per call (split + merge; up + down); moe_ffn_bwd's too (the
    clusters' strips, the sums); grouped_ffn_bwd's at most 3 (dA / dB /
    H, dxs, the weight gradients); ssd_scan_bwd's at most 5 (chunk
    states, state pass, chunk tiles, dcum, group sums)."""
    for name, most in (("decode_attention", 2), ("grouped_ffn", 2),
                       ("grouped_ffn_bwd", 3), ("moe_ffn_bwd", 2),
                       ("ssd_scan_bwd", 5)):
        for c in cases.get(name, ()):
            if not 1 <= c["kernels_per_call"] <= most:
                fail(f"{name} {c['dtype']} {c.get('model', '')}: one call "
                     f"ran {c['kernels_per_call']} CUDA kernels, want "
                     f"1..{most}: {c['kernel_device_us']}")


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


def ssd_bwd_work(B, S, nh, hd, g, ds, l, sz, init, d_final):
    """(bytes, operations) of one SSD scan gradient: each input (x, dt,
    A, Bm, Cm, dy, the states given) read once and each output (dx, ddt,
    dA, dBm, dCm, d_init_state) written once; per (row, head) and chunk
    of n positions, the causal halves of the five l x l products (s =
    C·Bᵀ, q = dy·xᵀ, v, dC, dB: n(n+1)/2 pairs, 2·(3·ds + 2·hd)
    operations each) and the hd x ds products this run's data needs: G_c
    (every chunk: d_init_state is an output), the chunk's own state S_c
    (each chunk but the last, for the entering states), the entering
    state's term (where one enters: a chunk after the first, or an
    init_state), the two D_c terms (where a cotangent leaves the chunk:
    a chunk before the last, or d_final), 2·n·hd·ds each, and the state
    recursions (6·hd·ds a chunk)."""
    st = B * nh * hd * ds * 4
    nbytes = (3 * B * S * nh * hd * sz + 4 * B * S * g * ds * sz
              + 2 * B * S * nh * 4 + 2 * nh * 4
              + st * (1 + int(init) + int(d_final)))
    flops, starts = 0, list(range(0, S, l))
    for c, t0 in enumerate(starts):
        n = min(l, S - t0)
        last = c == len(starts) - 1
        prods = 1 + (not last) + (c > 0 or init) + 2 * (not last or d_final)
        flops += n * (n + 1) // 2 * 2 * (3 * ds + 2 * hd) \
            + prods * 2 * n * hd * ds + 6 * hd * ds
    return nbytes, float(flops * B * nh)


def ssd_bwd_cases(archs):
    """ssd_scan_bwd against ssd_scan_bwd_plain at the SSM training
    shapes' widths, one group, dt = softplus(randn + shift) with shift 0
    and -5 as ssd_cases draws: first the train phases' own shape (8 x
    512 tokens: full chunks, f32, no states, dy zero at the last
    position as the loss leaves it; the kernels line reads mamba2's
    shift 0 case), then 8 x 500 (a ragged last chunk) in f32 (the
    training path's dtype) and bf16, init_state and d_final nonzero in
    the shift -5 case of each dtype. Each gradient
    within SCAN_BWD_TOL of its largest magnitude, every output finite,
    two calls bit-equal; timed beside ssd_bwd_work's bound (bound_ms, by
    the inputs' dtype: f32 on the CUDA cores) and the same work as
    3xTF32 products on the tensor cores (bound_tc_ms), with its CUDA
    kernels per call and their device us. No PyTorch call computes this
    function (library_ms None). Own generator."""
    from repro_torch.kernels import ssd_scan_bwd, ssd_scan_bwd_plain
    from repro_torch.models.ssm import dims

    g = torch.Generator(device=CUDA)
    g.manual_seed(2468)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=CUDA)
                ).to(dtype)

    names = ("dx", "ddt", "dA", "dBm", "dCm", "d_init_state")
    out = []
    for name in SSM_ARCHS:
        s = archs[name].ssm
        _, nh, _ = dims(s, archs[name].d_model)
        B, hd, grp, ds = 8, s.head_dim, s.n_groups, s.d_state
        for S, dtype, shift, states in (
                (512, torch.float32, 0.0, False),
                (512, torch.float32, -5.0, False),
                (500, torch.float32, 0.0, False),
                (500, torch.bfloat16, 0.0, False),
                (500, torch.float32, -5.0, True),
                (500, torch.bfloat16, -5.0, True)):
            l = min(s.chunk_size, S)
            sz = torch.finfo(dtype).bits // 8
            x = randn(B, S, nh, hd, scale=0.5, dtype=dtype)
            dt = torch.nn.functional.softplus(randn(B, S, nh) + shift)
            A = -torch.exp(randn(nh, scale=0.3))
            Bm = randn(B, S, grp, ds, scale=0.3, dtype=dtype)
            Cm = randn(B, S, grp, ds, scale=0.3, dtype=dtype)
            dy = randn(B, S, nh, hd, dtype=dtype)
            if S % l == 0:   # the train phases' shape: no loss at S - 1
                dy[:, -1] = 0
            st0 = randn(B, nh, hd, ds, scale=0.2) if states else None
            df = randn(B, nh, hd, ds) if states else None
            args = (x, dt, A, Bm, Cm, dy)
            kw = dict(chunk=s.chunk_size, init_state=st0, d_final=df)

            def kernel():
                return ssd_scan_bwd(*args, **kw)
            ker, again = kernel(), kernel()
            ref = ssd_scan_bwd_plain(*args, **kw)
            errs = {n: max_err(a, r) / max(float(r.float().abs().max()),
                                           1e-30)
                    for n, a, r in zip(names, ker, ref)}
            bit_equal = all(torch.equal(a, b) for a, b in zip(ker, again))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in ker)
            nbytes, flops = ssd_bwd_work(B, S, nh, hd, grp, ds, l, sz,
                                         states, states)
            bms, by = bound_ms(nbytes, flops, dtype)
            ms = time_ms(kernel, iters=10)
            n_kern, kern_us = cuda_kernels_of(kernel)
            case = dict(
                dtype=str(dtype).replace("torch.", ""), model=name,
                init_state=states, d_final=states, dt_shift=shift,
                shape=f"B={B} S={S} nh={nh} hd={hd} g={grp} ds={ds} "
                      f"chunk={l}",
                max_abs_err=max(max_err(a, r) for a, r in zip(ker, ref)),
                rel_err=errs, tol=SCAN_BWD_TOL[dtype],
                ok=max(errs.values()) <= SCAN_BWD_TOL[dtype] and bit_equal
                and finite, bit_equal=bit_equal, finite=finite,
                ms=ms, tflops=flops / ms / 1e9, kernels_per_call=n_kern,
                kernel_device_us=kern_us,
                pass_us={k: sum(t for kn, t in kern_us.items() if k in kn)
                         for k in SSD_BWD_KERNELS},
                plain_ms=time_ms(lambda: ssd_scan_bwd_plain(*args, **kw),
                                 iters=5),
                bound_ms=bms, bound_by=by,
                bound_tc_ms=bound_tc_ms(nbytes, flops), library_ms=None,
                bytes=nbytes, flops=flops)
            log(f"ssd_scan_bwd {name} S={S} {dtype} dt_shift={shift} "
                f"states={states}: errors / max |ref| {errs} (limit "
                f"{SCAN_BWD_TOL[dtype]}), bit-equal {bit_equal}; {ms:.4f} "
                f"ms (bound {bms:.4f} by {by}, on the tensor cores "
                f"{case['bound_tc_ms']:.4f}), {case['tflops']:.2f} "
                f"TFLOP/s, plain {case['plain_ms']:.3f} ms, {n_kern} CUDA "
                f"kernels per call, device us by pass {case['pass_us']}")
            out.append(case)
            del x, Bm, Cm, dy, ker, again, ref
    return out


# ------------------------------------------------------ parity phase ---

def path_parity(cfg, prompt_len: int, cache_len: int, prefix_len: int = 0,
                layers: int = 2):
    """Same seeded weights, f32, ``layers`` layers: CPU (plain versions)
    vs GPU (kernels). The weights are drawn on the card, which draws
    faster than the host, and copied to the host. Audio prompts are
    frames of the config's codebooks; ``prefix_len`` N(0, 1) prefix
    embeddings go before the prompt."""
    from repro_torch.bridge import init_params
    from repro_torch.models.model import decode_step, params_to, prefill
    from repro_torch.serving.sampler import greedy

    cfg2 = dataclasses.replace(cfg, num_layers=layers)
    on_card = init_params(cfg2, seed=0, dtype=torch.float32, device=CUDA)
    params = {"cpu": params_to(on_card, "cpu"), CUDA: on_card}
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, prompt_len)
                           + frames_of(cfg)).astype(np.int32)
    pe = rng.standard_normal((4, prefix_len, cfg.d_model)).astype(
        np.float32) if prefix_len else None
    runs = []
    for dev in ("cpu", CUDA):
        p = params.pop(dev)
        lg, cache, _ = prefill(cfg2, p, torch.as_tensor(prompts, device=dev),
                               cache_len=cache_len, capacity_factor=8.0,
                               prefix_embeds=None if pe is None
                               else torch.as_tensor(pe, device=dev))
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
        del p, cache
    (lc, tc), (lg_, tg) = runs
    if not torch.isfinite(lg_[..., :cfg.vocab_size]).all():
        fail(f"parity {cfg.name}: non-finite logits on the GPU")
    err = max_err(lc, lg_)
    same = bool((tc == tg).all())
    log(f"parity {cfg.name}: {layers} layers f32, prefill 4x{prompt_len} "
        f"(prefix {prefix_len}, frames {frames_of(cfg)}) + 8 "
        f"decode steps: tokens equal={same}, max |logit diff|={err:.3e} "
        f"(tol {PARITY_LOGIT_TOL})")
    if not same or err > PARITY_LOGIT_TOL:
        fail(f"parity {cfg.name}: CPU and GPU disagree")
    return dict(tokens_equal=same, max_abs_logit_diff=err, layers=layers)


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
            "ssd_scan": 0, "grouped_ffn_bwd": 0, "ssd_scan_bwd": 0,
            "moe_ffn_bwd": 0}


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
              policies, expect=None, requests: int = 8,
              capacity_factor: float = 8.0, params=None):
    """Engine.generate, continuous batching, ``requests`` requests, under
    each policy, the engine at ``capacity_factor``, on ``params`` (bf16
    weights drawn from seed 0 on the card when None). The launch counters
    are set to 0 just before each policy's continuous run and read just
    after it; the lockstep run and the
    prefill check lie outside that window. Every kernel in ``kernels``
    must have launched; ``expect(engine)`` gives exact counts to hold.
    Each policy's result holds a replayed decode step's wall and device
    time (replayed_step_ms) on the state its warm run left."""
    from repro_torch import kernels as K
    from repro_torch.bridge import init_params, param_count
    from repro_torch.models.model import prefill
    from repro_torch.serving import Engine

    if params is None:
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CUDA)
    log(f"main path: {cfg.name} {cfg.num_layers} layers, "
        f"{param_count(params) / 1e9:.3f} B parameters, bf16")
    frames = frames_of(cfg)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(requests, prompt_len) + frames
    ).astype(np.int32)
    results, tokens = {}, {}
    for pol in policies:
        eng = Engine(cfg, params, policy=pol, cache_len=cache_len,
                     capacity_factor=capacity_factor, device=CUDA)
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
            if cont.shape != (requests, new) + frames or \
                    st.new_tokens != cont.size or \
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
        if lg.shape != (requests,) + frames + (cfg.padded_vocab,) or \
                not torch.isfinite(lg[..., :cfg.vocab_size]).all():
            fail(f"main path {cfg.name} ({pol.mode}): bad prefill logits")
        res = dict(tokens_per_s=st.new_tokens / wall, wall_s=wall,
                   tokens_per_s_warm=wst.new_tokens / wall_warm,
                   wall_s_warm=wall_warm, capture_s=st.capture_s,
                   launches=counts, prompt_len=prompt_len, new_tokens=new,
                   requests=requests, tokens_per_request=st.new_tokens
                   // requests)
        msg = ""
        if cfg.moe is not None:
            res.update(activated_experts=st.mean_aux("activated_experts"),
                       selected_set=st.mean_aux("selected_set"))
            msg = (f", activated experts per layer "
                   f"{res['activated_experts']:.2f}")
        with torch.no_grad():
            res["replayed_step"] = replayed_step_ms(eng, eng.decode_chunk)
        results[pol.mode] = res
        tokens[pol.mode] = cont
        log(f"main path {cfg.name} policy={pol.mode}: continuous == "
            f"lockstep, {st.new_tokens} tokens in {wall:.3f} s = "
            f"{res['tokens_per_s']:.1f} tokens/s cold (capture "
            f"{st.capture_s:.3f} s), {wall_warm:.3f} s = "
            f"{res['tokens_per_s_warm']:.1f} tokens/s warm{msg}")
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


def moe_expect(cfg, new: int, decode: str = "moe_ffn"):
    """Exact launches of an MoE continuous run: one prefill of all the
    requests (grouped_ffn once per layer), then decode_chunk steps a
    round until the last of the new-1 tokens after the first
    (decode_attention and the ``decode`` kernel, moe_ffn on the dense
    path or grouped_ffn on the sorted one, once per layer per step)."""
    def expect(eng):
        steps = -(-(new - 1) // eng.decode_chunk) * eng.decode_chunk
        L = cfg.num_layers
        out = {"ssd_scan": 0, "grouped_ffn": L, "moe_ffn": 0,
               "decode_attention": L * steps}
        out[decode] += L * steps
        return out
    return expect


def gpt_oss_served(cfg):
    """gpt-oss-120b-proxy at its own widths cut to GPT_OSS_LAYERS layers,
    through Engine.generate as granite's main path runs (8 x 128
    prompts, 32 new, cache 512, bf16, random weights from seed 0): the
    engine at GPT_OSS_CF under policy off and batch (k0 1, m_l 8),
    decode on moe_ffn, then at the engine's default ENGINE_CF under
    policy off, decode on grouped_ffn (the same function: neither path
    drops a token). Exact launches (moe_expect), the batch policy
    activating fewer experts per layer per decode step than off (under a
    random router), and each run's replayed decode step beside
    launch/roofline.py's one-card bound of that step (model_shards 1).
    Returns (runs, the phase's own record, params, prompts)."""
    import gc

    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.moe import OFF

    cut = dataclasses.replace(cfg, num_layers=GPT_OSS_LAYERS)
    batch = XSharePolicy(mode="batch", k0=1, m_l=8)
    runs, params, prompts, toks = main_path(
        cut, kernels=("grouped_ffn", "moe_ffn", "decode_attention"),
        prompt_len=128, new=32, cache_len=512, policies=(OFF, batch),
        expect=moe_expect(cut, 32), capacity_factor=GPT_OSS_CF)
    gc.collect()                # the first engines' captured graphs
    torch.cuda.empty_cache()
    sorted_runs, _, _, sorted_toks = main_path(
        cut, kernels=("grouped_ffn", "decode_attention"), prompt_len=128,
        new=32, cache_len=512, policies=(OFF,),
        expect=moe_expect(cut, 32, decode="grouped_ffn"),
        capacity_factor=ENGINE_CF, params=params)
    runs["off sorted"] = sorted_runs["off"]
    # bf16 sums in another order: greedy tokens may part after a near tie
    same = float((sorted_toks["off"] == toks["off"]).mean())
    act = {p: runs[p]["activated_experts"] for p in runs}
    log(f"main path {cfg.name}: mean activated experts per layer per "
        f"decode step (random router) off {act['off']:.3f}, batch "
        f"{act['batch']:.3f}, off at capacity_factor {ENGINE_CF} "
        f"{act['off sorted']:.3f}; its tokens equal to off's at "
        f"{GPT_OSS_CF}: {same:.4f}")
    if not act["batch"] < act["off"]:
        fail(f"main path {cfg.name}: batch activates {act['batch']} "
             f"experts, off {act['off']}")
    record = dict(
        reduced={"num_layers": [cfg.num_layers, GPT_OSS_LAYERS],
                 "why": "36 layers take 233.6 GB in bf16; 8 take 53.7 GB "
                        "of one card's 80"},
        capacity_factor={"off": GPT_OSS_CF, "batch": GPT_OSS_CF,
                         "off sorted": ENGINE_CF},
        why_capacity_factor="a path selector, not a change of the function "
                            "(neither path drops a token): E / k = 32 puts "
                            "decode on moe_ffn, the default 8 on grouped_ffn",
        sorted_tokens_equal_share=same, activated_experts=act,
        router="random weights from seed 0",
        roofline=served_decode_roofline(cut, runs, (OFF, batch)))
    record["roofline"].update(step_roofline(cut, [(
        "decode off sorted", served_decode(), OFF,
        runs["off sorted"]["replayed_step"])]))
    return runs, record, params, prompts


def step_roofline(cfg, cases):
    """launch/roofline.py's one-card bound (model_shards 1: the experts on
    one shard) of each (name, ShapeConfig, policy, measured step) case,
    beside the measured step's wall and device busy ms. Printed, not
    held."""
    from repro_torch.launch import roofline as R

    roof = {}
    for name, shape, pol, measured in cases:
        nbytes = R.analytic_bytes(cfg, shape, policy=pol, num_devices=1,
                                  model_shards=1)
        flops = R.analytic_flops(cfg, shape)
        t = R.roofline_terms(flops, nbytes, 0.0)
        bound = max(t["compute_s"], t["memory_s"]) * 1e3
        busy = measured["device_busy_ms"]
        roof[name] = dict(
            bytes=nbytes, flops=flops, memory_ms=t["memory_s"] * 1e3,
            compute_ms=t["compute_s"] * 1e3, bound_ms=bound,
            bound_by=t["dominant"], measured_wall_ms=measured["wall_ms"],
            measured_device_busy_ms=busy,
            share_of_wall=bound / measured["wall_ms"],
            share_of_busy=bound / busy if isinstance(busy, float)
            else "not measured")
        log(f"roofline {cfg.name} {cfg.num_layers} layers {name} (one "
            f"card, model_shards 1): {json.dumps(roof[name])}")
    return roof


def served_decode():
    """The shape of a served decode step: 8 rows, a cache of 512."""
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(name="served decode", seq_len=512, global_batch=8,
                       kind="decode", cache_len=512)


def served_decode_roofline(cfg, runs, policies):
    """step_roofline of the served bf16 decode step under each policy
    beside the main path's replayed step of that policy."""
    return step_roofline(cfg, [(f"decode {p.mode}", served_decode(), p,
                                runs[p.mode]["replayed_step"])
                               for p in policies])


# ----------------------------------------------------- families phase ---

def frames_of(cfg) -> tuple:
    """The trailing shape of one token: (K,) codebooks for the audio
    family, () for the others."""
    return (cfg.num_codebooks,) if cfg.family == "audio" else ()


def decode_step_ms(eng, prompts, pe, steps: int = 5):
    """Host wall of one eager decode step as the lockstep loop runs it
    (decode_step, the greedy pick, its read to the host), median of
    ``steps`` after a prefill of ``prompts`` after ``pe``."""
    from repro_torch.serving.sampler import greedy
    lg, cache, _ = eng._prefill(eng.params,
                                torch.as_tensor(prompts, device=CUDA), pe)
    tok = greedy(lg)
    walls = []
    for _ in range(steps + 1):            # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, _ = eng._decode(eng.params, tok[:, None], cache)
        tok = greedy(lg[:, -1])
        tok.cpu()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls[1:])) * 1e3


def prefix_generate(eng, prompts, pe, new: int):
    """Engine.generate with prefix embeddings (the lockstep loop), the
    launch counters set to 0 just before and read just after. Returns
    (tokens, stats, wall s, launches)."""
    from repro_torch import kernels as K
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    toks, st = eng.generate(prompts, new, prefix_embeds=pe)
    torch.cuda.synchronize()
    return toks, st, time.perf_counter() - t0, K.launch_counts()


def check_prefix_run(name, cfg, toks, st, counts, *, requests, new):
    """A prefix run's gates: tokens of the expected shape in the
    vocabulary, new_tokens counting K per frame, decode_attention once
    per layer per decode step (new - 1 of them) and no other kernel."""
    shape = (requests, new) + frames_of(cfg)
    want = {"decode_attention": cfg.num_layers * (new - 1),
            "grouped_ffn": 0, "moe_ffn": 0, "ssd_scan": 0}
    wrong = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if toks.shape != shape or st.new_tokens != toks.size or \
            toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"families {name}: tokens {toks.shape} (want {shape}), "
             f"new_tokens {st.new_tokens}, range {toks.min()}..{toks.max()}")
    if wrong:
        fail(f"families {name}: launches (counted, expected) {wrong}")


def vlm_served(cfg, *, requests=8, new=FAMILY_NEW, cache_len=512):
    """paligemma-3b at full width, bf16, random weights from seed 0:
    ``requests`` requests of FAMILY_PREFIX N(0, 1) prefix embeddings
    (a torch.Generator, seed 0) and FAMILY_PROMPT prompt tokens through
    Engine.generate(prompts, new, prefix_embeds=pe), the lockstep loop,
    twice. Gates: the first token is the argmax of forward(...,
    prefix_embeds=pe) at the last position; decode_attention launched
    exactly num_layers x (new - 1) times a call; both calls' tokens
    equal."""
    from repro_torch.bridge import init_params, param_count
    from repro_torch.models.model import forward
    from repro_torch.serving import Engine
    from repro_torch.serving.sampler import greedy

    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CUDA)
    g = torch.Generator(device=CUDA)
    g.manual_seed(0)
    pe = torch.randn((requests, FAMILY_PREFIX, cfg.d_model), generator=g,
                     device=CUDA).to(torch.bfloat16)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(requests, FAMILY_PROMPT)).astype(np.int32)
    eng = Engine(cfg, params, cache_len=cache_len, device=CUDA)
    runs = [prefix_generate(eng, prompts, pe, new) for _ in range(2)]
    for toks, st, _, counts in runs:
        check_prefix_run(cfg.name, cfg, toks, st, counts,
                         requests=requests, new=new)
    (toks, st, wall, counts), (toks2, _, wall2, _) = runs
    if not np.array_equal(toks, toks2):
        fail(f"families {cfg.name}: a second call gave other tokens")
    with torch.no_grad():
        lg, _ = forward(cfg, eng.params, torch.as_tensor(prompts,
                                                         device=CUDA),
                        prefix_embeds=pe)
    first = greedy(lg[:, -1]).cpu().numpy()
    if lg.shape[1] != FAMILY_PREFIX + FAMILY_PROMPT or \
            not np.array_equal(first, toks[:, 0]):
        fail(f"families {cfg.name}: first tokens {toks[:, 0]} != the "
             f"argmax of forward's last position {first}")
    with torch.no_grad():
        step_ms = decode_step_ms(eng, prompts, pe)
    res = dict(tokens_per_s=st.new_tokens / wall, wall_s=wall,
               tokens_per_s_second=st.new_tokens / wall2,
               wall_s_second=wall2, decode_step_wall_ms=step_ms,
               launches=counts, requests=requests, prefix_len=FAMILY_PREFIX,
               prompt_len=FAMILY_PROMPT, new_tokens=new,
               params_b=param_count(params) / 1e9)
    log(f"families {cfg.name}: {json.dumps(res)}")
    return res


def audio_served(cfg, *, requests=8, new=FAMILY_NEW, cache_len=512):
    """musicgen-large at full width, bf16: main_path's gates over frames
    of num_codebooks (continuous (replayed graphs) == lockstep (eager),
    cold and warm, decode_attention once per layer per decode step,
    new_tokens counting K per frame), a replayed step's wall and device
    time; then once more with cfg.prefix_len N(0, 1) conditioning
    embeddings through the lockstep loop: shape and launches."""
    from repro_torch.models.moe import OFF
    from repro_torch.serving import Engine

    res, params, prompts, _ = main_path(
        cfg, kernels=("decode_attention",), prompt_len=FAMILY_PROMPT,
        new=new, cache_len=cache_len, policies=(OFF,),
        expect=dense_expect(cfg, new), requests=requests)
    eng = Engine(cfg, params, cache_len=cache_len, device=CUDA)
    g = torch.Generator(device=CUDA)
    g.manual_seed(0)
    pe = torch.randn((requests, cfg.prefix_len, cfg.d_model), generator=g,
                     device=CUDA).to(torch.bfloat16)
    toks, st, wall, counts = prefix_generate(eng, prompts, pe, new)
    check_prefix_run(f"{cfg.name} prefix", cfg, toks, st, counts,
                     requests=requests, new=new)
    res["prefix"] = dict(tokens_per_s=st.new_tokens / wall, wall_s=wall,
                         launches=counts, prefix_len=cfg.prefix_len)
    log(f"families {cfg.name}: {json.dumps(res)}")
    del params, eng
    return res


# --------------------------------------- f8 cache at decode_32k phase ---

F8_STEPS = 8        # greedy decode steps at the served batch
F8_GATE_ROWS = 2    # rows of the e4m3 vs dequantized-bf16 gate
MEM_SHARE = 0.9     # of the card's memory a plan may fill


def fill_f8_cache(cfg, B: int, C: int, g, cur: int):
    """init_cache's e4m3 cache for B rows of C slots, K and V filled
    layer by layer and row by row with N(0, 1) drawn in bf16 from ``g``
    and rounded to e4m3 by the copy (no temporary larger than one row of
    one layer); cur_len ``cur`` for every row."""
    from repro_torch.models import init_cache
    cache = init_cache(cfg, B, C, F8, device=CUDA)
    for key in ("kv_k", "kv_v"):
        t = cache[key]
        for layer in range(t.shape[0]):
            for b in range(B):
                t[layer, b].copy_(torch.randn(
                    t.shape[2:], generator=g, device=CUDA,
                    dtype=torch.bfloat16))
    cache["cur_len"].fill_(cur)
    return cache


def f8_cache_phase(cfg):
    """musicgen-large at decode_32k's cache length (33 280 slots) on one
    card with an e4m3 cache, the planning experiments' regime.

    The dry run's records (launch/dryrun.lower_one on make_host_mesh())
    with a bf16 and an e4m3 cache give the largest batch each allows in
    MEM_SHARE of the card's memory (the weights plus that many rows of
    cache). At the e4m3 batch: the cache built by init_cache and filled
    from a seeded generator, cur_len 32768, F8_STEPS greedy steps through
    launch/serve.make_serve_step with the full-width bf16 weights, each
    timed by CUDA events; decode_attention's share of a profiled step;
    the peak memory against the served batch's record (params_gb +
    cache_gb); the record's byte bound of the step; tokens/s counting
    the K codebooks of a frame. Launches exact: decode_attention once a
    layer a step, nothing else. Then decode_attention's e4m3 instance on
    the served cache's first layer at the batch and lengths the steps
    gave it (``e4m3_case``: against its plain version at TOL and f32
    math at EXACT_BF16, timed), and the gate (``f8_gate``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.bridge import init_params
    from repro_torch.configs.shapes import get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import make_serve_step

    shape = get_shape("decode_32k")
    mesh = make_host_mesh()
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    budget = MEM_SHARE * total_gb
    recs, rows = {}, {}
    for name, dt in (("bfloat16", None), ("float8_e4m3fn", F8)):
        rec = dryrun.lower_one(cfg, shape, mesh, cache_dtype=dt)
        an = rec["analytic"]
        rows[name] = int((budget - an["params_gb"])
                         // (an["cache_gb"] / shape.global_batch))
        recs[name] = rec
        log(f"f8 cache: record ({name} cache) {dryrun.record_line(rec)} "
            f"{json.dumps(an)}; at most {rows[name]} rows in "
            f"{MEM_SHARE} x {total_gb:.2f} GB")
    B = rows["float8_e4m3fn"]
    served = dryrun.lower_one(cfg, dataclasses.replace(shape, global_batch=B),
                              mesh, cache_dtype=F8)
    want_gb = served["analytic"]["params_gb"] + served["analytic"]["cache_gb"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=CUDA)
    g.manual_seed(3280)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CUDA)
    t0 = time.perf_counter()
    cache = fill_f8_cache(cfg, B, DECODE_32K_CACHE, g, 32768)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    step = make_serve_step(cfg)
    tok = torch.randint(0, cfg.vocab_size, (B, 1) + frames_of(cfg),
                        generator=g, device=CUDA, dtype=torch.int32)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    step_ms = []
    for _ in range(F8_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache, _ = step(params, tok, cache)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    counts = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in counts}
    want["decode_attention"] = cfg.num_layers * F8_STEPS
    if counts != want:
        fail(f"f8 cache musicgen: launches {counts}, want {want}")
    if not bool(torch.isfinite(logits.float()).all()) or \
            int(cache["cur_len"].min()) != 32768 + F8_STEPS:
        fail("f8 cache musicgen: non-finite logits or cur_len off")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, tok, cache)
        torch.cuda.synchronize()
    kern = cuda_kernels(prof)
    dev_us = sum(e.self_device_time_total for e in kern)
    attn_us = sum(e.self_device_time_total for e in kern
                  if e.key.replace("(anonymous namespace)::", "")
                  .removeprefix("void ").startswith(
                      ("decode_split_kernel", "decode_merge_kernel")))
    med = float(np.median(step_ms))
    bound = served["memory_s"] * 1e3
    frames = B * F8_STEPS
    res = dict(
        rows=rows, predicted_rows={"bfloat16": 5, "float8_e4m3fn": 10},
        batch=B, cache_len=DECODE_32K_CACHE, cur_len=32768,
        steps=F8_STEPS, step_ms=step_ms, step_ms_median=med,
        bound_ms=bound, bound_by=served["dominant"],
        step_over_bound=med / bound, decode_attention_share=attn_us / dev_us,
        device_ms_profiled_step=dev_us / 1e3,
        kernels_profiled_step=sum(e.count for e in kern),
        peak_gb=peak_gb, record_state_gb=want_gb,
        tokens_per_s=frames * cfg.num_codebooks / (sum(step_ms) / 1e3),
        fill_s=fill_s, launches=counts,
        records={n: {k: r[k] for k in ("mesh", "devices", "analytic",
                                       "memory_s", "compute_s",
                                       "dominant", "trace_s")}
                 for n, r in recs.items()})
    log(f"f8 cache musicgen-large decode_32k: {B} rows x "
        f"{DECODE_32K_CACHE} slots (e4m3), step {med:.3f} ms median of "
        f"{F8_STEPS} ({[round(x, 3) for x in step_ms]}), bound "
        f"{bound:.3f} ms ({served['dominant']}), step / bound "
        f"{med / bound:.3f}; decode_attention {attn_us / dev_us:.3f} of "
        f"the profiled step's {dev_us / 1e3:.3f} device ms; peak "
        f"{peak_gb:.3f} GB against the record's {want_gb:.3f}; "
        f"{res['tokens_per_s']:.1f} tokens/s ({cfg.num_codebooks} "
        f"codebooks a frame); launches {counts}")
    # decode_attention's e4m3 instance against its plain version at the
    # shape the path gave it: the served cache's first layer, all B
    # rows, the lengths of the last step's read
    q = torch.randn((B, 1, cfg.attn.num_heads, cfg.attn.head_dim),
                    generator=g, device=CUDA).to(torch.bfloat16)
    last = 32768 + F8_STEPS - 1
    res["served_kernel_case"] = e4m3_case(
        f"{cfg.name} served", q, cache["kv_k"][0], cache["kv_v"][0],
        torch.full((B,), last, dtype=torch.int32, device=CUDA),
        f"cur_len {last} (the last timed step's read)")
    if not res["served_kernel_case"]["ok"]:
        fail(f"f8 cache: decode_attention's e4m3 instance disagrees with "
             f"its plain version on the served cache: "
             f"{res['served_kernel_case']}")
    del cache, logits, q
    torch.cuda.empty_cache()

    # the gate: e4m3 vs bf16 on the dequantized copy, same tokens
    res.update(f8_gate(cfg, params, step, g))
    del params
    torch.cuda.empty_cache()
    return res


def f8_gate(cfg, params, step, g) -> dict:
    """F8_GATE_ROWS rows of an e4m3 cache at decode_32k's length, stepped
    F8_STEPS times on the same (teacher-forced) tokens beside three
    references, each on its own cache.

    The gate: a bf16 copy dequantized from it whose cache writes round
    each new K / V row through e4m3 first holds the same cache values as
    the e4m3 run at every step, so its logits must be bit-equal: the
    e4m3 instance reads what the bf16 instance reads, in the same order.

    Printed, not gated: (a) a bf16 copy that writes its new rows in
    bf16, as a bf16 cache does (the comparison the plan first gated at
    TOL); its logits differ from the e4m3 run's by the rounding of each
    step's own row, carried through 48 bf16 layers. (b) The witness of
    that gap's size: the e4m3 run again with decode_attention's plain
    version in place of the kernel (the same cache values, another
    order of summation). If (b)'s gap is of (a)'s order, TOL is below
    what any change of rounding gives at this depth, and (a) says
    nothing about the kernel. On the CPU at 48 bf16 layers of reduced
    width, JAX's own e4m3 and bf16 paths differ by the same order as the
    port's (tests/test_torch_planning.py::
    test_f8_cache_gap_to_a_bf16_cache)."""
    from repro_torch.kernels import decode_attention_cached_plain
    from repro_torch.models import attention as A

    def fresh():
        g.manual_seed(3281)
        c8 = fill_f8_cache(cfg, F8_GATE_ROWS, DECODE_32K_CACHE, g, 32768)
        tok = torch.randint(0, cfg.vocab_size,
                            (F8_GATE_ROWS, 1) + frames_of(cfg),
                            generator=g, device=CUDA, dtype=torch.int32)
        return c8, tok

    def plain_attention(q, k, v, cur, *, window=None):
        return decode_attention_cached_plain(q, k, v, cur, window=window)

    # (b) first, on its own two e4m3 caches: the kernel's run and the
    # plain version's
    c8, tok = fresh()
    cp = {k: v.clone() for k, v in c8.items()}
    kernel_attention = A.decode_attention_cached
    plain_errs, scale = [], []
    for _ in range(F8_STEPS):
        l8, c8, _ = step(params, tok, c8)
        A.decode_attention_cached = plain_attention
        try:
            lp, cp, _ = step(params, tok, cp)
        finally:
            A.decode_attention_cached = kernel_attention
        plain_errs.append(max_err(l8, lp))
        scale.append(float(l8.float().abs().max()))
        tok = l8[:, -1].argmax(-1)[:, None].to(torch.int32)
    del c8, cp
    torch.cuda.empty_cache()

    # the gate and (a), from the same cache and first token
    c8, tok = fresh()
    cr = {k: v.clone() if k == "cur_len" else v.to(torch.bfloat16)
          for k, v in c8.items()}
    cb = {k: v.clone() for k, v in cr.items()}
    write = A.update_cache

    def rounded(cache, new, cur_len, *, window=None):
        return write(cache, new.to(F8).to(new.dtype), cur_len, window=window)
    equal, errs, oks = [], [], []
    for _ in range(F8_STEPS):
        l8, c8, _ = step(params, tok, c8)
        A.update_cache = rounded
        try:
            lr, cr, _ = step(params, tok, cr)
        finally:
            A.update_cache = write
        lb, cb, _ = step(params, tok, cb)
        equal.append(bool(torch.equal(l8, lr)))
        errs.append(max_err(l8, lb))
        oks.append(close(l8, lb, torch.bfloat16))
        tok = l8[:, -1].argmax(-1)[:, None].to(torch.int32)
    log(f"f8 cache gate ({F8_GATE_ROWS} rows, {F8_STEPS} steps): e4m3 step "
        f"== bf16 step on the dequantized cache with e4m3-rounded writes, "
        f"bit for bit: {equal}; against bf16 writes, logits max abs err "
        f"{[f'{e:.3g}' for e in errs]} (TOL {TOL[torch.bfloat16]}, within: "
        f"{oks}); the witness, e4m3 step with decode_attention's plain "
        f"version against the kernel's, logits max abs err "
        f"{[f'{e:.3g}' for e in plain_errs]}; logits max abs "
        f"{[f'{x:.3g}' for x in scale]}")
    if not all(equal):
        fail(f"f8 cache gate: the e4m3 step's logits differ from the bf16 "
             f"step's on the same cache values: {equal}")
    del c8, cr, cb
    return dict(gate_rows=F8_GATE_ROWS, gate_bit_equal=equal,
                gate_bf16_writes_max_abs_err=errs,
                gate_bf16_writes_within_tol=oks,
                witness_plain_attention_max_abs_err=plain_errs,
                logits_max_abs=scale)


# ------------------------------------------------------ dryrun phase ---

def dryrun_phase() -> dict:
    """``python -m repro_torch.launch.dryrun --all`` (10 archs x 4 shapes x
    2 production meshes, traced on meta in parallel processes: host work
    only) into a temporary file; prints the number traced and report.py's
    tables, and fails on any combination that does not trace."""
    import os
    import tempfile

    from repro_torch.launch import report
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--out", str(out)],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        recs = json.loads(out.read_text()) if out.exists() else []
    if proc.returncode != 0 or len(recs) != 80:
        fail(f"dryrun --all: exit {proc.returncode}, {len(recs)} of 80 "
             f"traced:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    log(f"dryrun --all: {len(recs)} of 80 traced in {wall:.1f} s "
        f"({os.cpu_count()} cores); slowest traces "
        f"{sorted((r['trace_s'], r['arch'], r['shape'], r['mesh']) for r in recs)[-3:]}")
    log("## Dry-run records\n" + report.dryrun_table(recs))
    log("## Roofline (single-pod)\n" + report.roofline_table(recs))
    return dict(traced=len(recs), wall_s=wall, cores=os.cpu_count(),
                trace_s_total=sum(r["trace_s"] for r in recs))


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


# ------------------------------------------------------------ EP phases ---

EP_SHARDS = 8          # the paper's and BENCH_ep.json's G = 8
DS = "deepseek-r1-proxy"
# benchmarks/table2_ep.py's measured setting: block_t, the verify shape's
# L_s, hot-expert replication
EP_BLOCK_T, EP_SPEC_LS, EP_REPLICATE_HOT, EP_MAX_REPLICAS = 8, 3, 1, 2


class RecordingEP:
    """Stands in for an EPExecutor under ep_context: records each MoE
    layer call's inputs and answers with the executor's ffn."""

    def __init__(self, ex):
        self.ex, self.calls = ex, []

    def ffn(self, *args):
        self.calls.append(args)
        return self.ex.ffn(*args)


def ep_block_t(ex, T: int, k: int) -> int:
    """The block_t ``ex.ffn`` uses on T tokens of top-k (max_rows None:
    the worst case M = T / S · k)."""
    from repro_torch.models.dispatch import default_block_t
    S = ex.placement.num_shards
    return ex.block_t or default_block_t(S * (-(-T // S) * k),
                                         ex.placement.expert_cap)


def ep_layer_stats(cfg, params, prompts, ex, pol, *, cache_len: int):
    """EPStats of ``ex`` on the routing of one eager decode step's MoE
    layers (recorded under ep_context), with one layer's EP output held
    bit-equal to sorted_expert_ffn at the executor's block_t (and
    compared at the sorted path's own), and the EP prefill layer's
    grouped_ffn call held against its plain version at TOL."""
    from repro_torch import ep as EP
    from repro_torch.kernels import grouped_ffn
    from repro_torch.models.dispatch import default_block_t, sorted_expert_ffn
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.sampler import greedy

    toks = torch.as_tensor(prompts, device=CUDA)
    pre = RecordingEP(ex)
    with EP.ep_context(pre):
        lg, cache, _ = prefill(cfg, params, toks, cache_len=cache_len,
                               capacity_factor=8.0, dispatch="ep")
    # the prefill's layer at each path's own block_t (EP's from S·M and
    # expert_cap, sorted's from T·k and E): reported, not a gate
    x, _, _, _, idx, _ = pre.calls[0]
    prefill_bt = (ep_block_t(ex, x.shape[0], idx.shape[1]),
                  default_block_t(x.shape[0] * idx.shape[1], ex.placement
                                  .num_experts))
    prefill_same = torch.equal(ex.ffn(*pre.calls[0]),
                               sorted_expert_ffn(*pre.calls[0]))
    # the EP prefill's grouped_ffn call (mostly invalid tiles, tile_eid
    # in placement order) against its plain version: a gate
    xs, plan, _ = ep_grouped_call(ex, pre.calls[0])
    bt_p = plan.block_t
    _, w1, w3, w2, _, _ = pre.calls[0]
    prefill_kernel = grouped_gate(
        f"ep {cfg.name} prefill layer 0",
        grouped_ffn(xs, w1, w3, w2, plan.tile_eid, plan.tile_valid,
                    block_t=bt_p),
        grouped_plain(xs, w1, w3, w2, plan.tile_eid, plan.tile_valid,
                      block_t=bt_p), plan.tile_valid, bt_p)
    prefill_kernel.update(block_t=bt_p)
    del xs, plan
    rec = RecordingEP(ex)
    with EP.ep_context(rec):
        decode_step(cfg, params, greedy(lg)[:, None], cache, policy=pol,
                    capacity_factor=8.0, dispatch="ep")
    if len(rec.calls) != cfg.num_layers:
        fail(f"ep: a decode step made {len(rec.calls)} EP layer calls, "
             f"want {cfg.num_layers}")
    x, w1, w3, w2, idx, w = rec.calls[0]
    bt = ep_block_t(ex, x.shape[0], idx.shape[1])
    y = ex.ffn(*rec.calls[0])
    if not torch.equal(y, sorted_expert_ffn(*rec.calls[0], block_t=bt)):
        fail(f"ep: layer 0's EP output != sorted_expert_ffn at block_t "
             f"{bt}")
    same_default = torch.equal(y, sorted_expert_ffn(*rec.calls[0]))
    peaks, rows, a2a, active = [], [], [], []
    for call in rec.calls:
        _, st = ex(*call)
        peaks.append(st.peak_tile_rows)
        rows.append(st.peak_rows)
        a2a.append(st.total_a2a_bytes)
        i, g = call[4], call[5]
        active.append(int(torch.unique(i[(i >= 0) & (g != 0)]).numel()))
    return dict(peak_tile_rows=float(np.mean(peaks)),
                peak_computed_rows=float(np.mean(rows)),
                a2a_bytes=float(np.mean(a2a)),
                activated_experts=float(np.mean(active)),
                layer_bit_equal_sorted_block_t=bt,
                layer_bit_equal_at_sorted_default_block_t=same_default,
                prefill_block_t_ep_sorted=prefill_bt,
                prefill_layer_bit_equal_at_defaults=prefill_same,
                prefill_layer_grouped_ffn_vs_plain=prefill_kernel)


def replayed_step_ms(eng, steps: int):
    """Wall (host clock, median of 5) and device time (CUDA events;
    torch.profiler's busy time, the port's kernels' share and the top
    kernels) of a decode step replayed from the
    captured loop of the engine's newest running batch, on the state its
    last generate left."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.step import NO_FAULT
    state = eng.loops.states()[-1]
    loop = state.loops[0]
    rem = np.full(state.tensors["tok"].shape[0], 1000, np.int32)
    walls, events = [], []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        loop(remaining=rem, fault=NO_FAULT)
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop(remaining=rem, fault=NO_FAULT)
        torch.cuda.synchronize()
    kern = cuda_kernels(prof)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=float(np.median(walls)) * 1e3 / steps,
                events_ms=float(np.median(events)) / steps,
                device_busy_ms=busy if kern else "not measured",
                kernels_per_step=sum(e.count for e in kern) / steps
                if kern else "not measured",
                port_kernels_ms=port_kernels_ms(kern, steps),
                top=[dict(name=e.key[:60], ms=e.self_device_time_total
                          / 1e3 / steps, calls=e.count / steps)
                     for e in top])


def ep_serve_phase(cfg, params, prompts, *, new=32, cache_len=512):
    """Engine(dispatch="ep") under an 8-shard EPExecutor at full width,
    three settings: policy off on the contiguous placement; Algorithm 6
    on plan_placement from the prompts' gate histogram; the same with
    the hottest expert replicated twice and update_placement between two
    generate calls. Gates: tokens equal dispatch="sorted"'s under the
    same policy and the EP lockstep run's; exact launches (grouped_ffn
    once per MoE layer call, no moe_ffn); one layer bit-equal to
    sorted_expert_ffn; after the update, the next call's tokens, the
    executor's device tables and placement.version are the new ones."""
    from repro_torch import ep as EP
    from repro_torch import kernels as K
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.moe import OFF
    from repro_torch.serving import Engine
    from repro_torch.serving.step import gate_probe

    E, L, S = cfg.moe.num_experts, cfg.num_layers, EP_SHARDS
    B = prompts.shape[0]
    hist = gate_probe(cfg, params, torch.as_tensor(prompts, device=CUDA)) \
        .cpu().numpy().astype(np.float64)
    alg6 = XSharePolicy(mode="ep", k0=1, m_g=2, num_groups=S)
    rep = dict(replicate_hot=EP_REPLICATE_HOT, max_replicas=EP_MAX_REPLICAS)
    settings = {
        "off": (OFF, EP.EPExecutor(S, EP.contiguous_placement(E, S),
                                   device=CUDA)),
        "alg6": (alg6, EP.EPExecutor(S, EP.plan_placement(hist, S),
                                     device=CUDA)),
        "alg6_rep": (alg6, EP.EPExecutor(
            S, EP.plan_placement(hist, S, **rep), device=CUDA, **rep)),
    }

    def timed(eng):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        toks, st = eng.generate(prompts, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return toks, st, wall, K.launch_counts()

    def expect(eng):
        steps = -(-(new - 1) // eng.decode_chunk) * eng.decode_chunk
        return {"grouped_ffn": L * (1 + steps), "moe_ffn": 0,
                "decode_attention": L * steps, "ssd_scan": 0,
                "grouped_ffn_bwd": 0, "ssd_scan_bwd": 0,
                "moe_ffn_bwd": 0}

    out = {}
    for name, (pol, ex) in settings.items():
        res = {"placement_expert_cap": ex.placement.expert_cap,
               "replication_factor": ex.placement.replication_factor}
        tps = {}
        ref = None
        for dispatch in ("sorted", "auto"):
            eng = Engine(cfg, params, policy=pol, dispatch=dispatch,
                         cache_len=cache_len, device=CUDA)
            for temp in ("cold", "warm"):
                toks, _, wall, _ = timed(eng)
                tps[f"{dispatch} {temp}"] = B * new / wall
            if dispatch == "sorted":
                ref = toks
            else:
                res["auto_tokens_equal_sorted"] = bool(
                    np.array_equal(toks, ref))
            del eng
        eng = Engine(cfg, params, policy=pol, dispatch="ep",
                     cache_len=cache_len, device=CUDA)
        with EP.ep_context(ex):
            lock, _ = eng.generate(prompts, new, lockstep=True)
            runs = [timed(eng) for _ in ("cold", "warm")]
        for (toks, st, wall, counts), temp in zip(runs, ("cold", "warm")):
            tps[f"ep {temp}"] = B * new / wall
            if not (np.array_equal(toks, ref) and np.array_equal(lock, ref)):
                fail(f"ep {name} ({temp}): tokens != dispatch='sorted''s "
                     f"or the EP lockstep run's")
            wrong = {n: (counts[n], v) for n, v in expect(eng).items()
                     if counts[n] != v}
            if wrong:
                fail(f"ep {name} ({temp}): launches (counted, expected) "
                     f"{wrong}")
        if runs[1][1].capture_s != 0.0:
            fail(f"ep {name}: the warm run captured again")
        res.update(tokens_per_s=tps, launches=runs[0][3],
                   capture_s=runs[0][1].capture_s,
                   activated_experts_served=runs[0][1].mean_aux(
                       "activated_experts"))
        if name == "alg6_rep":
            # a load in which the prompts' coldest expert turns hottest:
            # the planner replicates it, and hysteresis lets it through
            load = hist.copy()
            load[int(np.argmin(hist))] += hist.sum()
            v0, shape0 = ex.placement.version, ex.graph_key()[1:]
            if not ex.update_placement(load):
                fail("ep alg6_rep: update_placement kept the placement")
            with EP.ep_context(ex):
                toks, st, wall, counts = timed(eng)
            new_pl = ex.placement
            tabs_ok = all(np.array_equal(
                ex.tables[n].cpu().numpy(), a) for n, a in (
                ("hosts", new_pl.hosts), ("nhosts", new_pl.nhosts),
                ("local_slot", new_pl.local_slot),
                ("local_eids", np.clip(new_pl.local_eids, 0, E - 1))))
            if new_pl.version != v0 + 1 or not tabs_ok or \
                    not np.array_equal(toks, ref):
                fail(f"ep alg6_rep after update_placement: version "
                     f"{new_pl.version} (was {v0}), tables current "
                     f"{tabs_ok}, tokens equal sorted "
                     f"{np.array_equal(toks, ref)}")
            in_place = ex.graph_key()[1:] == shape0
            if in_place != (st.capture_s == 0.0):
                fail(f"ep alg6_rep: table shape kept {in_place} but "
                     f"capture {st.capture_s} s")
            res["update"] = dict(
                version=new_pl.version, in_place=in_place,
                capture_s=st.capture_s, tokens_per_s=B * new / wall,
                expert_cap=new_pl.expert_cap,
                replication_factor=new_pl.replication_factor)
            res["launches_after_update"] = counts
        res["replayed_step"] = replayed_step_ms(eng, eng.decode_chunk)
        del eng
        res["layer_stats"] = ep_layer_stats(cfg, params, prompts, ex, pol,
                                            cache_len=cache_len)
        res["card"] = gpu_name_power()
        out[name] = res
        log(f"ep {cfg.name} {name}: {json.dumps(res)}")
    return out


def ep_grouped_call(ex, args):
    """The one grouped_ffn call of the EP layer call ``ex(*args)``: its
    rows xs, its plan, and each shard's tile span [t0, t1). The plan's
    tiles follow the (shard, slot) groups, so shard s's tiles are those
    of groups s·cap .. (s+1)·cap - 1, every one valid."""
    _, _, plan, xs, _ = ex._run(*args, None, sync=True)
    S, cap = ex.placement.num_shards, ex.placement.expert_cap
    bt = plan.block_t
    tiles = ((plan.counts.long() + bt - 1) // bt).reshape(S, cap).sum(1)
    end = tiles.cumsum(0).tolist()
    spans = [(e - n, e) for e, n in zip(end, tiles.tolist())]
    return xs, plan, spans


def grouped_plain(xs, w1, w3, w2, tile_eid, tile_valid, *, block_t: int,
                  chunk: int = 16):
    """grouped_ffn_plain on the same inputs, over the valid tiles (an
    invalid tile's rows are zero by its definition), ``chunk`` tiles at
    a time with only their own experts' weights passed in: the plain
    version upcasts every expert it is given to f32, 45 GB at
    DeepSeek-R1's widths."""
    from repro_torch.kernels import grouped_ffn_plain
    d = xs.shape[1]
    ref = torch.zeros_like(xs).view(-1, block_t, d)
    xt = xs.view(-1, block_t, d)
    for c in torch.nonzero(tile_valid).flatten().split(chunk):
        u, inv = torch.unique(tile_eid[c].long(), return_inverse=True)
        ref[c] = grouped_ffn_plain(
            xt[c].reshape(-1, d), w1[u], w3[u], w2[u], inv, tile_valid[c],
            block_t=block_t).view(-1, block_t, d)
    return ref.view(-1, d)


def grouped_gate(label, ys, ref, tile_valid, block_t: int) -> dict:
    """Gate: the kernel's rows within TOL of the plain version's. Returns
    the max abs error beside the reference's rms over the valid tiles'
    rows."""
    dtype = ys.dtype
    live = ref.view(-1, block_t, ref.shape[1])[tile_valid != 0].float()
    res = dict(max_abs_err=max_err(ys, ref), ref_rms=float(
        live.pow(2).mean().sqrt()) if live.numel() else 0.0,
        tol=TOL[dtype], tiles=int(tile_valid.sum()),
        rows=ys.shape[0])
    if not close(ys, ref, dtype):
        fail(f"{label}: grouped_ffn vs grouped_ffn_plain {res}")
    return res


def ep_layer_phase(cfg, *, steps: int = 8, seed: int = 0):
    """The EP executor alone at one MoE layer of the paper's EP model's
    routed experts (E 256, top-8, d 7168, f 2048, bf16: 22.5 GB), with
    benchmarks/table2_ep.py's methods (off: top-8 on the contiguous
    placement; alg6: Algorithm 6, k0 1, m_g 5, on plan_placement from
    step 0's histogram, update_placement between steps; alg6_rep: the
    same with the hottest expert replicated twice) at the decode shape
    (16 tokens) and the verify shape (16 x (1 + 3)), ``steps`` steps
    each. Routing is a random router (seeded) over random rows. Gates:
    every step's y bit-equal to sorted_expert_ffn(block_t=8);
    exchange_counts == count_matrix; count_matrix.sum() == live pairs;
    one grouped_ffn launch per EP layer call; a CPU tensor raises; at
    the last step, the EP call's grouped_ffn (3.76e9-element weights,
    tile_eid in placement order, replicas) and each shard's own tiles
    launched alone within TOL of grouped_ffn_plain."""
    from repro_torch import ep as EP
    from repro_torch import kernels as K
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.kernels import grouped_ffn
    from repro_torch.models.dispatch import sorted_expert_ffn
    from repro_torch.models.moe import OFF, route

    m = cfg.moe
    E, k, d, f = m.num_experts, m.top_k, cfg.d_model, m.d_ff_expert
    S, bt = EP_SHARDS, EP_BLOCK_T
    g = torch.Generator(device=CUDA)
    g.manual_seed(seed)

    def draw(shape, scale):
        return torch.randn(shape, generator=g, device=CUDA,
                           dtype=torch.bfloat16).mul_(scale)
    w1, w3 = draw((E, d, f), d ** -0.5), draw((E, d, f), d ** -0.5)
    w2 = draw((E, f, d), f ** -0.5)
    p = {"wg": draw((d, E), d ** -0.5)}
    wbytes = 3 * E * d * f * 2
    alg6 = XSharePolicy(mode="ep", k0=1, m_g=5, num_groups=S)
    rep = dict(replicate_hot=EP_REPLICATE_HOT, max_replicas=EP_MAX_REPLICAS)
    out = {"expert_weight_gb": wbytes / 1e9}
    launches = {n: 0 for n in K.KERNELS}
    for shape, T in (("dec", 16), ("spec", 16 * (1 + EP_SPEC_LS))):
        xs, routes, hist = [], {"off": [], "x": []}, []
        for _ in range(steps):
            x = draw((T, d), 1.0)
            xs.append(x)
            for side, pol in (("off", OFF), ("x", alg6)):
                idx, w, _, _ = route(p, x, m, pol)
                routes[side].append((idx, w))
            idx, w = routes["x"][-1]
            counts = torch.zeros(E, dtype=torch.float64, device=CUDA)
            counts.index_add_(0, idx.reshape(-1).clamp(min=0).long(),
                              (w.reshape(-1) != 0).double())
            hist.append(counts.cpu().numpy())
        execs = {
            "off": EP.EPExecutor(S, EP.contiguous_placement(E, S),
                                 device=CUDA, block_t=bt),
            "alg6": EP.EPExecutor(S, EP.plan_placement(hist[0], S),
                                  device=CUDA, block_t=bt),
            "alg6_rep": EP.EPExecutor(
                S, EP.plan_placement(hist[0], S, **rep), device=CUDA,
                block_t=bt, **rep)}
        rec = {n: {"tile_peak": [], "row_peak": [], "a2a": []}
               for n in execs}
        for t in range(steps):
            for name, ex in execs.items():
                idx, w = routes["off" if name == "off" else "x"][t]
                if name != "off" and t > 0:
                    ex.update_placement(hist[t])
                args = (xs[t], w1, w3, w2, idx, w)
                K.reset_launch_counts()
                y, st = ex(*args)
                got = K.launch_counts()
                for n, c in got.items():
                    launches[n] += c
                if got["grouped_ffn"] != 1:
                    fail(f"ep {DS} {shape} {name}: {got['grouped_ffn']} "
                         f"grouped_ffn launches in one EP layer call")
                if not torch.equal(y, sorted_expert_ffn(*args, block_t=bt)):
                    fail(f"ep {DS} {shape} {name} step {t}: y != "
                         f"sorted_expert_ffn(block_t={bt})")
                cm = EP.exchange_counts(idx, w, ex.placement)
                live = int(((idx >= 0) & (w != 0)).sum())
                if not np.array_equal(cm, st.count_matrix) or \
                        int(st.count_matrix.sum()) != live:
                    fail(f"ep {DS} {shape} {name} step {t}: counts "
                         f"{cm.sum()} / {st.count_matrix.sum()}, live "
                         f"{live}")
                rec[name]["tile_peak"].append(st.peak_tile_rows)
                rec[name]["row_peak"].append(st.peak_rows)
                rec[name]["a2a"].append(st.total_a2a_bytes)
        try:
            execs["off"].ffn(xs[0].cpu(), w1, w3, w2, *routes["off"][0])
            fail(f"ep {DS}: a CPU tensor reached the executor on the card")
        except ValueError:
            pass
        res = {"tokens": T, "steps": steps, "per_method": rec,
               "rebalances": execs["alg6_rep"].rebalances,
               "rebalances_skipped": execs["alg6_rep"].rebalances_skipped,
               "replication_factor":
                   execs["alg6_rep"].placement.replication_factor}
        res.update(ep_ratios(rec))
        # times at the last step's routing and placements; the EP call's
        # grouped_ffn (every shard's tiles, on the full weights) and each
        # shard's own tiles launched alone, all held against the plain
        # version
        timing = {}
        for name, ex in execs.items():
            idx, w = routes["off" if name == "off" else "x"][-1]
            args = (xs[-1], w1, w3, w2, idx, w)
            rows, plan, spans = ep_grouped_call(ex, args)
            eid, valid = plan.tile_eid, plan.tile_valid
            ref = grouped_plain(rows, w1, w3, w2, eid, valid, block_t=bt)
            label = f"ep {DS} {shape} {name}"
            whole = grouped_gate(label, grouped_ffn(
                rows, w1, w3, w2, eid, valid, block_t=bt), ref, valid, bt)
            shards = []
            for s, (t0, t1) in enumerate(spans):
                if t0 == t1:
                    shards.append(dict(shard=s, tile_rows=0, ms=0.0))
                    continue
                sx, se, sv = rows[t0 * bt:t1 * bt], eid[t0:t1], valid[t0:t1]
                trows = (t1 - t0) * bt
                occ = int(torch.unique(se).numel())
                nbytes = 2 * trows * d * 2 + occ * 3 * d * f * 2
                own = grouped_gate(f"{label} shard {s}", grouped_ffn(
                    sx, w1, w3, w2, se, sv, block_t=bt),
                    ref[t0 * bt:t1 * bt], sv, bt)
                shards.append(dict(
                    shard=s, tile_rows=trows, experts=occ,
                    max_expert=int(se.max()),
                    max_abs_err=own["max_abs_err"], ref_rms=own["ref_rms"],
                    ms=time_ms(lambda: grouped_ffn(
                        sx, w1, w3, w2, se, sv, block_t=bt)),
                    bound_ms=bound_ms(nbytes, 6.0 * trows * d * f,
                                      torch.bfloat16)[0]))
            del rows, ref
            slow = max(shards, key=lambda c: c["ms"])
            timing[name] = dict(
                ep_layer_ms=time_ms(lambda: ex.ffn(*args), iters=10),
                sorted_ms=time_ms(lambda: sorted_expert_ffn(
                    *args, block_t=bt), iters=10),
                slowest_shard_ms=slow["ms"], slowest_shard=slow["shard"],
                slowest_shard_bound_ms=slow.get("bound_ms", 0.0),
                grouped_ffn_vs_plain=whole, shards=shards)
        for name in ("alg6", "alg6_rep"):
            timing[f"slowest_shard_ratio_off_over_{name}"] = \
                timing["off"]["slowest_shard_ms"] / \
                max(timing[name]["slowest_shard_ms"], 1e-9)
        res["timing"] = timing
        res["card"] = gpu_name_power()
        out[shape] = res
        log(f"ep {DS} layer {shape}: {json.dumps(res)}")
    out["launches"] = launches
    del w1, w3, w2
    return out


def ep_ratios(rec) -> dict:
    """benchmarks/table2_ep.py's _ratios: peak tile rows and peak real
    rows of off over each Algorithm 6 method, mean over steps."""
    off_t = np.asarray(rec["off"]["tile_peak"], float)
    off_r = np.asarray(rec["off"]["row_peak"], float)
    res = {}
    for m in ("alg6", "alg6_rep"):
        mt = np.maximum(np.asarray(rec[m]["tile_peak"], float), 1.0)
        res[f"peak_rows_ratio_{m}"] = float((off_t / mt).mean())
        res[f"peak_rows_ratio_{m}_min"] = float((off_t / mt).min())
        res[f"peak_real_rows_ratio_{m}"] = float(
            (off_r / np.maximum(np.asarray(rec[m]["row_peak"], float),
                                1.0)).mean())
    res["a2a_bytes_baseline"] = int(np.mean(rec["off"]["a2a"]))
    res["a2a_bytes_xshare"] = int(np.mean(rec["alg6_rep"]["a2a"]))
    return res


# ------------------------------------------------------- EP ranks phase ---

EP_RANKS = 4           # processes on the one card, over gloo
EP_RANK_STEPS = 4      # steps of each method at each shape, part (a)
EP_RANK_NEW = 32       # part (b)'s new tokens
# Algorithm 6 over the ranks' 4 groups at the 8-group settings' expert
# budgets: 4 x 10 = 8 x 5 (the layer), 4 x 4 = 8 x 2 (granite)
EP_RANK_MG_LAYER, EP_RANK_MG_SERVE = 10, 4


def expert_stacks(eids, d: int, f: int, *, seed: int, device,
                  dtype=torch.bfloat16):
    """w1, w3 (n, d, f) and w2 (n, f, d) of the experts ``eids`` (-1
    reads expert 0, as a cut does), each expert drawn from its own
    generator seeded by (seed, expert): a rank draws exactly its own
    experts, and the whole layer drawn the same way holds the same
    bits."""
    ids = np.clip(np.asarray(eids), 0, None).tolist()
    n = len(ids)
    w1 = torch.empty((n, d, f), dtype=dtype, device=device)
    w3 = torch.empty((n, d, f), dtype=dtype, device=device)
    w2 = torch.empty((n, f, d), dtype=dtype, device=device)
    for j, e in enumerate(ids):
        g = torch.Generator(device=device)
        g.manual_seed(seed * 1_000_003 + e)
        for dst, shape, scale in ((w1, (d, f), d ** -0.5),
                                  (w3, (d, f), d ** -0.5),
                                  (w2, (f, d), f ** -0.5)):
            dst[j] = torch.randn(shape, generator=g, device=device,
                                 dtype=dtype).mul_(scale)
    return w1, w3, w2


def card_bytes(dev) -> int:
    """torch.cuda.memory_allocated once the card is idle (0 off the
    card)."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def ep_rank_methods(E: int, S: int, hist0):
    """benchmarks/table2_ep.py's methods at S shards: name -> (routing
    side, first placement, executor keywords). A rank holds its
    expert_cap experts, so every placement is planned within the even
    split (``max_expert_cap``), the bound a DistEPExecutor plans in."""
    from repro_torch import ep as EP
    rep = dict(replicate_hot=EP_REPLICATE_HOT, max_replicas=EP_MAX_REPLICAS)
    even = dict(max_expert_cap=EP.even_cap(E, S))
    even_rep = dict(max_expert_cap=EP.even_cap(E, S, **rep), **rep)
    return {"off": ("off", EP.contiguous_placement(E, S), even),
            "alg6": ("x", EP.plan_placement(
                hist0, S, max_per_shard=even["max_expert_cap"]), even),
            "alg6_rep": ("x", EP.plan_placement(
                hist0, S, max_per_shard=even_rep["max_expert_cap"], **rep),
                even_rep)}


def ep_rank_layer_inputs(cfg, *, S: int, steps: int, seed: int, device):
    """Part (a)'s inputs, drawn here: per shape (16 tokens; 16 x (1 + 3))
    ``steps`` steps of rows and their routing by a random router under
    policy off and Algorithm 6 over S groups, the histograms the
    placements follow; and the references on the whole layer (drawn by
    ``expert_stacks``): the one-process EPExecutor's (y, EPStats) at
    block_t 8, each y held bit-equal to sorted_expert_ffn(block_t=8),
    and the one-process executor at S 1 on two decode steps (part
    (c)). The layer's weights are freed before returning."""
    from repro_torch import ep as EP
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.dispatch import sorted_expert_ffn
    from repro_torch.models.moe import OFF, route

    m = cfg.moe
    E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    bt = EP_BLOCK_T
    w = expert_stacks(range(E), d, f, seed=seed, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    wg = torch.randn((d, E), generator=g, device=device,
                     dtype=torch.bfloat16).mul_(d ** -0.5)
    alg6 = XSharePolicy(mode="ep", k0=1, m_g=EP_RANK_MG_LAYER, num_groups=S)
    spec, refs = {"S": S, "E": E, "d": d, "f": f, "k": m.top_k, "seed": seed,
                  "block_t": bt, "shapes": {}}, {}
    for shape, T in (("dec", 16), ("spec", 16 * (1 + EP_SPEC_LS))):
        xs, routes, hist = [], {"off": [], "x": []}, []
        for _ in range(steps):
            x = torch.randn((T, d), generator=g, device=device,
                            dtype=torch.bfloat16)
            xs.append(x)
            for side, pol in (("off", OFF), ("x", alg6)):
                idx, gw, _, _ = route({"wg": wg}, x, m, pol)
                routes[side].append((idx, gw))
            idx, gw = routes["x"][-1]
            # each expert's rows, most of them 0 (the placements stay
            # within the even split: ep_rank_methods)
            counts = torch.zeros(E, dtype=torch.float64, device=device)
            counts.index_add_(0, idx.reshape(-1).clamp(min=0).long(),
                              (gw.reshape(-1) != 0).double())
            hist.append(counts.cpu().numpy())
        methods = ep_rank_methods(E, S, hist[0])
        ref = {}
        for name, (side, pl, kw) in methods.items():
            ex = EP.EPExecutor(S, pl, device=device, block_t=bt, **kw)
            ys, sts = [], []
            for t in range(steps):
                if name != "off" and t > 0:
                    ex.update_placement(hist[t])
                args = (xs[t], *w, *routes[side][t])
                y, st = ex(*args)
                if not torch.equal(y, sorted_expert_ffn(*args, block_t=bt)):
                    fail(f"ep ranks {cfg.name} {shape} {name} step {t}: "
                         f"the one-process y != sorted_expert_ffn")
                ys.append(y.cpu())
                sts.append(st)
            ref[name] = {"y": ys, "stats": sts}
        refs[shape] = ref
        spec["shapes"][shape] = {
            "x": [x.cpu() for x in xs], "hist": hist,
            "routes": {s: [(i.cpu(), v.cpu()) for i, v in r]
                       for s, r in routes.items()}}
    # part (c): the layer at S 1, policy off, two decode-shape steps
    one = EP.EPExecutor(1, EP.contiguous_placement(E, 1), device=device,
                        block_t=bt)
    dec = spec["shapes"]["dec"]
    refs["world1"] = [one(dec["x"][t].to(device), *w,
                          *[a.to(device) for a in dec["routes"]["off"][t]]
                          )[0].cpu() for t in range(2)]
    del w
    torch.cuda.empty_cache()
    return spec, refs


def ep_rank_layer(rk, spec: dict) -> dict:
    """Part (a) on one rank, for each shape and method
    (``ep_rank_method``)."""
    return {shape: {name: ep_rank_method(rk, spec, shape, inp, name, *how)
                    for name, how in ep_rank_methods(
                        spec["E"], spec["S"], inp["hist"][0]).items()}
            for shape, inp in spec["shapes"].items()}


def ep_rank_method(rk, spec: dict, shape: str, inp: dict, name: str,
                   side: str, pl, kw: dict) -> dict:
    """One method of part (a) on one rank: the rank's own experts drawn
    (``expert_stacks`` of its ``local_eids``; the memory they take on the
    card read around the draw), the steps run through a DistEPExecutor
    (update_placement between steps, the experts drawn again when the
    rank's set changed), counters set to 0 just before each layer call
    and read just after; at the last step the rank's grouped_ffn call
    checked against its plain version and timed alone, the ranks taking
    turns behind a barrier."""
    import torch.distributed as dist

    from repro_torch import ep as EP
    from repro_torch import kernels as K
    from repro_torch.kernels import grouped_ffn

    dev, S = rk.device, spec["S"]
    d, f, bt = spec["d"], spec["f"], spec["block_t"]
    ex = EP.DistEPExecutor(pl, device=dev, block_t=bt, **kw)
    m0 = card_bytes(dev)
    held = ex.local_eids.copy()
    w = expert_stacks(held, d, f, seed=spec["seed"], device=dev)
    mem = card_bytes(dev) - m0
    ys, sts, calls = [], [], []
    launches = {n: 0 for n in K.KERNELS}
    args = None
    for t in range(len(inp["x"])):
        if name != "off" and t > 0:
            ex.update_placement(inp["hist"][t])
            if not np.array_equal(ex.local_eids, held):
                args = w = None
                held = ex.local_eids.copy()
                w = expert_stacks(held, d, f, seed=spec["seed"], device=dev)
        args = (inp["x"][t].to(dev), *w,
                *[a.to(dev) for a in inp["routes"][side][t]])
        K.reset_launch_counts()
        y, st = ex(*args)
        got = K.launch_counts()
        for n, c in got.items():
            launches[n] += c
        calls.append(got["grouped_ffn"])
        ys.append(y.cpu())
        sts.append(st)
    # the rank's own grouped_ffn call of the last step
    _, _, _, plan, xs, _ = ex._run(*args, None, sync=True)
    eid, valid = plan.tile_eid, plan.tile_valid
    check = grouped_gate(
        f"ep ranks {shape} {name} rank {rk.rank}",
        grouped_ffn(xs, *w, eid, valid, block_t=bt),
        grouped_plain(xs, *w, eid, valid, block_t=bt), valid, bt)
    trows = int(valid.sum()) * bt
    occ = int(torch.unique(eid[valid != 0]).numel()) if trows else 0
    ms = None
    for r in range(S):
        dist.barrier()
        if r == rk.rank and trows and dev.type == "cuda":
            ms = time_ms(lambda: grouped_ffn(xs, *w, eid, valid, block_t=bt))
    dist.barrier()
    return dict(
        y=ys, stats=sts, layer_calls=calls, launches=launches,
        expert_cap=pl.expert_cap, weight_bytes=mem,
        weight_bytes_cap_over_E=pl.expert_cap * 3 * d * f * 2,
        grouped_ffn=dict(
            rows=xs.shape[0], tile_rows=trows, experts=occ, ms=ms,
            bound_ms=bound_ms(2 * trows * d * 2 + occ * 3 * d * f * 2,
                              6.0 * trows * d * f, torch.bfloat16)[0]
            if trows else 0.0,
            max_abs_err=check["max_abs_err"], tol=check["tol"]))


def ep_rank_serve(rk, spec: dict) -> dict:
    """Part (b) on one rank: granite-moe at full width, drawn on the card
    as the parent drew it, copied to the host, the rank's experts cut
    from that copy (``bridge.cut_experts``) and the card's full copy
    freed; for each policy a DistEPExecutor and Engine(dispatch="ep")
    through the lockstep loop, counters set to 0 just before and read
    just after; the EPStats of the first decode step's layers (its calls
    recorded); then the continuous path, whose loop capture must raise."""
    from repro_torch import bridge
    from repro_torch import ep as EP
    from repro_torch import kernels as K
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.model import params_to
    from repro_torch.models.moe import OFF
    from repro_torch.serving import Engine

    dev, S, cfg = rk.device, spec["S"], spec["cfg"]
    L, E = cfg.num_layers, cfg.moe.num_experts
    host = params_to(bridge.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                        device=dev), "cpu")
    torch.cuda.empty_cache()
    pols = {"off": (OFF, EP.contiguous_placement(E, S)),
            "alg6": (XSharePolicy(mode="ep", k0=1, m_g=EP_RANK_MG_SERVE,
                                  num_groups=S),
                     EP.plan_placement(spec["hist"], S))}
    out = {}
    for name, (pol, pl) in pols.items():
        ex = EP.DistEPExecutor(pl, device=dev)
        params = bridge.cut_experts(host, ex.local_eids, device=dev)
        eng = Engine(cfg, params, policy=pol, cache_len=spec["cache_len"],
                     dispatch="ep", device=dev)
        rec = RecordingEP(ex)
        with EP.ep_context(rec):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            toks, _ = eng.generate(spec["prompts"], spec["new"],
                                   lockstep=True)
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
        with EP.ep_context(ex):
            first = [ex(*c)[1] for c in rec.calls[L:2 * L]]
            refused = None
            if name == "off":
                try:
                    eng.generate(spec["prompts"], 2)
                except RuntimeError as e:
                    refused = str(e)
        moe = params["layers"]["moe"]
        out[name] = dict(
            tokens=toks, launches=counts, layer_calls=len(rec.calls),
            wall_s=wall, expert_cap=pl.expert_cap,
            moe_bytes=sum(moe[n].numel() * moe[n].element_size()
                          for n in ("w1", "w3", "w2")),
            decode_step_stats={
                fl: np.sum([getattr(st, fl) for st in first], axis=0)
                for fl in ("computed_rows", "tile_rows", "sent_rows",
                           "a2a_bytes")},
            capture_refused=refused)
        del eng, params, rec
        torch.cuda.empty_cache()
    return out


def ep_rank_main(rk, layer_spec: dict, serve_spec: dict) -> dict:
    """What each of the gloo ranks runs: part (a), then part (b)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        return {"layer": ep_rank_layer(rk, layer_spec),
                "serve": ep_rank_serve(rk, serve_spec)}


def ep_rank_world1(rk, layer_spec: dict, serve_spec: dict) -> dict:
    """Part (c), one rank over NCCL: the layer at S 1 (all experts drawn
    by the rank) on two decode-shape steps, and one granite decode step
    under the rank's binding (logits)."""
    from repro_torch import bridge
    from repro_torch import ep as EP
    from repro_torch.models.model import params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, spec = rk.device, layer_spec
    E = spec["E"]
    with torch.no_grad():
        ex = EP.DistEPExecutor(EP.contiguous_placement(E, 1), device=dev,
                               block_t=spec["block_t"])
        w = expert_stacks(ex.local_eids, spec["d"], spec["f"],
                          seed=spec["seed"], device=dev)
        dec = spec["shapes"]["dec"]
        ys = [ex(dec["x"][t].to(dev), *w,
                 *[a.to(dev) for a in dec["routes"]["off"][t]])[0].cpu()
              for t in range(2)]
        del w
        torch.cuda.empty_cache()
        cfg = serve_spec["cfg"]
        host = params_to(bridge.init_params(
            cfg, seed=0, dtype=torch.bfloat16, device=dev), "cpu")
        gex = EP.DistEPExecutor(
            EP.contiguous_placement(cfg.moe.num_experts, 1), device=dev)
        params = bridge.cut_experts(host, gex.local_eids, device=dev)
        logits = ep_decode_logits(cfg, params, serve_spec, gex, dev)
    return {"layer_y": ys, "decode_logits": logits,
            "backend": rk.backend, "world_size": rk.size}


def ep_decode_logits(cfg, params, spec: dict, ex, dev):
    """Logits of one decode step after the prefill of spec's prompts,
    both under ``ex`` with dispatch="ep"."""
    from repro_torch import ep as EP
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.sampler import greedy
    toks = torch.as_tensor(spec["prompts"], device=dev)
    with EP.ep_context(ex):
        lg, cache, _ = prefill(cfg, params, toks, cache_len=spec["cache_len"],
                               capacity_factor=8.0, dispatch="ep")
        lg2, _, _ = decode_step(cfg, params, greedy(lg)[:, None], cache,
                                capacity_factor=8.0, dispatch="ep")
    return lg2.float().cpu()


def ep_ranks_phase(dcfg, gcfg, *, steps: int = EP_RANK_STEPS,
                   new: int = EP_RANK_NEW, seed: int = 0):
    """Expert parallelism with one process per shard: ``EP_RANKS`` ranks
    over gloo on the one card (ep/dist.py spawn), each holding only its
    experts, rows exchanged by all_to_all_single. (a) deepseek-r1-proxy's
    routed experts, one layer, the table2_ep methods at S 4: every y
    bit-equal to the one-process EPExecutor's (itself bit-equal to
    sorted_expert_ffn(block_t=8)), every EPStats field equal, one
    grouped_ffn launch per layer call on each rank, each rank's own
    grouped_ffn call within TOL of its plain version and timed alone;
    the slowest rank's ms, the peak-rows ratios off / alg6, each rank's
    expert bytes on the card against cap / E of the layer's, and two
    NVLink bounds per layer call on a four-card host, of the occupied
    rows (a2a_bytes) and of the exchange's M-row blocks. (b)
    granite-moe at full width served by the ranks through the lockstep
    loop, policy off and Algorithm 6: tokens equal the one-process
    dispatch="sorted" run's, exact launches on each rank, one decode
    step's per-rank EPStats, and the continuous path's graph capture
    refused with a clear error on every rank. (c) one rank over NCCL:
    the layer at S 1 and one granite decode step bit-equal to the
    one-process executor at S 1."""
    from repro_torch import bridge
    from repro_torch import ep as EP
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.ep import dist as DIST
    from repro_torch.launch import roofline as RF
    from repro_torch.models.moe import OFF
    from repro_torch.serving import Engine
    from repro_torch.serving.step import gate_probe

    dev, S = CUDA, EP_RANKS
    t0 = time.perf_counter()
    layer_spec, layer_ref = ep_rank_layer_inputs(dcfg, S=S, steps=steps,
                                                 seed=seed, device=dev)
    # part (b)'s references: the one-process sorted run per policy, and
    # part (c)'s decode logits under the one-process executor at S 1
    params = bridge.init_params(gcfg, seed=0, dtype=torch.bfloat16,
                                device=dev)
    prompts = np.random.default_rng(1).integers(
        0, gcfg.vocab_size, (8, 128)).astype(np.int32)
    hist = gate_probe(gcfg, params, torch.as_tensor(prompts, device=dev)) \
        .cpu().numpy().astype(np.float64)
    serve_spec = {"cfg": gcfg, "S": S, "prompts": prompts, "new": new,
                  "cache_len": 512, "hist": hist}
    pols = {"off": OFF, "alg6": XSharePolicy(
        mode="ep", k0=1, m_g=EP_RANK_MG_SERVE, num_groups=S)}
    sorted_toks = {}
    for name, pol in pols.items():
        eng = Engine(gcfg, params, policy=pol, cache_len=512,
                     dispatch="sorted", device=dev)
        sorted_toks[name] = eng.generate(prompts, new)[0]
        del eng
    one = EP.EPExecutor(1, EP.contiguous_placement(gcfg.moe.num_experts, 1),
                        device=dev)
    world1_logits = ep_decode_logits(gcfg, params, serve_spec, one, dev)
    del params
    torch.cuda.empty_cache()
    prep_s = time.perf_counter() - t0

    log(f"ep ranks: backend gloo, {S} ranks on {torch.cuda.device_count()} "
        f"card(s)")
    t0 = time.perf_counter()
    outs = DIST.spawn(ep_rank_main, S, backend="gloo", device=dev,
                      args=(layer_spec, serve_spec))
    ranks_s = time.perf_counter() - t0
    fields = ("computed_rows", "tile_rows", "sent_rows", "a2a_bytes",
              "count_matrix")
    # (a): bit-equality, stats, launches; figures from the ranks
    res_a, dm = {}, layer_spec["d"]
    for shape, ref in ((s, layer_ref[s]) for s in layer_spec["shapes"]):
        rec, per = {}, {}
        for name, want in ref.items():
            for r, o in enumerate(outs):
                got = o["layer"][shape][name]
                for t, (y, st) in enumerate(zip(got["y"], got["stats"])):
                    ok = torch.equal(y, want["y"][t]) and all(
                        np.array_equal(getattr(st, fl),
                                       getattr(want["stats"][t], fl))
                        for fl in fields) and \
                        st.max_rows == want["stats"][t].max_rows
                    if not ok:
                        fail(f"ep ranks {DS} {shape} {name} rank {r} step "
                             f"{t}: y or EPStats != the one-process "
                             f"executor's")
                if got["layer_calls"] != [1] * len(got["y"]):
                    fail(f"ep ranks {DS} {shape} {name} rank {r}: "
                         f"grouped_ffn launches per layer call "
                         f"{got['layer_calls']}")
            sts = outs[0]["layer"][shape][name]["stats"]
            rec[name] = {"tile_peak": [s.peak_tile_rows for s in sts],
                         "row_peak": [s.peak_rows for s in sts],
                         "a2a": [s.total_a2a_bytes for s in sts]}
            ranks = [o["layer"][shape][name] for o in outs]
            slow = max(range(S), key=lambda r: ranks[r]["grouped_ffn"]["ms"]
                       or 0.0)
            per[name] = dict(
                expert_cap=ranks[0]["expert_cap"],
                weight_gb_per_rank=[r["weight_bytes"] / 1e9 for r in ranks],
                weight_gb_cap_over_E=ranks[0]["weight_bytes_cap_over_E"]
                / 1e9,
                grouped_ffn_per_rank=[r["grouped_ffn"] for r in ranks],
                slowest_rank=slow,
                slowest_rank_ms=ranks[slow]["grouped_ffn"]["ms"],
                occupied_rows_nvlink_bound_ms_per_layer_call=float(np.mean(
                    [RF.roofline_terms(0.0, 0.0, RF.ep_collective_bytes(s))
                     ["collective_s"] * 1e3 for s in sts])),
                padded_exchange_bytes_per_rank=float(np.mean(
                    [RF.ep_padded_exchange_bytes(S, s.max_rows, dm, 2)
                     for s in sts])),
                padded_exchange_nvlink_bound_ms_per_layer_call=float(np.mean(
                    [RF.ep_padded_exchange_bytes(S, s.max_rows, dm, 2)
                     / RF.LINK_BW * 1e3 for s in sts])),
                a2a_bytes_per_rank=np.mean([s.a2a_bytes for s in sts],
                                           axis=0).tolist(),
                launches_rank0=ranks[0]["launches"])
        res = {"per_method": per}
        res.update(ep_ratios(rec))
        res["slowest_rank_ms_ratio_off_over_alg6"] = \
            (per["off"]["slowest_rank_ms"] or 0.0) / \
            max(per["alg6"]["slowest_rank_ms"] or 0.0, 1e-9)
        res_a[shape] = res
        log(f"ep ranks {DS} layer {shape} (the NVLink 4 bounds on a "
            f"four-card host, not measurements: of the occupied rows, "
            f"a2a_bytes, and of the exchange as it moves them, M rows a "
            f"peer): {json.dumps(res)}")
    # (b)
    L = gcfg.num_layers
    expect = {n: 0 for n in outs[0]["serve"]["off"]["launches"]}
    expect.update(grouped_ffn=L * new, decode_attention=L * (new - 1))
    res_b = {}
    for name in pols:
        runs = [o["serve"][name] for o in outs]
        for r, run in enumerate(runs):
            if not np.array_equal(run["tokens"], sorted_toks[name]):
                fail(f"ep ranks {gcfg.name} {name} rank {r}: tokens != the "
                     f"one-process dispatch='sorted' run's")
            if run["launches"] != expect:
                fail(f"ep ranks {gcfg.name} {name} rank {r}: launches "
                     f"{run['launches']}, want {expect}")
            if name == "off" and not (run["capture_refused"] and
                                      "CUDA graph" in run["capture_refused"]):
                fail(f"ep ranks {gcfg.name} rank {r}: the continuous "
                     f"loop's capture under gloo gave "
                     f"{run['capture_refused']!r}, want a clear refusal")
        res_b[name] = dict(
            tokens_equal_sorted=True, launches_per_rank=runs[0]["launches"],
            wall_s_per_rank=[run["wall_s"] for run in runs],
            tokens_per_s=[prompts.shape[0] * new / run["wall_s"]
                          for run in runs],
            expert_cap=runs[0]["expert_cap"],
            moe_gb_per_rank=[run["moe_bytes"] / 1e9 for run in runs],
            decode_step_stats_rank0={k: v.tolist() for k, v in
                                     runs[0]["decode_step_stats"].items()},
            capture_refused=runs[0]["capture_refused"])
        log(f"ep ranks {gcfg.name} {name}: {json.dumps(res_b[name])}")
    # (c)
    log("ep ranks: backend nccl, 1 rank")
    t0 = time.perf_counter()
    w1 = DIST.spawn(ep_rank_world1, 1, backend="nccl", device=dev,
                    args=(layer_spec, serve_spec))[0]
    world1_s = time.perf_counter() - t0
    ok_layer = all(torch.equal(a, b) for a, b in zip(w1["layer_y"],
                                                     layer_ref["world1"]))
    ok_logits = torch.equal(w1["decode_logits"], world1_logits)
    if not (ok_layer and ok_logits):
        fail(f"ep ranks nccl world size 1: layer bit-equal "
             f"{ok_layer}, decode logits bit-equal {ok_logits}")
    res_c = dict(backend=w1["backend"], world_size=w1["world_size"],
                 layer_bit_equal=ok_layer, decode_logits_bit_equal=ok_logits)
    log(f"ep ranks world size 1: {json.dumps(res_c)}")
    launches = {f"rank {r} layer": {"launches": {
        n: sum(o["layer"][s][m]["launches"][n] for s in o["layer"]
               for m in o["layer"][s]) for n in expect}}
        for r, o in enumerate(outs)}
    for r, o in enumerate(outs):
        for name in pols:
            launches[f"rank {r} serve {name}"] = {
                "launches": o["serve"][name]["launches"]}
    return dict(layer=res_a, serve=res_b, world1=res_c, launches=launches,
                prep_s=prep_s, ranks_s=ranks_s, world1_s=world1_s,
                card=gpu_name_power())


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


# ---------------------------------------------------- serve cli phase ---

SERVE_CLI = ["--arch", ARCH, "--batch", "8", "--prompt-len", "128",
             "--new-tokens", "32"]
SERVE_CLI_RUNS = {"off": [], "batch": ["--policy", "batch", "--k0", "1",
                                       "--m-l", "8"],
                  "spec": ["--spec-len", "4"]}


def ops_cases(archs):
    """Each public wrapper of ``repro_torch.kernels.ops`` once against its
    kernel's plain version, f32 and bf16, at the kernel phase's shapes:
    granite's decode step (xshare_moe_ffn, 8 tokens, policy off,
    max_active None, so E), its 8 x 128 prefill (xshare_grouped_ffn,
    top-8 of 32) and its decode attention (flash_decode, 8 rows, cache
    512, lengths 129-160); mamba2-370m's prefill (ssd_chunk_scan, 8 x
    500, B and C pre-broadcast to the heads, as the reference takes
    them). Each call must add one to its kernel's launch count."""
    from repro_torch import kernels as K
    from repro_torch.core.routing import topk_route
    from repro_torch.kernels import ops
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens
    from repro_torch.models.moe import OFF, route
    from repro_torch.models.ssm import dims

    g = torch.Generator(device=CUDA)
    g.manual_seed(2121)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=CUDA)
                ).to(dtype)

    cfg, scfg = archs[ARCH], archs["mamba2-370m"]
    d, E, f, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert, \
        cfg.moe.top_k
    a, s = cfg.attn, scfg.ssm
    _, nh, _ = dims(s, scfg.d_model)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        w1, w3 = (randn(E, d, f, scale=0.02, dtype=dtype) for _ in range(2))
        w2 = randn(E, f, d, scale=0.02, dtype=dtype)
        wg = randn(d, E, scale=0.02)
        xt = randn(8, d, dtype=dtype)
        _, _, combine, _ = route({"wg": wg}, xt, cfg.moe, OFF)
        active = (combine != 0).any(0)
        x = randn(8 * 128, d, dtype=dtype)
        plan = dispatch_plan(*topk_route(x.float() @ wg, k), E)
        xs = gather_tokens(x, plan)
        q = randn(8, a.num_heads, a.head_dim, dtype=dtype)
        kc, vc = (randn(8, 512, a.num_kv_heads, a.head_dim, dtype=dtype)
                  for _ in range(2))
        lengths = torch.randint(129, 161, (8,), generator=g, device=CUDA,
                                dtype=torch.int32)
        B, S = 8, 500
        sx = randn(B, S, nh, s.head_dim, scale=0.5, dtype=dtype)
        sdt = torch.nn.functional.softplus(randn(B, S, nh))
        sA = -torch.exp(randn(nh, scale=0.3))
        sB, sC = (randn(B, S, nh, s.d_state, scale=0.3, dtype=dtype)
                  for _ in range(2))
        calls = (
            ("xshare_moe_ffn", "moe_ffn", TOL,
             lambda: ops.xshare_moe_ffn(xt, w1, w3, w2, combine, active),
             lambda: K.moe_ffn_plain(xt, w1, w3, w2, combine, active)),
            ("xshare_grouped_ffn", "grouped_ffn", TOL,
             lambda: ops.xshare_grouped_ffn(
                 xs, w1, w3, w2, plan.tile_eid, plan.tile_valid,
                 block_t=plan.block_t),
             lambda: K.grouped_ffn_plain(
                 xs, w1, w3, w2, plan.tile_eid, plan.tile_valid,
                 block_t=plan.block_t)),
            ("flash_decode", "decode_attention", TOL,
             lambda: ops.flash_decode(q, kc, vc, lengths),
             lambda: K.decode_attention_plain(q, kc, vc, lengths)),
            ("ssd_chunk_scan", "ssd_scan", SCAN_TOL,
             lambda: ops.ssd_chunk_scan(sx, sdt, sA, sB, sC,
                                        chunk=s.chunk_size),
             lambda: K.ssd_scan_plain(sx, sdt, sA, sB, sC,
                                      chunk=s.chunk_size)))
        for name, kernel, tol, call, plain in calls:
            before = K.KERNELS[kernel].launches
            got = call()
            launched = K.KERNELS[kernel].launches - before
            ref = plain()
            if name == "ssd_chunk_scan":
                err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
                ok = close(got[0], ref[0], dtype, tol) and \
                    close(got[1], ref[1], torch.float32, tol)
            else:
                err, ok = max_err(got, ref), close(got, ref, dtype, tol)
            case = dict(wrapper=name, kernel=kernel,
                        dtype=str(dtype).replace("torch.", ""),
                        max_abs_err=err, tol=tol[dtype], ok=ok,
                        launches=launched)
            log(f"ops {name} {dtype}: {json.dumps(case)}")
            if not ok or launched != 1:
                fail(f"ops.{name} ({dtype}): error {err} (tol "
                     f"{tol[dtype]}), {launched} launches of {kernel}")
            out.append(case)
    return out


def cli_lines(text: str):
    """The serve CLI's printed lines with every number replaced by #."""
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in text.splitlines()]


def cli_expect(cfg, run: str, stats, decode_chunk: int):
    """Exact launches of one serve CLI run (8 requests admitted together):
    plain, one prefill (grouped_ffn once per layer) and the decode rounds
    of decode_chunk steps up to the 31 tokens after the first (moe_ffn
    and decode_attention once per layer a step); speculative,
    spec_expect over the rounds the run reports."""
    from repro_torch.launch.serve import draft_config
    if run == "spec":
        return spec_expect(cfg, draft_config(cfg), stats.steps, 4)
    steps = -(-(32 - 1) // decode_chunk) * decode_chunk
    L = cfg.num_layers
    return {"grouped_ffn": L, "moe_ffn": L * steps,
            "decode_attention": L * steps, "ssd_scan": 0,
            "grouped_ffn_bwd": 0, "ssd_scan_bwd": 0,
            "moe_ffn_bwd": 0}


def serve_cli_phase(cfg, prof):
    """The serve CLI (``repro_torch.launch.serve.main``) at granite-moe's
    full width, f32 weights from seed 0 as the CLI draws them, 8 x 128
    prompts of SyntheticLM, 32 new: policy off, batch (k0 1, m_l 8) and
    --spec-len 4 (the CLI's 2-layer draft at the target's vocabulary).
    Counters set to 0 just before each run and read just after: exact
    launches. Each run prints the reference's lines; off's tokens equal
    Engine.generate's on the same weights and prompts, the spec run's
    equal off's, and batch activates fewer experts than off. Then the
    one-card roofline (model_shards 1) of the bf16 served decode step (B
    8, cache 512) beside the replayed step the profile phase measured,
    and of the 8 x 128 prefill beside its eager prefill: printed, not
    held."""
    import contextlib
    import inspect
    import io

    from repro_torch import kernels as K
    from repro_torch.bridge import init_params
    from repro_torch.configs.base import ShapeConfig, XSharePolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models.moe import OFF
    from repro_torch.serving import Engine

    if serve.draft_config(cfg) != draft_config(cfg):
        fail("serve CLI: its draft is not the spec phase's small draft")
    chunk = inspect.signature(Engine).parameters["decode_chunk"].default
    want_lines = ["generated: (#, #)", "OTPS #  steps #",
                  "mean activated experts/layer: # (selected set #, gate "
                  "mass #)"]
    out, toks = {}, {}
    for run, extra in SERVE_CLI_RUNS.items():
        buf = io.StringIO()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            tk, st = serve.main(SERVE_CLI + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        text = buf.getvalue()
        log(f"serve cli {run}: " + " | ".join(text.splitlines()))
        lines = want_lines[:2] + (["mean accepted drafts/step: #"]
                                  if run == "spec" else []) + want_lines[2:]
        if cli_lines(text) != lines:
            fail(f"serve cli {run}: printed {text!r}")
        want = cli_expect(cfg, run, st, chunk)
        if counts != want:
            fail(f"serve cli {run}: launches {counts}, expected {want} "
                 f"({st.steps} steps or rounds)")
        if tk.shape != (8, 32) or tk.min() < 0 or \
                tk.max() >= cfg.vocab_size:
            fail(f"serve cli {run}: bad tokens {tk.shape}")
        toks[run] = tk
        # the CLI's own OTPS is generate's, cold (capture included); the
        # call's wall also draws the weights and builds the engine
        out[run] = dict(otps=st.otps, call_wall_s=wall, steps=st.steps,
                        launches=counts,
                        capture_s=st.capture_s,
                        activated_experts=st.mean_aux("activated_experts"),
                        mean_accepted=st.mean_accepted)
        log(f"serve cli {run}: {json.dumps(out[run])}")
        torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device=CUDA)
    prompts = SyntheticLM(cfg.vocab_size, name=ARCH).sample(
        np.random.default_rng(0), 8, 128)
    direct, _ = Engine(cfg, params, cache_len=128 + 32 + 16,
                       device=CUDA).generate(prompts, 32)
    del params
    torch.cuda.empty_cache()
    if not np.array_equal(toks["off"], direct):
        fail("serve cli off: tokens differ from Engine.generate's")
    if not np.array_equal(toks["spec"], toks["off"]):
        fail("serve cli spec: tokens differ from plain greedy's")
    if not out["batch"]["activated_experts"] < out["off"]["activated_experts"]:
        fail(f"serve cli: batch activates {out['batch']['activated_experts']}"
             f" experts, off {out['off']['activated_experts']}")
    log("serve cli: off == Engine.generate, spec == off, activated experts "
        f"batch {out['batch']['activated_experts']:.2f} < off "
        f"{out['off']['activated_experts']:.2f}")

    pre = ShapeConfig(name="served prefill", seq_len=128, global_batch=8,
                      kind="prefill")
    batch = XSharePolicy(mode="batch", k0=1, m_l=8)
    roof = step_roofline(cfg, (
        ("decode off", served_decode(), OFF, prof["replay"]),
        ("decode batch", served_decode(), batch, prof["replay batch"]),
        ("prefill", pre, OFF, prof["prefill"])))
    return {"runs": out, "roofline": roof}


# -------------------------------------------------------- train phase ---

# The trained speculation of benchmarks/fig5_table4_spec.py, with its
# training recipe (benchmarks/common.py trained_model / trained_draft):
# the dataset family, the serving shape, and Algorithm 4 against the
# naive per-request top-k.
DATASETS = ("gpqa", "aime2025", "mmlu-pro", "aa-lcr")
BENCH_PROMPT, BENCH_NEW, BENCH_SPEC_LEN = 16, 48, 3
BENCH_CACHE = BENCH_PROMPT + BENCH_NEW + BENCH_SPEC_LEN + 8
BENCH_SPEC_ACCEPTANCE = 1.0   # BENCH_spec.json: 136 of 136 drafted
TARGET_STEPS, DRAFT_STEPS = 150, 300
SHORT_DRAFT_STEPS = (10, 20, 40)
# CPU == GPU train step: the loss as the kernel tests hold an output;
# each gradient and updated leaf within 1e-4 of its largest magnitude
# (sums over d = 1024 and 8 x 64 rows in another order)
TRAIN_LOSS_TOL, TRAIN_LEAF_TOL = 2e-5, 1e-4


def bench_cfg(num_experts: int, top_k: int, *, d_model: int = 64,
              vocab: int = 256, layers: int = 2, d_ff_expert: int = 64,
              shared: int = 0):
    """benchmarks/common.py bench_cfg, from repro_torch.configs."""
    from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig
    return ArchConfig(
        name=f"bench-moe-{num_experts}e{top_k}k", family="moe",
        num_layers=layers, d_model=d_model, d_ff=0, vocab_size=vocab,
        attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        moe=MoEConfig(num_experts=num_experts, top_k=top_k,
                      d_ff_expert=d_ff_expert, num_shared_experts=shared,
                      d_ff_shared=d_ff_expert if shared else 0))


def draft_cfg(*, d_model: int = 32, layers: int = 1, d_ff: int = 128,
              vocab: int = 256):
    """benchmarks/common.py draft_cfg: a dense draft an order of
    magnitude cheaper per step than the bench target."""
    from repro_torch.configs.base import ArchConfig, AttnConfig
    return ArchConfig(
        name=f"bench-draft-d{d_model}", family="dense", num_layers=layers,
        d_model=d_model, d_ff=d_ff, vocab_size=vocab,
        attn=AttnConfig(num_heads=2, num_kv_heads=1, head_dim=16))


def grouped_bwd_cases(archs):
    """grouped_ffn_bwd against grouped_ffn_bwd_plain at granite-moe's
    training plan: 8 x 128 tokens routed top-8 of 32 with expert 31 left
    without rows (its router column at -inf), so the plan has invalid
    tail tiles and an empty expert, block_t 128; f32 (the training
    path's dtype) and bf16. Each gradient within TOL of its largest
    magnitude, two calls bit-equal, timed beside its bound and the
    torch._grouped_mm yardstick. Own generator, last in the phase."""
    from repro_torch.core.routing import topk_route
    from repro_torch.kernels import grouped_ffn_bwd, grouped_ffn_bwd_plain
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens

    cfg = archs[ARCH]
    d, E, f, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert, \
        cfg.moe.top_k
    g = torch.Generator(device=CUDA)
    g.manual_seed(2024)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=CUDA)
                ).to(dtype)
    x32 = randn(8 * 128, d)
    logits = x32 @ randn(d, E, scale=0.02)
    logits[:, E - 1] = -float("inf")
    idx, w = topk_route(logits, k)
    plan = dispatch_plan(idx, w, E)
    bt = plan.block_t
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.finfo(dtype).bits // 8
        w1, w3 = (randn(E, d, f, scale=0.02, dtype=dtype) for _ in range(2))
        w2 = randn(E, f, d, scale=0.02, dtype=dtype)
        xs = gather_tokens(x32.to(dtype), plan)
        dys = randn(*xs.shape, scale=0.01, dtype=dtype)
        args = (xs, w1, w3, w2, plan.tile_eid, plan.tile_valid, dys)

        def kernel():
            return grouped_ffn_bwd(*args, block_t=bt)
        ker, again = kernel(), kernel()
        ref = grouped_ffn_bwd_plain(*args, block_t=bt)
        errs, ok = {}, True
        for name, a, r in zip(("dxs", "dw1", "dw3", "dw2"), ker, ref):
            scale = max(float(r.float().abs().max()), 1e-30)
            errs[name] = max_err(a, r) / scale
            ok = ok and errs[name] <= TOL[dtype]
        bit_equal = all(torch.equal(a, b) for a, b in zip(ker, again))
        n_valid = int(plan.tile_valid.sum())
        empty = [e for e in range(E) if int(plan.counts[e]) == 0]
        zeros = all(float(t[e].abs().max()) == 0.0
                    for t in ker[1:] for e in empty)
        n_rows = int(plan.counts.sum())
        occupied = E - len(empty)
        P = xs.shape[0]
        # reads: the valid tiles' rows of xs and dys, the occupied
        # experts' weights, the tile vectors; writes: dxs (P rows) and
        # the three weight gradients of all E experts
        nbytes = (2 * n_valid * bt * d * sz + occupied * 3 * d * f * sz
                  + 2 * plan.tile_eid.numel() * 4 + P * d * sz
                  + E * 3 * d * f * sz)
        # recompute A, B (4), G (2), dxs (4), three weight sums (6)
        flops = 16.0 * n_rows * d * f
        bms, by = bound_ms(nbytes, flops, dtype)
        n_kern, kern_us = cuda_kernels_of(kernel)
        case = dict(
            dtype=str(dtype).replace("torch.", ""), case="train",
            model=ARCH,
            shape=f"P={P} d={d} f={f} E={E} block_t={bt} rows={n_rows} "
                  f"valid_tiles={n_valid}/{plan.tile_eid.numel()} "
                  f"empty_experts={empty}",
            max_abs_err=max(max_err(a, r) for a, r in zip(ker, ref)),
            rel_err=errs, ok=ok and bit_equal and zeros and bool(empty)
            and n_valid < plan.tile_eid.numel(),
            bit_equal=bit_equal, empty_expert_zero=zeros, tol=TOL[dtype],
            kernels_per_call=n_kern, kernel_device_us=kern_us,
            ms=time_ms(kernel, iters=10),
            plain_ms=time_ms(lambda: grouped_ffn_bwd_plain(
                *args, block_t=bt), iters=5),
            bound_ms=bms, bound_by=by, library_ms=None)
        case["tflops"] = flops / case["ms"] / 1e9
        case["pass_us"], case["pass_tflops"] = bwd_passes(kern_us, n_rows,
                                                          d, f)
        if dtype == torch.bfloat16:
            case.update(grouped_mm_bwd_yardstick(plan, *args))
        else:
            case.update(sgemm_yardstick(n_valid * bt, d, f))
        log(f"grouped_ffn_bwd {dtype}: errors / max |ref| {errs} (limit "
            f"{TOL[dtype]}), bit-equal {bit_equal}, empty experts "
            f"{empty} zero {zeros}; {case['ms']:.4f} ms (bound {bms:.4f} "
            f"by {by}), {case['tflops']:.1f} TFLOP/s on the real rows, "
            f"plain {case['plain_ms']:.3f} ms, {n_kern} CUDA kernels per "
            f"call; per pass device us {case['pass_us']} and TFLOP/s on "
            f"the real rows {case['pass_tflops']}; torch._grouped_mm "
            f"yardstick: {case.get('grouped_mm_ms')}; cuBLAS SGEMM "
            f"TFLOP/s: {case.get('sgemm_tflops')}")
        out.append(case)
        del w1, w3, w2, xs, dys, ker, again, ref
    return out


def moe_bwd_cases(archs, n_kernels=len(MOE_BWD_KERNELS)):
    """moe_ffn_bwd against moe_ffn_bwd_plain at granite-moe's decode shape
    (8 tokens, d 1024, f 512, 32 experts top-8) and at its small
    draft's (d 128, 4 experts top-2 of width 128), f32 and bf16, each
    under policy off and batch (k0 1, m_l 8); then at the dense train
    step's shape (`train dense`: 4 x 8 = 32 tokens at granite's widths,
    policy off), f32 and bf16. route() gives combine as the column slice
    it hands moe_ffn; ``n_kernels`` goes to each moe_bwd_case. Own
    generator, last in the phase."""
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.moe import OFF

    g = torch.Generator(device=CUDA)
    g.manual_seed(2626)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=CUDA)
                ).to(dtype)
    out = []
    cfg = archs[ARCH]
    for label, c in ((ARCH, cfg), (f"{ARCH} draft", draft_config(cfg))):
        d, m = c.d_model, c.moe
        E, f = m.num_experts, m.d_ff_expert
        wg = randn(d, E, scale=0.02)
        x32 = randn(8, d)
        for dtype in (torch.float32, torch.bfloat16):
            w1, w3 = (randn(E, d, f, scale=0.02, dtype=dtype)
                      for _ in range(2))
            w2 = randn(E, f, d, scale=0.02, dtype=dtype)
            dy = randn(8, d, scale=0.01, dtype=dtype)
            for pol in (OFF, XSharePolicy(mode="batch", k0=1, m_l=8)):
                out.append(moe_bwd_case(label, x32.to(dtype), wg, w1, w3,
                                        w2, dy, m, pol, dtype, n_kernels))
            del w1, w3, w2
    d, m = cfg.d_model, cfg.moe
    E, f = m.num_experts, m.d_ff_expert
    wg = randn(d, E, scale=0.02)
    x32 = randn(32, d)
    for dtype in (torch.float32, torch.bfloat16):
        w1, w3 = (randn(E, d, f, scale=0.02, dtype=dtype) for _ in range(2))
        w2 = randn(E, f, d, scale=0.02, dtype=dtype)
        dy = randn(32, d, scale=0.01, dtype=dtype)
        out.append(moe_bwd_case(f"{ARCH} train", x32.to(dtype), wg, w1, w3,
                                w2, dy, m, OFF, dtype, n_kernels))
        del w1, w3, w2
    return out


def moe_bwd_case(label, xt, wg, w1, w3, w2, dy, mcfg, pol, dtype,
                 n_kernels=len(MOE_BWD_KERNELS)):
    """One moe_ffn_bwd case: each gradient (dx, dw1, dw3, dw2, dcombine)
    within TOL of its largest magnitude, the weight gradients and
    combine columns of the experts outside the slots exactly zero, two
    calls bit-equal, exactly ``n_kernels`` CUDA kernels a call (None:
    any number; their device us by pass in ``pass_us``); timed beside its bound: the selected experts'
    weights, x, dy and combine read once, dx, dcombine and all E
    experts' weight gradients written once, 16 operations per (token,
    expert) pair of nonzero weight and d f."""
    from repro_torch.kernels import moe_ffn_bwd, moe_ffn_bwd_plain
    from repro_torch.models.moe import policy_max_active, route

    sz = torch.finfo(dtype).bits // 8
    (T, d), (E, _, f) = xt.shape, w1.shape
    _, _, combine, _ = route({"wg": wg}, xt, mcfg, pol)
    active = (combine != 0).any(0)
    ma = policy_max_active(pol, T, E)
    args = (xt, w1, w3, w2, combine, active, dy)

    def kernel():
        return moe_ffn_bwd(*args, max_active=ma)
    ker, again = kernel(), kernel()
    ref = moe_ffn_bwd_plain(*args, max_active=ma)
    errs = {}
    for name, a, r in zip(("dx", "dw1", "dw3", "dw2", "dcombine"), ker, ref):
        errs[name] = max_err(a, r) / max(float(r.float().abs().max()), 1e-30)
    bit_equal = all(torch.equal(a, b) for a, b in zip(ker, again))
    n_act = int(active.sum())
    off = ~active
    zeros = not bool(off.any()) or (
        all(float(t[off].abs().max()) == 0.0 for t in ker[1:4])
        and float(ker[4][:, off].abs().max()) == 0.0)
    nnz = int((combine != 0).sum())
    nbytes = (2 * T * d * sz + T * E * 4 + E + n_act * 3 * d * f * sz
              + T * d * sz + E * 3 * d * f * sz + T * E * 4)
    bms, by = bound_ms(nbytes, 16.0 * nnz * d * f, dtype)
    n_kern, kern_us = cuda_kernels_of(kernel)
    case = dict(
        dtype=str(dtype).replace("torch.", ""), model=label,
        policy=pol.mode,
        shape=f"T={T} d={d} f={f} E={E} active={n_act} max_active={ma}",
        active=n_act, max_active=ma,
        max_abs_err=max(max_err(a, r) for a, r in zip(ker, ref)),
        rel_err=errs, tol=TOL[dtype], bit_equal=bit_equal,
        outside_slots_zero=zeros,
        ok=all(e <= TOL[dtype] for e in errs.values()) and bit_equal
        and zeros and n_kernels in (None, n_kern),
        kernels_per_call=n_kern, kernel_device_us=kern_us,
        pass_us={re.sub(r"_kernel.*", "", k.split("moe_bwd_")[-1]): v
                 for k, v in kern_us.items()},
        ms=time_ms(kernel),
        plain_ms=time_ms(lambda: moe_ffn_bwd_plain(*args, max_active=ma),
                         iters=5),
        bound_ms=bms, bound_by=by, library_ms=None)
    log(f"moe_ffn_bwd {label} {dtype} policy={pol.mode}: active={n_act} "
        f"max_active={ma}, errors / max |ref| {errs} (limit {TOL[dtype]}), "
        f"bit-equal {bit_equal}, outside the slots zero {zeros}; "
        f"{case['ms']:.4f} ms (bound {bms:.4f} by {by}), plain "
        f"{case['plain_ms']:.3f} ms, {n_kern} CUDA kernels per call, "
        f"device us by pass {case['pass_us']}")
    return case


def bwd_passes(kern_us, rows: int, d: int, f: int):
    """({pass: device us}, {pass: TFLOP/s on the real rows}) of one
    grouped_ffn_bwd call from cuda_kernels_of's per-kernel times."""
    us = {}
    for name, t in kern_us.items():
        for p in BWD_PASS_FLOPS:
            if f"{p}_" in name:
                us[p] = us.get(p, 0.0) + t
    return us, {p: BWD_PASS_FLOPS[p] * rows * d * f / (t * 1e6)
                for p, t in us.items() if t > 0}


def sgemm_yardstick(rows: int, d: int, f: int):
    """The f32 FFMA rate the card reaches in practice: one cuBLAS SGEMM
    (TF32 off) of the worked rows (rows, d) by (d, 3f), pass 1's three
    products as one. A yardstick of speed only, used nowhere in the
    port."""
    a = torch.randn(rows, d, device=CUDA)
    b = torch.randn(d, 3 * f, device=CUDA)
    ms = time_ms(lambda: a @ b, iters=10)
    return dict(sgemm_ms=ms, sgemm_tflops=6.0 * rows * d * f / ms / 1e9)


def grouped_mm_bwd_yardstick(plan, xs, w1, w3, w2, eid, valid, dys):
    """The backward's products through torch._grouped_mm on the same
    padded rows (each expert's segment, padded to block_t, one group):
    A and B again, G = dys W2^T, dxs = dA W1^T + dB W3^T and the three
    weight gradients as K-grouped products, with the SwiGLU's elementwise
    gradient between them. A yardstick of speed only, used nowhere in
    the port and kept out of the library column."""
    if not hasattr(torch, "_grouped_mm"):
        return dict(grouped_mm_ms=None, grouped_mm_note="no torch._grouped_mm")
    bt = plan.block_t
    offs = torch.cumsum((plan.counts + bt - 1) // bt * bt, 0,
                        dtype=torch.int32)
    rows = int(offs[-1])
    gm = torch._grouped_mm
    x, dy = xs[:rows], dys[:rows]

    def run():
        a = gm(x, w1, offs=offs).float()
        b = gm(x, w3, offs=offs).float()
        g = gm(dy, w2.transpose(1, 2), offs=offs).float()
        s = torch.sigmoid(a)
        da = (g * b * s * (1 + a * (1 - s))).to(x.dtype)
        db = (g * a * s).to(x.dtype)
        h = (a * s * b).to(x.dtype)
        dx = gm(da, w1.transpose(1, 2), offs=offs) + \
            gm(db, w3.transpose(1, 2), offs=offs)
        return (dx, gm(x.t(), da, offs=offs), gm(x.t(), db, offs=offs),
                gm(h.t(), dy, offs=offs))
    try:
        return dict(grouped_mm_ms=time_ms(run, iters=10),
                    grouped_mm_note="7 torch._grouped_mm calls + the "
                                    "elementwise gradient")
    except (RuntimeError, TypeError) as e:   # not built for this card
        return dict(grouped_mm_ms=None, grouped_mm_note=str(e)[:200])


def tree_errs(got, want):
    """{leaf path: max |got - want| over want's largest magnitude}."""
    from repro_torch.bridge import flatten
    g, w = flatten(got), flatten(want)
    return {k: max_err(g[k].cpu(), w[k].cpu())
            / max(float(w[k].float().abs().max()), 1e-30) for k in w}


def train_parity(cfg, *, seq: int = 64, bwd: str = "grouped_ffn_bwd",
                 capacity_factor: float = 1.25, never: tuple = ()):
    """``cfg`` cut to 2 layers, f32, the same seeded params and 4 x
    ``seq`` synthetic tokens on the CPU (plain versions) and on the card
    (the kernels: granite-moe's grouped_ffn and its backward, or at
    DENSE_CF moe_ffn and moe_ffn_bwd; an SSM layer's ssd_scan and
    ssd_scan_bwd): loss_and_grads, every gradient leaf within
    TRAIN_LEAF_TOL of its largest magnitude, ``bwd`` launched once per
    layer and no kernel of ``never``; then one make_train_step (remat, clip,
    AdamW at its default schedule): its loss within TRAIN_LOSS_TOL, its
    grad_norm within TRAIN_LEAF_TOL, the loss of the updated params on
    the same tokens within TRAIN_LOSS_TOL, and every updated leaf that
    was not all zero at init within TRAIN_LEAF_TOL of its largest
    magnitude. A leaf that starts at zero (the SSM family's conv biases,
    A_log and dt_bias) is printed with its worst element's clipped
    gradient in units of eps, not gated: AdamW's first step moves each
    element by lr g / (|g| + eps) (eps 1e-8), so such a leaf's largest
    magnitude is lr, and an element whose clipped gradient is within
    ~100 eps turns an f32 difference of 1e-7 of the gradient's largest
    magnitude into ~1e-3 of the step."""
    from repro_torch import kernels as K
    from repro_torch.bridge import flatten, init_params
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import loss_and_grads, make_train_step
    from repro_torch.models.model import loss_fn, params_to
    from repro_torch.optim import adamw_init

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = init_params(cfg2, seed=0, dtype=torch.float32, device="cpu")
    toks = SyntheticLM(cfg.vocab_size, name=cfg.name).sample(
        np.random.default_rng(0), 4, seq)
    step = make_train_step(cfg2, capacity_factor=capacity_factor)
    runs = []
    for dev in ("cpu", CUDA):
        p = params_to(params, dev)
        t = torch.as_tensor(toks, device=dev)
        K.reset_launch_counts()
        loss, grads = loss_and_grads(cfg2, p, t,
                                     capacity_factor=capacity_factor)
        launched = K.KERNELS[bwd].launches
        stray = {k: K.KERNELS[k].launches for k in never}
        new, _, m = step(p, adamw_init(p), toks)
        with torch.no_grad():
            after = float(loss_fn(cfg2, new, t)[0])
        runs.append((float(loss), grads, new, float(m["loss"]),
                     float(m["grad_norm"]), after, launched, stray))
        del p
    (lc, gc, pc, mc, nc, ac, _, _), \
        (lg, gg, pg, mg, ng, ag, launched, stray) = runs
    gerr, perr = tree_errs(gg, gc), tree_errs(pg, pc)
    zero = {k for k, v in flatten(params).items() if not bool(v.any())}
    gated = {k: e for k, e in perr.items() if k not in zero}
    gworst, pworst = max(gerr, key=gerr.get), max(gated, key=gated.get)

    def clipped_over_eps(k):
        # the worst updated element's clipped CPU gradient in units of
        # eps: how well AdamW's first step is conditioned there
        at = (flatten(pg)[k].cpu() - flatten(pc)[k]).abs().argmax()
        return abs(float(flatten(gc)[k].flatten()[at])) / max(nc, 1.0) \
            / 1e-8
    res = dict(loss_cpu=lc, loss_gpu=lg, step_loss_cpu=mc,
               step_loss_gpu=mg, grad_norm_cpu=nc, grad_norm_gpu=ng,
               loss_after_step_cpu=ac, loss_after_step_gpu=ag,
               worst_grad_leaf=gworst, worst_grad_err=gerr[gworst],
               worst_param_leaf=pworst, worst_param_err=perr[pworst],
               worst_param_clipped_grad_over_eps=clipped_over_eps(pworst),
               zero_init_leaves={k: dict(err=perr[k],
                                         clipped_grad_over_eps=(
                                             clipped_over_eps(k)))
                                 for k in sorted(zero)},
               bwd=bwd, bwd_launches=launched,
               capacity_factor=capacity_factor, never_launched=stray)
    log(f"train parity {cfg.name}: 2 layers f32, 4 x {seq} tokens, CPU vs "
        f"GPU: {json.dumps(res)} (limits: loss {TRAIN_LOSS_TOL}, leaves "
        f"{TRAIN_LEAF_TOL} of their largest magnitude)")
    if abs(lc - lg) > TRAIN_LOSS_TOL or abs(mc - mg) > TRAIN_LOSS_TOL or \
            abs(ac - ag) > TRAIN_LOSS_TOL or gerr[gworst] > TRAIN_LEAF_TOL \
            or perr[pworst] > TRAIN_LEAF_TOL \
            or abs(nc - ng) > TRAIN_LEAF_TOL * nc:
        fail(f"train parity {cfg.name}: CPU and GPU disagree")
    if launched != cfg2.num_layers or any(stray.values()):
        fail(f"train parity {cfg.name}: {launched} {bwd} launches, want "
             f"one per layer ({cfg2.num_layers}); {stray}, want none")
    return res


def train_full_width(cfg, *, steps: int = 10, batch: int = 8,
                     seq: int = 128):
    """granite-moe at all its layers, f32 params, remat: first
    loss_and_grads on step 1's batch with the sorted plans' expert counts
    recorded, so every expert that received rows must have a nonzero w1,
    w3 and w2 gradient and every other one a zero gradient; then
    ``steps`` make_train_step steps at cosine_schedule(3e-4, 2, steps)
    on SyntheticLM(vocab, name=arch) batches. The loss must be finite and
    fall, grad_norm finite. Launch counters set to 0 just before the
    steps and read just after."""
    from repro_torch.bridge import init_params
    from repro_torch.data import SyntheticLM, batches
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import dispatch

    params = init_params(cfg, seed=0, dtype=torch.float32, device=CUDA)
    stream = batches(SyntheticLM(cfg.vocab_size, name=cfg.name),
                     batch=batch, seq_len=seq, seed=0)
    data = [next(stream) for _ in range(steps)]
    counts, plan_of = [], dispatch.dispatch_plan

    def recording_plan(*a, **kw):
        plan = plan_of(*a, **kw)
        counts.append(plan.counts)
        return plan
    dispatch.dispatch_plan = recording_plan
    try:
        _, grads = loss_and_grads(cfg, params,
                                  torch.as_tensor(data[0], device=CUDA))
    finally:
        dispatch.dispatch_plan = plan_of
    L = cfg.num_layers
    routed = torch.stack(counts[:L]) > 0          # the forward's plans
    moe = grads["layers"]["moe"]
    nonzero = torch.stack([(moe[k] != 0).flatten(2).any(-1)
                           for k in ("w1", "w3", "w2")])   # (3, L, E)
    if not torch.equal(nonzero, routed[None].expand_as(nonzero)):
        fail(f"train {cfg.name}: expert weight gradients nonzero exactly "
             f"where the experts received rows? no")
    del grads
    res = dict(layers=L, batch=batch, seq=seq, steps=steps,
               routed_experts=int(routed.sum()))
    res.update(train_steps(cfg, params, data, BWD_KERNELS))
    launches, prof = res["launches"], res["profile"]
    res.update(fwd_per_step=launches["grouped_ffn"] / steps,
               bwd_per_step=launches["grouped_ffn_bwd"] / steps)
    log(f"train {cfg.name}: {L} layers, f32, remat, {batch} x {seq} "
        f"tokens: {json.dumps(res)}")
    log(f"train {cfg.name}: grouped_ffn_bwd {prof['bwd_ms']:.3f} of the "
        f"step's {prof['device_busy_ms']:.3f} device ms "
        f"({100 * prof['bwd_share']:.1f} %)")
    check_train_losses(cfg, res)
    if launches["grouped_ffn_bwd"] != L * steps or \
            launches["grouped_ffn"] < L * steps:
        fail(f"train {cfg.name}: launches {launches}, want one backward "
             f"per layer per step")
    torch.cuda.empty_cache()
    return res


def train_steps(cfg, params, data, bwd_kernels, **kw):
    """make_train_step (remat, ``kw``) at cosine_schedule(3e-4, 2, steps)
    over the batches of ``data``, from ``params`` (consumed): losses,
    grad_norms, the median step after the first, tokens/s, peak memory
    and the launch counts of the steps (counters set to 0 just before
    the steps, read just after), then train_step_profile over one more
    step with ``bwd_kernels``' share."""
    from repro_torch import kernels as K
    from repro_torch.bridge import param_count
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import adamw_init, cosine_schedule

    steps = len(data)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=cosine_schedule(3e-4, 2, steps), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, norms, times = [], [], []
    for toks in data:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, toks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = K.launch_counts()
    step_s = float(np.median(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = train_step_profile(step, params, opt, data[0], step_s,
                              bwd_kernels)
    toks = data[0].shape[0] * data[0].shape[1]
    return dict(params_b=param_count(params) / 1e9, losses=losses,
                grad_norms=norms, step_s=step_s, first_step_s=times[0],
                tokens_per_s=toks / step_s, peak_memory_gb=peak,
                launches=launches, profile=prof)


def train_dense_full_width(cfg, *, steps: int = 10, batch: int = 4,
                           seq: int = 8):
    """granite-moe at all its layers, f32 params, remat, on the dense
    path: ``batch`` x ``seq`` = 32 tokens a step at DENSE_CF, so every
    MoE layer runs moe_ffn (twice a step under remat) and moe_ffn_bwd
    (once): train_steps on SyntheticLM(vocab, name=arch) batches, the
    loss finite and falling, the launches exact (no grouped_ffn), the
    step's device ms and moe_ffn_bwd's share of it."""
    from repro_torch.bridge import init_params
    from repro_torch.data import SyntheticLM, batches

    params = init_params(cfg, seed=0, dtype=torch.float32, device=CUDA)
    stream = batches(SyntheticLM(cfg.vocab_size, name=cfg.name),
                     batch=batch, seq_len=seq, seed=0)
    data = [next(stream) for _ in range(steps)]
    L = cfg.num_layers
    res = dict(layers=L, batch=batch, seq=seq, steps=steps,
               capacity_factor=DENSE_CF)
    res.update(train_steps(cfg, params, data, MOE_BWD_KERNELS,
                           capacity_factor=DENSE_CF))
    launches, prof = res["launches"], res["profile"]
    log(f"train dense {cfg.name}: {L} layers, f32, remat, {batch} x {seq} "
        f"tokens: {json.dumps(res)}")
    log(f"train dense {cfg.name}: moe_ffn_bwd {prof['bwd_ms']:.3f} of the "
        f"step's {prof['device_busy_ms']:.3f} device ms "
        f"({100 * prof['bwd_share']:.1f} %); step {res['step_s']:.4f} s, "
        f"{res['tokens_per_s']:.0f} tokens/s, peak "
        f"{res['peak_memory_gb']:.2f} GB")
    check_train_losses(cfg, res)
    want = {"moe_ffn_bwd": L * steps, "moe_ffn": 2 * L * steps,
            "grouped_ffn": 0, "grouped_ffn_bwd": 0}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"train dense {cfg.name}: launches {launches}, want {want}")
    torch.cuda.empty_cache()
    return res


# the train CLI on the dense path: granite-moe reduced, 1 x 4 tokens
TRAIN_CLI = ["--arch", ARCH, "--reduced", "--batch", "1", "--seq", "4",
             "--steps", "2"]


def train_cli_phase():
    """python -m repro_torch.launch.train TRAIN_CLI on the card, in a
    subprocess (killed after 600 s): it must exit 0 and print a finite
    loss for each step."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("step")]
    res = dict(cmd=" ".join(["python -m repro_torch.launch.train",
                             *TRAIN_CLI]), rc=run.returncode, lines=lines,
               wall_s=time.perf_counter() - t0)
    log(f"train cli: {json.dumps(res)}")
    if run.returncode != 0 or len(lines) != 2 or not all(
            np.isfinite(float(ln.split()[3])) for ln in lines):
        fail(f"train cli: exit {run.returncode}\n{run.stdout[-2000:]}\n"
             f"{run.stderr[-4000:]}")
    return res


def check_train_losses(cfg, res):
    """The loss finite and falling, grad_norm finite."""
    if not all(np.isfinite(res["losses"] + res["grad_norms"])) or \
            res["losses"][-1] >= res["losses"][0]:
        fail(f"train {cfg.name}: the loss did not fall or is not finite")


def train_ssm_full_width(cfg, *, steps: int = 10, batch: int = 8,
                         seq: int = 512):
    """mamba2-370m or zamba2-1.2b at all its layers, f32 params, remat:
    loss_and_grads on step 1's batch, where every SSM layer's in_x,
    in_B, in_C, in_dt, A_log, D and out_proj gradient must be nonzero;
    then ``steps`` train steps (train_steps) on SyntheticLM(vocab,
    name=arch) batches: the loss finite and falling, grad_norm finite,
    ssd_scan_bwd launched exactly once per SSM layer per step and
    ssd_scan twice (the forward, and its recomputation under remat), and
    ssd_scan_bwd's share of a step's device time."""
    from repro_torch.bridge import init_params
    from repro_torch.data import SyntheticLM, batches
    from repro_torch.launch.train import loss_and_grads

    params = init_params(cfg, seed=0, dtype=torch.float32, device=CUDA)
    stream = batches(SyntheticLM(cfg.vocab_size, name=cfg.name),
                     batch=batch, seq_len=seq, seed=0)
    data = [next(stream) for _ in range(steps)]
    _, grads = loss_and_grads(cfg, params,
                              torch.as_tensor(data[0], device=CUDA))
    L = cfg.num_layers
    keys = ("in_x", "in_B", "in_C", "in_dt", "A_log", "D", "out_proj")
    zero = [(k, i) for k in keys for i in range(L)
            if not bool((grads["layers"]["ssm"][k][i] != 0).any())]
    del grads
    if zero:
        fail(f"train {cfg.name}: zero SSM weight gradients {zero}")
    res = dict(layers=L, batch=batch, seq=seq, steps=steps,
               ssm_grads_nonzero=True)
    res.update(train_steps(cfg, params, data, SSD_BWD_KERNELS))
    launches, prof = res["launches"], res["profile"]
    log(f"train {cfg.name}: {L} layers, f32, remat, {batch} x {seq} "
        f"tokens: {json.dumps(res)}")
    log(f"train {cfg.name}: ssd_scan_bwd {prof['bwd_ms']:.3f} of the "
        f"step's {prof['device_busy_ms']:.3f} device ms "
        f"({100 * prof['bwd_share']:.1f} %); step {res['step_s']:.4f} s, "
        f"{res['tokens_per_s']:.0f} tokens/s, peak "
        f"{res['peak_memory_gb']:.2f} GB")
    check_train_losses(cfg, res)
    want = {"ssd_scan_bwd": L * steps, "ssd_scan": 2 * L * steps}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"train {cfg.name}: launches {launches}, want {want}")
    torch.cuda.empty_cache()
    return res


def train_step_profile(step, params, opt, toks, step_s: float,
                       bwd_kernels=BWD_KERNELS):
    """torch.profiler (CUDA activity only) over one more train step:
    device busy ms (the kernels' durations summed), the idle share
    against the unprofiled median step, the kernel count, the eight
    kernels that take the most device time, the port's kernels' ms in
    the step and ``bwd_kernels``' ms and share of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, toks)
        torch.cuda.synchronize()
    kern = cuda_kernels(prof)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    ours = port_kernels_ms(kern, 1)
    bwd = sum(ms for k, ms in ours.items() if k.startswith(bwd_kernels))
    return dict(device_busy_ms=busy, idle=1 - busy / (step_s * 1e3),
                kernels=sum(e.count for e in kern),
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top],
                port_kernels_ms=ours, bwd_ms=bwd, bwd_share=bwd / busy)


def train_bench(cfg, steps: int, seed: int, **kw):
    """benchmarks/common.py trained_model / trained_draft on the card:
    ``steps`` steps at cosine_schedule(3e-3, 10, steps), remat off, on
    8 x 64 batches rotating over the dataset family, from params of the
    port's initializer at ``seed`` drawn on the CPU (so a CPU run of this
    recipe starts from the same numbers). Returns (params, losses)."""
    from repro_torch.bridge import init_params
    from repro_torch.data import make_dataset_family
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import params_to
    from repro_torch.optim import adamw_init, cosine_schedule

    params = params_to(init_params(cfg, seed=seed, device="cpu"), CUDA)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=cosine_schedule(3e-3, 10, steps),
                           remat=False, **kw)
    fam = make_dataset_family(cfg.vocab_size, DATASETS)
    rng = np.random.default_rng(seed)
    names, losses = list(fam), []
    for i in range(steps):
        params, opt, m = step(params, opt,
                              fam[names[i % len(names)]].sample(rng, 8, 64))
        losses.append(m["loss"])
    return params, [float(x) for x in losses]


def trained_spec():
    """fig5_table4_spec's setting on the card: the bench target trained
    150 steps (capacity_factor 4, seed 0) and the dense draft 300 steps
    (seed 1), then drafts cut short at SHORT_DRAFT_STEPS; 8 prompts of 16
    tokens, two per dataset (eval_tokens' layout, seed 123), 48 new,
    spec_len 3, under HIER and NAIVE. Tokens must equal plain greedy
    under every policy and draft; the first short draft whose acceptance
    lies strictly in (0, 1) is named (the phase fails if none does);
    with the 300-step draft HIER must activate fewer experts per verify
    pass than NAIVE."""
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.data import make_dataset_family
    from repro_torch.serving import Engine

    policies = {"HIER": XSharePolicy(mode="spec", k0=1, m_l=2, m_r=1,
                                     corr=1.0),
                "NAIVE": XSharePolicy(mode="spec", k0=0, m_l=0, m_r=4,
                                      corr=0.0)}
    cfg, dcfg = bench_cfg(32, 4), draft_cfg()
    t0 = time.perf_counter()
    params, tlosses = train_bench(cfg, TARGET_STEPS, 0, capacity_factor=4.0)
    drafts = {DRAFT_STEPS: train_bench(dcfg, DRAFT_STEPS, 1)}
    for n in SHORT_DRAFT_STEPS:
        drafts[n] = train_bench(dcfg, n, 1)
    train_s = time.perf_counter() - t0
    fam = make_dataset_family(cfg.vocab_size, DATASETS)
    rng = np.random.default_rng(123)
    prompts = np.concatenate([fam[n].sample(rng, 2, BENCH_PROMPT)
                              for n in DATASETS], axis=0)
    plain, _ = Engine(cfg, params, cache_len=BENCH_CACHE,
                      device=CUDA).generate(prompts, BENCH_NEW)
    runs, short = {}, None
    for steps, (dparams, dlosses) in drafts.items():
        for pname, pol in policies.items():
            eng = Engine(cfg, params, policy=pol, cache_len=BENCH_CACHE,
                         draft=(dcfg, dparams), spec_len=BENCH_SPEC_LEN,
                         device=CUDA)
            eng.generate(prompts, BENCH_NEW)       # captures the graphs
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            toks, st = eng.generate(prompts, BENCH_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            runs[f"{steps}-step draft {pname}"] = dict(
                draft_steps=steps, policy=pname,
                draft_final_loss=dlosses[-1],
                acceptance_rate=st.acceptance_rate,
                mean_accepted=st.mean_accepted, drafted=st.drafted,
                accepted=st.accepted, rounds=st.steps,
                activated_experts=st.mean_aux("activated_experts"),
                tokens_per_s=prompts.shape[0] * BENCH_NEW / wall,
                equal_to_plain=bool(np.array_equal(toks, plain)))
            log(f"trained spec {steps}-step draft {pname}: "
                f"{json.dumps(runs[f'{steps}-step draft {pname}'])}")
        if short is None and steps in SHORT_DRAFT_STEPS and any(
                0.0 < runs[f"{steps}-step draft {p}"]["acceptance_rate"]
                < 1.0 for p in policies):
            short = steps
    full = {p: runs[f"{DRAFT_STEPS}-step draft {p}"] for p in policies}
    # how varied the target's greedy text is: a draft that knows only
    # the most frequent successors agrees with a text that cycles
    distinct = float(np.mean([len(set(r.tolist())) for r in plain]))
    res = dict(target_losses=[tlosses[0], tlosses[-1]],
               plain_distinct_tokens_per_row=distinct,
               draft_losses={n: [d[1][0], d[1][-1]]
                             for n, d in drafts.items()},
               train_s=train_s, runs=runs, short_draft_in_0_1=short,
               acceptance_300=full["HIER"]["acceptance_rate"],
               reference_acceptance=BENCH_SPEC_ACCEPTANCE,
               activated_hier=full["HIER"]["activated_experts"],
               activated_naive=full["NAIVE"]["activated_experts"])
    log(f"trained spec: target loss {tlosses[0]:.3f} -> {tlosses[-1]:.3f}; "
        f"{DRAFT_STEPS}-step draft acceptance HIER "
        f"{full['HIER']['acceptance_rate']:.4f} / NAIVE "
        f"{full['NAIVE']['acceptance_rate']:.4f} (the reference's "
        f"BENCH_spec.json: {BENCH_SPEC_ACCEPTANCE}); first short draft "
        f"with acceptance in (0, 1): {short}; activated experts per "
        f"verify pass HIER {res['activated_hier']:.3f} vs NAIVE "
        f"{res['activated_naive']:.3f} (reference 9.58 vs 10.25); plain "
        f"greedy text: {distinct:.2f} distinct tokens in a row's "
        f"{BENCH_NEW}")
    bad = [k for k, r in runs.items() if not r["equal_to_plain"]]
    if bad:
        fail(f"trained spec: tokens differ from plain greedy in {bad}")
    if short is None:
        fail(f"trained spec: no draft of {SHORT_DRAFT_STEPS} steps gave an "
             f"acceptance strictly between 0 and 1")
    if not res["activated_hier"] < res["activated_naive"]:
        fail("trained spec: HIER activated no fewer experts than NAIVE")
    return res


def claims_cfg():
    """tests/test_system.py's model: 2 layers, d 64, 4 / 2 heads of 16,
    16 experts top-4 of width 64, a vocabulary of 128."""
    from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig
    return ArchConfig(
        name="sys-moe", family="moe", num_layers=2, d_model=64, d_ff=0,
        vocab_size=128,
        attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=64))


CLAIMS_STEPS = 60


def claims_train(device):
    """tests/test_system.py's recipe on ``device``, the one definition
    that tests/test_torch_system.py (the CPU) and trained_claims (the
    card) both train by: claims_cfg() from seed 0 in f32, CLAIMS_STEPS
    steps of make_train_step (cosine_schedule(3e-3, 5, 60), remat off,
    capacity_factor 4) on 8 x 64 batches of SyntheticLM(128, name="sys",
    branch=4) (seed 0). Returns (params, each step's loss as a tensor,
    16 x 64 eval tokens (seed 99), 4 requests of 4 tokens (seed 5))."""
    from repro_torch.bridge import init_params
    from repro_torch.data import SyntheticLM, batches
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = claims_cfg()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=device)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=cosine_schedule(3e-3, 5, CLAIMS_STEPS),
                           remat=False, capacity_factor=4.0)
    lm = SyntheticLM(cfg.vocab_size, name="sys", branch=4)
    stream = batches(lm, batch=8, seq_len=64, seed=0)
    losses = []
    for _ in range(CLAIMS_STEPS):
        params, opt, m = step(params, opt, next(stream))
        losses.append(m["loss"])
    toks = torch.as_tensor(next(batches(lm, batch=16, seq_len=64, seed=99)),
                           device=device)
    reqs = torch.as_tensor(lm.sample(np.random.default_rng(5), 4, 4),
                           device=device)
    return params, losses, toks, reqs


def paper_claims(params, toks, reqs):
    """tests/test_system.py's five claims on claims_cfg()'s ``params``,
    at capacity_factor 16, as (name, measure, forwards on the dense path,
    on the sorted path, holds): (1) batch (k0 1, m_l 2) activates fewer
    experts than off on 2 tokens a row; (2) eval loss under batch k0 2,
    m_l 12 ("rich") less off's < 0.2, and k0 0, m_l 1 ("poor") >= rich;
    (3) spec (k0 1, m_l 0, m_r 2) over 4 requests of 4 tokens activates
    no more than off, its selected set <= 16; (4) ep (k0 1, m_g 2, 4
    groups) on 4 tokens a row keeps max_group_load <= 2; (5) the gate
    mass under batch m_l 1, 4, 12 is monotone and <= 1. A forward of at
    most 32 tokens takes moe_ffn (the dense path), a longer one
    grouped_ffn, once per layer. Call measure under torch.no_grad()."""
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.model import forward, loss_fn

    cfg = claims_cfg()

    def aux_of(t, pol, spec_shape=None):
        return forward(cfg, params, t, policy=pol, spec_shape=spec_shape,
                       capacity_factor=16.0)[1]

    def act(t, pol, spec_shape=None):
        return float(aux_of(t, pol, spec_shape)["activated_experts"]
                     .float().mean())

    def ev(pol):
        return float(loss_fn(cfg, params, toks, policy=pol, remat=False,
                             capacity_factor=16.0, lb_weight=0.0)[0])

    def batch(k0, m_l):
        return XSharePolicy(mode="batch", k0=k0, m_l=m_l)

    off = XSharePolicy(mode="off")
    spec = XSharePolicy(mode="spec", k0=1, m_l=0, m_r=2)
    dec = toks[:, :2]
    return (
        ("1 batch activates fewer", lambda: dict(
            off=act(dec, off), batch=act(dec, batch(1, 2))), 2, 0,
         lambda v: v["batch"] < v["off"]),
        ("2 quality budget", lambda: dict(
            base=ev(off), rich=ev(batch(2, 12)), poor=ev(batch(0, 1))), 0, 3,
         lambda v: v["rich"] - v["base"] < 0.2
         and v["poor"] >= v["rich"] - 1e-6),
        ("3 spec budget", lambda: dict(
            spec=act(reqs, spec, (4, 4)), off=act(reqs, off),
            selected_set=float(aux_of(reqs, spec, (4, 4))["selected_set"]
                               .max())), 3, 0,
         lambda v: v["spec"] <= v["off"] and v["selected_set"] <= 16),
        ("4 ep group load", lambda: dict(max_group_load=float(aux_of(
            toks[:, :4], XSharePolicy(mode="ep", k0=1, m_g=2, num_groups=4))
            ["max_group_load"].max())), 0, 1,
         lambda v: v["max_group_load"] <= 2),
        ("5 gate mass", lambda: {f"m_l {m_l}": float(aux_of(
            dec, batch(1, m_l))["gate_mass"].mean()) for m_l in (1, 4, 12)},
         3, 0, lambda v: v["m_l 1"] <= v["m_l 4"] <= v["m_l 12"]
         <= 1.0 + 1e-6))


def trained_claims():
    """tests/test_system.py's five claims on a model trained on the card
    (claims_train(CUDA)), whose 512-token steps take the sorted path:
    grouped_ffn and grouped_ffn_bwd once per layer per step, exactly, and
    the loss falling. Then each of paper_claims held, its measured values
    printed and its moe_ffn / grouped_ffn launches held exactly."""
    from repro_torch import kernels as K

    L = claims_cfg().num_layers
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    params, losses, toks, reqs = claims_train(CUDA)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    train_launches = K.launch_counts()
    want = {"grouped_ffn": L * CLAIMS_STEPS,
            "grouped_ffn_bwd": L * CLAIMS_STEPS, "moe_ffn": 0,
            "moe_ffn_bwd": 0, "decode_attention": 0}
    wrong = {n: (train_launches[n], v) for n, v in want.items()
             if train_launches[n] != v}
    if wrong or not losses[-1] < losses[0]:
        fail(f"trained claims: launches (counted, expected) {wrong}, loss "
             f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    out = {}
    with torch.no_grad():
        for name, measure, n_dense, n_sorted, holds in paper_claims(
                params, toks, reqs):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            vals = measure()
            torch.cuda.synchronize()
            counts = K.launch_counts()
            want = {"moe_ffn": L * n_dense, "grouped_ffn": L * n_sorted,
                    "decode_attention": 0}
            ok = holds(vals)
            out[name] = dict(values=vals, holds=ok, launches=counts)
            log(f"trained claims {name}: {json.dumps(vals)} holds={ok}; "
                f"launches {counts}")
            wrong = {n: (counts[n], v) for n, v in want.items()
                     if counts[n] != v}
            if wrong:
                fail(f"trained claims {name}: launches (counted, expected) "
                     f"{wrong}")
    bad = [n for n, c in out.items() if not c["holds"]]
    log(f"trained claims: {CLAIMS_STEPS} steps in {train_s:.2f} s on the "
        f"card, loss {losses[0]:.4f} -> {losses[-1]:.4f}, training "
        f"launches {train_launches}; claims failing: {bad}")
    if bad:
        fail(f"trained claims: {bad} do not hold on the card")
    return dict(losses=[losses[0], losses[-1]], train_s=train_s,
                train_launches=train_launches, claims=out)


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
        log(f"built kernels in {time.perf_counter() - t0:.1f} s; each "
            f"nvcc unit's wall from the common start: "
            f"{[ln[3:] for ln in build.build_log.splitlines() if ln.startswith('== ')]}")
        ptxas = ptxas_report(build.build_log)
        for f in ptxas:
            log(f"  ptxas: {f['source']} {f['function'][:90]}: "
                f"{f['registers']} registers, {f['spill_bytes']} bytes "
                f"spilled")
        spills = [f for f in ptxas if f["spill_bytes"]]
        log(f"  ptxas: {len(ptxas)} kernels, {len(spills)} with spills: "
            f"{[(f['source'], f['function'][:60]) for f in spills]}")

    cfg = ARCHS[ARCH]
    with Phase("kernels"), torch.no_grad():
        cases = kernel_cases(ARCHS)
        cases["ssd_scan"] = ssd_cases(ARCHS)
        cases["grouped_ffn_bwd"] = grouped_bwd_cases(ARCHS)
        cases["ssd_scan_bwd"] = ssd_bwd_cases(ARCHS)
        cases["moe_ffn_bwd"] = moe_bwd_cases(ARCHS)
        for name, cs in paper_model_cases(ARCHS).items():
            cases[name] += cs
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
        parity[VLM] = path_parity(ARCHS[VLM], 64, 384,
                                  prefix_len=FAMILY_PREFIX)
        parity[AUDIO] = path_parity(ARCHS[AUDIO], 64, 128)
        parity[f"{ARCH} spec"] = spec_parity(cfg, 64, 128)
        parity[GPT_OSS] = path_parity(ARCHS[GPT_OSS], 64, 128,
                                      layers=GPT_OSS_PARITY_LAYERS)
        parity[LLAMA] = path_parity(ARCHS[LLAMA], 64, 128)
        torch.cuda.empty_cache()

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
    # the reference's other entry point: the serve CLI, and the public
    # kernel wrappers of kernels/ops.py
    with Phase(f"serve cli {ARCH}"), torch.no_grad():
        serve_cli = {"ops": ops_cases(ARCHS)}
        serve_cli.update(serve_cli_phase(cfg, prof[ARCH]))
        results[f"{ARCH} serve cli"] = serve_cli["runs"]
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
    # expert parallelism: Engine(dispatch="ep") at full width, then the
    # executor alone at the paper's EP model's expert widths
    ep = {}
    with Phase(f"ep {ARCH}"), torch.no_grad():
        ep[ARCH] = ep_serve_phase(cfg, params, prompts)
        results[f"{ARCH} ep"] = ep[ARCH]
    del params
    torch.cuda.empty_cache()
    with Phase(f"ep {DS} layer"), torch.no_grad():
        ep[f"{DS} layer"] = ep_layer_phase(ARCHS[DS])
        results[f"{DS} ep layer"] = {
            "layer calls": {"launches": ep[f"{DS} layer"]["launches"]}}
        torch.cuda.empty_cache()
    # one process per shard: ranks over gloo on the one card, NCCL at
    # world size 1
    with Phase("ep ranks"), torch.no_grad():
        ep["ranks"] = ep_ranks_phase(ARCHS[DS], cfg)
        results[f"{DS} ep ranks"] = ep["ranks"]["launches"]
        torch.cuda.empty_cache()
    # the paper's evaluation model at its own widths, 8 of its 36 layers
    paper = {}
    gcfg = ARCHS[GPT_OSS]
    with Phase(f"main path {GPT_OSS}"):
        results[GPT_OSS], paper[GPT_OSS], params, prompts = gpt_oss_served(
            gcfg)
    del params
    torch.cuda.empty_cache()
    with Phase(f"bf16 check {GPT_OSS}"), torch.no_grad():
        from repro_torch.bridge import init_params
        cut = dataclasses.replace(gcfg, num_layers=GPT_OSS_PARITY_LAYERS)
        bf16_check[GPT_OSS] = bf16_model_check(
            cut, init_params(cut, seed=0, dtype=torch.bfloat16, device=CUDA),
            prompts, cache_len=512, module=dispatch, attr="grouped_ffn",
            plain=grouped_ffn_plain)
        torch.cuda.empty_cache()
    # the dense family at head dim 128, all 32 layers
    lcfg = ARCHS[LLAMA]
    with Phase(f"main path {LLAMA}"):
        results[LLAMA], params, _, _ = main_path(
            lcfg, kernels=("decode_attention",), prompt_len=128, new=32,
            cache_len=512, policies=(OFF,), expect=dense_expect(lcfg, 32))
        paper[LLAMA] = {"roofline": served_decode_roofline(
            lcfg, results[LLAMA], (OFF,))}
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
    # the VLM and audio families at full width, one model at a time
    with Phase("families"):
        results[VLM] = {"prefix": vlm_served(ARCHS[VLM])}
        torch.cuda.empty_cache()
        results[AUDIO] = audio_served(ARCHS[AUDIO])
        torch.cuda.empty_cache()
    # the planning experiments' e4m3 cache, at decode_32k's cache length
    with Phase(f"f8 cache {AUDIO} decode_32k"), torch.no_grad():
        f8_cache = f8_cache_phase(ARCHS[AUDIO])
        results[f"{AUDIO} f8 decode_32k"] = {
            "e4m3": {"launches": f8_cache["launches"]}}
        cases["decode_attention"].append(f8_cache["served_kernel_case"])
    with Phase("dryrun"):
        dry = dryrun_phase()

    # training: the one kernel on its path is grouped_ffn, forward and
    # backward (the train step's counters are the backward's launches)
    with Phase(f"train {ARCH}"):
        train = {"parity": train_parity(cfg),
                 "full_width": train_full_width(cfg)}
        torch.cuda.empty_cache()
    # the dense path: moe_ffn forward, moe_ffn_bwd backward
    with Phase(f"train dense {ARCH}"):
        train["dense parity"] = train_parity(
            cfg, seq=8, bwd="moe_ffn_bwd", capacity_factor=DENSE_CF,
            never=("grouped_ffn", "grouped_ffn_bwd"))
        train["dense full_width"] = train_dense_full_width(cfg)
        train["cli"] = train_cli_phase()
    # the SSM and hybrid families: ssd_scan forward, ssd_scan_bwd backward
    for name in SSM_ARCHS:
        with Phase(f"train parity {name}"):
            train[f"{name} parity"] = train_parity(
                ARCHS[name], seq=500, bwd="ssd_scan_bwd")
            torch.cuda.empty_cache()
    for name in SSM_ARCHS:
        with Phase(f"train {name}"):
            train[name] = train_ssm_full_width(ARCHS[name])
    with Phase("trained spec"):
        train["trained_spec"] = trained_spec()
        torch.cuda.empty_cache()
    with Phase("trained claims"):
        train["trained_claims"] = trained_claims()

    sources = {"grouped_ffn": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                               "src/repro/kernels/moe_ffn.py:155"),
               # the gradient of the same TPU kernel (the JAX package
               # differentiates its jnp twin; Pallas has no backward)
               "grouped_ffn_bwd": (
                   "src/repro_torch/kernels/csrc/grouped_ffn_bwd.cu",
                   "src/repro/kernels/moe_ffn.py:155"),
               "moe_ffn": ("src/repro_torch/kernels/csrc/moe_ffn.cu",
                           "src/repro/kernels/moe_ffn.py:77"),
               # its gradient (the JAX package differentiates its dense
               # jnp path, src/repro/models/moe.py:245-259)
               "moe_ffn_bwd": ("src/repro_torch/kernels/csrc/moe_ffn_bwd.cu",
                               "src/repro/kernels/moe_ffn.py:77"),
               "decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attn.cuh",
                   "src/repro/kernels/decode_attn.py:67"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:66"),
               # its gradient (the JAX package differentiates
               # src/repro/models/ssm.py:87 ssd_chunked)
               "ssd_scan_bwd": (
                   "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                   "src/repro/kernels/ssd_scan.py:66")}
    line = []
    bwd_runs = {"grouped_ffn_bwd": [train["full_width"]],
                "ssd_scan_bwd": [train[n] for n in SSM_ARCHS],
                "moe_ffn_bwd": [train["dense full_width"]]}
    for name, cs in cases.items():
        # serving's main path runs bf16; training (the backwards) f32
        main_dtype = "float32" if name in bwd_runs else "bfloat16"
        main_case = next(c for c in cs if c["dtype"] == main_dtype)
        f32 = next(c for c in cs if c["dtype"] == "float32")
        tol = {"ssd_scan": SCAN_TOL,
               "ssd_scan_bwd": SCAN_BWD_TOL}.get(name, TOL)
        # summed over every main path's continuous runs; a backward's
        # over the full-width train steps
        launches = sum(r["launches"][name] for r in bwd_runs[name]) \
            if name in bwd_runs else \
            sum(r["launches"][name] for runs in results.values()
                for r in runs.values())
        line.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=launches,
            max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"],
            dtype=main_dtype, shape=main_case["shape"],
            tol=tol[getattr(torch, main_dtype)],
            max_abs_err_f32=f32["max_abs_err"],
            tol_f32=tol[torch.float32], cases=cs))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": line, "main_path": results,
                      "parity": parity, "spec_lossless": lossless,
                      "bf16_check": bf16_check, "profile": prof,
                      "graphs": graphs, "serve_cli": serve_cli,
                      "durability": durability,
                      "ep": ep, "train": train, "f8_cache": f8_cache,
                      "paper_models": paper,
                      "dryrun": dry, "card": card}),
          flush=True)
    print(gpu_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
