"""The hand-written CUDA kernels against their plain versions on a GPU,
at small and awkward shapes (ragged tiles, widths that are not a
multiple of the block, lengths of 0). Marked ``gpu``: they skip where
there is no CUDA device. Run them on a GPU machine with

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest: the suite's conftest imports JAX, which such a machine
need not have). Tolerances are tests/test_kernels.py's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chip_smoke():
    """The repository's chip_smoke.py as a module: its profiler count of
    the CUDA kernels one call runs is the one the tests hold too."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rand(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def check(out, ref, dtype):
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,E,f,k", [(8, 64, 4, 128, 2),
                                       (32, 128, 6, 96, 2),
                                       (300, 96, 8, 80, 3)])
def test_grouped_ffn_kernel(cuda, dtype, T, d, E, f, k):
    from repro_torch import kernels as K
    from repro_torch.core.routing import topk_route
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens
    g = torch.Generator().manual_seed(T)
    x = rand(g, (T, d), dtype).to(cuda)
    w1, w3 = (rand(g, (E, d, f), dtype, 0.05).to(cuda) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.05).to(cuda)
    idx, w = topk_route(rand(g, (T, E), torch.float32).to(cuda), k)
    plan = dispatch_plan(idx, w, E)
    xs = gather_tokens(x, plan)
    before = K.grouped_ffn.launches
    out = K.grouped_ffn(xs, w1, w3, w2, plan.tile_eid, plan.tile_valid,
                        block_t=plan.block_t)
    assert K.grouped_ffn.launches == before + 1
    ref = K.grouped_ffn_plain(xs, w1, w3, w2, plan.tile_eid,
                              plan.tile_valid, block_t=plan.block_t)
    check(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,E,f,n_act,max_active", [
    (1, 64, 4, 128, 2, 2), (8, 1024, 32, 512, 12, 16), (17, 96, 6, 80, 6, 6),
    (32, 128, 8, 64, 0, 3)])
def test_moe_ffn_kernel(cuda, dtype, T, d, E, f, n_act, max_active):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(T + E)
    x = rand(g, (T, d), dtype).to(cuda)
    w1, w3 = (rand(g, (E, d, f), dtype, 0.05).to(cuda) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.05).to(cuda)
    active = torch.zeros(E, dtype=torch.bool)
    active[torch.randperm(E, generator=g)[:n_act]] = True
    combine = torch.rand((T, E), generator=g) * active[None]
    active, combine = active.to(cuda), combine.to(cuda)
    out = K.moe_ffn(x, w1, w3, w2, combine, active, max_active=max_active)
    ref = K.moe_ffn_plain(x, w1, w3, w2, combine, active)
    check(out, ref, dtype)
    again = K.moe_ffn(x, w1, w3, w2, combine, active,
                      max_active=max_active)
    assert torch.equal(out, again), "moe_ffn must be deterministic"


def _moe_case(g, dev, dtype, T, d, E, f, on):
    x = rand(g, (T, d), dtype).to(dev)
    w1, w3 = (rand(g, (E, d, f), dtype, 0.05).to(dev) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.05).to(dev)
    active = torch.zeros(E, dtype=torch.bool)
    active[list(on)] = True
    combine = torch.rand((T, E), generator=g) * active[None]
    return x, w1, w3, w2, combine.to(dev), active.to(dev)


# the kernel finds each slot's expert from `active` itself (the s-th set
# entry): scattered ids over a wide E, a full budget, the first and the
# last expert alone, E = 256 with one token, and 32 tokens at granite's
# widths
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,E,f,on,max_active", [
    (8, 64, 128, 64, tuple(range(1, 128, 3))[:40], 48),
    (8, 128, 32, 64, tuple(range(0, 32, 2)), 16),
    (4, 64, 32, 128, (0,), 4),
    (4, 64, 32, 128, (31,), 4),
    (1, 64, 256, 64, (3, 77, 128, 200, 255), 8),
    (32, 1024, 8, 512, (1, 2, 5, 7), 8)],
    ids=["E128-scattered", "full-budget", "only-first", "only-last",
         "E256-T1", "T32-granite-widths"])
def test_moe_ffn_kernel_finds_experts(cuda, dtype, T, d, E, f, on,
                                      max_active):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(E + len(on))
    args = _moe_case(g, cuda, dtype, T, d, E, f, on)
    out = K.moe_ffn(*args, max_active=max_active)
    check(out, K.moe_ffn_plain(*args), dtype)
    assert torch.equal(out, K.moe_ffn(*args, max_active=max_active)), \
        "moe_ffn must be deterministic"


def test_moe_ffn_one_call_is_at_most_three_kernels(cuda):
    from repro_torch import kernels as K
    cuda_kernels_of = _chip_smoke().cuda_kernels_of
    g = torch.Generator().manual_seed(0)
    x, w1, w3, w2, combine, active = _moe_case(
        g, cuda, torch.bfloat16, 8, 1024, 32, 512, range(0, 32, 3))
    # routing hands over a column slice of a (T, E + 1) matrix
    wide = torch.zeros((8, 33), device=cuda)
    wide[:, :32] = combine
    args = (x, w1, w3, w2, wide[:, :32], active)
    n, per_kernel = cuda_kernels_of(lambda: K.moe_ffn(*args, max_active=16))
    assert 1 <= n <= 3, f"one moe_ffn call ran {n} CUDA kernels: " \
        f"{per_kernel}"


def test_moe_ffn_refuses_widths_not_a_multiple_of_8(cuda):
    from repro_torch import kernels as K
    x = torch.zeros((4, 60), device=cuda)
    w = torch.zeros((2, 60, 60), device=cuda)
    with pytest.raises(ValueError):
        K.moe_ffn(x, w, w, w, torch.zeros((4, 2), device=cuda),
                  torch.ones(2, dtype=torch.bool, device=cuda),
                  max_active=2)


def test_moe_ffn_refuses_more_than_32_tokens(cuda):
    from repro_torch import kernels as K
    x = torch.zeros((33, 64), device=cuda)
    w = torch.zeros((2, 64, 64), device=cuda)
    with pytest.raises(ValueError):
        K.moe_ffn(x, w, w, w, torch.zeros((33, 2), device=cuda),
                  torch.ones(2, dtype=torch.bool, device=cuda),
                  max_active=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,dh,S", [(2, 8, 2, 64, 256),
                                          (3, 4, 4, 32, 100),
                                          (1, 16, 2, 128, 1024),
                                          (2, 4, 1, 64, 64),
                                          (8, 16, 8, 64, 512),
                                          (8, 32, 32, 64, 1024)])
def test_decode_attention_kernel(cuda, dtype, B, H, Hkv, dh, S):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(B * S)
    q = rand(g, (B, H, dh), dtype).to(cuda)
    k = rand(g, (B, S, Hkv, dh), dtype).to(cuda)
    v = rand(g, (B, S, Hkv, dh), dtype).to(cuda)
    lengths = torch.randint(0, S + 1, (B,), generator=g)
    lengths[0] = 0
    lengths = lengths.to(cuda)
    out = K.decode_attention(q, k, v, lengths)
    ref = K.decode_attention_plain(q, k, v, lengths)
    assert float(out[0].float().abs().max()) == 0.0
    check(out, ref, dtype)


def _attn_case(g, dev, dtype, B, H, Hkv, dh, S, lengths):
    q = rand(g, (B, H, dh), dtype).to(dev)
    k = rand(g, (B, S, Hkv, dh), dtype).to(dev)
    v = rand(g, (B, S, Hkv, dh), dtype).to(dev)
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32).to(dev)


def _span(B, S, Hkv, dh, dtype, dev):
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import (_sm_count, block_step,
                                                 split_plan)
    code = build.DTYPE_CODES[str(dtype).replace("torch.", "")]
    return split_plan(B, S, Hkv, block_step(dh, code),
                      _sm_count(dev.index or 0))


# positions per split-block step: 4 warps x 4 a lane x 32 / lanes a
# warp load, a row's 16-byte chunks on a power of two of lanes (head dim
# 80: 10 bf16 chunks on 16 lanes, 20 f32 chunks on 32)
@pytest.mark.parametrize("dtype,steps", [
    (torch.float32, {16: 128, 32: 64, 64: 32, 80: 16, 128: 16, 256: 16}),
    (torch.bfloat16, {16: 256, 32: 128, 64: 64, 80: 32, 128: 32,
                      256: 16})])
def test_decode_attention_block_step(cuda, dtype, steps):
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import _HEAD_DIMS, block_step
    code = build.DTYPE_CODES[str(dtype).replace("torch.", "")]
    assert {dh: block_step(dh, code) for dh in _HEAD_DIMS} == steps
    assert block_step(96, code) == 0


# the kernel cuts S into spans, one block each: a length of 1, exactly
# one span, one position into the next span, and the whole cache
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,dh,S", [(16, 8, 64, 512), (32, 32, 64, 1024),
                                        (8, 1, 128, 300), (4, 4, 32, 100),
                                        (16, 2, 256, 200)])
def test_decode_attention_split_edges(cuda, dtype, H, Hkv, dh, S):
    from repro_torch import kernels as K
    n_split, span = _span(4, S, Hkv, dh, dtype, cuda)
    assert n_split * span >= S
    lengths = [1, min(span, S), min(span + 1, S), S]
    g = torch.Generator().manual_seed(S + dh)
    args = _attn_case(g, cuda, dtype, 4, H, Hkv, dh, S, lengths)
    check(K.decode_attention(*args), K.decode_attention_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 8])
def test_decode_attention_many_splits(cuda, dtype, H):
    from repro_torch import kernels as K
    n_split, _ = _span(1, 4096, 1, 64, dtype, cuda)
    assert n_split >= 32
    g = torch.Generator().manual_seed(H)
    for length in (4096, 2777):
        args = _attn_case(g, cuda, dtype, 1, H, 1, 64, 4096, [length])
        check(K.decode_attention(*args), K.decode_attention_plain(*args),
              dtype)


# the main paths at the lengths they serve: granite-moe (128 prompt
# tokens + up to 32 new, cache 512) and zamba2-1.2b (500 + 32, 1024)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,S,lo,hi", [(16, 8, 512, 129, 160),
                                           (32, 32, 1024, 501, 532)],
                         ids=["granite", "zamba2"])
def test_decode_attention_served_lengths(cuda, dtype, H, Hkv, S, lo, hi):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(lo)
    lengths = torch.randint(lo, hi + 1, (8,), generator=g)
    args = _attn_case(g, cuda, dtype, 8, H, Hkv, 64, S, lengths)
    out = K.decode_attention(*args)
    check(out, K.decode_attention_plain(*args), dtype)
    assert torch.equal(out, K.decode_attention(*args)), \
        "decode_attention must give the same bits call after call"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_is_deterministic(cuda, dtype):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(7)
    lengths = torch.randint(1, 513, (8,), generator=g)
    args = _attn_case(g, cuda, dtype, 8, 16, 8, 64, 512, lengths)
    first = K.decode_attention(*args)
    for _ in range(3):
        assert torch.equal(first, K.decode_attention(*args))


def test_decode_attention_one_call_is_at_most_two_kernels(cuda):
    from repro_torch import kernels as K
    cuda_kernels_of = _chip_smoke().cuda_kernels_of
    g = torch.Generator().manual_seed(8)
    for H, Hkv, S, lo in ((16, 8, 512, 129), (32, 32, 1024, 501)):
        args = _attn_case(g, cuda, torch.bfloat16, 8, H, Hkv, 64, S,
                          torch.randint(lo, lo + 32, (8,), generator=g))
        n, per_kernel = cuda_kernels_of(lambda: K.decode_attention(*args))
        assert 1 <= n <= 2, f"one decode_attention call ran {n} CUDA " \
            f"kernels: {per_kernel}"


def test_decode_attention_refuses_misaligned_tensors(cuda):
    from repro_torch import kernels as K
    q = _misaligned((2, 4, 64), torch.bfloat16, cuda)
    kv = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16, device=cuda)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.decode_attention(q, kv, kv, lengths)


# ------------------------------------------ the cached_attention contract

def _cached_case(g, dev, dtype, B, T, H, Hkv, dh, C, cur):
    q = rand(g, (B, T, H, dh), dtype).to(dev)
    k = rand(g, (B, C, Hkv, dh), dtype).to(dev)
    v = rand(g, (B, C, Hkv, dh), dtype).to(dev)
    return q, k, v, torch.as_tensor(cur, dtype=torch.int32).to(dev)


def _cached_check(dev, g, dtype, T, H, Hkv, dh, window):
    """Three rows: a full cache with cur_len ragged over [0, C - T]; a
    rolling window of 40 in a cache of 48 with cur_len before and past
    C (the cache wraps)."""
    from repro_torch import kernels as K
    if window is None:
        C = 96
        cur = [0, 37, C - T]
    else:
        C = window + 8
        cur = [C - 3, 2 * C + 5, 3 * C - 1]
    args = _cached_case(g, dev, dtype, 3, T, H, Hkv, dh, C, cur)
    before = K.decode_attention.launches
    out = K.decode_attention_cached(*args, window=window)
    assert K.decode_attention.launches == before + 1
    ref = K.decode_attention_cached_plain(*args, window=window)
    check(out, ref, dtype)


@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [1, 2, 5, 8])
def test_decode_attention_cached_kernel(cuda, T, rep, dh):
    """T queries per row (one verify pass: 1 + L_s), H / Hkv = rep, every
    head dim, full and windowed caches, f32 and bf16."""
    g = torch.Generator().manual_seed(T * 100 + rep * 10 + dh)
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 40):
            _cached_check(cuda, g, dtype, T, 2 * rep, 2, dh, window)


# granite-moe's verify shape (B 8, 1 + L_s = 5, cache 512, 16 / 8 heads of
# 64) at the lengths it serves, and its heads under a rolling window of
# 128 (cache 640) with cur_len over three wraps
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 128], ids=["full", "window"])
def test_decode_attention_cached_verify_shape(cuda, dtype, window):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(5)
    C = 512 if window is None else window + 512
    cur = torch.randint(128, 161, (8,), generator=g) if window is None \
        else torch.randint(0, 3 * C, (8,), generator=g)
    args = _cached_case(g, cuda, dtype, 8, 5, 16, 8, 64, C, cur)
    out = K.decode_attention_cached(*args, window=window)
    check(out, K.decode_attention_cached_plain(*args, window=window), dtype)
    for _ in range(3):
        assert torch.equal(out, K.decode_attention_cached(*args,
                                                          window=window)), \
            "decode_attention must give the same bits call after call"


@pytest.mark.parametrize("window", [None, 128], ids=["full", "window"])
def test_decode_attention_cached_is_at_most_two_kernels(cuda, window):
    from repro_torch import kernels as K
    cuda_kernels_of = _chip_smoke().cuda_kernels_of
    g = torch.Generator().manual_seed(6)
    C = 512 if window is None else window + 512
    args = _cached_case(g, cuda, torch.bfloat16, 8, 5, 16, 8, 64, C,
                        torch.randint(128, 161, (8,), generator=g))
    n, per_kernel = cuda_kernels_of(
        lambda: K.decode_attention_cached(*args, window=window))
    assert 1 <= n <= 2, f"one decode_attention call ran {n} CUDA " \
        f"kernels: {per_kernel}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_cached_one_query_equals_lengths_contract(cuda,
                                                                   dtype):
    """T = 1 on a full cache is the Pallas contract with lengths =
    cur_len + 1: the same bits."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(7)
    for H, Hkv, S in ((16, 8, 512), (32, 32, 1024)):
        lengths = torch.randint(1, S + 1, (8,), generator=g)
        q, k, v, lens = _attn_case(g, cuda, dtype, 8, H, Hkv, 64, S,
                                   lengths)
        one = K.decode_attention(q, k, v, lens)
        cached = K.decode_attention_cached(q[:, None].contiguous(), k, v,
                                           lens - 1)
        assert torch.equal(one, cached[:, 0])


# h2o-danube-1.8b's decode and verify shapes: head dim 80 (10 bf16
# chunks padded to 16 lanes, 20 f32 chunks to 32), 32 / 8 heads, a
# rolling window of 4096 in 4608 slots with cur_len past C (wrapped)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 5])
def test_decode_attention_head_dim_80(cuda, dtype, T):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(80 + T)
    C, window = 4608, 4096
    cur = torch.randint(C, 3 * C, (4,), generator=g)
    args = _cached_case(g, cuda, dtype, 4, T, 32, 8, 80, C, cur)
    out = K.decode_attention_cached(*args, window=window)
    check(out, K.decode_attention_cached_plain(*args, window=window), dtype)
    for _ in range(3):
        assert torch.equal(out, K.decode_attention_cached(*args,
                                                          window=window)), \
            "decode_attention must give the same bits call after call"


def test_decode_attention_reads_a_bf16_cache_under_f32_queries(cuda):
    """q is cast to the cache's dtype, as the reference does; the output
    comes back in q's dtype. A float8_e5m2 cache has no instance and is
    refused on the card (an e4m3 one has: the tests below)."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(12)
    q, k, v, cur = _cached_case(g, cuda, torch.bfloat16, 3, 5, 8, 2, 64,
                                96, [0, 37, 91])
    want = K.decode_attention_cached(q, k, v, cur).float()
    out = K.decode_attention_cached(q.float(), k, v, cur)
    assert out.dtype == torch.float32
    assert torch.equal(out, want)
    check(out, K.decode_attention_cached_plain(q.float(), k, v, cur),
          torch.bfloat16)
    f8 = k.to(torch.float8_e5m2)
    with pytest.raises(ValueError, match="float8_e5m2"):
        K.decode_attention_cached(q, f8, f8, cur)


# ------------------------------------------------ the e4m3 cache instance

# (atol, rtol) of a bf16 output against f32 math on its inputs: one
# rounding to bf16 is within 2^-9 of the value (chip_smoke.EXACT_BF16)
EXACT_BF16 = (1e-5, 2.0 ** -8)


def _e4m3_case(g, dev, B, T, H, Hkv, dh, C, cur):
    q, k, v, cur = _cached_case(g, dev, torch.bfloat16, B, T, H, Hkv, dh,
                                C, cur)
    return q, k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn), cur


def test_decode_attention_e4m3_block_step(cuda):
    """An e4m3 lane loads 8 bytes, 8 elements: bf16's geometry."""
    from repro_torch.kernels.decode_attn import E4M3_CODE, block_step
    assert {dh: block_step(dh, E4M3_CODE) for dh in (64, 128)} == \
        {64: 64, 128: 32}
    assert block_step(80, E4M3_CODE) == 0


# musicgen-large's heads (32 / 32 of 64) and qwen3-moe-235b's (64 / 4 of
# 128), a decode step and a verify pass, full cache and rolling window
@pytest.mark.parametrize("window", [None, 40], ids=["full", "window"])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("H,Hkv,dh", [(32, 32, 64), (64, 4, 128),
                                      (16, 8, 64)])
def test_decode_attention_e4m3_cached(cuda, H, Hkv, dh, T, window):
    """bf16 q over an e4m3 cache: within TOL of the plain version on the
    same cache (which dequantizes it to bf16) and within EXACT_BF16 of
    f32 math on the dequantized inputs; the same bits call after call."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(T * 1000 + dh + H)
    if window is None:
        C, cur = 96, [0, 37, 96 - T]
    else:
        C = window + 8
        cur = [C - 3, 2 * C + 5, 3 * C - 1]
    q, k, v, cur = _e4m3_case(g, cuda, 3, T, H, Hkv, dh, C, cur)
    before = K.decode_attention.launches
    out = K.decode_attention_cached(q, k, v, cur, window=window)
    assert K.decode_attention.launches == before + 1
    assert out.dtype == torch.bfloat16
    check(out, K.decode_attention_cached_plain(q, k, v, cur, window=window),
          torch.bfloat16)
    exact = K.decode_attention_cached_plain(
        q.float(), k.float(), v.float(), cur, window=window)
    atol, rtol = EXACT_BF16
    torch.testing.assert_close(out.float(), exact, atol=atol, rtol=rtol)
    for _ in range(2):
        assert torch.equal(out, K.decode_attention_cached(q, k, v, cur,
                                                          window=window))


def test_decode_attention_e4m3_lengths_contract_and_f32_queries(cuda):
    """The Pallas contract (one query per row, lengths) over an e4m3
    cache, and f32 queries, which are read as bf16 and come back f32."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(21)
    q, k, v, cur = _e4m3_case(g, cuda, 4, 1, 16, 8, 128, 300,
                              [0, 1, 150, 299])
    lengths = cur + 1
    check(K.decode_attention(q[:, 0], k, v, lengths),
          K.decode_attention_plain(q[:, 0], k, v, lengths), torch.bfloat16)
    out = K.decode_attention_cached(q.float(), k, v, cur)
    assert out.dtype == torch.float32
    assert torch.equal(out, K.decode_attention_cached(q, k, v, cur).float())


def test_decode_attention_e4m3_refuses_other_head_dims(cuda):
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(22)
    q, k, v, cur = _e4m3_case(g, cuda, 2, 1, 4, 4, 80, 64, [3, 9])
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        K.decode_attention_cached(q, k, v, cur)


def test_f8_cache_model_on_the_card_matches_the_cpu(cuda):
    """A 2-layer f32 granite-moe with an e4m3 cache: prefill writes the
    cache, three decode steps update it in place; the greedy
    tokens equal the CPU's, the logits are within the bf16 TOL, and the
    cache bytes the card wrote equal the CPU's where both rounded the
    same f32 values (at most a few elements differ by one code)."""
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import decode_step, params_to, prefill
    cfg = ARCHS["granite-moe-1b-a400m"].reduced(
        num_layers=2, max_d_model=128, max_vocab=256)
    params = init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    f8 = torch.float8_e4m3fn
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        p = params_to(params, dev)
        logits, cache, _ = prefill(cfg, p, toks.to(dev), cache_len=32,
                                   cache_dtype=f8)
        assert cache["kv_k"].dtype == f8
        out, tok = [logits.float().cpu()], logits.argmax(-1)
        for _ in range(3):
            lg, cache, _ = decode_step(cfg, p, tok[:, None].int(), cache)
            out.append(lg[:, 0].float().cpu())
            tok = lg[:, 0].argmax(-1)
        runs[dev.type] = (out, {k: c.cpu() for k, c in cache.items()})
    (oc, cc), (og, cg) = runs["cpu"], runs["cuda"]
    for a, b in zip(oc, og):
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        torch.testing.assert_close(b, a, atol=2e-2, rtol=2e-2)
    assert torch.equal(cc["cur_len"], cg["cur_len"])
    for key in ("kv_k", "kv_v"):
        diff = (cc[key].view(torch.uint8).int()
                - cg[key].view(torch.uint8).int()).abs()
        assert int((diff > 1).sum()) == 0 and \
            float((diff > 0).float().mean()) < 0.01, key


def test_cached_attention_start_pos_raises_on_cuda(cuda):
    from repro_torch.models.attention import cached_attention
    q = torch.zeros((2, 3, 4, 64), device=cuda)
    kv = torch.zeros((2, 16, 2, 64), device=cuda)
    cur = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="start_pos"):
        cached_attention(q, kv, kv, cur,
                         start_pos=torch.zeros((2, 1, 1), device=cuda))


def _grouped_case(g, dev, dtype, d, E, f, idx, w, block_t=None):
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens
    x = rand(g, (idx.shape[0], d), dtype).to(dev)
    w1, w3 = (rand(g, (E, d, f), dtype, 0.05).to(dev) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.05).to(dev)
    plan = dispatch_plan(idx.to(dev), w.to(dev), E, block_t=block_t)
    return (gather_tokens(x, plan), w1, w3, w2, plan.tile_eid,
            plan.tile_valid), plan.block_t


# block_t at both ends of default_block_t's range [8, 256] (256 spans
# two of the kernel's 128-row blocks), and every row on one expert
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,E,f,k,block_t,one_expert", [
    (40, 64, 4, 128, 2, 8, False), (300, 96, 8, 80, 3, 256, False),
    (600, 128, 6, 64, 2, 256, False), (200, 64, 8, 96, 1, 16, True),
    (500, 128, 4, 128, 2, 128, True)])
def test_grouped_ffn_kernel_tiles(cuda, dtype, T, d, E, f, k, block_t,
                                  one_expert):
    from repro_torch import kernels as K
    from repro_torch.core.routing import topk_route
    g = torch.Generator().manual_seed(T + block_t)
    if one_expert:   # every row on expert E - 1 (k = 1) or E - 1 and 0
        idx = torch.tensor([[E - 1, 0][:k]] * T)
        w = torch.full((T, k), 1.0 / k)
    else:
        idx, w = topk_route(rand(g, (T, E), torch.float32), k)
    args, bt = _grouped_case(g, cuda, dtype, d, E, f, idx, w, block_t)
    assert bt == block_t
    out = K.grouped_ffn(*args, block_t=bt)
    check(out, K.grouped_ffn_plain(*args, block_t=bt), dtype)
    assert torch.equal(out, K.grouped_ffn(*args, block_t=bt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_invalid_tiles_give_zeros(cuda, dtype):
    from repro_torch import kernels as K
    from repro_torch.core.routing import topk_route
    g = torch.Generator().manual_seed(3)
    idx, w = topk_route(rand(g, (64, 8), torch.float32), 2)
    args, bt = _grouped_case(g, cuda, dtype, 64, 8, 64, idx, w, 16)
    xs, w1, w3, w2, eid, valid = args
    # a call with valid tiles first leaves nonzero rows in the block the
    # allocator hands the next output, so stale memory cannot pass
    nonzero = K.grouped_ffn(*args, block_t=bt)
    assert float(nonzero.float().abs().max()) > 0.0
    del nonzero
    out = K.grouped_ffn(xs, w1, w3, w2, eid, torch.zeros_like(valid),
                        block_t=bt)
    assert float(out.float().abs().max()) == 0.0
    assert not bool(torch.isnan(out.float()).any())


def test_grouped_ffn_granite_prefill_shape(cuda):
    from repro_torch import kernels as K
    from repro_torch.core.routing import topk_route
    g = torch.Generator().manual_seed(1024)
    idx, w = topk_route(rand(g, (8 * 128, 32), torch.float32), 8)
    args, bt = _grouped_case(g, cuda, torch.bfloat16, 1024, 32, 512, idx, w)
    assert bt == 128
    out = K.grouped_ffn(*args, block_t=bt)
    check(out, K.grouped_ffn_plain(*args, block_t=bt), torch.bfloat16)


def test_grouped_ffn_one_call_is_at_most_two_kernels(cuda):
    from repro_torch import kernels as K
    from repro_torch.core.routing import topk_route
    cuda_kernels_of = _chip_smoke().cuda_kernels_of
    g = torch.Generator().manual_seed(2)
    idx, w = topk_route(rand(g, (512, 32), torch.float32), 8)
    args, bt = _grouped_case(g, cuda, torch.bfloat16, 1024, 32, 512, idx, w)
    n, per_kernel = cuda_kernels_of(lambda: K.grouped_ffn(*args,
                                                          block_t=bt))
    assert 1 <= n <= 2, f"one grouped_ffn call ran {n} CUDA kernels: " \
        f"{per_kernel}"


@pytest.mark.parametrize("d,f", [(60, 64), (64, 60)])
def test_grouped_ffn_refuses_widths_not_a_multiple_of_8(cuda, d, f):
    from repro_torch import kernels as K
    xs = torch.zeros((16, d), dtype=torch.bfloat16, device=cuda)
    w13 = torch.zeros((2, d, f), dtype=torch.bfloat16, device=cuda)
    w2 = torch.zeros((2, f, d), dtype=torch.bfloat16, device=cuda)
    tiles = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        K.grouped_ffn(xs, w13, w13, w2, tiles, tiles, block_t=8)


@pytest.mark.parametrize("name", ["xs", "w1", "w3", "w2"])
def test_grouped_ffn_refuses_misaligned_tensors(cuda, name):
    from repro_torch import kernels as K
    shapes = dict(xs=(16, 64), w1=(2, 64, 32), w3=(2, 64, 32),
                  w2=(2, 32, 64))
    t = {k: torch.zeros(v, dtype=torch.bfloat16, device=cuda)
         for k, v in shapes.items()}
    t[name] = _misaligned(shapes[name], torch.bfloat16, cuda)
    assert t[name].is_contiguous() and t[name].data_ptr() % 16
    tiles = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.grouped_ffn(t["xs"], t["w1"], t["w3"], t["w2"], tiles, tiles,
                      block_t=8)


# ssd_scan against its plain version: tests/test_kernels.py's bars for
# the scan, 1e-4 in f32 and 5e-2 in bf16
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


# dt = softplus(randn + shift): shift 0 gives dt ~ 0.8, so a long chunk
# decays by exp(-100) or less and the carried state barely reaches the
# next one; shift -5 gives dt ~ 0.01 (real Mamba2's range), where it
# dominates.
@pytest.mark.parametrize("dt_shift", [0.0, -5.0], ids=["dt0.8", "dt0.01"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,g,ds,chunk,init", [
    (2, 64, 4, 32, 4, 16, 16, False),     # g = nh, the Pallas contract
    (1, 100, 8, 64, 1, 64, 32, True),     # ragged tail, one group, state
    (2, 300, 4, 64, 1, 128, 256, False),  # mamba2's chunk and state width
    (2, 250, 8, 64, 2, 64, 128, True),    # zamba2's, two groups
    (1, 37, 2, 32, 2, 16, 256, True),     # one chunk shorter than chunk
    (8, 500, 32, 64, 1, 128, 256, False),  # mamba2-370m's prefill
    (8, 500, 64, 64, 1, 64, 128, False),   # zamba2-1.2b's prefill
    (1, 129, 4, 64, 1, 64, 128, True),     # a last chunk of 1 position
])
def test_ssd_scan_kernel(cuda, dtype, dt_shift, B, S, nh, hd, g, ds, chunk,
                         init):
    from repro_torch import kernels as K
    gen = torch.Generator().manual_seed(S + nh)
    x = rand(gen, (B, S, nh, hd), dtype, 0.5).to(cuda)
    dt = torch.nn.functional.softplus(
        rand(gen, (B, S, nh), torch.float32) + dt_shift).to(cuda)
    A = (-torch.exp(rand(gen, (nh,), torch.float32, 0.3))).to(cuda)
    Bm = rand(gen, (B, S, g, ds), dtype, 0.3).to(cuda)
    Cm = rand(gen, (B, S, g, ds), dtype, 0.3).to(cuda)
    st0 = rand(gen, (B, nh, hd, ds), torch.float32, 0.2).to(cuda) \
        if init else None
    before = K.ssd_scan.launches
    y, st = K.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=st0)
    assert K.ssd_scan.launches == before + 1
    yr, sr = K.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, init_state=st0)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    for out, ref in ((y, yr), (st, sr)):
        torch.testing.assert_close(out.float().cpu(), ref.float().cpu(),
                                   atol=SCAN_TOL[dtype], rtol=SCAN_TOL[dtype])
    y2, st2 = K.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=st0)
    assert torch.equal(y, y2) and torch.equal(st, st2), \
        "ssd_scan must be deterministic"


# a large entering state (10x the usual scale): its term goes through the
# tensor cores as a bf16 hi + lo pair and must stay within the tolerance
@pytest.mark.parametrize("dt_shift", [0.0, -5.0], ids=["dt0.8", "dt0.01"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,g,ds,chunk", [
    (2, 300, 4, 64, 1, 128, 256), (2, 250, 8, 64, 2, 64, 128),
    (1, 37, 2, 32, 2, 16, 256)])
def test_ssd_scan_kernel_large_state(cuda, dtype, dt_shift, B, S, nh, hd, g,
                                     ds, chunk):
    from repro_torch import kernels as K
    gen = torch.Generator().manual_seed(S * nh)
    x = rand(gen, (B, S, nh, hd), dtype, 0.5).to(cuda)
    dt = torch.nn.functional.softplus(
        rand(gen, (B, S, nh), torch.float32) + dt_shift).to(cuda)
    A = (-torch.exp(rand(gen, (nh,), torch.float32, 0.3))).to(cuda)
    Bm = rand(gen, (B, S, g, ds), dtype, 0.3).to(cuda)
    Cm = rand(gen, (B, S, g, ds), dtype, 0.3).to(cuda)
    st0 = rand(gen, (B, nh, hd, ds), torch.float32, 2.0).to(cuda)
    y, st = K.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=st0)
    yr, sr = K.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, init_state=st0)
    for out, ref in ((y, yr), (st, sr)):
        torch.testing.assert_close(out.float().cpu(), ref.float().cpu(),
                                   atol=SCAN_TOL[dtype], rtol=SCAN_TOL[dtype])
    y2, st2 = K.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=st0)
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_ssd_scan_refuses_what_it_does_not_take(cuda):
    from repro_torch import kernels as K
    x = torch.zeros((1, 8, 2, 48), device=cuda)          # hd 48
    dt = torch.zeros((1, 8, 2), device=cuda)
    A = -torch.ones((2,), device=cuda)
    bc = torch.zeros((1, 8, 1, 16), device=cuda)
    with pytest.raises(ValueError):
        K.ssd_scan(x, dt, A, bc, bc, chunk=8)
    x = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError):                       # dt in bf16
        K.ssd_scan(x, dt.bfloat16(), A, bc, bc, chunk=8)
    bc = torch.zeros((1, 8, 1, 128), device=cuda)         # (hd 32, ds 128)
    with pytest.raises(ValueError):                       # not built
        K.ssd_scan(x, dt, A, bc, bc, chunk=8)


def _misaligned(shape, dtype, device):
    """A contiguous tensor whose storage starts one element past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype, device=device)[1:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["x", "Bm", "Cm", "init_state"])
def test_ssd_scan_refuses_misaligned_tensors(cuda, dtype, name):
    from repro_torch import kernels as K
    B, S, nh, hd, ds = 1, 40, 2, 64, 64
    shapes = dict(x=(B, S, nh, hd), Bm=(B, S, 1, ds), Cm=(B, S, 1, ds),
                  init_state=(B, nh, hd, ds))
    t = {k: torch.zeros(v, dtype=torch.float32 if k == "init_state"
                        else dtype, device=cuda) for k, v in shapes.items()}
    t[name] = _misaligned(shapes[name], t[name].dtype, cuda)
    assert t[name].is_contiguous() and t[name].data_ptr() % 16
    dt = torch.full((B, S, nh), 0.5, device=cuda)
    A = -torch.ones((nh,), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.ssd_scan(t["x"], dt, A, t["Bm"], t["Cm"], chunk=32,
                   init_state=t["init_state"])


# ssd_scan's gradient against its plain version, relative to each
# gradient's largest magnitude: 1e-4 in f32 (the scan's bar; dcum's row
# and column sums cancel), 2e-2 with bf16 inputs (one rounding of dx, dB,
# dC on either side)
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _scan_bwd_case(dev, dtype, B, S, nh, hd, g, ds, init, d_final,
                   dt_shift, seed):
    """The forward's inputs and both cotangents, drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    x = rand(gen, (B, S, nh, hd), dtype, 0.5).to(dev)
    dt = torch.nn.functional.softplus(
        rand(gen, (B, S, nh), torch.float32) + dt_shift).to(dev)
    A = (-torch.exp(rand(gen, (nh,), torch.float32, 0.3))).to(dev)
    Bm = rand(gen, (B, S, g, ds), dtype, 0.3).to(dev)
    Cm = rand(gen, (B, S, g, ds), dtype, 0.3).to(dev)
    st0 = rand(gen, (B, nh, hd, ds), torch.float32, 0.2).to(dev) \
        if init else None
    dy = rand(gen, (B, S, nh, hd), dtype).to(dev)
    df = rand(gen, (B, nh, hd, ds), torch.float32).to(dev) \
        if d_final else None
    return (x, dt, A, Bm, Cm, dy), dict(init_state=st0, d_final=df)


@pytest.mark.parametrize("dt_shift", [0.0, -5.0], ids=["dt0.8", "dt0.007"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,g,ds,chunk,init,d_final", [
    (2, 64, 4, 32, 4, 16, 16, False, False),    # g = nh
    (1, 100, 8, 64, 1, 64, 32, True, True),     # ragged tail, both states
    (2, 300, 4, 64, 1, 128, 256, False, True),  # mamba2's chunk and width
    (2, 250, 8, 64, 2, 64, 128, True, False),   # zamba2's, two groups
    (1, 37, 2, 32, 2, 16, 256, True, True),     # one chunk, shorter
    (8, 500, 32, 64, 1, 128, 256, False, False),  # mamba2-370m's train
    (8, 500, 64, 64, 1, 64, 128, True, True),     # zamba2-1.2b's
    (1, 129, 4, 64, 1, 64, 128, True, True),    # a last chunk of 1
    (1, 200, 4, 64, 1, 128, 80, True, True),    # chunk 80: tiles 64 + 16
    (2, 50, 4, 32, 2, 16, 8, True, False),      # chunk 8: below one mma
])
def test_ssd_scan_bwd_kernel(cuda, dtype, dt_shift, B, S, nh, hd, g, ds,
                             chunk, init, d_final):
    """The gradient kernel against ssd_scan_bwd_plain: every gradient
    within SCAN_BWD_TOL of its largest magnitude and finite, the input
    dtypes kept, one launch counted, two calls bit-equal."""
    from repro_torch import kernels as K
    args, kw = _scan_bwd_case(cuda, dtype, B, S, nh, hd, g, ds, init,
                              d_final, dt_shift, seed=S + nh + ds)
    before = K.ssd_scan_bwd.launches
    out = K.ssd_scan_bwd(*args, chunk=chunk, **kw)
    assert K.ssd_scan_bwd.launches == before + 1
    ref = K.ssd_scan_bwd_plain(*args, chunk=chunk, **kw)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        assert bool(torch.isfinite(o.float()).all())
        _rel_close(o, r, SCAN_BWD_TOL[dtype])
    again = K.ssd_scan_bwd(*args, chunk=chunk, **kw)
    for o, a in zip(out, again):
        assert torch.equal(o, a), "ssd_scan_bwd must be deterministic"


def test_ssd_scan_bwd_one_call_is_five_kernels(cuda):
    from repro_torch import kernels as K
    args, kw = _scan_bwd_case(cuda, torch.float32, 2, 100, 4, 64, 1, 64,
                              True, True, -5.0, seed=5)
    n, per_kernel = _chip_smoke().cuda_kernels_of(
        lambda: K.ssd_scan_bwd(*args, chunk=32, **kw))
    assert n == 5, per_kernel


def test_ssd_scan_bwd_refuses_what_it_does_not_take(cuda):
    """Shapes outside _SHAPES, a dy of another dtype or shape, a d_final
    not in f32: ValueError before any launch."""
    from repro_torch import kernels as K
    args, _ = _scan_bwd_case(cuda, torch.float32, 1, 8, 2, 32, 1, 16,
                             False, False, 0.0, seed=1)
    x, dt, A, Bm, Cm, dy = args
    before = K.ssd_scan_bwd.launches
    x48 = torch.zeros((1, 8, 2, 48), device=cuda)          # hd 48
    with pytest.raises(ValueError):
        K.ssd_scan_bwd(x48, dt, A, Bm, Cm, x48, chunk=8)
    b128 = torch.zeros((1, 8, 1, 128), device=cuda)        # (32, 128)
    with pytest.raises(ValueError):
        K.ssd_scan_bwd(x, dt, A, b128, b128, dy, chunk=8)
    with pytest.raises(ValueError):
        K.ssd_scan_bwd(x, dt, A, Bm, Cm, dy.bfloat16(), chunk=8)
    with pytest.raises(ValueError):
        K.ssd_scan_bwd(x, dt, A, Bm, Cm, dy[:, :4].contiguous(), chunk=8)
    with pytest.raises(ValueError):
        K.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=8,
                       d_final=torch.zeros((1, 2, 32, 16), device=cuda,
                                           dtype=torch.bfloat16))
    assert K.ssd_scan_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["x", "Bm", "Cm", "dy", "init_state",
                                  "d_final"])
def test_ssd_scan_bwd_refuses_misaligned_tensors(cuda, dtype, name):
    from repro_torch import kernels as K
    B, S, nh, hd, ds = 1, 40, 2, 64, 64
    shapes = dict(x=(B, S, nh, hd), Bm=(B, S, 1, ds), Cm=(B, S, 1, ds),
                  dy=(B, S, nh, hd), init_state=(B, nh, hd, ds),
                  d_final=(B, nh, hd, ds))
    t = {k: torch.zeros(v, dtype=torch.float32 if k in ("init_state",
                                                         "d_final")
                        else dtype, device=cuda) for k, v in shapes.items()}
    t[name] = _misaligned(shapes[name], t[name].dtype, cuda)
    assert t[name].is_contiguous() and t[name].data_ptr() % 16
    dt = torch.full((B, S, nh), 0.5, device=cuda)
    A = -torch.ones((nh,), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.ssd_scan_bwd(t["x"], dt, A, t["Bm"], t["Cm"], t["dy"], chunk=32,
                       init_state=t["init_state"], d_final=t["d_final"])


def test_ssd_scan_autograd_runs_the_backward_kernel(cuda):
    """Under autograd on the card ssd_scan is SsdScan: the forward
    kernel, then one ssd_scan_bwd launch whose gradients are the direct
    call's bit for bit, init_state's included; with the final state
    unread the kernel takes no d_final."""
    from repro_torch import kernels as K
    args, kw = _scan_bwd_case(cuda, torch.float32, 2, 100, 4, 64, 1, 64,
                              True, False, -5.0, seed=9)
    x, dt, A, Bm, Cm, dy = args
    leaves = [t.clone().requires_grad_(True)
              for t in (x, dt, A, Bm, Cm, kw["init_state"])]
    before = (K.ssd_scan.launches, K.ssd_scan_bwd.launches)
    y, _ = K.ssd_scan(*leaves[:5], chunk=32, init_state=leaves[5])
    got = torch.autograd.grad(y, leaves, dy)
    assert (K.ssd_scan.launches, K.ssd_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = K.ssd_scan_bwd(*args, chunk=32, init_state=kw["init_state"])
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


def test_ssm_loss_gradient_on_the_card_equals_the_cpu(cuda):
    """loss_and_grads of a 2-layer mamba2-370m reduced to d 128 (head dim
    32, state 16, chunk 32), f32, 2 x 70 tokens (three chunks, the last
    ragged), on the card (ssd_scan and ssd_scan_bwd) and on the CPU
    (their plain versions) from the same params: the loss within 2e-5,
    every leaf within 1e-4 of its largest magnitude, one backward launch
    per SSM layer."""
    from repro_torch import kernels as K
    from repro_torch.bridge import flatten, init_params
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.model import params_to
    cfg = ARCHS["mamba2-370m"].reduced(num_layers=2, max_d_model=128,
                                       max_vocab=256)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 256,
                                                             (2, 70)))
    lc, gc = loss_and_grads(cfg, params, toks)
    before = K.ssd_scan_bwd.launches
    lg, gg = loss_and_grads(cfg, params_to(params, cuda), toks.to(cuda))
    assert K.ssd_scan_bwd.launches - before == cfg.num_layers
    assert abs(float(lc) - float(lg)) <= 2e-5
    for key, want in flatten(gc).items():
        _rel_close(flatten(gg)[key].cpu(), want, 1e-4)


# ------------------------------------------ decode loops as CUDA graphs ---

def _graph_model(name, dev, policy=None):
    """A 2-layer reduced model in f32, prefilled on 4 rows of 16 tokens:
    (cfg, params, tok, cache)."""
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import prefill
    cfg = ARCHS[name].reduced(num_layers=2, max_d_model=128, max_vocab=256)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int32), device=dev)
    lg, cache, _ = prefill(cfg, params, prompts, cache_len=64,
                           capacity_factor=8.0)
    return cfg, params, lg.argmax(-1).to(torch.int32), cache


def _clone_tree(tree):
    return {k: v.clone() for k, v in tree.items()}


def _plain_loop(cfg, params, tok, cache, dev, *, policy=None, chunk=8,
                temperature=0.0, seed=0):
    """A GraphLoop over (tok, cache) for decode_steps_fused, and the
    fused closure itself for the eager side."""
    from repro_torch.models.moe import OFF
    from repro_torch.serving import graphs as G
    from repro_torch.serving.step import NO_FAULT, make_fused
    fused = make_fused(cfg, policy=policy or OFF, decode_chunk=chunk,
                       temperature=temperature)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = G.LoopState({"tok": tok, "cache": cache}, gen)

    def run(t, g, i):
        return fused(params, t["tok"], t["cache"], i["remaining"], g,
                     i["fault"])
    inputs = {"remaining": torch.zeros(4, dtype=torch.int32, device=dev),
              "fault": torch.tensor(NO_FAULT, dtype=torch.int32,
                                    device=dev)}
    return state.loop(0, lambda: (run, inputs)), fused


def _check_plain_round(out, ref, state_tok, state_cache, e_tok, e_cache):
    for i, name in ((2, "toks"), (4, "ok"), (5, "poisoned")):
        assert torch.equal(out[i], ref[i]), name
    for k in ref[3]:
        assert torch.equal(out[3][k], ref[3][k]), k
    assert torch.equal(state_tok, e_tok)
    for k, v in e_cache.items():
        assert torch.equal(state_cache[k], v), k   # bit-equal, cur_len too


@pytest.mark.parametrize("name,policy", [
    ("granite-moe-1b-a400m", "off"), ("granite-moe-1b-a400m", "batch"),
    ("mamba2-370m", "off"), ("zamba2-1.2b", "off")])
def test_graph_replay_equals_eager_decode(cuda, name, policy):
    """Two replays of a captured decode chunk (8 steps, slot 1 running
    out mid-chunk, slot 3 empty) against decode_steps_fused run eagerly
    on cloned state: tokens, ok, poisoned and aux exact, tok and every
    cache tensor bit-equal, and each kernel's launch count the same."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.serving.step import NO_FAULT
    pol = XSharePolicy(mode="batch", k0=1, m_l=0) if policy == "batch" \
        else None
    cfg, params, tok, cache = _graph_model(name, cuda)
    e_tok, e_cache = tok.clone(), _clone_tree(cache)
    K.reset_launch_counts()
    loop, fused = _plain_loop(cfg, params, tok, cache, cuda, policy=pol)
    assert loop.graph is not None and K.launch_counts() == \
        {k: 0 for k in K.KERNELS}
    rem = np.array([20, 3, 20, 0], np.int32)
    for _ in range(2):
        K.reset_launch_counts()
        ref = fused(params, e_tok, e_cache, torch.as_tensor(rem, device=cuda),
                    None, NO_FAULT)
        eager_counts = K.launch_counts()
        K.reset_launch_counts()
        out = loop(remaining=rem, fault=NO_FAULT)
        assert K.launch_counts() == eager_counts
        _check_plain_round(out, ref, tok, cache, e_tok, e_cache)
        rem = np.maximum(rem - out[4].sum(0).cpu().numpy(), 0) \
            .astype(np.int32)


def test_graph_replay_fault_poisons_one_slot(cuda):
    """A NaN fault at (slot 3, step 5), set through the static operand of
    a replay, quarantines exactly slot 3 from step 5 on; the other slots'
    tokens equal a fault-free eager run's."""
    from repro_torch.serving.step import NO_FAULT
    cfg, params, tok, cache = _graph_model("granite-moe-1b-a400m", cuda)
    e_tok, e_cache = tok.clone(), _clone_tree(cache)
    loop, fused = _plain_loop(cfg, params, tok, cache, cuda)
    rem = np.full(4, 20, np.int32)
    ref = fused(params, e_tok, e_cache, torch.as_tensor(rem, device=cuda),
                None, NO_FAULT)
    out = loop(remaining=rem, fault=(3, 5))
    assert out[5].tolist() == [False, False, False, True]
    ok = out[4].cpu()
    assert ok[:5].all() and not ok[5:, 3].any() and ok[:, :3].all()
    assert torch.equal(out[2][:, :3], ref[2][:, :3])
    assert torch.equal(out[2][:5], ref[2][:5])
    cur = cache["cur_len"].cpu()
    assert cur[3] == e_cache["cur_len"][3].cpu() - 3     # froze at step 5
    out = loop(remaining=rem, fault=NO_FAULT)            # operand cleared
    assert not out[5].any()


def test_graph_replay_samples_like_eager(cuda):
    """Temperature 0.8: a replay draws from the registered generator the
    tokens the eager loop draws from a generator with the same seed, and
    leaves it in the same state."""
    from repro_torch.serving.step import NO_FAULT
    cfg, params, tok, cache = _graph_model("granite-moe-1b-a400m", cuda)
    e_tok, e_cache = tok.clone(), _clone_tree(cache)
    loop, fused = _plain_loop(cfg, params, tok, cache, cuda,
                              temperature=0.8, seed=11)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    rem = np.full(4, 20, np.int32)
    for _ in range(2):
        ref = fused(params, e_tok, e_cache,
                    torch.as_tensor(rem, device=cuda), gen, NO_FAULT)
        out = loop(remaining=rem, fault=NO_FAULT)
        assert torch.equal(out[2], ref[2])
        assert torch.equal(loop.gen.get_state(), gen.get_state())
    assert len(set(out[2].flatten().tolist())) > 4, "sampling drew"


def test_graph_replay_equals_eager_spec_round(cuda):
    """A captured speculative dispatch (3 rounds, spec_len 3, the target's
    params + 0.035 N(0, 1) as the draft, one plain slot, one with a
    budget of 4) against spec_steps_fused
    run eagerly on cloned state: every output exact, both caches
    bit-equal."""
    from repro_torch import kernels as K
    from repro_torch.models.model import prefill
    from repro_torch.serving import graphs as G
    from repro_torch.serving.step import NO_FAULT, make_spec_fused
    cfg, params, tok, cache = _graph_model("granite-moe-1b-a400m", cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(9)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                v + 0.035 * torch.randn(v.shape, generator=g, device=cuda)
                for k, v in tree.items()}
    dparams = perturb(params)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int32), device=cuda)
    _, dcache, _ = prefill(cfg, dparams, prompts, cache_len=64,
                           capacity_factor=8.0)
    fused = make_spec_fused(cfg, cfg, spec_len=3, num_rounds=3)
    state = G.LoopState({"tok": tok, "cache": cache, "dcache": dcache},
                        torch.Generator(device=cuda))
    E = cfg.moe.num_experts
    names = ("remaining", "budget", "draft_len", "spec_on", "priors")
    ops = dict(remaining=np.array([12, 12, 5, 12], np.int32),
               budget=np.array([2 ** 30, 4, 2 ** 30, 0], np.int32),
               draft_len=np.array([3, 2, 3, 0], np.int32),
               spec_on=np.array([True, True, True, False]),
               priors=np.random.default_rng(4).random((4, E))
               .astype(np.float32))

    def run(t, g, i):
        return fused(params, dparams, t["tok"], t["cache"], t["dcache"],
                     *(i[n] for n in names), i["fault"])
    inputs = {n: torch.zeros_like(torch.as_tensor(ops[n]), device=cuda)
              for n in names}
    inputs["fault"] = torch.tensor(NO_FAULT, dtype=torch.int32, device=cuda)
    e = {"tok": tok.clone(), "cache": _clone_tree(cache),
         "dcache": _clone_tree(dcache)}
    loop = state.loop(0, lambda: (run, inputs))
    K.reset_launch_counts()
    ref = fused(params, dparams, e["tok"], e["cache"], e["dcache"],
                *(torch.as_tensor(ops[n], device=cuda) for n in names),
                NO_FAULT)
    eager_counts = K.launch_counts()
    K.reset_launch_counts()
    out = loop(**ops, fault=NO_FAULT)
    assert K.launch_counts() == eager_counts
    for i in (3, 4, 5, 6, 7, 8, 10):
        assert torch.equal(out[i], ref[i]), i
    assert int(ref[8].sum()) > 0, "nothing was drafted"
    assert torch.equal(tok, e["tok"])
    for key in ("cache", "dcache"):
        for k, v in e[key].items():
            assert torch.equal(state.tensors[key][k], v), (key, k)


def test_engine_generate_replays_and_reuses_its_graphs(cuda):
    """Engine.generate on the card: continuous (replayed graphs) equals
    lockstep (eager), the first call pays the capture, a second call
    captures nothing and gives the same tokens."""
    from repro_torch.serving import Engine
    cfg, params, _, _ = _graph_model("granite-moe-1b-a400m", cuda)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    eng = Engine(cfg, params, cache_len=64, device=cuda)
    lock, _ = eng.generate(prompts, 12, lockstep=True)
    first, st1 = eng.generate(prompts, 12)
    second, st2 = eng.generate(prompts, 12)
    assert np.array_equal(first, lock) and np.array_equal(second, lock)
    assert st1.capture_s > 0 and st2.capture_s == 0
    assert len(eng.loops.states()) == 1


def test_graph_capture_of_a_host_sync_raises(cuda):
    """A loop that reads a value back to the host cannot be captured:
    building its GraphLoop raises, and the card works on after it."""
    from repro_torch.serving import graphs as G
    state = G.LoopState({"tok": torch.ones(4, dtype=torch.int32,
                                           device=cuda)},
                        torch.Generator(device=cuda))

    def run(t, g, i):
        n = int(t["tok"].sum())          # a device -> host read
        return (t["tok"] + n,)
    with pytest.raises(RuntimeError):
        state.loop(0, lambda: (run, {}))
    assert int(torch.ones(3, device=cuda).sum()) == 3


# ------------------------------------------------------------ training

def _bwd_case(cuda, dtype, block_t, T=90, d=64, E=5, f=72, k=2, seed=0):
    """A sorted plan over experts 0..3 of 5 whose buffer ends in invalid
    tiles: expert 3 takes 3 rows (one partial tile), expert 4 none; d and
    f need not be multiples of the kernel's tiles (f = 72); a random
    output gradient on every row."""
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens
    g = torch.Generator().manual_seed(seed)
    idx = torch.argsort(torch.rand((T, E - 2), generator=g), 1)[:, :k]
    idx[:3, 1] = E - 2
    w = torch.full((T, k), 0.5)
    plan = dispatch_plan(idx.to(cuda), w.to(cuda), E, block_t=block_t)
    xs = gather_tokens(rand(g, (T, d), dtype).to(cuda), plan)
    w1, w3 = (rand(g, (E, d, f), dtype, 0.1).to(cuda) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.1).to(cuda)
    dys = rand(g, tuple(xs.shape), dtype).to(cuda)
    assert (plan.tile_valid == 0).any()
    assert 4 not in plan.tile_eid[plan.tile_valid > 0].tolist()
    assert int(plan.counts[3]) == 3
    return (xs, w1, w3, w2, plan.tile_eid, plan.tile_valid, dys), plan


def _rel_close(out, ref, tol):
    """max |out - ref| within tol of ref's largest magnitude."""
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * max(float(ref.float().abs().max()), 1e-30), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_t", [8, 64, 128, 256])
@pytest.mark.parametrize("d,f", [(64, 72), (72, 200)])
def test_grouped_ffn_bwd_kernel(cuda, dtype, block_t, d, f):
    """The backward kernel against its plain version: every gradient
    within TOL of its largest magnitude, exact zeros for the expert with
    no rows and for invalid tiles' rows, two calls bit-equal, and three
    CUDA kernels a call. d 72, f 200: multiples of 8, not of the
    kernel's 64- and 128-wide tiles."""
    from repro_torch import kernels as K
    args, plan = _bwd_case(cuda, dtype, block_t, d=d, f=f)
    before = K.grouped_ffn_bwd.launches
    out = K.grouped_ffn_bwd(*args, block_t=block_t)
    assert K.grouped_ffn_bwd.launches == before + 1
    ref = K.grouped_ffn_bwd_plain(*args, block_t=block_t)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        _rel_close(o, r, TOL[dtype])
    assert float(out[1][3].abs().max()) > 0.0   # the one partial tile
    assert float(out[1][4].abs().max()) == 0.0
    assert float(out[2][4].abs().max()) == 0.0
    assert float(out[3][4].abs().max()) == 0.0
    rows = (plan.tile_valid == 0).repeat_interleave(block_t)
    assert float(out[0][rows].abs().max()) == 0.0
    again = K.grouped_ffn_bwd(*args, block_t=block_t)
    for o, a in zip(out, again):
        assert torch.equal(o, a)
    n, per_kernel = _chip_smoke().cuda_kernels_of(
        lambda: K.grouped_ffn_bwd(*args, block_t=block_t))
    assert n == 3, per_kernel


def test_grouped_ffn_bwd_refuses_widths_off_the_chunks(cuda):
    """The kernel copies 16-byte chunks: d and f must be multiples of 8,
    and the wrapper raises before launching otherwise."""
    from repro_torch import kernels as K
    args, _ = _bwd_case(cuda, torch.bfloat16, 8, f=60)
    before = K.grouped_ffn_bwd.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        K.grouped_ffn_bwd(*args, block_t=8)
    assert K.grouped_ffn_bwd.launches == before


def test_grouped_ffn_autograd_runs_the_backward_kernel(cuda):
    from repro_torch import kernels as K
    (xs, w1, w3, w2, eid, valid, dys), _ = _bwd_case(cuda, torch.float32,
                                                     16)
    leaves = [t.clone().requires_grad_(True) for t in (xs, w1, w3, w2)]
    before = K.grouped_ffn_bwd.launches
    ys = K.grouped_ffn(*leaves, eid, valid, block_t=16)
    got = torch.autograd.grad(ys, leaves, dys)
    assert K.grouped_ffn_bwd.launches == before + 1
    want = K.grouped_ffn_bwd(xs, w1, w3, w2, eid, valid, dys, block_t=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernels_without_a_backward_refuse_gradients(cuda):
    """decode_attention (both entry points) raises on the card when
    autograd would record it; under no_grad, and on the CPU, it runs.
    (ssd_scan, grouped_ffn and moe_ffn have their gradient kernels:
    SsdScan, GroupedFFN, MoeFFN, tested above.)"""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(3)
    q = rand(g, (2, 4, 32), torch.float32).to(cuda).requires_grad_(True)
    kv = rand(g, (2, 16, 2, 32), torch.float32).to(cuda)
    lens = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    calls = {
        "decode_attention": lambda: K.decode_attention(q, kv, kv, lens),
        "decode_attention ": lambda: K.decode_attention_cached(
            q[:, None], kv, kv, lens),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name.strip()}.*no "
                                               f"backward"):
            call()
        with torch.no_grad():
            call()
    out = K.decode_attention_plain(q.detach().cpu().requires_grad_(True),
                                   kv.cpu(), kv.cpu(), lens.cpu())
    assert out.grad_fn is not None


def _moe_bwd_case(g, dev, dtype, T, d, E, f, k, policy):
    """moe_ffn_bwd's arguments for T tokens routed top-k under policy
    ("off", or "batch" at k0 1 and m_l E / 4) by route(), which hands
    combine over as a column slice, a random output gradient, and the
    policy's max_active."""
    from repro_torch.configs.base import MoEConfig, XSharePolicy
    from repro_torch.models.moe import OFF, policy_max_active, route
    pol = OFF if policy == "off" else XSharePolicy(mode="batch", k0=1,
                                                   m_l=E // 4)
    x = rand(g, (T, d), dtype).to(dev)
    w1, w3 = (rand(g, (E, d, f), dtype, 0.05).to(dev) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.05).to(dev)
    wg = rand(g, (d, E), torch.float32, 0.3).to(dev)
    dy = rand(g, (T, d), dtype).to(dev)
    moe = MoEConfig(num_experts=E, top_k=k, d_ff_expert=f)
    _, _, combine, _ = route({"wg": wg}, x, moe, pol)
    active = (combine != 0).any(0)
    return ((x, w1, w3, w2, combine, active, dy),
            policy_max_active(pol, T, E))


@pytest.mark.parametrize("policy", ["off", "batch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,E,f,k", [(5, 64, 8, 48, 2),
                                       (32, 72, 12, 200, 3),
                                       (8, 1024, 32, 512, 8),
                                       (32, 1024, 32, 512, 8),
                                       (12, 1000, 16, 200, 4),
                                       (3, 1160, 6, 56, 2),
                                       (32, 1160, 6, 56, 2)],
                         ids=["small", "T32-ragged", "granite-decode",
                              "granite-train", "d1000", "d1160",
                              "d1160-T32"])
def test_moe_ffn_bwd_kernel(cuda, dtype, policy, T, d, E, f, k):
    """moe_ffn's backward kernel against its plain version: every
    gradient (dx, dw1, dw3, dw2, dcombine) within TOL of its largest
    magnitude, exact zeros for the experts outside the slots, two calls
    bit-equal, one launch counted and two CUDA kernels a call. d 72,
    f 200: multiples of 8, not of the kernel's 16-row tiles or its
    32-column strips; granite-train: the dense train step's 32 tokens;
    d 1000: a cluster of 8 blocks whose last holds 104 rows, not 128;
    d 1160: over 8 x 128 rows, so each block holds 160 rows in two
    chunks and reads them again for the weight gradients (at 3 and at 32
    tokens)."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(T + E)
    args, ma = _moe_bwd_case(g, cuda, dtype, T, d, E, f, k, policy)
    active = args[5]
    assert int(active.sum()) <= ma
    before = K.moe_ffn_bwd.launches
    out = K.moe_ffn_bwd(*args, max_active=ma)
    assert K.moe_ffn_bwd.launches == before + 1
    ref = K.moe_ffn_bwd_plain(*args, max_active=ma)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        _rel_close(o, r, TOL[dtype])
    off = ~active
    if bool(off.any()):
        for t in out[1:4]:
            assert float(t[off].abs().max()) == 0.0
        assert float(out[4][:, off].abs().max()) == 0.0
    again = K.moe_ffn_bwd(*args, max_active=ma)
    for o, a in zip(out, again):
        assert torch.equal(o, a)
    n, per_kernel = _chip_smoke().cuda_kernels_of(
        lambda: K.moe_ffn_bwd(*args, max_active=ma))
    assert n == 2, per_kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_bwd_kernel_runs_only_the_slots(cuda, dtype):
    """With max_active below the active count the kernel, as the forward,
    runs the first max_active active experts: the gradient equals the
    plain version's, which masks the same slots, and the active experts
    past them get exact zeros."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(7)
    x, w1, w3, w2, combine, active = _moe_case(
        g, cuda, dtype, 6, 64, 8, 48, (0, 2, 3, 5, 6))
    dy = rand(g, (6, 64), dtype).to(cuda)
    args = (x, w1, w3, w2, combine, active, dy)
    out = K.moe_ffn_bwd(*args, max_active=3)
    ref = K.moe_ffn_bwd_plain(*args, max_active=3)
    for o, r in zip(out, ref):
        _rel_close(o, r, TOL[dtype])
    for t in out[1:4]:
        assert float(t[5:].abs().max()) == 0.0 and \
            float(t[3].abs().max()) > 0.0
    assert float(out[4][:, 5:].abs().max()) == 0.0


def test_moe_ffn_autograd_equals_moe_ffn_bwd(cuda):
    """Under torch.autograd.grad moe_ffn is MoeFFN: one forward and one
    backward launch, and the gradient of x, the weights and combine
    bit-equal to a direct moe_ffn_bwd call."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(5)
    (x, w1, w3, w2, comb, active, dy), ma = _moe_bwd_case(
        g, cuda, torch.float32, 8, 64, 8, 48, 2, "off")
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2, comb)]
    before = (K.moe_ffn.launches, K.moe_ffn_bwd.launches)
    y = K.moe_ffn(*leaves, active, max_active=ma)
    assert type(y.grad_fn).__name__ == "MoeFFNBackward"
    got = torch.autograd.grad(y, leaves, dy)
    assert (K.moe_ffn.launches, K.moe_ffn_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = K.moe_ffn_bwd(x, w1, w3, w2, comb, active, dy, max_active=ma)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


@pytest.mark.parametrize("T", [1, 4])
def test_decode_attention_head_dim_16(cuda, T):
    """The trained speculation's target and draft (head dim 16): 8 rows,
    4 / 2 heads, a decode step (T = 1) and a verify pass (T = 4), f32."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(16 + T)
    args = _cached_case(g, cuda, torch.float32, 8, T, 4, 2, 16, 75,
                        [16 + 5 * b for b in range(8)])
    out = K.decode_attention_cached(*args)
    check(out, K.decode_attention_cached_plain(*args), torch.float32)


@pytest.mark.parametrize("batch,seq,cf,bwd", [
    (4, 24, 1.25, "grouped_ffn_bwd"), (4, 8, 4.0, "moe_ffn_bwd")],
    ids=["sorted", "dense"])
def test_train_step_on_the_card_equals_the_cpu(cuda, batch, seq, cf, bwd):
    """One make_train_step of a 2-layer MoE on the card and on the CPU
    from the same params: 4 x 24 tokens take the sorted dispatch
    (grouped_ffn and its backward kernel), 4 x 8 at capacity_factor 4
    the dense path (moe_ffn and moe_ffn_bwd); the loss within 2e-5,
    every updated leaf within 1e-4 of its largest magnitude, the
    backward kernel launched once per layer."""
    from repro_torch import kernels as K
    from repro_torch.bridge import flatten, init_params
    from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import params_to
    from repro_torch.optim import adamw_init
    cfg = ArchConfig(name="tiny-moe", family="moe", num_layers=2,
                     d_model=64, d_ff=0, vocab_size=128,
                     attn=AttnConfig(num_heads=4, num_kv_heads=2,
                                     head_dim=16),
                     moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    params = init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, 128, (batch, seq))
    step = make_train_step(cfg, capacity_factor=cf)
    outs = {}
    for dev in ("cpu", cuda):
        p = params_to(params, dev)
        before = K.KERNELS[bwd].launches
        outs[str(dev)] = step(p, adamw_init(p), toks)
        if dev is cuda:   # one backward per MoE layer
            assert K.KERNELS[bwd].launches - before == cfg.num_layers
    (pc, _, mc), (pg, _, mg) = outs["cpu"], outs[str(cuda)]
    assert abs(float(mc["loss"]) - float(mg["loss"])) <= 2e-5
    for key, want in flatten(pc).items():
        _rel_close(flatten(pg)[key].cpu(), want, 1e-4)


# ------------------------------------------------- expert parallelism

def _ep_case(g, dev, dtype, T, d, E, f, k):
    """x, the three expert weights, top-k routing of T tokens."""
    from repro_torch.core.routing import topk_route
    x = rand(g, (T, d), dtype).to(dev)
    w1, w3 = (rand(g, (E, d, f), dtype, 0.05).to(dev) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.05).to(dev)
    idx, w = topk_route(rand(g, (T, E), torch.float32).to(dev), k)
    return x, w1, w3, w2, idx, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,E,f,k,S", [(8, 64, 16, 128, 2, 8),
                                         (43, 96, 32, 64, 8, 8),
                                         (300, 128, 12, 80, 2, 4)])
@pytest.mark.parametrize("block_t", [8, None])
def test_ep_layer_bit_equals_sorted(cuda, dtype, T, d, E, f, k, S,
                                    block_t):
    """The EP layer (one grouped_ffn launch over every shard's tiles, on
    the layer's own weights) bit-equal to the sorted dispatch on the
    card: at a shared block_t, and at each path's own default; under a
    contiguous and a replicated placement."""
    from repro_torch import ep as EP
    from repro_torch import kernels as K
    from repro_torch.models.dispatch import sorted_expert_ffn
    g = torch.Generator().manual_seed(T + E)
    args = _ep_case(g, cuda, dtype, T, d, E, f, k)
    ref = sorted_expert_ffn(*args, block_t=block_t)
    load = np.arange(E, dtype=np.float64) ** 2
    for pl in (EP.contiguous_placement(E, S),
               EP.plan_placement(load, S, replicate_hot=2, max_replicas=3)):
        ex = EP.EPExecutor(S, pl, device=cuda, block_t=block_t)
        before = K.grouped_ffn.launches
        y = ex.ffn(*args)
        assert K.grouped_ffn.launches == before + 1
        assert torch.equal(y, ref)
        y2, st = ex(*args)
        assert torch.equal(y2, ref)
        assert st.count_matrix.sum() == T * k


def test_ep_ffn_captures_and_replays_new_tables(cuda):
    """ffn captured in a CUDA graph replays equal to eager; after an
    update_placement of the same table shape the same graph reads the new
    tables and still equals eager (and the sorted dispatch)."""
    from repro_torch import ep as EP
    from repro_torch.models.dispatch import sorted_expert_ffn
    g = torch.Generator().manual_seed(9)
    E, S = 32, 8
    args = _ep_case(g, cuda, torch.bfloat16, 8, 128, E, 64, 8)
    rep = dict(replicate_hot=1, max_replicas=2)
    ex = EP.EPExecutor(S, EP.plan_placement(np.ones(E), S, **rep),
                       device=cuda, **rep)
    ref = ex.ffn(*args)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        ex.ffn(*args)                                   # warm-up
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = ex.ffn(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    shape = ex.graph_key()[1:]
    load = np.ones(E)
    load[5] = 3.0                  # expert 5 replicated in expert 0's place
    assert ex.update_placement(load) and ex.graph_key()[1:] == shape
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ex.ffn(*args))
    assert torch.equal(out, sorted_expert_ffn(*args))


def _rank_calls(S, E, d, f, T, dtype):
    """Host-side EP layer calls at top_k 1, 2 and 8, on the contiguous
    and a replicated placement, and the full weights (CPU tensors)."""
    from repro_torch import ep as EP
    g = torch.Generator().manual_seed(S * 100 + d)
    weights = [rand(g, sh, dtype, 0.05) for sh in ((E, d, f), (E, d, f),
                                                   (E, f, d))]
    load = np.arange(E, dtype=np.float64) ** 2
    calls = []
    for k in (1, 2, 8):
        x, _, _, _, idx, w = _ep_case(g, "cpu", dtype, T, d, E, f, k)
        for tag, pl in (("contig", EP.contiguous_placement(E, S)),
                        ("rep", EP.plan_placement(load, S, replicate_hot=2,
                                                  max_replicas=min(S, 3)))):
            calls.append((f"k{k}_{tag}", pl, x, idx, w, None))
    return weights, calls


def _check_rank_calls(outs, weights, calls, dev):
    """Each rank's gathered y and EPStats equal the one-process
    executor's and y the sorted dispatch's, bit for bit; grouped_ffn
    launched once in each of the two layer calls."""
    from repro_torch import ep as EP
    from repro_torch.models.dispatch import sorted_expert_ffn
    for name, pl, x, idx, w, _ in calls:
        args = [t.to(dev) for t in (x, *weights, idx, w)]
        y1, st1 = EP.EPExecutor(pl.num_shards, pl, device=dev)(*args)
        ref = sorted_expert_ffn(*args).cpu()
        for o in outs:
            r = o["calls"][name]
            assert torch.equal(r["y"], y1.cpu()) and torch.equal(r["y"], ref)
            assert torch.equal(r["ffn"], ref)
            assert r["launches"] == 2
            assert r["held"][0][0] == pl.expert_cap
            for fld in ("computed_rows", "tile_rows", "sent_rows",
                        "a2a_bytes", "count_matrix"):
                np.testing.assert_array_equal(getattr(r["stats"], fld),
                                              getattr(st1, fld))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ep_ranks_over_gloo_on_one_card(cuda, dtype):
    """Two processes over gloo on the one card, each holding only its
    experts' stacks: bit-equal to the one-process executor and to sorted
    dispatch, exact grouped_ffn launches per rank; a real CUDA graph
    capture of the layer raises a clear error on every rank (no hang)."""
    import torch_ep_ranks as RANKS
    from repro_torch.ep import dist as DIST
    weights, calls = _rank_calls(2, 16, 128, 64, 37, dtype)
    _, pl, x, idx, w, _ = calls[2]
    outs = DIST.spawn(RANKS.suite, 2, backend="gloo", args=(weights, calls),
                      kwargs=dict(card_capture=(pl, x, idx, w)))
    _check_rank_calls(outs, weights, calls, cuda)
    for o in outs:
        assert "CUDA graph" in o["card_capture"] and \
            "gloo" in o["card_capture"]


def test_ep_rank_over_nccl_world_size_one(cuda):
    """NCCL at world size 1 (one rank, all experts): bit-equal to the
    one-process executor at S 1 and to sorted dispatch; NCCL with more
    ranks than cards raises before any process starts."""
    import torch_ep_ranks as RANKS
    from repro_torch.ep import dist as DIST
    weights, calls = _rank_calls(1, 16, 128, 64, 37, torch.bfloat16)
    outs = DIST.spawn(RANKS.suite, 1, backend="nccl", args=(weights, calls))
    _check_rank_calls(outs, weights, calls, cuda)
    with pytest.raises(ValueError, match="card per rank"):
        DIST.spawn(RANKS.suite, torch.cuda.device_count() + 1,
                   backend="nccl", args=(weights, calls))


def test_ep_engine_on_the_card_equals_sorted(cuda):
    """A 2-layer Engine(dispatch="ep") (16 experts over 8 shards, the
    decode loop replayed from a graph) gives dispatch="sorted"'s tokens,
    continuous and lockstep, with grouped_ffn once per MoE layer call and
    no moe_ffn."""
    from repro_torch import ep as EP
    from repro_torch import kernels as K
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving import Engine
    cfg = ARCHS["granite-moe-1b-a400m"].reduced(
        num_layers=2, max_d_model=128, max_vocab=256, max_experts=16)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    ref, _ = Engine(cfg, params, cache_len=64, dispatch="sorted",
                    device=cuda).generate(prompts, 12)
    eng = Engine(cfg, params, cache_len=64, dispatch="ep", device=cuda)
    ex = EP.EPExecutor(8, EP.contiguous_placement(16, 8), device=cuda)
    with EP.ep_context(ex):
        lock, _ = eng.generate(prompts, 12, lockstep=True)
        K.reset_launch_counts()
        out, st = eng.generate(prompts, 12)
        counts = K.launch_counts()
    assert np.array_equal(out, ref) and np.array_equal(lock, ref)
    steps = -(-11 // eng.decode_chunk) * eng.decode_chunk
    assert counts["grouped_ffn"] == cfg.num_layers * (1 + steps)
    assert counts["moe_ffn"] == 0
    assert st.capture_s > 0


def test_ep_spec_engine_on_the_card_equals_plain(cuda):
    """Speculative decoding with the verify pass under dispatch="ep"
    (self-draft, the spec round replayed from a graph): plain greedy's
    tokens."""
    from repro_torch import ep as EP
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving import Engine
    cfg = ARCHS["granite-moe-1b-a400m"].reduced(
        num_layers=2, max_d_model=128, max_vocab=256, max_experts=16)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    ref, _ = Engine(cfg, params, cache_len=64, device=cuda).generate(
        prompts, 12)
    eng = Engine(cfg, params, cache_len=64, dispatch="ep",
                 draft=(cfg, params), spec_len=3, device=cuda)
    with EP.ep_context(EP.EPExecutor(8, EP.contiguous_placement(16, 8),
                                     device=cuda)):
        out, st = eng.generate(prompts, 12)
    assert np.array_equal(out, ref) and st.drafted > 0


def test_ep_executor_on_the_card_refuses_cpu_tensors(cuda):
    from repro_torch import ep as EP
    g = torch.Generator().manual_seed(1)
    x, w1, w3, w2, idx, w = _ep_case(g, cuda, torch.float32, 8, 64, 8, 64,
                                     2)
    ex = EP.EPExecutor(4, EP.contiguous_placement(8, 4), device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        ex.ffn(x.cpu(), w1, w3, w2, idx, w)
    with pytest.raises(ValueError, match="cpu"):
        ex(x, w1, w3, w2, idx.cpu(), w)


def test_ep_engine_new_table_shape_keeps_device_memory(cuda):
    """After an update_placement that changes the table shape, the next
    generate captures a running batch and graphs in place of the old
    ones: the card holds what it held before, but for the new shape's
    tables, and the tokens are still dispatch="sorted"'s."""
    import gc

    from repro_torch import ep as EP
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving import Engine
    cfg = ARCHS["granite-moe-1b-a400m"].reduced(
        num_layers=2, max_d_model=128, max_vocab=256, max_experts=16)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    ref, _ = Engine(cfg, params, cache_len=64, dispatch="sorted",
                    device=cuda).generate(prompts, 12)
    rep = dict(replicate_hot=1, max_replicas=2)
    ex = EP.EPExecutor(8, EP.plan_placement(np.ones(16), 8, **rep),
                       device=cuda, **rep)
    eng = Engine(cfg, params, cache_len=64, dispatch="ep", device=cuda)

    def held():
        gc.collect()
        torch.cuda.synchronize(cuda)
        return torch.cuda.memory_allocated(cuda)
    with EP.ep_context(ex):
        eng.generate(prompts, 12)
        before, shape = held(), ex.graph_key()[1:]
        ex.replicate_hot, ex.max_replicas = 2, 4
        assert ex.update_placement(np.arange(1, 17, dtype=float) ** 4)
        assert ex.graph_key()[1:] != shape
        out, st = eng.generate(prompts, 12)
        after = held()
    tables = sum(-(-t.numel() * t.element_size() // 512) * 512
                 for t in ex.tables.values())
    assert np.array_equal(out, ref) and st.capture_s > 0
    assert len(eng.loops.states()) == 1
    assert before <= after <= before + tables, (before, after, tables)


# ---------------------------------------------- the launch layer (ops) ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_wrappers_launch_their_kernels(cuda, dtype):
    """Each public wrapper of kernels/ops.py on CUDA tensors launches its
    kernel once and agrees with the plain version (TOL; the scan's
    SCAN_TOL); xshare_moe_ffn's max_active None is E."""
    from repro_torch import kernels as K
    from repro_torch.core.routing import combine_matrix, topk_route
    from repro_torch.kernels import ops
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens
    g = torch.Generator().manual_seed(31)
    T, d, E, f = 8, 128, 8, 96
    w1, w3 = (rand(g, (E, d, f), dtype, 0.05).to(cuda) for _ in range(2))
    w2 = rand(g, (E, f, d), dtype, 0.05).to(cuda)
    x = rand(g, (T, d), dtype).to(cuda)
    idx, w = topk_route(rand(g, (T, E), torch.float32).to(cuda), 2)
    combine = combine_matrix(idx, w, E)
    active = (combine != 0).any(0)
    xs_plan = dispatch_plan(idx, w, E)
    xs = gather_tokens(x, xs_plan)
    q = rand(g, (3, 4, 64), dtype).to(cuda)
    kc, vc = (rand(g, (3, 100, 2, 64), dtype).to(cuda) for _ in range(2))
    lengths = torch.tensor([100, 37, 1], dtype=torch.int32, device=cuda)
    sx = rand(g, (2, 70, 4, 64), dtype, 0.5).to(cuda)
    sdt = torch.nn.functional.softplus(rand(g, (2, 70, 4),
                                            torch.float32)).to(cuda)
    sA = -torch.exp(rand(g, (4,), torch.float32, 0.3)).to(cuda)
    sB, sC = (rand(g, (2, 70, 4, 128), dtype, 0.3).to(cuda)
              for _ in range(2))
    pairs = (
        ("moe_ffn", TOL,
         lambda: ops.xshare_moe_ffn(x, w1, w3, w2, combine, active),
         lambda: K.moe_ffn_plain(x, w1, w3, w2, combine, active)),
        ("grouped_ffn", TOL,
         lambda: ops.xshare_grouped_ffn(xs, w1, w3, w2, xs_plan.tile_eid,
                                        xs_plan.tile_valid,
                                        block_t=xs_plan.block_t),
         lambda: K.grouped_ffn_plain(xs, w1, w3, w2, xs_plan.tile_eid,
                                     xs_plan.tile_valid,
                                     block_t=xs_plan.block_t)),
        ("decode_attention", TOL,
         lambda: ops.flash_decode(q, kc, vc, lengths),
         lambda: K.decode_attention_plain(q, kc, vc, lengths)),
        ("ssd_scan", SCAN_TOL,
         lambda: ops.ssd_chunk_scan(sx, sdt, sA, sB, sC, chunk=32),
         lambda: K.ssd_scan_plain(sx, sdt, sA, sB, sC, chunk=32)))
    for kernel, tol, call, plain in pairs:
        before = K.KERNELS[kernel].launches
        out = call()
        assert K.KERNELS[kernel].launches == before + 1, kernel
        ref = plain()
        for o, r in zip(*((out, ref) if kernel == "ssd_scan"
                          else ((out,), (ref,)))):
            torch.testing.assert_close(o.float().cpu(), r.float().cpu(),
                                       atol=tol[o.dtype], rtol=tol[o.dtype])


def test_serve_cli_on_the_card(cuda, capsys):
    """The serve CLI at --reduced on the card (the default device): the
    kernels of the path launch, and --spec-len 3 gives the plain run's
    tokens (speculation is lossless)."""
    from repro_torch import kernels as K
    from repro_torch.launch import serve
    args = ["--arch", "granite-moe-1b-a400m", "--reduced", "--batch", "4",
            "--prompt-len", "40", "--new-tokens", "12"]
    toks = []
    for extra in ([], ["--spec-len", "3"]):
        K.reset_launch_counts()
        got, st = serve.main(args + extra)
        counts = K.launch_counts()
        assert min(counts[n] for n in ("grouped_ffn", "moe_ffn",
                                       "decode_attention")) > 0, counts
        assert got.shape == (4, 12) and st.new_tokens == 48
        toks.append(got)
    np.testing.assert_array_equal(toks[1], toks[0])
    assert capsys.readouterr().out.count("generated: (4, 12)") == 2


# ---- gpt-oss-120b-proxy's and llama3-8b's serving shapes ---------------
# d = f = 2880 (22.5 x 128: a half tile at the edge of grouped_ffn's
# 128-column down pass), 128 experts top-4 with normalized gates; the
# weights are drawn on the card (3.2 B elements a dtype)

def _paper_moe(dev, dtype, seed):
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["gpt-oss-120b-proxy"]
    m, d = cfg.moe, cfg.d_model
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dt=dtype):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dt)
    w1, w3 = (randn(m.num_experts, d, m.d_ff_expert, scale=0.02)
              for _ in range(2))
    w2 = randn(m.num_experts, m.d_ff_expert, d, scale=0.02)
    return m, randn, randn(d, m.num_experts, scale=0.02, dt=torch.float32), \
        (w1, w3, w2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_gpt_oss_decode_shape(cuda, dtype):
    """One decode step of 8 tokens, policy off (128 slots) and batch (k0
    1, m_l 8: 16 slots), routed as the model routes."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import XSharePolicy
    from repro_torch.models.moe import OFF, policy_max_active, route
    m, randn, wg, (w1, w3, w2) = _paper_moe(cuda, dtype, 28)
    x = randn(8, wg.shape[0])
    for pol in (OFF, XSharePolicy(mode="batch", k0=1, m_l=8)):
        _, _, combine, _ = route({"wg": wg}, x, m, pol)
        active = (combine != 0).any(0)
        ma = policy_max_active(pol, 8, m.num_experts)
        assert int(active.sum()) <= ma
        args = (x, w1, w3, w2, combine, active)
        out = K.moe_ffn(*args, max_active=ma)
        check(out, K.moe_ffn_plain(*args), dtype)
        assert torch.equal(out, K.moe_ffn(*args, max_active=ma))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,block_t", [(8 * 128, None), (8 * 128, 128),
                                       (8 * 5, None), (8, None)],
                         ids=["prefill", "prefill-bt128", "verify", "decode"])
def test_grouped_ffn_gpt_oss_plans(cuda, dtype, T, block_t):
    """The 8 x 128 prefill's plan (top-4 of 128: block_t 16 by default,
    and 128), an 8 x 5 verify pass's (block_t 8) and an 8-token decode
    step's at the engine's default capacity factor (block_t 8)."""
    from repro_torch import kernels as K
    from repro_torch.core.routing import topk_route
    from repro_torch.models.dispatch import dispatch_plan, gather_tokens
    m, randn, wg, (w1, w3, w2) = _paper_moe(cuda, dtype, T)
    x = randn(T, wg.shape[0])
    idx, w = topk_route(x.float() @ wg, m.top_k)
    plan = dispatch_plan(idx, w, m.num_experts, block_t=block_t)
    assert plan.block_t == (block_t or {1024: 16, 40: 8, 8: 8}[T])
    args = (gather_tokens(x, plan), w1, w3, w2, plan.tile_eid,
            plan.tile_valid)
    out = K.grouped_ffn(*args, block_t=plan.block_t)
    check(out, K.grouped_ffn_plain(*args, block_t=plan.block_t), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,dh", [(64, 8, 64), (32, 8, 128)],
                         ids=["gpt-oss", "llama3"])
def test_decode_attention_paper_model_decode_shape(cuda, dtype, H, Hkv, dh):
    """8 rows, one query each, cur_len 128-159 in a cache of 512."""
    from repro_torch import kernels as K
    g = torch.Generator().manual_seed(H + dh)
    cur = torch.randint(128, 160, (8,), generator=g)
    args = _cached_case(g, cuda, dtype, 8, 1, H, Hkv, dh, 512, cur)
    out = K.decode_attention_cached(*args)
    check(out, K.decode_attention_cached_plain(*args), dtype)
    assert torch.equal(out, K.decode_attention_cached(*args))
