"""The port's kernel modules on the CPU: each kernel's plain PyTorch
version against the JAX package's kernel (Pallas in interpret mode) on
the same inputs, with the sweeps of tests/test_kernels.py.

Tolerances are those of tests/test_kernels.py: 2e-5 in f32, 2e-2 in
bf16 (atol = rtol). The CUDA kernels themselves run only on a GPU
(tests/test_torch_gpu.py, chip_smoke.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ops import flash_decode, xshare_moe_ffn  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.dispatch import sorted_expert_ffn as j_sorted  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.dispatch import (dispatch_plan,  # noqa: E402
                                         sorted_expert_ffn)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def both(a, name):
    """One f32 numpy array as the same values in JAX and in torch."""
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def close(t, j, name):
    tol = DTYPES[name][2]
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def ffn_weights(rng, E, d, f):
    return [(rng.standard_normal(s) * 0.05).astype(np.float32)
            for s in ((E, d, f), (E, d, f), (E, f, d))]


def topk_routing(rng, T, E, k):
    logits = rng.standard_normal((T, E)).astype(np.float32)
    idx = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(logits, idx, 1)
    w = np.exp(top - top.max(1, keepdims=True))
    return idx.astype(np.int32), (w / w.sum(1, keepdims=True)).astype(
        np.float32)


# ----------------------------------------------------------- moe_ffn ------

@pytest.mark.parametrize("T,d,E,f,blockf", [
    (8, 64, 4, 128, 64), (16, 128, 8, 256, 128), (4, 32, 16, 64, 64),
    (32, 128, 6, 96, 32),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_ffn_plain_matches_jax_kernel(T, d, E, f, blockf, dt):
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w1, w3, w2 = ffn_weights(rng, E, d, f)
    idx, w = topk_routing(rng, T, E, 2)
    combine = np.zeros((T, E), np.float32)
    np.put_along_axis(combine, idx, w, 1)
    n_act = max(1, E // 2)
    active = np.zeros(E, bool)
    active[rng.permutation(E)[:n_act]] = True
    combine = np.where(active[None], combine, 0.0).astype(np.float32)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = [both(a, dt)
                                              for a in (x, w1, w3, w2)]
    ref = xshare_moe_ffn(jx, j1, j3, j2, jnp.asarray(combine),
                         jnp.asarray(active), max_active=n_act + 1,
                         block_f=blockf)
    out = K.moe_ffn(tx, t1, t3, t2, torch.tensor(combine),
                    torch.tensor(active), max_active=n_act + 1)
    assert out.dtype == tx.dtype and out.shape == (T, d)
    close(out, ref, dt)


def test_moe_ffn_all_inactive_is_zero():
    rng = np.random.default_rng(0)
    T, d, E, f = 4, 32, 4, 64
    x = torch.tensor(rng.standard_normal((T, d)), dtype=torch.float32)
    w1, w3, w2 = [torch.tensor(a) for a in ffn_weights(rng, E, d, f)]
    out = K.moe_ffn(x, w1, w3, w2, torch.zeros((T, E)),
                    torch.zeros(E, dtype=torch.bool), max_active=2)
    assert float(out.abs().max()) == 0.0


# ------------------------------------------------- grouped (sorted) -------

@pytest.mark.parametrize("T,d,E,f,blockf,k", [
    (8, 64, 4, 128, 64, 2), (16, 128, 8, 256, 128, 1),
    (32, 128, 6, 96, 32, 2),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_grouped_ffn_plain_matches_jax_kernel(T, d, E, f, blockf, k, dt):
    """The port's sorted pipeline (grouped_ffn's plain version on the
    CPU) against the JAX pipeline through the Pallas grouped_ffn."""
    rng = np.random.default_rng(T * E + k)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w1, w3, w2 = ffn_weights(rng, E, d, f)
    idx, w = topk_routing(rng, T, E, k)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = [both(a, dt)
                                              for a in (x, w1, w3, w2)]
    ref = j_sorted(jx, j1, j3, j2, jnp.asarray(idx), jnp.asarray(w),
                   use_kernel=True, block_f=blockf)
    out = sorted_expert_ffn(tx, t1, t3, t2, torch.tensor(idx),
                            torch.tensor(w))
    assert out.dtype == tx.dtype
    close(out, ref, dt)


def test_grouped_ffn_empty_experts_zero_tiles():
    """All-dropped routing: no valid tile, zero output."""
    rng = np.random.default_rng(0)
    T, d, E, f = 8, 32, 4, 64
    x = torch.tensor(rng.standard_normal((T, d)), dtype=torch.float32)
    w1, w3, w2 = [torch.tensor(a) for a in ffn_weights(rng, E, d, f)]
    idx = torch.full((T, 1), -1, dtype=torch.int32)
    w = torch.zeros((T, 1))
    assert int(dispatch_plan(idx, w, E).tile_valid.sum()) == 0
    out = sorted_expert_ffn(x, w1, w3, w2, idx, w)
    assert float(out.abs().max()) == 0.0


def test_grouped_ffn_invalid_tiles_emit_zeros():
    """The plain version honours tile_valid even for non-zero rows."""
    rng = np.random.default_rng(1)
    P, d, E, f, bt = 32, 16, 3, 32, 8
    xs = torch.tensor(rng.standard_normal((P, d)), dtype=torch.float32)
    w1, w3, w2 = [torch.tensor(a) for a in ffn_weights(rng, E, d, f)]
    eid = torch.tensor([0, 2, 1, 0], dtype=torch.int32)
    valid = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    ys = K.grouped_ffn(xs, w1, w3, w2, eid, valid, block_t=bt)
    assert float(ys[16:].abs().max()) == 0.0
    assert float(ys[:16].abs().max()) > 0.0


# ------------------------------------------------------- decode_attn ------

@pytest.mark.parametrize("B,H,Hkv,dh,S,bs", [
    (2, 8, 2, 64, 256, 64), (3, 4, 4, 32, 100, 32),
    (1, 16, 2, 128, 1024, 256), (2, 4, 1, 64, 64, 16),
    (2, 8, 2, 80, 200, 40),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_plain_matches_jax_kernel(B, H, Hkv, dh, S, bs, dt):
    rng = np.random.default_rng(B * S)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = [both(a, dt) for a in (q, k, v)]
    ref = flash_decode(jq, jk, jv, jnp.asarray(lengths), block_s=bs)
    out = K.decode_attention(tq, tk, tv, torch.tensor(lengths))
    close(out, ref, dt)


def test_decode_attention_length_masking():
    """Positions past a row's length do not influence its output."""
    rng = np.random.default_rng(0)
    B, H, Hkv, dh, S = 1, 4, 2, 32, 64
    q = torch.tensor(rng.standard_normal((B, H, dh)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((B, S, Hkv, dh)),
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((B, S, Hkv, dh)),
                     dtype=torch.float32)
    lengths = torch.tensor([17])
    out1 = K.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[:, 17:] = 99.0
    v2[:, 17:] = -99.0
    out2 = K.decode_attention(q, k2, v2, lengths)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


def test_decode_attention_zero_length_gives_zeros_like_jax():
    """A row of length 0: zeros, not NaN, as the Pallas kernel gives."""
    rng = np.random.default_rng(3)
    B, H, Hkv, dh, S = 2, 4, 2, 32, 32
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    lengths = np.array([0, 5], np.int32)
    ref = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lengths), block_s=16)
    out = K.decode_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), torch.tensor(lengths))
    assert float(out[0].abs().max()) == 0.0
    close(out, ref, "f32")


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("window,wrap", [(None, False), (24, False),
                                         (24, True)])
def test_decode_attention_cached_plain_at_head_dim_80(T, window, wrap):
    """h2o-danube's head dim (80, not a power of two) under the
    cached_attention contract, one query and a verify block, full and
    rolling-window caches (window 24 in 32 slots), wrapped past C: the
    plain version against the JAX package's cached_attention and, for
    one query over a full cache, its Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(80 + T + (window or 0) + wrap)
    B, H, Hkv, dh = 3, 8, 2, 80
    C = 48 if window is None else window + 8
    q = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    ck = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    cv = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    cur = np.array([0, 13, C - T], np.int32)
    if wrap:
        cur = np.array([C - 2, 2 * C + 5, 3 * C - 1], np.int32)
    ref = JA.cached_attention(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), jnp.asarray(cur),
                              window=window)
    out = K.decode_attention_cached(torch.tensor(q), torch.tensor(ck),
                                    torch.tensor(cv), torch.tensor(cur),
                                    window=window)
    close(out, ref, "f32")
    if T == 1 and window is None:
        # query 0 at position cur sees slots [0, cur + 1)
        ker = flash_decode(jnp.asarray(q[:, 0]), jnp.asarray(ck),
                           jnp.asarray(cv), jnp.asarray(cur + 1),
                           block_s=16)
        close(out[:, 0], ker, "f32")


@pytest.mark.parametrize("cache", ["bf16", "f8"])
def test_cached_attention_reads_a_cache_of_another_dtype(cache):
    """f32 queries over a bf16 cache, and over a float8_e4m3fn cache
    (dequantized to bf16 per use), against the reference's
    cached_attention on the same stored values: output in q's dtype,
    within the bf16 tolerance."""
    rng = np.random.default_rng(11)
    B, T, H, Hkv, dh, C = 2, 3, 4, 2, 32, 40
    tdt = {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn}[cache]
    jdt = {"bf16": jnp.bfloat16, "f8": jnp.float8_e4m3fn}[cache]
    q = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    # the stored values, exactly representable in the cache's dtype
    ck, cv = (torch.tensor(rng.standard_normal((B, C, Hkv, dh)),
                           dtype=torch.float32).to(tdt) for _ in range(2))
    cur = np.array([5, C - T], np.int32)
    ref = JA.cached_attention(
        jnp.asarray(q), jnp.asarray(ck.float().numpy(), jdt),
        jnp.asarray(cv.float().numpy(), jdt), jnp.asarray(cur))
    out = K.decode_attention_cached(torch.tensor(q), ck, cv,
                                    torch.tensor(cur))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    close(out, ref, "bf16")


def test_one_byte_cache_is_refused_on_the_card():
    """init_cache and prefill refuse a 1-byte cache that decode_attention
    has no instance for (float8_e5m2) for a CUDA device before
    allocating anything (so no GPU is needed to see it), and let an
    e4m3 one through (the e4m3 instance reads it); the CPU makes
    both."""
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["granite-moe-1b-a400m"].reduced(num_layers=1,
                                                max_d_model=64,
                                                max_vocab=64)
    e5, e4 = torch.float8_e5m2, torch.float8_e4m3fn
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        TMD.init_cache(cfg, 2, 16, e5, device="cuda")

    class CudaTokens:                   # where prefill reads the device
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        TMD.prefill(cfg, {}, CudaTokens(), cache_len=16, cache_dtype=e5)
    TMD.check_cache_dtype(e4, "cuda")
    for f8 in (e4, e5):
        cache = TMD.init_cache(cfg, 2, 16, f8, device="cpu")
        assert cache["kv_k"].dtype == f8
        assert not cache["kv_k"].view(torch.uint8).any()


# ------------------------------------------------------------ wrappers ----

def kernel_step(dh: int, itemsize: int) -> int:
    """The split kernel's positions per block step (the library's
    decode_attention_step, which needs the card): 4 warps x 4 positions
    a lane x positions per warp load, a row's 16-byte chunks on a power
    of two of lanes."""
    chunks = dh * itemsize // 16
    return 4 * 4 * (32 // min(32, 1 << (chunks - 1).bit_length()))


@pytest.mark.parametrize("B,S,Hkv,dh,itemsize", [
    (8, 512, 8, 64, 2), (8, 1024, 32, 64, 2), (8, 512, 8, 64, 4),
    (1, 4096, 1, 64, 2), (3, 100, 4, 32, 2), (2, 300, 1, 128, 4),
    (1, 1, 1, 256, 2), (64, 8192, 8, 128, 2)])
def test_decode_attention_split_plan(B, S, Hkv, dh, itemsize):
    """The split kernel's grid, chosen from S, B and Hkv alone: whole
    steps of positions per span, every position in exactly one span, no
    span wholly past S, and at most 16 blocks per SM on a full cache
    unless a span is already one step."""
    from repro_torch.kernels.decode_attn import split_plan
    sms = 132
    step = kernel_step(dh, itemsize)
    n_split, span = split_plan(B, S, Hkv, step, sms)
    assert span % step == 0
    assert (n_split - 1) * span < S <= n_split * span
    assert n_split * B * Hkv <= 16 * sms or span == step


@pytest.mark.parametrize("itemsize,step", [(2, 32), (4, 16)])
def test_decode_attention_split_plan_at_head_dim_80(itemsize, step):
    """Head dim 80 pads a row's 16-byte chunks (10 in bf16, 20 in f32)
    to 16 and 32 lanes, so a block walks 32 and 16 positions a step;
    spans are whole steps and cover h2o-danube's 4096-position window
    (+ T - 1) exactly once."""
    from repro_torch.kernels.decode_attn import split_plan
    assert kernel_step(80, itemsize) == step
    for S in (4096, 4100):
        n_split, span = split_plan(4, S, 8, step, 132)
        assert span % step == 0
        assert (n_split - 1) * span < S <= n_split * span


# granite-moe's and zamba2-1.2b's decode shapes (bf16): about 4 blocks
# per SM or more when the cache is full
@pytest.mark.parametrize("B,S,Hkv", [(8, 512, 8), (8, 1024, 32)])
def test_decode_attention_split_plan_fills_the_card(B, S, Hkv):
    from repro_torch.kernels.decode_attn import split_plan
    n_split, _ = split_plan(B, S, Hkv, kernel_step(64, 2), 132)
    assert n_split * B * Hkv >= 3.8 * 132


def test_cpu_tensors_never_reach_the_cuda_library(monkeypatch):
    """On the CPU a wrapper takes its plain version without building or
    loading anything and without counting a launch."""
    def no_lib():
        raise AssertionError("the CPU path must not load the kernels")
    monkeypatch.setattr(build, "lib", no_lib)
    K.reset_launch_counts()
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((4, 16)), dtype=torch.float32)
    w1, w3, w2 = [torch.tensor(a) for a in ffn_weights(rng, 2, 16, 32)]
    K.moe_ffn(x, w1, w3, w2, torch.ones((4, 2)),
              torch.ones(2, dtype=torch.bool), max_active=2)
    K.moe_ffn_bwd(x, w1, w3, w2, torch.ones((4, 2)),
                  torch.ones(2, dtype=torch.bool), x, max_active=2)
    K.grouped_ffn(x, w1, w3, w2, torch.zeros(1, dtype=torch.int32),
                  torch.ones(1, dtype=torch.int32), block_t=4)
    K.grouped_ffn_bwd(x, w1, w3, w2, torch.zeros(1, dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32), x, block_t=4)
    q = torch.zeros((1, 2, 32))
    kv = torch.zeros((1, 8, 1, 32))
    K.decode_attention(q, kv, kv, torch.tensor([3]))
    xs = torch.zeros((1, 8, 2, 32))
    bc = torch.zeros((1, 8, 1, 16))
    K.ssd_scan(xs, torch.ones((1, 8, 2)), -torch.ones(2), bc, bc, chunk=4)
    K.ssd_scan_bwd(xs, torch.ones((1, 8, 2)), -torch.ones(2), bc, bc, xs,
                   chunk=4)
    assert K.launch_counts() == {"grouped_ffn": 0, "moe_ffn": 0,
                                 "decode_attention": 0, "ssd_scan": 0,
                                 "grouped_ffn_bwd": 0, "ssd_scan_bwd": 0,
                                 "moe_ffn_bwd": 0}


class ElsewhereTensor:
    """Stands in for a tensor on a device with neither a kernel nor a
    plain route (this CPU build can make no such tensor): a wrapper must
    raise on its device before reading anything else."""
    device = torch.device("xpu")
    ndim = 3
    requires_grad = False

    def __getitem__(self, index):
        return self


def test_wrappers_refuse_devices_without_a_kernel():
    """CPU and meta tensors take the plain version (on meta it only
    propagates shapes and dtypes, and counts no launch); a tensor on any
    other device without a kernel raises instead of computing
    silently."""
    before = K.launch_counts()
    q = torch.zeros((1, 2, 32), device="meta")
    kv = torch.zeros((1, 8, 1, 32), device="meta")
    out = K.decode_attention(q, kv, kv, torch.tensor([3], device="meta"))
    assert (out.device.type, out.shape) == ("meta", q.shape)
    x = torch.zeros((4, 16), device="meta")
    w = torch.zeros((2, 16, 32), device="meta")
    y = K.moe_ffn(x, w, w, w.transpose(1, 2),
                  torch.ones((4, 2), device="meta"),
                  torch.ones(2, dtype=torch.bool, device="meta"),
                  max_active=2)
    assert (y.device.type, y.shape, y.dtype) == ("meta", x.shape, x.dtype)
    ys = K.grouped_ffn(x, w, w, w.transpose(1, 2),
                       torch.zeros(1, dtype=torch.int32, device="meta"),
                       torch.ones(1, dtype=torch.int32, device="meta"),
                       block_t=4)
    assert (ys.device.type, ys.shape) == ("meta", x.shape)
    assert K.launch_counts() == before
    far = ElsewhereTensor()
    with pytest.raises(ValueError):
        K.decode_attention(far, kv, kv, torch.tensor([3]))
    with pytest.raises(ValueError):
        K.decode_attention_cached(far, kv, kv, torch.tensor([3]))
    with pytest.raises(ValueError):
        K.moe_ffn(far, w, w, w.transpose(1, 2), torch.ones((4, 2)),
                  torch.ones(2, dtype=torch.bool), max_active=2)
    with pytest.raises(ValueError):
        K.moe_ffn_bwd(far, w, w, w.transpose(1, 2), torch.ones((4, 2)),
                      torch.ones(2, dtype=torch.bool), far, max_active=2)
    with pytest.raises(ValueError):
        K.grouped_ffn(far, w, w, w.transpose(1, 2),
                      torch.zeros(1, dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32), block_t=4)
    with pytest.raises(ValueError):
        K.grouped_ffn_bwd(far, w, w, w.transpose(1, 2),
                          torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32), far, block_t=4)
