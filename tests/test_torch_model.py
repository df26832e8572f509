"""The port's model against the JAX package on the reduced configs the
serving tests use: same weights (JAX init_params, carried over by the
bridge), same inputs. Prefill and 8 decode steps with per-slot active
masks within 2e-5, caches equal after each step, cached_attention on
every path, and the weight bridge round trip."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

TOL = 2e-5


def small(archs, name):
    return archs[name].reduced(num_layers=2, max_d_model=128, max_vocab=256)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def moe_pair():
    jcfg = small(JARCHS, "granite-moe-1b-a400m")
    tcfg = small(ARCHS, "granite-moe-1b-a400m")
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(to_np(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


# ----------------------------------------------------------- weights ------

@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "llama3-8b",
                                  "mamba2-370m", "zamba2-1.2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_keys_shapes_dtypes_match_jax(name, dtype):
    jp = JMD.init_params(small(JARCHS, name), jax.random.PRNGKey(0),
                         dtype=getattr(jnp, dtype))
    tp = bridge.init_params(small(ARCHS, name), seed=0,
                            dtype=getattr(torch, dtype), device="cpu")
    jflat = bridge.flatten(to_np(jp))
    tflat = bridge.flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    for key, arr in jflat.items():
        assert tuple(tflat[key].shape) == arr.shape, key
        assert str(tflat[key].dtype).replace("torch.", "") == \
            str(arr.dtype), key


def test_bridge_round_trip_bf16():
    """JAX bf16 params -> numpy -> torch -> numpy: every leaf equal, bf16
    leaves as their f32 upcast; the f32 upcast plus the checkpoint's
    dtype sidecar comes back as bf16."""
    cfg = small(JARCHS, "granite-moe-1b-a400m")
    jp = JMD.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    tp = bridge.from_numpy(to_np(jp), device="cpu")
    assert tp["layers"]["moe"]["w1"].dtype == torch.bfloat16
    assert tp["layers"]["moe"]["wg"].dtype == torch.float32
    back = bridge.flatten(bridge.to_numpy(tp))
    for key, arr in bridge.flatten(to_np(jp)).items():
        np.testing.assert_array_equal(back[key], arr.astype(np.float32))
    again = bridge.from_numpy(bridge.unflatten(back), device="cpu",
                              dtypes=bridge.dtypes_of(tp))
    for key, t in bridge.flatten(again).items():
        assert t.dtype == bridge.flatten(tp)[key].dtype
        assert torch.equal(t, bridge.flatten(tp)[key])


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-1.2b"])
def test_bridge_round_trip_keeps_ssm_decay_params_f32(name):
    """A bf16 SSM model keeps A_log, D and dt_bias in f32 through JAX ->
    numpy -> torch -> numpy -> torch, and every leaf comes back equal."""
    cfg = small(JARCHS, name)
    jp = JMD.init_params(cfg, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    tp = bridge.from_numpy(to_np(jp), device="cpu")
    ssm = tp["layers"]["ssm"]
    assert ssm["in_x"].dtype == torch.bfloat16
    for key in ("A_log", "D", "dt_bias"):
        assert ssm[key].dtype == torch.float32, key
    back = bridge.flatten(bridge.to_numpy(tp))
    for key, arr in bridge.flatten(to_np(jp)).items():
        np.testing.assert_array_equal(back[key], arr.astype(np.float32))
    again = bridge.from_numpy(bridge.unflatten(back), device="cpu",
                              dtypes=bridge.dtypes_of(tp))
    for key, t in bridge.flatten(again).items():
        assert t.dtype == bridge.flatten(tp)[key].dtype, key
        assert torch.equal(t, bridge.flatten(tp)[key])
    own = bridge.init_params(small(ARCHS, name), dtype=torch.bfloat16,
                             device="cpu")["layers"]["ssm"]
    assert {k: own[k].dtype for k in ("A_log", "D", "dt_bias")} == \
        dict.fromkeys(("A_log", "D", "dt_bias"), torch.float32)


def test_model_module_owns_the_parameters(moe_pair):
    _, tcfg, _, tp = moe_pair
    m = TMD.Model(tcfg, tp)
    assert sum(p.numel() for p in m.parameters()) == bridge.param_count(tp)
    assert all(not p.requires_grad for p in m.parameters())
    for key, t in bridge.flatten(m.params).items():
        assert torch.equal(t, bridge.flatten(tp)[key])


@pytest.mark.parametrize("name", ["paligemma-3b", "musicgen-large"])
def test_unported_families_raise(name):
    """What the VLM and audio families still refuse, now that they are
    ported: speculative decoding of an audio target (codebook frames, as
    the JAX package refuses), and a prefix with a draft model (the JAX
    package drops it unread). Their init_params and init_cache give the
    JAX package's keys, shapes and dtypes."""
    from repro_torch.serving import Engine
    jcfg, cfg = small(JARCHS, name), small(ARCHS, name)
    assert cfg.family in ("vlm", "audio")
    tp = bridge.init_params(cfg, device="cpu")
    jflat = bridge.flatten(to_np(JMD.init_params(jcfg,
                                                 jax.random.PRNGKey(0))))
    tflat = bridge.flatten(tp)
    assert sorted(tflat) == sorted(jflat)
    assert all(tuple(tflat[k].shape) == a.shape and
               str(tflat[k].dtype) == f"torch.{a.dtype}"
               for k, a in jflat.items())
    jc = JMD.init_cache(jcfg, 1, 8, jnp.float32)
    tc = TMD.init_cache(cfg, 1, 8, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    if cfg.family == "audio":
        with pytest.raises(NotImplementedError, match="codebook streams"):
            Engine(cfg, tp, draft=(cfg, tp), spec_len=2, device="cpu")
    else:
        eng = Engine(cfg, tp, cache_len=64, draft=(cfg, tp), spec_len=2,
                     device="cpu")
        with pytest.raises(ValueError, match="draft model"):
            eng.generate(np.zeros((1, 4), np.int32), 2,
                         prefix_embeds=np.zeros((1, 3, cfg.d_model)))


# ---------------------------------------------------- forward / decode ----

@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "h2o-danube-1.8b"])
def test_forward_matches_jax(name):
    jcfg, tcfg = small(JARCHS, name), small(ARCHS, name)
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(2))
    tp = bridge.from_numpy(to_np(jp), device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40))
    ref, _ = JMD.forward(jcfg, jp, jnp.asarray(toks))
    out, _ = TMD.forward(tcfg, tp, torch.tensor(toks))
    close(out, ref)


def test_prefill_and_decode_steps_match_jax(moe_pair):
    """Prefill logits, then 8 decode steps with per-slot active masks:
    logits within 2e-5 and the whole cache equal after every step."""
    jcfg, tcfg, jp, tp = moe_pair
    rng = np.random.default_rng(7)
    B, S = 3, 12
    prompts = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc, _ = JMD.prefill(jcfg, jp, jnp.asarray(prompts), cache_len=32,
                            capacity_factor=8.0)
    tl, tc, _ = TMD.prefill(tcfg, tp, torch.tensor(prompts), cache_len=32,
                            capacity_factor=8.0)
    close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(8):
        active = np.ones(B, bool)
        active[step % B] = step < 5          # slots drop in and out
        jl, jc, jaux = JMD.decode_step(
            jcfg, jp, jnp.asarray(tok[:, None]), jc, capacity_factor=8.0,
            active=jnp.asarray(active))
        tl, tc, taux = TMD.decode_step(
            tcfg, tp, torch.tensor(tok[:, None]), tc, capacity_factor=8.0,
            active=torch.tensor(active))
        close(tl, jl)
        np.testing.assert_array_equal(tc["cur_len"].numpy(),
                                      np.asarray(jc["cur_len"]))
        close(tc["kv_k"], jc["kv_k"])
        close(tc["kv_v"], jc["kv_v"])
        np.testing.assert_array_equal(
            taux["activated_experts"].numpy(),
            np.asarray(jaux["activated_experts"]))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)


def test_cache_surgery_matches_jax(moe_pair):
    jcfg, tcfg, jp, tp = moe_pair
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    _, jreq, _ = JMD.prefill(jcfg, jp, jnp.asarray(prompts), cache_len=16)
    _, treq, _ = TMD.prefill(tcfg, tp, torch.tensor(prompts), cache_len=16)
    jb = JMD.init_cache(jcfg, 3, 16, jnp.float32)
    tb = TMD.init_cache(tcfg, 3, 16, torch.float32)
    jb = JMD.insert_request(jb, jreq, 2, src=1)
    tb = TMD.insert_request(tb, treq, 2, src=1)
    for key in ("cur_len", "kv_k", "kv_v"):
        close(tb[key], jb[key])
    assert tb["cur_len"].tolist() == [0, 0, 10]
    tb = TMD.evict_slot(tb, 2)
    assert tb["cur_len"].tolist() == [0, 0, 0]
    assert float(tb["kv_k"][:, 2].abs().max()) > 0
    tb = TMD.evict_slot(tb, 2, scrub=True)
    assert float(tb["kv_k"][:, 2].abs().max()) == 0.0


@pytest.mark.parametrize("T,window,start", [(1, None, False), (1, 24, False),
                                            (1, None, True), (3, None, False),
                                            (4, 24, False)])
def test_cached_attention_matches_jax(T, window, start):
    """Every case takes the decode_attention kernel's plain version on the
    CPU (the kernel on the card); start_pos is computed on the CPU only."""
    rng = np.random.default_rng(T * 10 + (window or 0))
    B, H, Hkv, dh, C = 3, 4, 2, 32, 40
    q = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    ck = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    cv = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    cur = np.array([0, 17, C - T], np.int32)
    # start_pos broadcasts against the (B, T, C) slot positions
    sp = np.array([0, 5, 9], np.int32).reshape(B, 1, 1) if start else None
    ref = JA.cached_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cur),
        window=window, start_pos=None if sp is None else jnp.asarray(sp))
    out = TA.cached_attention(
        torch.tensor(q), torch.tensor(ck), torch.tensor(cv),
        torch.tensor(cur), window=window,
        start_pos=None if sp is None else torch.tensor(sp))
    close(out, ref)


@pytest.mark.parametrize("window", [None, 8])
def test_update_cache_matches_jax(window):
    rng = np.random.default_rng(4)
    B, C, Hkv, dh, T = 3, 12, 2, 8, 3
    cache = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    new = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    cur = np.array([0, 5, 10], np.int32)      # the last row runs off a
    ref = JA.update_cache(jnp.asarray(cache), jnp.asarray(new),  # full cache
                          jnp.asarray(cur), window=window)
    out = TA.update_cache(torch.tensor(cache), torch.tensor(new),
                          torch.tensor(cur), window=window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_rope_and_flash_attention_match_jax():
    rng = np.random.default_rng(9)
    B, S, H, Hkv, dh = 2, 37, 4, 2, 16
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    pos = np.tile(np.arange(S), (B, 1)) + 3
    close(TA.apply_rope(torch.tensor(q), torch.tensor(pos), 1e4),
          JA.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4))
    for window in (None, 5):
        ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window, q_chunk=16,
                                 kv_chunk=16)
        out = TA.flash_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), window=window, q_chunk=16)
        close(out, ref)


def test_padded_vocab_is_masked():
    cfg = dataclasses.replace(small(ARCHS, "granite-moe-1b-a400m"),
                              vocab_size=250)
    tp = bridge.init_params(cfg, seed=1, device="cpu")
    x = torch.randn((2, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    lg = TMD.lm_head_apply(cfg, tp, x)
    assert lg.shape[-1] == cfg.padded_vocab == 256
    assert bool((lg[..., 250:] == torch.tensor(-1e30)).all())
    assert bool((lg[..., :250] > -1e29).all())
