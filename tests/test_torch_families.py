"""The VLM and audio families in the port against the JAX package:
paligemma-3b (``family="vlm"``: prefix embeddings before the tokens, tied
embeddings, GELU, MQA) and musicgen-large (``family="audio"``: frames of
4 codebooks, summed embeddings, one head per codebook), each cut to 2
layers, d 128, vocab 256. The same weights (JAX init_params, carried over
by the bridge) and the same inputs give logits, caches, the loss and
every gradient leaf within 2e-5 (f32), and the same greedy tokens through
Engine.generate; the front door streams codebook frames through a kill
and a recovery; and the two reference faults around prefixes are
refused."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as JOPT  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.launch.train import make_train_step as j_make_train_step  # noqa
from repro.models import model as JMD  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.step import decode_steps_fused as j_fused  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import optim as TOPT  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving import (Engine, Fault, FaultInjector,  # noqa: E402
                                 InvalidRequest, recover)
from repro_torch.serving.errors import REASON_COMPLETED  # noqa: E402
from repro_torch.serving.step import decode_steps_fused  # noqa: E402

TOL = 2e-5
VLM, AUDIO = "paligemma-3b", "musicgen-large"
# (model, prefix embeddings given): paligemma always serves a prefix,
# musicgen with its conditioning embeddings and without
CASES = [(VLM, True), (AUDIO, False), (AUDIO, True)]
IDS = ["paligemma-prefix", "musicgen", "musicgen-prefix"]
B, S, NEW = 2, 12, 6


def small(archs, name):
    return archs[name].reduced(num_layers=2, max_d_model=128, max_vocab=256)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def fam():
    """name -> (JAX config, port config, JAX params, port params)."""
    out = {}
    for i, name in enumerate((VLM, AUDIO)):
        jcfg, tcfg = small(JARCHS, name), small(ARCHS, name)
        jp = JMD.init_params(jcfg, jax.random.PRNGKey(10 + i))
        out[name] = (jcfg, tcfg, jp, bridge.from_numpy(to_np(jp),
                                                      device="cpu"))
    return out


def inputs(cfg, *, batch=B, seq=S, prefix=True, seed=0):
    """Seeded tokens ((batch, seq) or (batch, seq, K) frames) and, when
    asked, N(0, 1) prefix embeddings (batch, prefix_len, d), numpy."""
    rng = np.random.default_rng(seed)
    shape = (batch, seq) + ((cfg.num_codebooks,)
                            if cfg.family == "audio" else ())
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    pe = rng.standard_normal((batch, cfg.prefix_len, cfg.d_model)
                             ).astype(np.float32) if prefix else None
    return toks, pe


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def pe_of(pe, lib):
    return None if pe is None else lib(pe)


def test_families_are_the_references():
    """The configs the tests cut: paligemma an MQA decoder with tied
    embeddings and a prefix, musicgen 4 codebooks, untied heads."""
    v, a = small(ARCHS, VLM), small(ARCHS, AUDIO)
    assert (v.family, v.tie_embeddings, v.act, v.attn.num_kv_heads) == \
        ("vlm", True, "gelu", 1)
    assert (a.family, a.num_codebooks, a.tie_embeddings) == \
        ("audio", 4, False)
    assert v.prefix_len == a.prefix_len == 8


# ---------------------------------------------------------- the model ----

@pytest.mark.parametrize("name,prefix", CASES, ids=IDS)
def test_forward_matches_jax(fam, name, prefix):
    jcfg, tcfg, jp, tp = fam[name]
    toks, pe = inputs(tcfg, prefix=prefix)
    want, _ = JMD.forward(jcfg, jp, jnp.asarray(toks),
                          prefix_embeds=pe_of(pe, jnp.asarray))
    with torch.no_grad():
        got, _ = TMD.forward(tcfg, tp, torch.as_tensor(toks),
                             prefix_embeds=pe_of(pe, torch.as_tensor))
    P = pe.shape[1] if prefix else 0
    K = (tcfg.num_codebooks,) if tcfg.family == "audio" else ()
    assert got.shape == (B, P + S) + K + (tcfg.padded_vocab,)
    close(got, want)


@pytest.mark.parametrize("name,prefix", CASES, ids=IDS)
def test_prefill_and_decode_match_forward_and_jax(fam, name, prefix):
    """prefill of the first S - 2 tokens after the prefix, then two
    decode steps: each position's logits equal the JAX package's
    prefill / decode_step and its forward's at P + i; caches equal the
    JAX package's, cur_len = P + the tokens fed."""
    jcfg, tcfg, jp, tp = fam[name]
    toks, pe = inputs(tcfg, prefix=prefix, seed=1)
    P = pe.shape[1] if prefix else 0
    full, _ = JMD.forward(jcfg, jp, jnp.asarray(toks),
                          prefix_embeds=pe_of(pe, jnp.asarray))
    jlg, jc, _ = JMD.prefill(jcfg, jp, jnp.asarray(toks[:, :S - 2]),
                             cache_len=64,
                             prefix_embeds=pe_of(pe, jnp.asarray))
    with torch.no_grad():
        lg, cache, _ = TMD.prefill(tcfg, tp, torch.as_tensor(toks[:, :S - 2]),
                                   cache_len=64,
                                   prefix_embeds=pe_of(pe, torch.as_tensor))
        close(lg, jlg)
        close(lg, full[:, P + S - 3])
        for i in (S - 2, S - 1):
            jd, jc, _ = JMD.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                        jc)
            td, cache, _ = TMD.decode_step(tcfg, tp,
                                           torch.as_tensor(toks[:, i:i + 1]),
                                           cache)
            close(td, jd)
            close(td[:, 0], full[:, P + i])
    assert cache["cur_len"].tolist() == [P + S] * B
    for k in ("kv_k", "kv_v"):
        close(cache[k], jc[k])


@pytest.mark.parametrize("name", [VLM, AUDIO])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_match_jax(name, dtype):
    """bridge.init_params and init_cache give the JAX package's keys,
    shapes and dtypes: the audio embedding (K, V, d) and untied head (K,
    d, V), paligemma's tied table (no lm_head), KV caches as the dense
    family's."""
    jcfg, tcfg = small(JARCHS, name), small(ARCHS, name)
    jflat = bridge.flatten(to_np(JMD.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=getattr(jnp, dtype))))
    tflat = bridge.flatten(bridge.init_params(
        tcfg, seed=0, dtype=getattr(torch, dtype), device="cpu"))
    assert sorted(tflat) == sorted(jflat)
    for k, a in jflat.items():
        assert tuple(tflat[k].shape) == a.shape, k
        assert str(tflat[k].dtype).replace("torch.", "") == str(a.dtype), k
    jc = JMD.init_cache(jcfg, 3, 32, getattr(jnp, dtype))
    tc = TMD.init_cache(tcfg, 3, 32, getattr(torch, dtype))
    assert sorted(tc) == sorted(jc) == ["cur_len", "kv_k", "kv_v"]
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k


# ----------------------------------------------------------- training ----

@pytest.fixture(scope="module")
def jax_grads(fam):
    out = {}
    for (name, prefix), cid in zip(CASES, IDS):
        jcfg, _, jp, tp = fam[name]
        toks, pe = inputs(fam[name][1], prefix=prefix, seed=2)
        f = jax.jit(jax.value_and_grad(lambda p: JMD.loss_fn(
            jcfg, p, jnp.asarray(toks),
            prefix_embeds=pe_of(pe, jnp.asarray), remat=False)[0]))
        out[cid] = f(jp)
    return out


@pytest.mark.parametrize("name,prefix", CASES, ids=IDS)
def test_loss_and_every_gradient_leaf_match_jax(fam, jax_grads, name,
                                                prefix):
    """loss_fn (the prefix positions predict nothing; musicgen's NLL is
    averaged over its codebooks) and torch.autograd through it, remat
    on, against jax.value_and_grad of the JAX package's, remat off:
    every leaf within 2e-5 of its largest magnitude."""
    from repro_torch.launch.train import loss_and_grads
    _, tcfg, _, tp = fam[name]
    toks, pe = inputs(tcfg, prefix=prefix, seed=2)
    jl, jg = jax_grads[IDS[CASES.index((name, prefix))]]
    loss, grads = loss_and_grads(tcfg, tp, torch.as_tensor(toks),
                                 prefix_embeds=pe_of(pe, torch.as_tensor))
    assert abs(float(loss) - float(jl)) <= TOL
    jflat, tflat = bridge.flatten(to_np(jg)), bridge.flatten(grads)
    assert sorted(jflat) == sorted(tflat)
    for k, g in jflat.items():
        err = np.abs(tflat[k].numpy() - g).max() / max(np.abs(g).max(),
                                                       1e-30)
        assert err <= TOL, (k, err)
    assert float(tflat["embed"].abs().max()) > 0


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_train_step_with_prefix_matches_jax(fam, name):
    """One make_train_step with prefix_embeds against the JAX package's
    (lr 3e-4); then accum_steps=2, which splits the prefix with the
    tokens, equals the whole batch of 4."""
    jcfg, tcfg, jp, tp = fam[name]
    toks, pe = inputs(tcfg, batch=4, seed=3)
    jstep = jax.jit(j_make_train_step(
        jcfg, lr=JOPT.cosine_schedule(3e-4, 1, 3)))
    jp2, _, jm = jstep(jp, JOPT.adamw_init(jp), jnp.asarray(toks),
                       jnp.asarray(pe))
    outs = [make_train_step(tcfg, lr=TOPT.cosine_schedule(3e-4, 1, 3),
                            accum_steps=a)(tp, TOPT.adamw_init(tp), toks,
                                           torch.as_tensor(pe))
            for a in (1, 2)]
    (tp1, _, tm1), (tp2, _, tm2) = outs
    assert abs(float(tm1["loss"]) - float(jm["loss"])) <= TOL
    assert abs(float(tm2["loss"]) - float(tm1["loss"])) <= TOL
    jflat = bridge.flatten(to_np(jp2))
    for k, v in bridge.flatten(tp1).items():
        close(v, jflat[k], tol=1e-4)
        close(bridge.flatten(tp2)[k], v.numpy(), tol=1e-5)


# ------------------------------------------------------------ serving ----

@pytest.fixture(scope="module")
def served(fam):
    """Greedy tokens of the JAX Engine, NEW new per request, by case."""
    out = {}
    for (name, prefix), cid in zip(CASES, IDS):
        jcfg, tcfg, jp, _ = fam[name]
        toks, pe = inputs(tcfg, batch=3, seed=4, prefix=prefix)
        out[cid] = JEngine(jcfg, jp, cache_len=64).generate(
            toks, NEW, prefix_embeds=pe_of(pe, jnp.asarray))
    return out


@pytest.mark.parametrize("name,prefix", CASES, ids=IDS)
def test_generate_matches_jax(fam, served, name, prefix):
    """Engine.generate's greedy tokens equal the JAX engine's: with a
    prefix through the lockstep loop (the JAX package's prefix path);
    musicgen without one also through the continuous scheduler, whose
    (num_slots, K) token buffer carries whole frames, == lockstep."""
    _, tcfg, _, tp = fam[name]
    toks, pe = inputs(tcfg, batch=3, seed=4, prefix=prefix)
    want, jst = served[IDS[CASES.index((name, prefix))]]
    eng = Engine(tcfg, tp, cache_len=64, device="cpu")
    got, st = eng.generate(toks, NEW, prefix_embeds=pe)
    K = (tcfg.num_codebooks,) if tcfg.family == "audio" else ()
    assert got.shape == (3, NEW) + K
    np.testing.assert_array_equal(got, np.asarray(want))
    assert st.new_tokens == jst.new_tokens == 3 * NEW * int(np.prod(K))
    if not prefix:
        assert st.capture_s == 0.0 and eng.loops.states()
        lock, _ = eng.generate(toks, NEW, lockstep=True)
        np.testing.assert_array_equal(lock, got)


def test_audio_scheduler_state_carries_frames(fam):
    """The running batch of an audio scheduler holds (num_slots, K)
    tokens under a key that names K, so a LoopPool never lends it to a
    scheduler of a single stream; requests admitted mid-stream into a
    freed slot give their solo tokens; the invariants hold."""
    _, tcfg, _, tp = fam[AUDIO]
    eng = Engine(tcfg, tp, cache_len=64, device="cpu")
    toks, _ = inputs(tcfg, batch=3, seed=5, prefix=False)
    solo = [eng.generate(toks[b:b + 1], NEW)[0][0] for b in range(3)]
    sched = eng.make_scheduler(num_slots=2, invariants=True)
    assert sched._tok.shape == (2, tcfg.num_codebooks)
    assert tcfg.num_codebooks in sched._state_key()
    for b in range(3):
        sched.submit(toks[b], NEW - b)
    states = sched.run()
    sched.release()
    for b, st in enumerate(states):
        np.testing.assert_array_equal(np.stack(st.tokens), solo[b][:NEW - b])


def test_decode_loop_freezes_one_poisoned_frame_slot(fam):
    """decode_steps_fused with (B, K) tokens and a NaN fault at (slot 1,
    step 2): that slot alone stops there, its cur_len frozen and its
    last frame kept whole; tokens, ok and poisoned equal the JAX
    package's loop under the same fault."""
    jcfg, tcfg, jp, tp = fam[AUDIO]
    toks, _ = inputs(tcfg, batch=3, seed=6, prefix=False)
    jlg, jc, _ = JMD.prefill(jcfg, jp, jnp.asarray(toks), cache_len=64)
    jt, _, jtoks, _, jok, jpois = j_fused(
        jcfg, jp, jnp.argmax(jlg, -1).astype(jnp.int32), jc,
        jnp.full((3,), 10, jnp.int32), jax.random.PRNGKey(0), num_steps=5,
        fault=jnp.asarray((1, 2), jnp.int32))
    with torch.no_grad():
        lg, cache, _ = TMD.prefill(tcfg, tp, torch.as_tensor(toks),
                                   cache_len=64)
        tok = lg.argmax(-1).to(torch.int32)
        tok0 = tok.clone()
        t, cache, ttoks, _, ok, pois = decode_steps_fused(
            tcfg, tp, tok, cache, torch.full((3,), 10, dtype=torch.int32),
            None, num_steps=5, fault=(1, 2))
    assert ttoks.shape == (5, 3, tcfg.num_codebooks)
    assert pois.tolist() == [False, True, False] == np.asarray(jpois).tolist()
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert cache["cur_len"].tolist() == [S + 5, S + 2, S + 5]
    assert torch.equal(t[1], ttoks[1, 1]) and not torch.equal(t[1], tok0[1])


def test_audio_frontdoor_streams_survive_a_kill(fam, tmp_path):
    """musicgen through the FrontDoor, 2 slots, 3 requests, a journal
    and a snapshot every round: killed entering round 2 with a torn
    journal write, then recover(): every stream's frames (journaled and
    snapshotted as lists) equal Engine.generate's, nothing lost, replay
    fidelity 1.0."""
    _, tcfg, _, tp = fam[AUDIO]
    eng = Engine(tcfg, tp, cache_len=64, decode_chunk=2, device="cpu")
    toks, _ = inputs(tcfg, batch=3, seed=7, prefix=False)
    want, _ = eng.generate(toks, NEW)
    jp, sp = os.path.join(tmp_path, "wal.journal"), \
        os.path.join(tmp_path, "snap")
    door = eng.make_frontdoor(
        num_slots=2, journal_path=jp, snapshot_path=sp,
        snapshot_every_rounds=1,
        faults=FaultInjector([Fault("crash_mid_round", step=2),
                              Fault("journal_torn_write", nbytes=7)]))
    streams = [door.submit(toks[b], NEW) for b in range(3)]
    door.drain(timeout=120.0)
    assert door.crashed is not None and all(s.done for s in streams)
    door2, report = recover(eng, journal_path=jp, snapshot_path=sp,
                            num_slots=2)
    door2.drain(timeout=120.0)
    assert door2.crashed is None and report.snapshot_used
    assert report.requests == 3 and report.resumed + report.terminal == 3
    for b in range(3):
        s = door2.streams[b]
        assert s.finish_reason == REASON_COMPLETED
        np.testing.assert_array_equal(np.stack(s.tokens), want[b])
    assert door2.replay_stats()["fidelity"] == 1.0


# ------------------------------------------------ the reference's faults --

def test_prefix_with_a_draft_model_raises(fam):
    """Reference fault (a): with a draft model the JAX Engine.generate
    returns from its speculative branch before it looks at
    prefix_embeds, so the prefix is dropped without a word (its tokens
    equal the run without one). The port raises instead."""
    jcfg, tcfg, jp, tp = fam[VLM]
    toks, pe = inputs(tcfg, batch=2, seed=8)
    jeng = JEngine(jcfg, jp, cache_len=64, draft=(jcfg, jp), spec_len=2)
    dropped, _ = jeng.generate(toks, 4, prefix_embeds=jnp.asarray(pe),
                               lockstep=True)
    plain, _ = jeng.generate(toks, 4, lockstep=True)
    np.testing.assert_array_equal(np.asarray(dropped), np.asarray(plain))
    eng = Engine(tcfg, tp, cache_len=64, draft=(tcfg, tp), spec_len=2,
                 device="cpu")
    for lockstep in (False, True):
        with pytest.raises(ValueError, match="draft model"):
            eng.generate(toks, 4, prefix_embeds=pe, lockstep=lockstep)


def test_prefix_that_overflows_the_cache_is_an_invalid_request(fam):
    """Reference fault (b): the JAX engine validates the prompt without
    its prefix, so P + S past the cache fails as an AssertionError in
    the cache build, and P + S + new - 1 past it would write beyond the
    cache while decoding. The port counts P and raises InvalidRequest,
    as for an over-long prompt; a request that fits is served."""
    jcfg, tcfg, jp, tp = fam[VLM]
    toks, pe = inputs(tcfg, batch=2, seed=9)          # P 8 + S 12 = 20
    with pytest.raises(AssertionError):
        JEngine(jcfg, jp, cache_len=16).generate(
            toks, 2, prefix_embeds=jnp.asarray(pe))
    with pytest.raises(InvalidRequest):
        Engine(tcfg, tp, cache_len=16, device="cpu").generate(
            toks, 2, prefix_embeds=pe)
    eng = Engine(tcfg, tp, cache_len=24, device="cpu")
    with pytest.raises(InvalidRequest):
        eng.generate(toks, 6, prefix_embeds=pe)       # 20 + 6 - 1 > 24
    assert eng.generate(toks, 5, prefix_embeds=pe)[0].shape == (2, 5)
    with pytest.raises(InvalidRequest):
        eng.generate(toks, 2, prefix_embeds=pe[:1])   # batch 1 of 2
