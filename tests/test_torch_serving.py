"""The port's serving stack against the JAX package's: the same weights
and prompts give the same greedy tokens through Engine.generate (policy
off and XShare batch) and through the scheduler with mid-stream
admission and eviction (FCFS and affinity admission). Inside the port:
continuous equals lockstep, and the scheduler's invariants hold."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import XSharePolicy as JPolicy  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import XSharePolicy  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.serving import (Engine, InvariantViolation,  # noqa: E402
                                 QueueFull)

POLICIES = {"off": {}, "batch": dict(mode="batch", k0=1, m_l=0)}


def small(archs, name):
    return archs[name].reduced(num_layers=2, max_d_model=128, max_vocab=256)


def setup(name, seed):
    jcfg, tcfg = small(JARCHS, name), small(ARCHS, name)
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    tp = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg, jp, tp = setup("granite-moe-1b-a400m", 1)
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (3, 12), 0, jcfg.vocab_size))
    return jcfg, tcfg, jp, tp, prompts


def engines(moe, policy="off", **kw):
    jcfg, tcfg, jp, tp, _ = moe
    pol = POLICIES[policy]
    jeng = JEngine(jcfg, jp, cache_len=128, policy=JPolicy(**pol), **kw)
    teng = Engine(tcfg, tp, cache_len=128, policy=XSharePolicy(**pol),
                  device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("policy", ["off", "batch"])
def test_generate_matches_jax(moe, policy):
    """3 prompts x 12 tokens, 20 new: identical greedy tokens and the
    same activated-expert statistics."""
    prompts = moe[4]
    jeng, teng = engines(moe, policy)
    ref, jst = jeng.generate(prompts, 20)
    out, tst = teng.generate(prompts, 20)
    np.testing.assert_array_equal(out, ref)
    assert tst.new_tokens == jst.new_tokens == 60
    np.testing.assert_allclose(tst.mean_aux("activated_experts"),
                               jst.mean_aux("activated_experts"))
    lock, _ = teng.generate(prompts, 20, lockstep=True)
    np.testing.assert_array_equal(lock, out)


@pytest.mark.parametrize("admission", ["fcfs", "affinity"])
def test_scheduler_midstream_matches_jax(moe, admission):
    """Two slots, four requests of different lengths: later requests are
    admitted into slots freed mid-stream. Every request's tokens equal
    the JAX scheduler's and the port's solo run."""
    tcfg = moe[1]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=s).astype(np.int32)
               for s in (12, 12, 9, 15)]
    lens = [6, 14, 10, 8]
    jeng, teng = engines(moe, decode_chunk=3)
    runs = []
    for eng in (jeng, teng):
        sched = eng.make_scheduler(num_slots=2, admission=admission)
        for p, n in zip(prompts, lens):
            sched.submit(p, n)
        states = sched.run()
        assert all(s.status == "done" for s in states)
        runs.append([np.stack(s.tokens) for s in states])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(b, a)
    for p, n, toks in zip(prompts, lens, runs[1]):
        solo, _ = teng.generate(p[None], n)
        np.testing.assert_array_equal(toks, solo[0])


def test_dense_window_model_matches_jax():
    """The dense family with a rolling-window cache survives cache
    surgery, and agrees with the JAX engine."""
    jcfg, tcfg, jp, tp = setup("h2o-danube-1.8b", 3)
    assert tcfg.attn.sliding_window
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(4), (2, 10), 0, jcfg.vocab_size))
    ref, _ = JEngine(jcfg, jp, cache_len=128, decode_chunk=8).generate(
        prompts, 30)
    teng = Engine(tcfg, tp, cache_len=128, decode_chunk=8, device="cpu")
    out, _ = teng.generate(prompts, 30)
    np.testing.assert_array_equal(out, ref)
    lock, _ = teng.generate(prompts, 30, lockstep=True)
    np.testing.assert_array_equal(lock, out)


# ------------------------------------------------ SSM and hybrid ------

def ssm_small(archs, name):
    """Reduced mamba2-370m, or zamba2-1.2b with three shared-block
    applications (the last group ragged)."""
    if name == "zamba2-1.2b":
        return dataclasses.replace(
            archs[name].reduced(num_layers=5, max_d_model=128,
                                max_vocab=256), attn_every=2)
    return small(archs, name)


@pytest.fixture(scope="module", params=["mamba2-370m", "zamba2-1.2b"])
def ssm(request):
    """One engine per side; decode chunk 3 serves generate and the
    scheduler alike (tokens do not depend on it)."""
    name = request.param
    jcfg, tcfg = ssm_small(JARCHS, name), ssm_small(ARCHS, name)
    jp = j_init(jcfg, jax.random.PRNGKey(5))
    tp = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return (tcfg, JEngine(jcfg, jp, cache_len=128, decode_chunk=3),
            Engine(tcfg, tp, cache_len=128, decode_chunk=3, device="cpu"))


def test_ssm_generate_matches_jax(ssm):
    """3 prompts of 40 tokens, 12 new: the JAX engine's greedy tokens, no
    router statistics, and continuous == lockstep."""
    tcfg, jeng, teng = ssm
    prompts = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (3, 40)).astype(np.int32)
    ref, jst = jeng.generate(prompts, 12)
    out, tst = teng.generate(prompts, 12)
    np.testing.assert_array_equal(out, ref)
    assert tst.new_tokens == jst.new_tokens == 36
    assert np.isnan(tst.mean_aux("activated_experts"))
    lock, _ = teng.generate(prompts, 12, lockstep=True)
    np.testing.assert_array_equal(lock, out)


@pytest.mark.parametrize("admission", ["fcfs", "affinity"])
def test_ssm_scheduler_midstream_matches_jax(ssm, admission):
    """Two slots, four requests of different lengths, admitted into slots
    freed mid-stream (affinity falls back to FCFS: no router): the JAX
    scheduler's tokens, and each request's solo run."""
    tcfg, jeng, teng = ssm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=s).astype(np.int32)
               for s in (12, 12, 9, 15)]
    lens = [6, 14, 10, 8]
    runs = []
    for eng in (jeng, teng):
        sched = eng.make_scheduler(num_slots=2, admission=admission)
        for p, n in zip(prompts, lens):
            sched.submit(p, n)
        states = sched.run()
        assert all(s.status == "done" for s in states)
        runs.append([np.stack(s.tokens) for s in states])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(b, a)
    for p, n, toks in zip(prompts, lens, runs[1]):
        solo, _ = teng.generate(p[None], n)
        np.testing.assert_array_equal(toks, solo[0])


def test_fused_chunk_size_and_masked_slots(moe):
    """Tokens do not depend on the decode chunk, and a partly empty batch
    routes exactly like its occupied rows alone."""
    tcfg, tp, prompts = moe[1], moe[3], moe[4]
    outs = [Engine(tcfg, tp, cache_len=128, decode_chunk=c,
                   device="cpu").generate(prompts, 17)[0] for c in (1, 5)]
    np.testing.assert_array_equal(outs[0], outs[1])
    eng = Engine(tcfg, tp, cache_len=128, decode_chunk=4, device="cpu")
    acts = []
    for slots in (4, 3):
        sched = eng.make_scheduler(num_slots=slots, invariants=True)
        for b in range(prompts.shape[0]):
            sched.submit(prompts[b], 10)
        states = sched.run()
        for b, st in enumerate(states):
            np.testing.assert_array_equal(np.stack(st.tokens), outs[0][b, :10])
            assert len(st.layer_aux) == 9
            assert 0.0 <= st.ttft_s <= st.latency_s
        acts.append(np.array([a["activated_experts"]
                              for a in sched.step_aux]))
    np.testing.assert_array_equal(acts[0], acts[1])


def test_affinity_priors_and_robustness_knobs(moe):
    tcfg, tp, prompts = moe[1], moe[3], moe[4]
    eng = Engine(tcfg, tp, cache_len=128, decode_chunk=2, device="cpu")
    sched = eng.make_scheduler(num_slots=2, admission="affinity")
    for b in range(prompts.shape[0]):
        sched.submit(prompts[b], 6)
    assert sched.gate_priors().shape == (2, tcfg.moe.num_experts)
    states = sched.run()
    assert all(s.gate_hist is not None and s.gate_hist.shape ==
               (tcfg.moe.num_experts,) for s in states)
    # bounded queue, cancellation, shedding
    sched = eng.make_scheduler(num_slots=1, max_queue=2)
    sched.submit(prompts[0], 4)
    victim = sched.submit(prompts[1], 4)
    with pytest.raises(QueueFull):
        sched.submit(prompts[2], 4)
    assert sched.cancel(victim.req.rid)
    states = sched.run()
    assert [s.finish_reason for s in states] == ["completed", "cancelled"]
    assert sched.reason_counts() == {"completed": 1, "cancelled": 1}
    sched._active[0] = True                 # corrupt the slot table
    with pytest.raises(InvariantViolation):
        sched.check_invariants()


def test_sampling_is_seeded(moe):
    tcfg, tp, prompts = moe[1], moe[3], moe[4]
    g, _ = Engine(tcfg, tp, cache_len=128, device="cpu").generate(prompts, 16)
    s1, _ = Engine(tcfg, tp, cache_len=128, temperature=1.5, seed=7,
                   device="cpu").generate(prompts, 16)
    s2, _ = Engine(tcfg, tp, cache_len=128, temperature=1.5, seed=7,
                   device="cpu").generate(prompts, 16)
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(g, s1)


def test_unported_options_raise(moe):
    """Speculative decoding raises for an SSM target (a rejected draft
    would need its state rolled back); prefix embeddings are not ported
    yet."""
    tcfg, tp = moe[1], moe[3]
    scfg = small(ARCHS, "mamba2-370m")
    sp = bridge.init_params(scfg, device="cpu")
    with pytest.raises(NotImplementedError, match="rolling back cur_len"):
        Engine(scfg, sp, draft=(scfg, sp), spec_len=3, device="cpu")
    eng = Engine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.generate(moe[4], 4, prefix_embeds=np.zeros((3, 2, 128)))


def test_nan_quarantine_freezes_one_slot(moe):
    """A (slot, step) NaN fault poisons that slot only: it stops at the
    step, its cur_len freezes, and the other slots' tokens are exactly
    those of a fault-free run."""
    from repro_torch.models.model import prefill
    from repro_torch.serving.step import decode_steps_fused
    tcfg, tp, prompts = moe[1], moe[3], moe[4]
    runs = []
    for fault in ((-1, -1), (1, 2)):
        lg, cache, _ = prefill(tcfg, tp, torch.tensor(prompts),
                               cache_len=64, capacity_factor=8.0)
        tok = lg.argmax(-1).to(torch.int32)
        rem = torch.full((3,), 10, dtype=torch.int32)
        runs.append(decode_steps_fused(tcfg, tp, tok, cache, rem, None,
                                       num_steps=5, capacity_factor=8.0,
                                       fault=fault))
    (_, c0, t0, _, ok0, p0), (_, c1, t1, _, ok1, p1) = runs
    assert not p0.any() and p1.tolist() == [False, True, False]
    assert ok0.all() and ok1[:2, 1].all() and not ok1[2:, 1].any()
    assert c1["cur_len"].tolist() == [17, 14, 17]
    np.testing.assert_array_equal(t1[:, [0, 2]].numpy(),
                                  t0[:, [0, 2]].numpy())


def test_degradation_watchdog_and_deadlines(moe):
    """The host-side knobs: queue pressure and watchdog stalls climb the
    degradation ladder (tightened XShare policy, FCFS admission) while
    every request still completes; an expired TTFT deadline sheds a
    queued request; overload="shed" records a refusal instead of
    raising."""
    tcfg, tp, prompts = moe[1], moe[3], moe[4]
    eng = Engine(tcfg, tp, cache_len=128, decode_chunk=2, device="cpu")
    sched = eng.make_scheduler(num_slots=1, admission="affinity",
                               degrade=True, watchdog_s=1e-9,
                               invariants=True)
    for b in range(3):
        sched.submit(prompts[b], 5)
    states = sched.run()
    assert all(s.status == "done" and len(s.tokens) == 5 for s in states)
    assert sched.degrade_events and sched.stall_events > 0
    assert sched.level > 0 and sched.admission_effective == "fcfs"
    sched = eng.make_scheduler(num_slots=1, max_queue=1, overload="shed")
    sched.submit(prompts[0], 3)
    late = sched.submit(prompts[1], 3, ttft_deadline_s=-1.0)
    assert late.finish_reason == "shed_queue"
    sched = eng.make_scheduler(num_slots=1)
    sched.submit(prompts[0], 3)
    sched.submit(prompts[1], 3, ttft_deadline_s=0.0, arrival_s=0.0)
    states = sched.run()
    assert [s.finish_reason for s in states] == ["completed",
                                                 "deadline_ttft"]
