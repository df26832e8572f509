"""Speculative decoding in the port against the JAX package: greedy
acceptance, one draft-verify dispatch, the engine's continuous and
lockstep spec paths (self, perturbed, untrained and noisy drafts), a
rolling window cache, budgets, adaptive draft lengths, mixed spec and
plain traffic, Algorithm 4 with correlation priors, and the plain
cached-attention version the decode_attention kernel is held to.

Also the two faults speculative decoding has in the JAX package: an SSM
or hybrid target gives wrong tokens when a draft is rejected (the
recurrent state is not rolled back), and a draft with a smaller
vocabulary reads past its embedding. The port refuses both.

Weights come from JAX through the bridge; inputs from numpy seeds.
Tolerances: integer outputs exact, caches and f32 attention 2e-5."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import XSharePolicy as JPolicy  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import greedy_accept as j_accept  # noqa: E402
from repro.serving.step import spec_steps_fused as j_spec_steps  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs.base import XSharePolicy  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models.model import prefill  # noqa: E402
from repro_torch.serving import (Engine, SpecConfig,  # noqa: E402
                                 SpecScheduler, greedy_accept,
                                 rollback_cur_len, spec_steps_fused)

MOE = "granite-moe-1b-a400m"
SPEC_POLICY = dict(mode="spec", k0=1, m_l=2, m_r=1, corr=1.0)


def small(archs, name, **kw):
    return archs[name].reduced(num_layers=2, max_d_model=128, max_vocab=256,
                               **kw)


def to_torch(tree):
    return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def perturbed(jparams, seed, scale):
    """The parameters plus scale * N(0, 1) noise from a numpy seed, as
    a JAX tree (the same numbers go to both packages)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.asarray(a).dtype)), jparams)


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = small(JARCHS, MOE), small(ARCHS, MOE)
    jp = j_init(jcfg, jax.random.PRNGKey(1))
    # at this size a random model repeats the prompt's last token, so an
    # untrained draft agrees with the target; the perturbed draft is
    # accepted about 60 % of the time, the noisy one almost never
    drafts = {"self": jp, "perturbed": perturbed(jp, 9, 0.035),
              "untrained": j_init(jcfg, jax.random.PRNGKey(77)),
              "noisy": perturbed(jp, 9, 0.1)}
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, size=(3, 12)).astype(np.int32)
    plain, _ = Engine(tcfg, to_torch(jp), cache_len=128,
                      device="cpu").generate(prompts, 20)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=to_torch(jp),
                jdrafts=drafts,
                tdrafts={k: to_torch(v) for k, v in drafts.items()},
                prompts=prompts, plain=plain)


def spec_engine(moe, draft, **kw):
    return Engine(moe["tcfg"], moe["tp"], cache_len=128, device="cpu",
                  draft=(moe["tcfg"], moe["tdrafts"][draft]), **kw)


# ------------------------------------------------------ greedy_accept ---

def _accept_case(case):
    rng = np.random.default_rng(len(case))
    B, Ls, V = {"ragged": (4, 3, 16), "ties": (3, 3, 8),
                "ls1": (3, 1, 16), "b1": (1, 4, 16)}[case]
    lg = rng.standard_normal((B, Ls + 1, V)).astype(np.float32)
    if case == "ties":       # every position's max shared by two tokens
        lg[..., 2] = lg[..., 5] = lg.max(-1) + 1.0
    t_hat = lg.argmax(-1)
    drafts = t_hat[:, :Ls].copy()
    drafts[0, Ls // 2] = (drafts[0, Ls // 2] + 1) % V  # a mismatch
    limit = rng.integers(0, Ls + 1, size=B).astype(np.int32)
    limit[-1] = Ls
    return lg, drafts.astype(np.int32), limit


@pytest.mark.parametrize("case", ["ragged", "ties", "ls1", "b1"])
@pytest.mark.parametrize("with_limit", [False, True])
def test_greedy_accept_matches_jax(case, with_limit):
    lg, drafts, limit = _accept_case(case)
    ref = j_accept(jnp.asarray(lg), jnp.asarray(drafts),
                   limit=jnp.asarray(limit) if with_limit else None)
    out = greedy_accept(torch.tensor(lg), torch.tensor(drafts),
                        limit=torch.tensor(limit) if with_limit else None)
    for name in ("accepted", "new_tokens", "num_new"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    if case == "ties":       # ties go to the lower index, as jnp.argmax
        assert set(out.new_tokens.numpy().ravel()) <= {2}
    cur = torch.tensor([10, 20, 30, 40][:lg.shape[0]], dtype=torch.int32)
    np.testing.assert_array_equal(rollback_cur_len(cur, out).numpy(),
                                  cur.numpy() + out.num_new.numpy())


# ------------------------------------------------- one fused dispatch ---

@pytest.mark.parametrize("policy", ["off", "spec"])
def test_spec_steps_fused_matches_jax(moe, policy):
    """Three rounds of spec_len 3 over a batch of a speculative slot, a
    speculative slot with a budget of 2 and a shorter draft length, and a
    plain slot, with the perturbed draft: every integer output equal,
    both caches within 2e-5."""
    jcfg, tcfg = moe["jcfg"], moe["tcfg"]
    jd, td = moe["jdrafts"]["perturbed"], moe["tdrafts"]["perturbed"]
    prompts = moe["prompts"]
    E = jcfg.moe.num_experts
    priors = np.random.default_rng(5).random((3, E)).astype(np.float32)
    ops = dict(remaining=[10, 6, 4], budget=[2 ** 30, 2, 0],
               draft_len=[3, 2, 0], spec_on=[True, True, False])
    kw = dict(num_rounds=3, spec_len=3, capacity_factor=8.0)
    pol = dict(SPEC_POLICY) if policy == "spec" else {}

    lg, c, _ = j_prefill(jcfg, moe["jp"], jnp.asarray(prompts),
                         cache_len=64, capacity_factor=8.0)
    _, dc, _ = j_prefill(jcfg, jd, jnp.asarray(prompts), cache_len=64,
                         capacity_factor=8.0)
    ref = j_spec_steps(
        jcfg, moe["jp"], jcfg, jd, jnp.argmax(lg, -1).astype(jnp.int32),
        c, dc, jnp.asarray(ops["remaining"], jnp.int32),
        jnp.asarray(ops["budget"], jnp.int32),
        jnp.asarray(ops["draft_len"], jnp.int32),
        jnp.asarray(ops["spec_on"]), jnp.asarray(priors),
        policy=JPolicy(**pol), **kw)

    toks = torch.tensor(prompts)
    lg, c, _ = prefill(tcfg, moe["tp"], toks, cache_len=64,
                       capacity_factor=8.0)
    _, dc, _ = prefill(tcfg, td, toks, cache_len=64, capacity_factor=8.0)
    out = spec_steps_fused(
        tcfg, moe["tp"], tcfg, td, lg.argmax(-1).to(torch.int32), c, dc,
        torch.tensor(ops["remaining"], dtype=torch.int32),
        torch.tensor(ops["budget"], dtype=torch.int32),
        torch.tensor(ops["draft_len"], dtype=torch.int32),
        torch.tensor(ops["spec_on"]), torch.tensor(priors),
        policy=XSharePolicy(**pol), **kw)

    (tok, cache, dcache, rem, bud, new_tokens, num_new, accepted, drafted,
     aux, poisoned) = out
    for name, o, r in (("tok", tok, ref[0]), ("remaining", rem, ref[3]),
                       ("budget", bud, ref[4]),
                       ("new_tokens", new_tokens, ref[5]),
                       ("num_new", num_new, ref[6]),
                       ("accepted", accepted, ref[7]),
                       ("drafted", drafted, ref[8]),
                       ("poisoned", poisoned, ref[10])):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)
    assert int(accepted.sum()) > 0 and int(drafted.sum()) > \
        int(accepted.sum()), "the perturbed draft must be ragged"
    for mine, theirs in ((cache, ref[1]), (dcache, ref[2])):
        np.testing.assert_array_equal(mine["cur_len"].numpy(),
                                      np.asarray(theirs["cur_len"]))
        for key in ("kv_k", "kv_v"):
            np.testing.assert_allclose(mine[key].numpy(),
                                       np.asarray(theirs[key]), atol=2e-5,
                                       rtol=2e-5, err_msg=key)
    for key in ("activated_experts", "selected_set"):
        np.testing.assert_array_equal(aux[key].numpy(),
                                      np.asarray(ref[9][key]), err_msg=key)
    np.testing.assert_allclose(aux["req_gate_hist"].numpy(),
                               np.asarray(ref[9]["req_gate_hist"]),
                               atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------ engine ---

@pytest.mark.parametrize("draft", ["self", "perturbed", "untrained",
                                   "noisy"])
def test_engine_spec_equals_plain(moe, draft):
    """Continuous (SpecScheduler) and lockstep spec output equal plain
    greedy decoding token for token, whatever the draft (the noisy one
    takes the zero-accept path round after round)."""
    eng = spec_engine(moe, draft, spec_len=3)
    spec, st = eng.generate(moe["prompts"], 20)
    np.testing.assert_array_equal(spec, moe["plain"])
    lock, lst = eng.generate(moe["prompts"], 20, lockstep=True)
    np.testing.assert_array_equal(lock, moe["plain"])
    assert 0 < st.drafted and 0 <= st.accepted <= st.drafted
    if draft == "self":
        assert st.acceptance_rate == 1.0 and lst.mean_accepted == 3.0
    if draft in ("perturbed", "noisy"):
        assert st.acceptance_rate < 1.0


def test_engine_spec_matches_jax(moe):
    """The perturbed draft through both engines, continuous and
    lockstep: the same tokens and the same drafted and accepted counts
    (the same ragged acceptance round by round)."""
    jeng = JEngine(moe["jcfg"], moe["jp"], cache_len=128, spec_len=3,
                   draft=(moe["jcfg"], moe["jdrafts"]["perturbed"]))
    teng = spec_engine(moe, "perturbed", spec_len=3)
    for lockstep in (False, True):
        ref, rst = jeng.generate(moe["prompts"], 20, lockstep=lockstep)
        out, ost = teng.generate(moe["prompts"], 20, lockstep=lockstep)
        np.testing.assert_array_equal(out, np.asarray(ref))
        assert (ost.steps, ost.drafted, ost.accepted) == \
            (rst.steps, rst.drafted, rst.accepted)
        assert ost.accepted_hist == pytest.approx(rst.accepted_hist)


def test_spec_window_cache_matches_plain_and_jax():
    """h2o-danube's rolling-window cache (window 64 at this size, cache
    64 + 512): 10 prompt tokens and 60 new cross the window, and verify
    blocks of 5 straddle it."""
    jcfg, tcfg = small(JARCHS, "h2o-danube-1.8b"), \
        small(ARCHS, "h2o-danube-1.8b")
    assert tcfg.attn.sliding_window == 64
    jp = j_init(jcfg, jax.random.PRNGKey(3))
    tp = to_torch(jp)
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    plain, _ = Engine(tcfg, tp, cache_len=128, device="cpu").generate(
        prompts, 60)
    spec, _ = Engine(tcfg, tp, cache_len=128, draft=(tcfg, tp), spec_len=4,
                     device="cpu").generate(prompts, 60)
    np.testing.assert_array_equal(spec, plain)
    ref, _ = JEngine(jcfg, jp, cache_len=128, draft=(jcfg, jp),
                     spec_len=4).generate(prompts, 60)
    np.testing.assert_array_equal(spec, np.asarray(ref))


def test_spec_budget_exhaustion_degrades_to_plain(moe):
    eng = spec_engine(moe, "self", spec_len=3, spec_budget=4)
    spec, st = eng.generate(moe["prompts"], 16)
    np.testing.assert_array_equal(spec, moe["plain"][:, :16])
    assert st.spec_budget_exhausted == moe["prompts"].shape[0]
    assert 0 < st.accepted <= st.drafted


def test_adaptive_draft_length_stays_bounded(moe):
    """With a draft that is almost never accepted the per-slot draft
    length shrinks; the invariant check bounds it to [min_draft,
    spec_len] every round."""
    eng = spec_engine(moe, "noisy", spec_len=4)
    seen = []
    sched = eng.make_scheduler(
        num_slots=2, invariants=True,
        spec_cfg=SpecConfig(spec_len=4, min_draft=1, shrink_below=0.9,
                            grow_above=0.99),
        on_round=lambda s, r: seen.append(
            [sp.draft_len for sp in s._slot_spec if sp is not None]))
    sts = [sched.submit(moe["prompts"][b], 20) for b in range(2)]
    sched.run()
    for b, st in enumerate(sts):
        np.testing.assert_array_equal(np.asarray(st.tokens),
                                      moe["plain"][b])
    lens = [d for round_lens in seen for d in round_lens]
    assert min(lens) < 4 and all(1 <= d <= 4 for d in lens)


def test_mixed_spec_and_plain_with_midstream_eviction(moe):
    """Four requests with different horizons through two slots, one of
    them plain: slots turn over mid-run, draft and target cur_len stay
    in step (invariants every round), and every request's tokens equal
    plain greedy decoding and the JAX scheduler's."""
    horizons = [10, 17, 5, 12]
    plain, _ = Engine(moe["tcfg"], moe["tp"], cache_len=128,
                      device="cpu").generate(moe["prompts"][[0, 1, 2, 0]],
                                             17)
    runs = []
    for eng in (spec_engine(moe, "perturbed", spec_len=3),
                JEngine(moe["jcfg"], moe["jp"], cache_len=128, spec_len=3,
                        draft=(moe["jcfg"], moe["jdrafts"]["perturbed"]))):
        sched = eng.make_scheduler(num_slots=2, invariants=True)
        sts = [sched.submit(moe["prompts"][b % 3], horizons[b],
                            spec=(b != 2)) for b in range(4)]
        sched.run()
        runs.append(sts)
    for b in range(4):
        mine, theirs = runs[0][b], runs[1][b]
        assert mine.finish_reason == "completed"
        np.testing.assert_array_equal(np.asarray(mine.tokens),
                                      plain[b, :horizons[b]])
        np.testing.assert_array_equal(np.asarray(mine.tokens),
                                      np.asarray(theirs.tokens))
        assert (mine.drafted, mine.accepted_drafts) == \
            (theirs.drafted, theirs.accepted_drafts)
    assert runs[0][2].drafted == 0 and sum(s.drafted for s in runs[0]) > 0


def test_algorithm4_priors_match_jax(moe):
    """XShare's Algorithm 4 on the verify pass, with the correlation
    priors the scheduler folds from each round's per-request gate
    histograms: per round and layer, the activated experts and the
    selected set equal the JAX package's, and so do the tokens. 16
    experts (top-8), so the selection leaves some out."""
    jcfg = small(JARCHS, MOE, max_experts=16)
    tcfg = small(ARCHS, MOE, max_experts=16)
    jp = j_init(jcfg, jax.random.PRNGKey(1))
    jd = perturbed(jp, 9, 0.035)
    pol = dict(SPEC_POLICY)
    jeng = JEngine(jcfg, jp, cache_len=128, spec_len=3,
                   policy=JPolicy(**pol), draft=(jcfg, jd))
    teng = Engine(tcfg, to_torch(jp), cache_len=128, spec_len=3,
                  policy=XSharePolicy(**pol), draft=(tcfg, to_torch(jd)),
                  device="cpu")
    scheds = []
    for eng in (teng, jeng):
        sched = eng.make_scheduler(num_slots=3)
        for b in range(3):
            sched.submit(moe["prompts"][b], 16)
        sched.run()
        scheds.append(sched)
    mine, theirs = scheds
    assert len(mine.step_aux) == len(theirs.step_aux) > 0
    for a, b in zip(mine.step_aux, theirs.step_aux):
        for key in ("activated_experts", "selected_set"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
    assert max(int(a["selected_set"].max()) for a in mine.step_aux) < 16
    for a, b in zip(mine._states, theirs._states):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))
    np.testing.assert_allclose(mine.gate_priors(), theirs.gate_priors(),
                               atol=1e-5)


# --------------------------------------------- cached attention (plain) ---

@pytest.mark.parametrize("T", [1, 2, 5])
@pytest.mark.parametrize("window,wrap", [(None, False), (16, False),
                                         (16, True)])
def test_cached_attention_plain_matches_jax(T, window, wrap):
    """The decode_attention kernel's plain version under the
    cached_attention contract: a full cache, and a rolling window of 16
    in a cache of 24 (window + 8: verify writes never reach an in-window
    slot) with cur_len before and past C, so the cache wraps."""
    rng = np.random.default_rng(T * 7 + (window or 0) + wrap)
    B, H, Hkv, dh = 3, 4, 2, 32
    C = 40 if window is None else window + 8
    q = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    ck = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    cv = rng.standard_normal((B, C, Hkv, dh)).astype(np.float32)
    cur = np.array([0, 11, C - T], np.int32)
    if wrap:
        cur = np.array([C - 2, 2 * C + 5, 3 * C - 1], np.int32)
    ref = JA.cached_attention(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), jnp.asarray(cur),
                              window=window)
    out = K.decode_attention_cached(torch.tensor(q), torch.tensor(ck),
                                    torch.tensor(cv), torch.tensor(cur),
                                    window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------------------- faults ---

@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-1.2b"])
def test_jax_spec_is_wrong_for_recurrent_targets(name):
    """The JAX package's speculative decoding steps an SSM's state and
    conv tails over the whole verify block and rolls back only cur_len:
    with a draft that is sometimes rejected, its tokens leave plain
    greedy decoding. (With an exact draft nothing is rolled back and the
    tokens agree.)"""
    cfg = small(JARCHS, name)
    jp = j_init(cfg, jax.random.PRNGKey(1))
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    plain, _ = JEngine(cfg, jp, cache_len=64).generate(prompts, 16,
                                                       lockstep=True)
    spec, st = JEngine(cfg, jp, cache_len=64, spec_len=3,
                       draft=(cfg, perturbed(jp, 7, 0.05))).generate(
        prompts, 16, lockstep=True)
    assert st.accepted < st.drafted
    assert (np.asarray(spec) != np.asarray(plain)).mean() > 0.25


@pytest.mark.parametrize("target,draft", [
    ("mamba2-370m", "mamba2-370m"), ("zamba2-1.2b", "zamba2-1.2b"),
    (MOE, "mamba2-370m"), ("mamba2-370m", MOE)])
def test_port_refuses_spec_with_recurrent_models(target, draft):
    tcfg, dcfg = small(ARCHS, target), small(ARCHS, draft)
    tp = bridge.init_params(tcfg, device="cpu")
    dp = bridge.init_params(dcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="rolling back cur_len"):
        Engine(tcfg, tp, draft=(dcfg, dp), spec_len=3, device="cpu")
    with pytest.raises(NotImplementedError, match="rolling back cur_len"):
        SpecScheduler(tcfg, tp, draft=(dcfg, dp),
                      spec_cfg=SpecConfig(spec_len=3), num_slots=2,
                      device="cpu")


def test_port_refuses_a_draft_with_another_vocabulary(moe):
    """The serve CLI's draft, cfg.reduced(num_layers=2, max_d_model=128),
    keeps a vocabulary of 1024 under a target of 49155: target tokens
    would index past its embedding (JAX clamps the gather and runs on;
    torch raises or asserts on the card). A draft with the target's
    vocabulary is taken."""
    tcfg = moe["tcfg"]
    dcfg = dataclasses.replace(tcfg, vocab_size=128)
    dp = bridge.init_params(dcfg, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        Engine(tcfg, moe["tp"], draft=(dcfg, dp), spec_len=3, device="cpu")
    full = ARCHS[MOE]
    cli = full.reduced(num_layers=2, max_d_model=128)
    assert cli.vocab_size != full.vocab_size
    ok = full.reduced(num_layers=2, max_d_model=128,
                      max_vocab=full.vocab_size)
    assert ok.vocab_size == full.vocab_size
