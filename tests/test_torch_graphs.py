"""The port's serving loops in the form the card captures as CUDA graphs
(serving/graphs.py), checked on the CPU, where they run as they are:
the NaN-fault operand as a device tensor against the JAX package's
traced one; the running batch written in place through the schedulers'
whole life (admission, inserts, evictions, a quarantine scrub, a
degradation level change) with tokens equal to the JAX package's; the
engine lending one running batch to each scheduler in turn; and the
launch counters a replay adds. The graphs themselves are in
tests/test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving.step import decode_steps_fused as j_decode  # noqa: E402
from repro.serving.step import spec_steps_fused as j_spec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models.model import prefill  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import graphs as G  # noqa: E402
from repro_torch.serving.step import (decode_steps_fused,  # noqa: E402
                                      spec_steps_fused)

MOE = "granite-moe-1b-a400m"
B, STEPS, ROUNDS, SPEC_LEN = 3, 4, 3, 2
# disabled, the first (slot, step or round), the last
FAULTS = [(-1, -1), (0, 0), (B - 1, STEPS - 1)]
LENGTHS = (3, 5, 8)   # new tokens of the scheduler tests' requests
# nine requests in three slots start at level 1 and come down to 0
DEGRADE = dict(degrade=True, degrade_hi=2.5)


def small(archs):
    return archs[MOE].reduced(num_layers=2, max_d_model=128, max_vocab=256)


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = small(JARCHS), small(ARCHS)
    jp = j_init(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, size=(B, 12)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompts


@pytest.fixture(scope="module")
def prefilled(moe):
    jcfg, tcfg, jp, tp, prompts = moe
    jlg, jc, _ = j_prefill(jcfg, jp, jnp.asarray(prompts), cache_len=64,
                           capacity_factor=8.0)
    tlg, tc, _ = prefill(tcfg, tp, torch.tensor(prompts), cache_len=64,
                         capacity_factor=8.0)
    tok = tlg.argmax(-1).to(torch.int32)

    def fresh():
        """The JAX tok and cache, and copies of the port's (its loops
        write them in place)."""
        return (jnp.argmax(jlg, -1).astype(jnp.int32), jc, tok.clone(),
                {k: v.clone() for k, v in tc.items()})
    return fresh


@pytest.fixture(scope="module")
def j_decode_jit(moe):
    jcfg = moe[0]
    return jax.jit(lambda p, tok, c, rem, f: j_decode(
        jcfg, p, tok, c, rem, jax.random.PRNGKey(0), num_steps=STEPS,
        capacity_factor=8.0, fault=f))


@pytest.mark.parametrize("fault", FAULTS)
def test_decode_fault_operand_matches_jax(moe, prefilled, j_decode_jit,
                                          fault):
    """decode_steps_fused with the fault as a (2,) int32 tensor gives the
    JAX package's tokens, ok, poisoned and cur_len for its traced
    operand, and writes tok and cur_len in place."""
    jtok, jc, ttok, tc = prefilled()
    rem = np.array([10, 2, 10], np.int32)   # slot 1 ends mid-chunk
    ref = j_decode_jit(moe[2], jtok, jc, jnp.asarray(rem),
                       jnp.asarray(fault, jnp.int32))
    cur = tc["cur_len"]
    out = decode_steps_fused(moe[1], moe[3], ttok, tc, torch.tensor(rem),
                             None, num_steps=STEPS, capacity_factor=8.0,
                             fault=torch.tensor(fault, dtype=torch.int32))
    assert out[0] is ttok and out[1] is tc and tc["cur_len"] is cur
    for name, o, r in (("toks", out[2], ref[2]), ("ok", out[4], ref[4]),
                       ("poisoned", out[5], ref[5]),
                       ("tok", ttok, ref[0]),
                       ("cur_len", cur, ref[1]["cur_len"])):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                      err_msg=name)
    assert bool(out[5].any()) == (fault[0] >= 0)


@pytest.fixture(scope="module")
def j_spec_jit(moe):
    jcfg = moe[0]
    return jax.jit(lambda p, tok, c, dc, rem, bud, dl, so, pri, f: j_spec(
        jcfg, p, jcfg, p, tok, c, dc, rem, bud, dl, so, pri,
        num_rounds=ROUNDS, spec_len=SPEC_LEN, capacity_factor=8.0, fault=f))


@pytest.mark.parametrize("fault", [(-1, -1), (0, 0), (B - 1, ROUNDS - 1)])
def test_spec_fault_operand_matches_jax(moe, prefilled, j_spec_jit, fault):
    """spec_steps_fused (self-draft, a plain slot beside two speculative
    ones) with the fault as a tensor: every integer output and both
    caches' cur_len equal the JAX package's, tok and cur_len written in
    place."""
    jtok, jc, ttok, tc = prefilled()
    _, jdc, _, tdc = prefilled()
    E = moe[0].moe.num_experts
    ops = [np.array([9, 9, 9], np.int32), np.array([2 ** 30] * 3, np.int32),
           np.array([2, 1, 0], np.int32), np.array([True, True, False]),
           np.zeros((B, E), np.float32)]
    ref = j_spec_jit(moe[2], jtok, jc, jdc, *map(jnp.asarray, ops),
                     jnp.asarray(fault, jnp.int32))
    curs = tc["cur_len"], tdc["cur_len"]
    out = spec_steps_fused(moe[1], moe[3], moe[1], moe[3], ttok, tc, tdc,
                           *map(torch.tensor, ops), num_rounds=ROUNDS,
                           spec_len=SPEC_LEN, capacity_factor=8.0,
                           fault=torch.tensor(fault, dtype=torch.int32))
    assert out[0] is ttok and (tc["cur_len"], tdc["cur_len"]) == curs
    for i, name in ((0, "tok"), (3, "remaining"), (4, "budget"),
                    (5, "new_tokens"), (6, "num_new"), (7, "accepted"),
                    (8, "drafted"), (10, "poisoned")):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]),
                                      err_msg=name)
    for mine, theirs in zip(curs, (ref[1], ref[2])):
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(theirs["cur_len"]))
    assert bool(out[10].any()) == (fault[0] >= 0)


# ------------------------------------------- the schedulers' batch state --

def _pointers(sched):
    ptrs = {"tok": sched._tok.data_ptr()}
    caches = {"cache": sched._cache}
    if hasattr(sched, "_dcache"):
        caches["dcache"] = sched._dcache
    for name, c in caches.items():
        ptrs.update({f"{name}/{k}": v.data_ptr() for k, v in c.items()})
    return ptrs


def _serve(eng, prompts, faults):
    """Three slots, nine requests (so queue pressure climbs the
    degradation ladder and comes down again), the pointers recorded
    after every round."""
    sched = eng.make_scheduler(num_slots=B, invariants=True, faults=faults,
                               **DEGRADE)
    seen, levels = [_pointers(sched)], []

    def on_round(s, _):
        seen.append(_pointers(s))
        levels.append(s.level)
    sched.on_round = on_round
    states = [sched.submit(prompts[i % B], LENGTHS[i % 3])
              for i in range(9)]
    sched.run()
    return sched, states, seen, levels


def _campaign(mod, nan_step):
    # a NaN on slot 1 at a step (plain) or round (speculative) of the
    # second dispatch, and two failed inserts of rid 4, inside the retry
    # budget
    return mod.FaultInjector([mod.Fault("nan_logits", slot=1, step=nan_step),
                              mod.Fault("insert_fail", rid=4, times=2)])


@pytest.mark.parametrize("spec", [False, True])
def test_scheduler_state_stays_in_place(moe, spec):
    """Scheduler and SpecScheduler: ``tok`` and every cache tensor keep
    their addresses through whole-batch admission, inserts, evictions,
    a quarantine scrub and degradation level changes, and every
    request's tokens and finish reason equal the JAX package's."""
    jcfg, tcfg, jp, tp, prompts = moe
    kw = dict(cache_len=64, decode_chunk=2)
    if spec:
        kw = dict(cache_len=64, spec_len=SPEC_LEN, spec_rounds=2)
    teng = Engine(tcfg, tp, device="cpu",
                  draft=(tcfg, tp) if spec else None, **kw)
    jeng = JEngine(jcfg, jp, draft=(jcfg, jp) if spec else None, **kw)
    nan_step = 3 if spec else 5
    sched, states, seen, levels = _serve(teng, prompts,
                                         _campaign(tfaults, nan_step))
    jsched = jeng.make_scheduler(num_slots=B,
                                 faults=_campaign(jfaults, nan_step),
                                 **DEGRADE)
    jstates = [jsched.submit(prompts[i % B], LENGTHS[i % 3])
               for i in range(9)]
    jsched.run()
    assert all(p == seen[0] for p in seen), "the batch state moved"
    assert len(set(levels)) > 1, "no degradation level change"
    reasons = [s.finish_reason for s in states]
    assert reasons == [s.finish_reason for s in jstates]
    assert reasons.count("numerics_nonfinite") == 1
    assert sched.retries == 2
    for s, js in zip(states, jstates):
        np.testing.assert_array_equal(np.asarray(s.tokens),
                                      np.asarray(js.tokens))


def test_engine_lends_one_state_in_turn(moe):
    """Engine.generate hands its running batch back: a second call, and
    a scheduler made after it, borrow the same tensors; a scheduler made
    while another is live gets its own, and a released or dropped one's
    is lent again, zeroed."""
    _, tcfg, _, tp, prompts = moe
    eng = Engine(tcfg, tp, cache_len=64, device="cpu")
    a, sa = eng.generate(prompts, 5)
    b, _ = eng.generate(prompts, 5)
    np.testing.assert_array_equal(a, b)
    assert sa.capture_s == 0.0 and len(eng.loops.states()) == 1
    first = eng.make_scheduler(num_slots=B)
    second = eng.make_scheduler(num_slots=B)
    assert len(eng.loops.states()) == 2
    assert first._cache["kv_k"].data_ptr() != \
        second._cache["kv_k"].data_ptr()
    first._cache["kv_k"].fill_(1.0)
    ptr = first._cache["kv_k"].data_ptr()
    first.release()
    assert first._cache is None and first._tok is None
    del second
    third = eng.make_scheduler(num_slots=B)
    fourth = eng.make_scheduler(num_slots=B)
    assert len(eng.loops.states()) == 2
    assert ptr in (third._cache["kv_k"].data_ptr(),
                   fourth._cache["kv_k"].data_ptr())
    assert not third._cache["kv_k"].any() and not fourth._cache["kv_k"].any()


# ------------------------------------------------------ launch counts ---

def test_launch_counts_same_with_capture_bookkeeping():
    """A loop whose kernels count launches, run four times as it is,
    counts what one warm-up, one capture (each taken back) and four
    replays of the recorded move count; on the CPU a GraphLoop runs the
    loop itself, counting as it goes."""
    def run(t, gen, i):
        K.moe_ffn.launches += 3
        K.decode_attention.launches += 2
        K.grouped_ffn.launches += int(i["n"])
        return t["tok"] + i["n"]

    state = G.LoopState({"tok": torch.zeros(2, dtype=torch.int32)},
                        torch.Generator())
    inputs = {"n": torch.zeros((), dtype=torch.int32)}
    K.reset_launch_counts()
    for _ in range(4):
        run(state.tensors, state.gen, {"n": torch.tensor(1)})
    eager = K.launch_counts()
    K.reset_launch_counts()
    with G.launches_taken_back():
        run(state.tensors, state.gen, {"n": torch.tensor(1)})   # warm-up
    with G.launches_taken_back() as moved:
        run(state.tensors, state.gen, {"n": torch.tensor(1)})   # capture
    assert all(v == 0 for v in K.launch_counts().values())
    for _ in range(4):
        G.add_launches(moved)
    assert K.launch_counts() == eager
    K.reset_launch_counts()
    loop = state.loop(0, lambda: (run, inputs))
    assert loop.graph is None and state.loop(0, None) is loop
    for _ in range(4):
        out = loop(n=1)
    assert K.launch_counts() == eager and out.tolist() == [1, 1]
    K.reset_launch_counts()
