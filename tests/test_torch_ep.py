"""The port's expert-parallel execution against the JAX package's: the
placement planner's tables equal JAX's; EPExecutor's output within 2e-5
of the JAX shard_map executor's and every EPStats field equal, across
top_k 1, 2 and 8, skewed routing with masked tokens, a replicated hot
expert, Algorithm 6's restricted routing, max_rows None / "auto" / a
clamp, and T not a multiple of S. Inside the port, EP is bit-equal to
the sorted dispatch in every case (k = 8 included: both sum a token's
pairs in slot order). decode_step(dispatch="ep") against JAX under a
JAX ep_context, and Engine(dispatch="ep") tokens against "sorted",
before and after a placement update.

The JAX executor needs the 8 host devices tests/conftest.py forces."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import ep as JEP  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import XSharePolicy as JPolicy  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.ep import executor as JX  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.sharding import make_ep_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import ep as EP  # noqa: E402
from repro_torch.configs.base import EPConfig, MoEConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.ep import executor as TX  # noqa: E402
from repro_torch.models import dispatch as TD  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

TOL = 2e-5
D, E, F = 32, 16, 64


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(s) * 0.2).astype(np.float32)
            for s in ((E, D, F), (E, D, F), (E, F, D))]


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices (tests/conftest.py)")
    return {s: make_ep_mesh(s) for s in (4, 8)}


def routing(T, k, seed):
    """Distinct experts per token, gate weights in [0.1, 1.1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    w = (rng.random((T, k)) + 0.1).astype(np.float32)
    return x, idx.astype(np.int32), w


def skewed(T, k, seed):
    """Most pairs on expert 3, masked tokens (idx -1, w 0), a dead pair."""
    x, idx, w = routing(T, k, seed)
    idx[: T // 2] = 3
    idx[5:9], w[5:9] = -1, 0.0
    w[12, 1] = 0.0
    return x, idx, w


def hot_load():
    load = np.ones(E)
    load[0] = 100.0
    return load


def alg6(T, k, seed):
    """Routing by the JAX router under Algorithm 6 (k0 1, m_g 1, 8
    groups)."""
    x, _, _ = routing(T, k, seed)
    rng = np.random.default_rng(seed + 1)
    p = {"wg": jnp.asarray(rng.standard_normal((D, E)), jnp.float32)}
    idx, w, _, _ = JM.route(p, jnp.asarray(x), JMoE(E, k, F),
                            JPolicy(mode="ep", k0=1, m_g=1, num_groups=8))
    return x, np.asarray(idx, np.int32), np.asarray(w, np.float32)


def clamp_reference(idx, w, placement, M):
    """The clamp's semantics written out: shard s holds tokens
    [s·T/S, (s+1)·T/S) of the padded batch; each of its live pairs, in
    (token, slot) order, goes to hosts[e, gtok % nhosts[e]], and only the
    first M pairs per (source, destination) survive. Returns w with the
    dropped pairs' weights zeroed."""
    S = placement.num_shards
    T, k = idx.shape
    T_loc = -(-T // S)
    w = w.copy()
    seen = np.zeros((S, S), int)
    for t in range(T):
        for j in range(k):
            e = idx[t, j]
            if e < 0 or e >= E or w[t, j] == 0:
                continue
            dst = placement.hosts[e, t % placement.nhosts[e]]
            src = t // T_loc
            if seen[src, dst] >= M:
                w[t, j] = 0.0
            seen[src, dst] += 1
    return w


# (name, S, T, k, routing, placement, max_rows)
CASES = [
    ("k1", 8, 40, 1, "plain", "contig", None),
    ("k2", 8, 40, 2, "plain", "contig", None),
    ("k8", 8, 40, 8, "plain", "contig", None),
    ("skew_mask_T43", 8, 43, 2, "skewed", "contig", None),
    ("replicated_S4", 4, 40, 2, "hot", "replicated", None),
    ("alg6", 8, 40, 2, "alg6", "contig", None),
    ("auto", 8, 40, 2, "plain", "contig", "auto"),
    ("clamp", 8, 40, 2, "skewed", "contig", 3),
]


def make_case(case):
    name, S, T, k, kind, place, mr = case
    seed = {"k1": 1, "k2": 2, "k8": 8}.get(name, 7)
    if kind == "plain":
        x, idx, w = routing(T, k, seed)
    elif kind == "skewed":
        x, idx, w = skewed(T, k, seed)
    elif kind == "hot":
        x, idx, w = routing(T, k, seed)
        idx[:] = 0                          # every pair on expert 0
    else:
        x, idx, w = alg6(T, k, seed)
    return x, idx, w


def placements(S, place):
    if place == "contig":
        return EP.contiguous_placement(E, S), \
            JEP.contiguous_placement(E, S)
    kw = dict(replicate_hot=1, max_replicas=4)
    return EP.plan_placement(hot_load(), S, **kw), \
        JEP.plan_placement(hot_load(), S, **kw)


def torch_args(x, weights, idx, w):
    return [torch.tensor(a) for a in (x, *weights, idx, w)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_executor_matches_jax_and_sorted(mesh, weights, case):
    """y within 2e-5 of the JAX executor's, every EPStats field equal;
    port-EP bit-equal to port-sorted (the clamp: on routing whose
    dropped pairs are zeroed as the clamp's semantics say)."""
    name, S, T, k, kind, place, mr = case
    x, idx, w = make_case(case)
    tpl, jpl = placements(S, place)
    ex = EP.EPExecutor(S, tpl, device="cpu", max_rows=mr)
    y, st = ex(*torch_args(x, weights, idx, w))
    jex = JEP.EPExecutor(mesh[S], jpl, max_rows=mr)
    jy, jst = jex(*[jnp.asarray(a) for a in (x, *weights, idx, w)])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    for field in ("computed_rows", "tile_rows", "sent_rows", "a2a_bytes",
                  "count_matrix"):
        np.testing.assert_array_equal(getattr(st, field),
                                      np.asarray(getattr(jst, field)),
                                      err_msg=field)
    assert st.max_rows == jst.max_rows
    assert (st.peak_rows, st.peak_tile_rows, st.total_a2a_bytes) == \
        (jst.peak_rows, jst.peak_tile_rows, jst.total_a2a_bytes)
    live = int(((idx >= 0) & (w != 0)).sum())
    assert st.count_matrix.sum() == live
    ws = w if mr != 3 else clamp_reference(idx, w, tpl, st.max_rows)
    ref = TD.sorted_expert_ffn(*torch_args(x, weights, idx, ws))
    assert torch.equal(y, ref)
    if mr == "auto":
        assert st.max_rows < T // S * k
    if mr == 3:
        assert (ws == 0).sum() > (w == 0).sum()     # the clamp dropped


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("block_t", [None, 8, 32])
def test_ep_bit_equals_sorted(weights, S, k, block_t):
    """Without JAX: contiguous and replicated placements, at the
    executor's block_t and the sorted path's own."""
    x, idx, w = routing(37, k, seed=S * k)
    for pl in (EP.contiguous_placement(E, S),
               EP.plan_placement(hot_load(), S, replicate_hot=2,
                                 max_replicas=3)):
        ex = EP.EPExecutor(S, pl, device="cpu", block_t=block_t)
        args = torch_args(x, weights, idx, w)
        ref = TD.sorted_expert_ffn(*args)
        assert torch.equal(ex(*args)[0], ref)
        assert torch.equal(ex.ffn(*args), ref)


def test_route_pairs_match_jax_per_shard():
    S, T, k = 8, 40, 2
    _, idx, w = skewed(T, k, seed=3)
    pl = EP.plan_placement(hot_load(), S, replicate_hot=2)
    tabs = TX._device_tables(pl, "cpu")
    got = TX._route_pairs(torch.tensor(idx).reshape(S, T // S, k),
                          torch.tensor(w).reshape(S, T // S, k),
                          tabs["hosts"], tabs["nhosts"], E, S)
    for s in range(S):
        rows = slice(s * T // S, (s + 1) * T // S)
        want = JX._route_pairs(jnp.asarray(idx[rows]), jnp.asarray(w[rows]),
                               jnp.asarray(pl.hosts),
                               jnp.asarray(pl.nhosts), s * T // S, E, S)
        for g, j in zip((got[0], got[1], got[3], got[4]),
                        (want[0], want[1], want[3], want[4])):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(j))


# ------------------------------------------------- placement planner ------

def skewed_load(seed, n=E, alpha=1.2):
    rng = np.random.default_rng(seed)
    return np.sort(rng.pareto(alpha, n) + 0.1)[::-1].copy()


def same_tables(a, b):
    for f in ("hosts", "nhosts", "local_eids", "local_slot"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.version, a.expert_cap, a.replication_factor,
            a.weight_bytes_factor()) == \
        (b.version, b.expert_cap, b.replication_factor,
         b.weight_bytes_factor())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("S", [3, 4, 8])
def test_placements_equal_jax(seed, S):
    n = 16 + 5 * seed
    same_tables(EP.contiguous_placement(n, S),
                JEP.contiguous_placement(n, S))
    loads = [skewed_load(seed, n), np.ones(n),
             np.random.default_rng(seed).integers(0, 4, n).astype(float)]
    for load in loads:
        for kw in ({}, dict(replicate_hot=2), dict(replicate_hot=3,
                                                   max_replicas=2)):
            a = EP.plan_placement(load, S, version=seed, **kw)
            b = JEP.plan_placement(load, S, version=seed, **kw)
            same_tables(a, b)
            assert EP.placement_peak(a, load) == JEP.placement_peak(b, load)
            new, changed = EP.rebalance(EP.contiguous_placement(n, S), load,
                                        hysteresis=0.05, **kw)
            jnew, jchanged = JEP.rebalance(JEP.contiguous_placement(n, S),
                                           load, hysteresis=0.05, **kw)
            assert changed == jchanged
            same_tables(new, jnew)


def test_exchange_counts_matches_stats(weights):
    x, idx, w = skewed(43, 2, seed=9)
    pl = EP.plan_placement(hot_load(), 8, replicate_hot=1)
    ex = EP.EPExecutor(8, pl, device="cpu")
    cm = EP.exchange_counts(torch.tensor(idx), torch.tensor(w), pl)
    _, stats = ex(*torch_args(x, weights, idx, w))
    np.testing.assert_array_equal(cm, stats.count_matrix)


def test_rebalance_hysteresis():
    load = hot_load()
    prev = EP.contiguous_placement(E, 8)
    new, changed = EP.rebalance(prev, load, replicate_hot=1,
                                max_replicas=4, hysteresis=0.1)
    assert changed and new.version == prev.version + 1
    again, changed2 = EP.rebalance(new, load, replicate_hot=1,
                                   max_replicas=4, hysteresis=0.1)
    assert not changed2 and again is new


def test_executor_update_placement_uploads_tables(weights):
    """A True update replaces the device tables (in place when the table
    shape is unchanged); hysteresis skips the second."""
    ex = EP.EPExecutor(8, EP.contiguous_placement(E, 8), device="cpu",
                       replicate_hot=1, max_replicas=4)
    assert ex.update_placement(hot_load())
    assert ex.rebalances == 1 and ex.placement.nhosts[0] == 4
    np.testing.assert_array_equal(ex.tables["hosts"].numpy(),
                                  ex.placement.hosts)
    assert not ex.update_placement(hot_load())
    assert ex.rebalances_skipped == 1
    ptr = ex.tables["hosts"].data_ptr()
    load = hot_load()[::-1].copy()           # the same shape, expert 15 hot
    assert ex.update_placement(load)
    assert ex.tables["hosts"].data_ptr() == ptr
    np.testing.assert_array_equal(ex.tables["hosts"].numpy(),
                                  ex.placement.hosts)
    x, idx, w = routing(24, 2, seed=4)
    args = torch_args(x, weights, idx, w)
    assert torch.equal(ex.ffn(*args), TD.sorted_expert_ffn(*args))


def test_executor_from_config(weights):
    cfg = EPConfig(num_shards=8, replicate_hot=1, max_replicas=2,
                   rebalance_hysteresis=0.25, block_t=8)
    load = np.ones(E)
    load[3] = 50.0
    ex = EP.EPExecutor.from_config(cfg, E, device="cpu", load=load)
    assert ex.hysteresis == 0.25 and ex.block_t == 8
    assert ex.placement.nhosts[3] == 2
    jpl = JEP.plan_placement(load, 8, replicate_hot=1, max_replicas=2)
    same_tables(ex.placement, jpl)
    x, idx, w = routing(24, 2, seed=9)
    args = torch_args(x, weights, idx, w)
    assert torch.equal(ex(*args)[0], TD.sorted_expert_ffn(*args))
    ex2 = EP.EPExecutor.from_config(EPConfig(num_shards=8), E, device="cpu")
    same_tables(ex2.placement, JEP.contiguous_placement(E, 8))


def test_executor_refuses_mismatches(weights):
    with pytest.raises(ValueError, match="shards"):
        EP.EPExecutor(4, EP.contiguous_placement(E, 8), device="cpu")
    ex = EP.EPExecutor(8, EP.contiguous_placement(E, 8), device="cpu")
    x, idx, w = routing(8, 2, seed=1)
    args = torch_args(x, weights, idx, w)
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="meta"):
        ex.ffn(*args)


def test_expert_ffn_ep_bound_and_unbound(weights):
    x, idx, w = routing(40, 2, seed=5)
    p = dict(zip(("w1", "w3", "w2"), (torch.tensor(a) for a in weights)))
    moe = MoEConfig(E, 2, F)
    args = (p, torch.tensor(x), torch.tensor(idx), torch.tensor(w), moe)
    y_sorted = TM.expert_ffn(*args, dispatch="sorted")
    assert torch.equal(TM.expert_ffn(*args, dispatch="ep"), y_sorted)
    ex = EP.EPExecutor(8, EP.contiguous_placement(E, 8), device="cpu")
    with EP.ep_context(ex):
        assert EP.current_executor() is ex
        assert torch.equal(TM.expert_ffn(*args, dispatch="ep"), y_sorted)
    assert EP.current_executor() is None


# ------------------------------------------------------ model, engine ------

def small(archs):
    return archs["granite-moe-1b-a400m"].reduced(
        num_layers=2, max_d_model=128, max_vocab=256, max_experts=16)


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = small(JARCHS), small(ARCHS)
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def test_decode_step_ep_matches_jax(mesh, granite):
    """Prefill, then 2 decode steps with dispatch="ep" under each side's
    ep_context (8 shards, expert 0 replicated): logits within 2e-5."""
    jcfg, tcfg, jp, tp = granite
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    kw = dict(replicate_hot=1, max_replicas=2)
    ex = EP.EPExecutor(8, EP.plan_placement(hot_load(), 8, **kw),
                       device="cpu")
    jex = JEP.EPExecutor(mesh[8], JEP.plan_placement(hot_load(), 8, **kw))
    jl, jc, _ = JMD.prefill(jcfg, jp, jnp.asarray(prompts), cache_len=32,
                            capacity_factor=8.0)
    tl, tc, _ = TMD.prefill(tcfg, tp, torch.tensor(prompts), cache_len=32,
                            capacity_factor=8.0)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(2):
        with JEP.ep_context(jex):
            jl, jc, _ = JMD.decode_step(jcfg, jp, jnp.asarray(tok[:, None]),
                                        jc, capacity_factor=8.0,
                                        dispatch="ep")
        with EP.ep_context(ex):
            tl, tc, _ = TMD.decode_step(tcfg, tp, torch.tensor(tok[:, None]),
                                        tc, capacity_factor=8.0,
                                        dispatch="ep")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)


def test_engine_ep_equals_sorted(granite):
    """Engine(dispatch="ep") gives dispatch="sorted"'s tokens, continuous
    and lockstep, and again after update_placement: a placement of the
    same table shape is copied into the tables the loop already reads
    (no new running batch); one of another shape gets a running batch
    (and, on the card, graphs) in place of the old one's, so the pool
    holds as many bytes as before."""
    _, cfg, _, tp = granite
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    ref, _ = Engine(cfg, tp, cache_len=64, dispatch="sorted",
                    device="cpu").generate(prompts, 10)
    ex = EP.EPExecutor(4, EP.plan_placement(np.ones(E), 4, replicate_hot=1,
                                            max_replicas=2),
                       device="cpu", replicate_hot=1, max_replicas=2)
    eng = Engine(cfg, tp, cache_len=64, dispatch="ep", device="cpu")
    with EP.ep_context(ex):
        out, _ = eng.generate(prompts, 10)
        lock, _ = eng.generate(prompts, 10, lockstep=True)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(lock, ref)
        shape = (ex.placement.expert_cap, ex.placement.hosts.shape[1])
        load = np.ones(E)
        load[9] = 4.0                       # expert 9 replicated now
        assert ex.update_placement(load) and ex.placement.version == 1
        assert (ex.placement.expert_cap,
                ex.placement.hosts.shape[1]) == shape
        out2, _ = eng.generate(prompts, 10)
        np.testing.assert_array_equal(out2, ref)
        assert len(eng.loops.states()) == 1
        held = pool_bytes(eng.loops)
        ex.replicate_hot, ex.max_replicas = 2, 4
        assert ex.update_placement(load * np.arange(1, E + 1) ** 2)
        assert ex.placement.version == 2
        assert ex.placement.hosts.shape[1] != shape[1]
        out3, _ = eng.generate(prompts, 10)
        np.testing.assert_array_equal(out3, ref)
        assert len(eng.loops.states()) == 1
        assert pool_bytes(eng.loops) == held
    # unbound, "ep" is "sorted": its running batch replaces the bound one
    out4, _ = eng.generate(prompts, 10)
    np.testing.assert_array_equal(out4, ref)
    assert len(eng.loops.states()) == 1


def pool_bytes(pool) -> int:
    """Bytes of the tensors the pool's running batches hold."""
    def walk(t):
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(walk(v) for v in t)
        return 0
    return sum(walk(s.tensors) for s in pool.states())


def test_loop_pool_replaces_states_of_another_binding():
    """A state lent under one binding is kept while its scheduler holds
    it; once free, acquiring the same key under another binding drops
    it (its capture time stays in the pool's total); other keys are
    untouched."""
    from repro_torch.serving.graphs import LoopPool, LoopState

    class Holder:
        pass

    def make():
        return LoopState({"tok": torch.zeros(4)}, torch.Generator())
    pool = LoopPool()
    a, b, other = Holder(), Holder(), Holder()
    sa = pool.acquire("k", a, make, binding=("ex", 4, 1))
    so = pool.acquire("k2", other, make, binding=("ex", 4, 1))
    sb = pool.acquire("k", b, make, binding=("ex", 5, 2))
    assert len(pool.states()) == 3         # sa is still lent to a
    sa.loops[0] = SimpleNamespace(capture_s=1.5)
    pool.release(sa)
    pool.release(sb)
    assert pool.acquire("k", a, make, binding=("ex", 5, 2)) is sb
    assert pool.capture_s == 1.5
    assert pool.states() == [so, sb]
    pool.release(sb)
    sc = pool.acquire("k", b, make)
    assert sc is not sb and pool.states() == [so, sc]


def test_spec_engine_ep_equals_plain(granite):
    """Speculative decoding with the verify pass under dispatch="ep"
    (the target's own params as its draft): the SpecScheduler's tokens
    and the host-side reference's equal plain greedy decoding's."""
    _, cfg, _, tp = granite
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    ref, _ = Engine(cfg, tp, cache_len=64, device="cpu").generate(prompts,
                                                                  10)
    ex = EP.EPExecutor(4, EP.contiguous_placement(E, 4), device="cpu")
    eng = Engine(cfg, tp, cache_len=64, dispatch="ep", draft=(cfg, tp),
                 spec_len=3, device="cpu")
    with EP.ep_context(ex):
        out, st = eng.generate(prompts, 10)
        lock, _ = eng.generate(prompts, 10, lockstep=True)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(lock, ref)
    assert st.drafted > 0
