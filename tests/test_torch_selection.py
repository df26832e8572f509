"""The port's XShare selection (Algorithms 1-6), routing and metrics
against the JAX package on the same gates: masks, indices and counts
exactly equal, weights within 2e-5. Includes tied scores (ties go to
the lower expert index in both), -inf pools, all-zero (masked) rows and
an expert count that the group count does not divide."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import metrics as jm  # noqa: E402
from repro.core import routing as jr  # noqa: E402
from repro.core import selection as js  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import XSharePolicy as JPolicy  # noqa: E402
from repro.models.moe import route as j_route  # noqa: E402
from repro_torch.configs.base import MoEConfig, XSharePolicy  # noqa: E402
from repro_torch.core import metrics as tm  # noqa: E402
from repro_torch.core import routing as tr  # noqa: E402
from repro_torch.core import selection as ts  # noqa: E402
from repro_torch.models.moe import policy_max_active, route  # noqa: E402


def gates(seed, shape, *, ties=False, zero_rows=()):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32)
    if ties:     # quantize so many scores are exactly equal
        logits = np.round(logits * 2) / 2
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = (g / g.sum(-1, keepdims=True)).astype(np.float32)
    for r in zero_rows:
        g[..., r, :] = 0.0
    return g


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


CASES = [(0, 6, 8, False, ()), (1, 4, 12, True, ()), (2, 8, 16, True, (1, 3)),
         (3, 3, 10, False, (0,)), (4, 5, 32, True, ())]


@pytest.mark.parametrize("seed,T,E,ties,zero_rows", CASES)
def test_batch_and_greedy_select_equal_jax(seed, T, E, ties, zero_rows):
    g = gates(seed, (T, E), ties=ties, zero_rows=zero_rows)
    tg, jg = torch.tensor(g), jnp.asarray(g)
    for k0 in (0, 1, 2):
        eq(ts.warmup_union(tg, k0), js.warmup_union(jg, k0))
        for m in (0, 1, 3, E + 2):
            eq(ts.batch_select(tg, m, k0), js.batch_select(jg, m, k0))
    for m in (0, 2, 5):
        eq(ts.greedy_select(tg, m), js.greedy_select(jg, m))
        eq(ts.topk_mask(tg, m), js.topk_mask(jg, m))


@pytest.mark.parametrize("seed,T,E,ties,zero_rows", CASES)
def test_ep_select_equal_jax_including_ragged_groups(seed, T, E, ties,
                                                     zero_rows):
    g = gates(seed, (T, E), ties=ties, zero_rows=zero_rows)
    tg, jg = torch.tensor(g), jnp.asarray(g)
    for G in (2, 3):                         # 3 leaves ragged groups
        for m_g in (0, 2):
            for strict in (True, False):
                got = ts.ep_select(tg, m_g, G, 1, strict_cap=strict)
                eq(got, js.ep_select(jg, m_g, G, 1, strict_cap=strict))
                assert int(tm.max_group_load(got, G)) == \
                    int(jm.max_group_load(jnp.asarray(got.numpy()), G))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_select_equal_jax_with_and_without_priors(seed):
    b, t, E = 3, 4, 10
    g = gates(seed, (b, t, E), ties=seed == 1)
    g[1] = 0.0                                  # an inactive request
    pri = np.abs(np.random.default_rng(seed).standard_normal(
        (b, E))).astype(np.float32)
    tg, jg = torch.tensor(g), jnp.asarray(g)
    for m_r in (0, 1, 3):
        eq(ts.per_request_select(tg, m_r, 1),
           js.per_request_select(jg, m_r, 1))
        for m in (0, 2):
            eq(ts.spec_select(tg, m, m_r, 1), js.spec_select(jg, m, m_r, 1))
            eq(ts.spec_select(tg, m, m_r, 1, priors=torch.tensor(pri)),
               js.spec_select(jg, m, m_r, 1, priors=jnp.asarray(pri)))


@pytest.mark.parametrize("seed,T,E,ties,zero_rows", CASES)
def test_restricted_topk_equal_jax(seed, T, E, ties, zero_rows):
    """Indices exact, weights within 2e-5; a selected set smaller than k
    leaves -inf in the pool (weight 0), and an empty set gives all-zero
    weights, not NaN."""
    g = gates(seed, (T, E), ties=ties, zero_rows=zero_rows)
    logits = np.log(np.clip(g, 1e-30, None)).astype(np.float32)
    tg, jg = torch.tensor(g), jnp.asarray(g)
    rng = np.random.default_rng(seed)
    for n_sel in (0, 1, 3, E):
        mask = np.zeros(E, bool)
        mask[rng.permutation(E)[:n_sel]] = True
        for k in (1, 4):
            for lg in (None, logits):
                ti, tw = ts.restricted_topk(
                    tg, torch.tensor(mask), k,
                    logits=None if lg is None else torch.tensor(lg))
                ji, jw = js.restricted_topk(
                    jg, jnp.asarray(mask), k,
                    logits=None if lg is None else jnp.asarray(lg))
                eq(ti, ji)
                assert np.isfinite(tw.numpy()).all()
                np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                           atol=2e-5, rtol=2e-5)


def test_topk_route_breaks_ties_toward_lower_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]], np.float32)
    ti, tw = tr.topk_route(torch.tensor(logits), 3)
    ji, jw = jr.topk_route(jnp.asarray(logits), 3)
    eq(ti, ji)
    assert ti.tolist() == [[1, 2, 4]]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-5)


def test_affinity_and_metrics_equal_jax():
    rng = np.random.default_rng(5)
    hists = np.abs(rng.standard_normal((4, 8))).astype(np.float32)
    mass = np.abs(rng.standard_normal(8)).astype(np.float32)
    np.testing.assert_allclose(
        ts.rank_by_affinity(torch.tensor(hists), torch.tensor(mass)).numpy(),
        np.asarray(js.rank_by_affinity(jnp.asarray(hists),
                                       jnp.asarray(mass))), atol=2e-5)
    assert float(ts.rank_by_affinity(torch.tensor(hists),
                                     torch.zeros(8)).max()) == 0.0
    g = gates(6, (5, 8))
    np.testing.assert_allclose(
        ts.gate_histogram(torch.tensor(g)).numpy(),
        np.asarray(js.gate_histogram(jnp.asarray(g))), atol=2e-6)
    sel = np.arange(8) < 3
    np.testing.assert_allclose(
        float(tm.gate_mass_captured(torch.tensor(g), torch.tensor(sel))),
        float(jm.gate_mass_captured(jnp.asarray(g), jnp.asarray(sel))),
        atol=2e-6)
    a = torch.tensor([[0, 1, 2]])
    b = torch.tensor([[1, 2, 3]])
    assert int(tm.topk_overlap(a, b, 8)[0]) == 2
    assert tm.expected_activated(64, 4, 16) == jm.expected_activated(
        64, 4, 16)


POLICIES = [("off", {}), ("batch", dict(k0=1, m_l=0)),
            ("batch", dict(k0=1, m_l=3)), ("batch", dict(k0=2, m_l=5)),
            ("ep", dict(k0=1, m_g=1, num_groups=4)),
            ("ep", dict(k0=1, m_g=2, num_groups=3, strict_cap=False)),
            ("spec", dict(k0=1, m_l=2, m_r=1))]


@pytest.mark.parametrize("mode,kw", POLICIES)
@pytest.mark.parametrize("masked", [False, True])
def test_route_equals_jax_and_respects_max_active(mode, kw, masked):
    """route(): idx exact, weights / combine within 2e-5, integer aux
    exact; and under every policy the experts activated never exceed
    policy_max_active — the bound the dense kernel's slot count rests
    on (a larger set would silently drop experts)."""
    T, d, E, k = 8, 16, 12, 4
    spec_shape = (2, 4) if mode == "spec" else None
    moe_t = MoEConfig(num_experts=E, top_k=k, d_ff_expert=8)
    moe_j = JMoE(num_experts=E, top_k=k, d_ff_expert=8)
    pol_t, pol_j = XSharePolicy(mode=mode, **kw), JPolicy(mode=mode, **kw)
    bound = policy_max_active(pol_t, T, E, spec_shape=spec_shape)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((T, d)).astype(np.float32)
        wg = (rng.standard_normal((d, E)) * 0.5).astype(np.float32)
        tmask = rng.random(T) > 0.3 if masked else None
        ti, tw, tc, ta = route(
            {"wg": torch.tensor(wg)}, torch.tensor(x), moe_t, pol_t,
            spec_shape=spec_shape,
            token_mask=None if tmask is None else torch.tensor(tmask))
        ji, jw, jc, ja = j_route(
            {"wg": jnp.asarray(wg)}, jnp.asarray(x), moe_j, pol_j,
            spec_shape=spec_shape,
            token_mask=None if tmask is None else jnp.asarray(tmask))
        eq(ti, ji)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
        for key in ("activated_experts", "selected_set", "max_group_load",
                    "max_group_tokens"):
            assert int(ta[key]) == int(ja[key]), key
        for key in ("gate_mass", "lb_loss"):
            np.testing.assert_allclose(float(ta[key]), float(ja[key]),
                                       atol=2e-5, rtol=2e-5)
        assert int((tc != 0).any(0).sum()) <= bound


# ------------------------- the JAX package's own properties, in the port ---

@pytest.mark.parametrize("seed", range(6))
def test_port_greedy_is_the_modular_optimum(seed):
    """Cor 3.3: top-m by aggregated score == the exhaustive best |S| <= m."""
    import itertools
    rng = np.random.default_rng(seed)
    T, E, m = int(rng.integers(1, 6)), int(rng.integers(2, 8)), \
        int(rng.integers(0, 8))
    g = gates(seed, (T, E))
    sel = ts.greedy_select(torch.tensor(g), m).numpy()
    agg = g.sum(0)
    best = max((agg[list(c)].sum() for c in
                itertools.combinations(range(E), min(m, E))), default=0.0)
    assert agg[sel].sum() >= best - 1e-6
    assert sel.sum() == min(m, E)


@pytest.mark.parametrize("seed", range(6))
def test_port_selection_invariants(seed):
    rng = np.random.default_rng(seed)
    T, E = 6, 12
    g = torch.tensor(gates(seed, (T, E)))
    m, k0 = int(rng.integers(0, 6)), int(rng.integers(0, 3))
    s0, sel = ts.warmup_union(g, k0), ts.batch_select(g, m, k0)
    assert bool((sel | ~s0).all()) and int(sel.sum()) <= int(s0.sum()) + m
    perm = torch.tensor(rng.permutation(T))
    assert torch.equal(ts.batch_select(g[perm], m, 1),
                       ts.batch_select(g, m, 1))
    G, m_g = 4, int(rng.integers(1, 4))
    assert int(tm.max_group_load(ts.ep_select(g, m_g, G, k0), G)) <= m_g
    idx, w = ts.restricted_topk(g, sel, 3)
    for t in range(T):
        for s in range(3):
            if float(w[t, s]) > 0:
                assert bool(sel[idx[t, s]])
    sums = w.sum(-1).numpy()
    assert np.all((np.abs(sums - 1.0) < 1e-5) | (sums == 0.0))
    gs = torch.tensor(gates(seed, (2, 3, E)))
    s_r = ts.per_request_select(gs, 1, 1)
    assert bool((ts.spec_select(gs, 2, 1, 1) | ~s_r.any(0)).all())


def test_port_off_policy_and_empty_cases():
    g = torch.tensor(gates(0, (8, 16)))
    idx, w, mask = ts.apply_policy(
        g, XSharePolicy(mode="off"), top_k=4)
    assert int(mask.sum()) == 16
    assert torch.equal(idx, torch.argsort(-g, dim=-1, stable=True)[:, :4])
    assert not bool(ts.topk_mask(torch.ones((3, 5)), 0).any())
    z = torch.zeros((3, 6))
    z[0, 2] = 1.0
    s0 = ts.warmup_union(z, 1)
    assert int(s0.sum()) == 1 and bool(s0[2])
