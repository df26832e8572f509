"""The port's sorted dispatch and MoE layer against the JAX package:
every DispatchPlan field exactly equal (masked idx == -1 rows, dropped
w == 0 pairs, capacity clamps and XShare budgets included), expert_ffn
in sorted, einsum and dense modes within 2e-5, and inside the port the
dense path (moe_ffn's plain version) against the sorted path."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import XSharePolicy as JPolicy  # noqa: E402
from repro.models import dispatch as JD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs.base import MoEConfig, XSharePolicy  # noqa: E402
from repro_torch.models import dispatch as TD  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

TOL = 2e-5


def routing(seed, T, E, k, *, masked=0, zero_w=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    idx = np.argsort(-logits, axis=1, kind="stable")[:, :k].astype(np.int32)
    w = rng.random((T, k)).astype(np.float32) + 0.1
    w /= w.sum(1, keepdims=True)
    rows = rng.permutation(T)
    idx[rows[:masked]] = -1                    # masked slots
    w[rows[:masked]] = 0.0
    flat = rng.permutation(T * k)[:zero_w]     # dropped pairs
    w.reshape(-1)[flat] = 0.0
    return idx, w


PLANS = [dict(T=8, E=4, k=2), dict(T=16, E=8, k=1, masked=5),
         dict(T=32, E=6, k=2, zero_w=7), dict(T=12, E=16, k=4, masked=3,
                                               zero_w=4),
         dict(T=64, E=32, k=8, masked=10), dict(T=8, E=4, k=2, masked=8)]


@pytest.mark.parametrize("case", PLANS)
@pytest.mark.parametrize("opts", [{}, dict(capacity=3), dict(max_active=3),
                                  dict(capacity=2, max_active=5, block_t=8)])
def test_dispatch_plan_fields_exact(case, opts):
    case = dict(case)
    T, E, k = case.pop("T"), case.pop("E"), case.pop("k")
    idx, w = routing(T * E + k, T, E, k, **case)
    if "max_active" in opts:
        # the budget bounds the experts that really occur
        used = np.unique(idx[(idx >= 0) & (w != 0)])
        keep = np.isin(idx, used[:opts["max_active"]])
        idx = np.where(keep, idx, -1).astype(np.int32)
        w = np.where(keep, w, 0.0).astype(np.float32)
    tp = TD.dispatch_plan(torch.tensor(idx), torch.tensor(w), E, **opts)
    jp = JD.dispatch_plan(jnp.asarray(idx), jnp.asarray(w), E, **opts)
    assert tp.block_t == jp.block_t and tp.padded_rows == jp.padded_rows
    for field in ("order", "s_tok", "dest", "counts", "tile_eid",
                  "tile_valid"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(tp.s_w.numpy(), np.asarray(jp.s_w))
    x = np.random.default_rng(0).standard_normal((T, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        TD.gather_tokens(torch.tensor(x), tp).numpy(),
        np.asarray(JD.gather_tokens(jnp.asarray(x), jp)))


def test_group_token_loads_ragged_groups():
    counts = np.array([3, 0, 5, 1, 2, 7, 4], np.int32)
    for G in (2, 3, 4):
        np.testing.assert_array_equal(
            TD.group_token_loads(torch.tensor(counts), G).numpy(),
            np.asarray(JD.group_token_loads(jnp.asarray(counts), G)))


def moe_params(seed, d, E, f):
    rng = np.random.default_rng(seed)
    p = {"wg": rng.standard_normal((d, E)) * 0.3,
         "w1": rng.standard_normal((E, d, f)) * 0.1,
         "w3": rng.standard_normal((E, d, f)) * 0.1,
         "w2": rng.standard_normal((E, f, d)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: torch.tensor(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("dispatch", ["sorted", "einsum", "dense"])
@pytest.mark.parametrize("T,E,k,masked", [(8, 4, 2, 0), (16, 8, 2, 5),
                                          (24, 6, 1, 3), (30, 16, 4, 0)])
def test_expert_ffn_modes_match_jax(dispatch, T, E, k, masked):
    d, f = 32, 48
    tp, jp = moe_params(T + E, d, E, f)
    idx, w = routing(T * k, T, E, k, masked=masked)
    x = np.random.default_rng(T).standard_normal((T, d)).astype(np.float32)
    kw = dict(dispatch=dispatch, capacity_factor=8.0)
    out = TM.expert_ffn(tp, torch.tensor(x), torch.tensor(idx),
                        torch.tensor(w), MoEConfig(E, k, f), **kw)
    ref = JM.expert_ffn(jp, jnp.asarray(x), jnp.asarray(idx),
                        jnp.asarray(w), JMoE(E, k, f), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("mode,kw", [("off", {}),
                                     ("batch", dict(k0=1, m_l=2)),
                                     ("ep", dict(k0=1, m_g=1,
                                                 num_groups=4))])
def test_dense_path_equals_sorted_path_in_the_port(mode, kw):
    """moe_ffn (the dense decode path) and grouped_ffn (the sorted path)
    compute the same function of the same routing."""
    T, d, E, k, f = 8, 32, 8, 2, 64
    tp, _ = moe_params(1, d, E, f)
    x = torch.tensor(np.random.default_rng(2).standard_normal((T, d)),
                     dtype=torch.float32)
    mask = torch.tensor([True] * 6 + [False] * 2)
    pol = XSharePolicy(mode=mode, **kw)
    outs = [TM.moe_apply(tp, x, MoEConfig(E, k, f), pol, token_mask=mask,
                         dispatch=dsp, capacity_factor=8.0)[0]
            for dsp in ("dense", "sorted")]
    assert float(outs[0][~mask].abs().max()) == 0.0
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                               atol=TOL, rtol=TOL)


def test_auto_dispatch_picks_dense_at_decode_and_sorted_at_prefill(
        monkeypatch):
    calls = []
    monkeypatch.setattr(TM, "moe_ffn",
                        lambda *a, **kw: calls.append("dense") or
                        torch.zeros_like(a[0]))
    monkeypatch.setattr(TM.DSP, "sorted_expert_ffn",
                        lambda x, *a, **kw: calls.append("sorted") or
                        torch.zeros_like(x))
    tp, _ = moe_params(0, 16, 32, 8)
    moe = MoEConfig(32, 8, 8)
    for T in (8, 64):
        x = torch.zeros((T, 16))
        TM.moe_apply(tp, x, moe, capacity_factor=8.0)
    assert calls == ["dense", "sorted"]


@pytest.mark.parametrize("mode,kw", [("off", {}),
                                     ("batch", dict(k0=1, m_l=3))])
def test_moe_apply_matches_jax(mode, kw):
    T, d, E, k, f = 12, 32, 8, 2, 48
    tp, jp = moe_params(3, d, E, f)
    x = np.random.default_rng(4).standard_normal((2, T // 2, d)).astype(
        np.float32)
    mask = np.random.default_rng(5).random((2, T // 2)) > 0.25
    out, aux = TM.moe_apply(tp, torch.tensor(x), MoEConfig(E, k, f),
                            XSharePolicy(mode=mode, **kw),
                            token_mask=torch.tensor(mask))
    ref, jaux = JM.moe_apply(jp, jnp.asarray(x), JMoE(E, k, f),
                             JPolicy(mode=mode, **kw),
                             token_mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    assert int(aux["activated_experts"]) == int(jaux["activated_experts"])


def test_ep_dispatch_is_not_ported():
    """dispatch="ep" with no EPExecutor bound is the sorted path, bit for
    bit, as in the JAX package (the name dates from when "ep" raised; the
    executor itself is tests/test_torch_ep.py's)."""
    T, d, E, k, f = 12, 8, 4, 2, 8
    tp, _ = moe_params(0, d, E, f)
    idx, w = routing(3, T, E, k, masked=2)
    x = torch.tensor(np.random.default_rng(4).standard_normal((T, d)),
                     dtype=torch.float32)
    args = (tp, x, torch.tensor(idx), torch.tensor(w), MoEConfig(E, k, f))
    assert torch.equal(TM.expert_ffn(*args, dispatch="ep"),
                       TM.expert_ffn(*args, dispatch="sorted"))
