"""moe_ffn's gradient on the CPU: ``moe_ffn_bwd_plain`` (the
specification the CUDA kernel csrc/moe_ffn_bwd.cu is held to on the
card, tests/test_torch_gpu.py) and ``MoeFFN``'s gradient against
``jax.vjp`` of the JAX package's dense expert path
(``models/moe.py expert_ffn(..., dispatch="dense")``); the slots' mask
against float64 autograd of the plain forward; ``moe_apply``'s every
leaf, the router's ``wg`` included, under policies off, batch and batch
with k0 0 (whose picks outside the selected set have weight 0); a
2-layer granite-moe loss gradient at 1 x 4 tokens (the dense path)
against ``jax.grad``; and ``moe_ffn``'s routing through ``MoeFFN``.

Inputs come from numpy seeds; weights cross by value. Tolerances, of each
gradient's largest magnitude: 2e-5 in f32 and 2e-2 in bf16 (the repo's
kernel tolerances), 1e-10 in float64, 1e-4 for the loss gradient
(tests/test_torch_train.py's LEAF_TOL). combine's gradient is compared
on the active columns: on an all-zero column the JAX vjp gives
<dy, y_e>, the port 0 (the kernel runs only the selected experts)."""
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

KM = sys.modules["repro_torch.kernels.moe_ffn"]   # the module, not the function

TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
LEAF_TOL = 1e-4
NAMES = ("dx", "dw1", "dw3", "dw2", "dcombine")


def rel_err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def ffn_inputs(seed, T, d, f, E, inactive):
    """x, w1, w3, w2, combine, dy (float64 numpy): combine uniform in
    (0, 1) but 0 on the ``inactive`` columns."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d))
    w1, w3 = (rng.standard_normal((E, d, f)) * 0.1 for _ in range(2))
    w2 = rng.standard_normal((E, f, d)) * 0.1
    comb = rng.uniform(0.05, 1.0, (T, E))
    comb[:, list(inactive)] = 0.0
    dy = rng.standard_normal((T, d))
    return x, w1, w3, w2, comb, dy


def jax_vjp(arrs, jdt, E):
    """jax.vjp of expert_ffn(dispatch="dense") for (x, w1, w3, w2,
    combine) at dy, x and the weights in jdt, combine in f32."""
    x, w1, w3, w2, comb, dy = arrs
    moe = JB.MoEConfig(num_experts=E, top_k=2, d_ff_expert=w1.shape[-1])
    idx = jnp.zeros((x.shape[0], 2), jnp.int32)   # unread: combine given

    def f(x_, a, b, c, cm):
        return JM.expert_ffn({"w1": a, "w3": b, "w2": c}, x_, idx,
                             jnp.zeros(idx.shape), moe, dispatch="dense",
                             combine=cm)
    prim = [jnp.asarray(a, jdt) for a in (x, w1, w3, w2)] + \
        [jnp.asarray(comb, jnp.float32)]
    grads = jax.jit(lambda p, g: jax.vjp(f, *p)[1](g))(
        prim, jnp.asarray(dy, jdt))
    return [np.asarray(g, np.float32) for g in grads]


# (T, d, f, E, inactive experts): one token; 5 tokens over 6 experts of
# which 2 unused; the kernel's 32 tokens over 8 experts, 3 unused
CASES = [(1, 16, 24, 4, (2,)), (5, 32, 24, 6, (1, 4)),
         (32, 64, 40, 8, (0, 3, 7))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=["T1", "T5", "T32"])
def test_plain_backward_and_moe_ffn_fn_match_jax_vjp(case, dt):
    """moe_ffn_bwd_plain and torch.autograd.grad through MoeFFN against
    jax.vjp of the dense path: dx, dw1, dw3, dw2 and combine's active
    columns within TOL; the unused experts' weight gradients and
    combine columns exactly 0; both ways bit-equal."""
    T, d, f, E, off = case
    tdt, jdt = DTYPES[dt]
    arrs = ffn_inputs(T + E, T, d, f, E, off)
    x, w1, w3, w2, comb, dy = (torch.tensor(a).to(tdt) for a in arrs)
    comb = comb.float()
    active = (comb != 0).any(0)
    assert int(active.sum()) == E - len(off)
    want = jax_vjp(arrs, jdt, E)
    plain = K.moe_ffn_bwd_plain(x, w1, w3, w2, comb, active, dy,
                                max_active=E)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2, comb)]
    y = K.moe_ffn(*leaves[:4], leaves[4], active, max_active=E)
    assert type(y.grad_fn).__name__ == "MoeFFNBackward"
    got = torch.autograd.grad(y, leaves, dy)
    on = active.numpy()
    for name, p, g, w in zip(NAMES, plain, got, want):
        assert p.dtype == g.dtype and torch.equal(p, g), name
        if name == "dcombine":
            p, w = p[:, on], w[:, on]
        assert rel_err(p, w) <= TOL[dt], (name, rel_err(p, w))
    for t in plain[1:4]:
        assert float(t[~active].abs().max()) == 0.0
    assert float(plain[4][:, ~active].abs().max()) == 0.0


def test_plain_backward_runs_only_the_slots():
    """With max_active below the active count, moe_ffn_bwd_plain (which
    computes in f32) is the gradient of the forward over the first
    max_active active experts (the kernel's slots): float64 autograd of
    moe_ffn_plain on combine and active cut to those slots, combine's
    gradient masked to them."""
    arrs = ffn_inputs(11, 6, 16, 24, 6, (1,))
    x, w1, w3, w2, comb, dy = (torch.tensor(a) for a in arrs)
    active = (comb != 0).any(0)
    slot = KM._slot_mask(active, 3)
    assert slot.tolist() == [True, False, True, True, False, False]
    got = K.moe_ffn_bwd_plain(x, w1, w3, w2, comb, active, dy, max_active=3)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2, comb)]
    y = K.moe_ffn_plain(*leaves[:4], leaves[4] * slot, slot)
    want = list(torch.autograd.grad(y, leaves, dy))
    want[4] = want[4] * slot
    for name, g, w in zip(NAMES, got, want):
        assert rel_err(g, w) <= TOL["f32"], name


# ------------------------------------------------------ the MoE layer

# (mode, k0, m_l): tests/test_torch_train.py's three; at top-3, batch
# with k0 0 selects 2 experts, so each token's third pick falls outside
# the set with weight 0 (at top-2 it would leave none)
POLICIES = {"off": ("off", 0, 0), "batch": ("batch", 1, 2),
            "batch-k0-0": ("batch", 0, 2)}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_moe_apply_dense_gradient_matches_jax_for_every_leaf(policy):
    """moe_apply(dispatch="dense") on 6 tokens, 8 experts top-3, f32: the
    gradient of sum(y r) for x and every parameter (wg included) within
    2e-5 of its largest magnitude of jax.grad's. Under batch with k0 0
    the selected set is the batch's top 2 experts, so each token's third
    pick falls outside it with weight 0: those experts are inactive, the
    port's combine gradient there is 0 and JAX's is not, and wg's
    gradient agrees all the same (restricted_topk sets a weight-0 pick
    by a where, which passes its gradient to nothing)."""
    mode, k0, m_l = POLICIES[policy]
    T, d, f, E = 6, 32, 24, 8
    rng = np.random.default_rng(3)
    arrs = {"wg": rng.standard_normal((d, E)) * 0.3,
            "w1": rng.standard_normal((E, d, f)) * 0.1,
            "w3": rng.standard_normal((E, d, f)) * 0.1,
            "w2": rng.standard_normal((E, f, d)) * 0.1,
            "x": rng.standard_normal((T, d)),
            "r": rng.standard_normal((T, d))}
    jmoe = JB.MoEConfig(num_experts=E, top_k=3, d_ff_expert=f)
    tmoe = TB.MoEConfig(num_experts=E, top_k=3, d_ff_expert=f)
    jpol = JB.XSharePolicy(mode=mode, k0=k0, m_l=m_l)
    tpol = TB.XSharePolicy(mode=mode, k0=k0, m_l=m_l)
    keys = ("wg", "w1", "w3", "w2", "x")

    def jloss(*vals):
        p = dict(zip(keys, vals))
        y, _ = JM.moe_apply(p, p.pop("x"), jmoe, jpol, dispatch="dense")
        return (y * jnp.asarray(arrs["r"], jnp.float32)).sum()
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *(jnp.asarray(arrs[k], jnp.float32) for k in keys))
    leaves = {k: torch.tensor(arrs[k], dtype=torch.float32,
                              requires_grad=True) for k in keys}
    p = {k: leaves[k] for k in keys[:4]}
    y, _ = TM.moe_apply(p, leaves["x"], tmoe, tpol, dispatch="dense")
    got = torch.autograd.grad(
        (y * torch.tensor(arrs["r"], dtype=torch.float32)).sum(),
        [leaves[k] for k in keys])
    for k, g, w in zip(keys, got, want):
        assert rel_err(g, w) <= TOL["f32"], (k, rel_err(g, w))
    assert float(got[0].abs().max()) > 0
    if policy == "batch-k0-0":   # picks of weight 0, off the set
        with torch.no_grad():
            idx, w, comb, _ = TM.route(p, leaves["x"], tmoe, tpol)
        active = (comb != 0).any(0)
        zero = w == 0
        assert bool(zero.any()) and not bool(active[idx[zero]].any())


# ------------------------------------- the loss gradient, reduced, T 4

@pytest.fixture(scope="module")
def granite():
    """(port config, params, 1 x 4 tokens, JAX loss, JAX grads): granite
    cut to 2 layers of d 64 (4 experts top-2), 4 tokens, so each MoE
    layer takes the dense path (capacity max(4, ...) >= T)."""
    name = "granite-moe-1b-a400m"
    jc = JARCHS[name].reduced(num_layers=2, max_d_model=64, max_vocab=128)
    tc = ARCHS[name].reduced(num_layers=2, max_d_model=64, max_vocab=128)
    tp = bridge.init_params(tc, seed=0, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
    toks = np.random.default_rng(6).integers(0, 128, (1, 4))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JMD.loss_fn(jc, p, jnp.asarray(toks), remat=False)[0]))(jp)
    return tc, tp, toks, loss, grads


@pytest.mark.parametrize("remat,fwd_per_layer", [(False, 1), (True, 2)],
                         ids=["plain", "remat"])
def test_loss_gradient_through_moe_ffn_fn_matches_jax(granite, monkeypatch,
                                                      remat, fwd_per_layer):
    """loss_and_grads of the 2-layer model at 1 x 4 tokens against
    jax.grad of the JAX loss_fn: the loss within 2e-5, every leaf
    (the router's wg included, nonzero) within 1e-4 of its largest
    magnitude. Each MoE layer runs moe_ffn under autograd, so through
    MoeFFN: its forward once a layer (twice under remat, which runs it
    again in the backward) and moe_ffn_bwd once a layer; no grouped_ffn;
    the plain versions count no kernel launch."""
    tc, tp, toks, jl, jg = granite
    calls = {"fwd": 0, "bwd": 0, "grouped": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(KM, "_moe_ffn", counting("fwd", KM._moe_ffn))
    monkeypatch.setattr(KM, "moe_ffn_bwd", counting("bwd", KM.moe_ffn_bwd))
    monkeypatch.setattr(KM, "_grouped_ffn",
                        counting("grouped", KM._grouped_ffn))
    before = K.launch_counts()
    loss, grads = loss_and_grads(tc, tp, torch.as_tensor(toks), remat=remat)
    L = tc.num_layers
    assert calls == {"fwd": fwd_per_layer * L, "bwd": L, "grouped": 0}
    assert K.launch_counts() == before
    assert abs(float(loss) - float(jl)) <= 2e-5
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = bridge.flatten(grads)
    assert sorted(jflat) == sorted(tflat)
    errs = {k: rel_err(tflat[k], jflat[k]) for k in jflat}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_TOL, (worst, errs[worst])
    assert float(tflat["layers/moe/wg"].abs().max()) > 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_moe_ffn_routes_through_moe_ffn_fn_only_under_autograd(device):
    """With an input that requires grad moe_ffn is MoeFFN (on meta its
    backward propagates shapes and dtypes); under no_grad, or with no
    input requiring grad, it is the plain forward with no grad_fn, and
    the same numbers."""
    arrs = ffn_inputs(5, 4, 16, 16, 4, (3,))
    x, w1, w3, w2, comb, dy = (torch.tensor(a, dtype=torch.float32)
                               .to(device) for a in arrs)
    active = (comb != 0).any(0)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2, comb)]
    y = K.moe_ffn(*leaves, active, max_active=4)
    assert type(y.grad_fn).__name__ == "MoeFFNBackward"
    got = torch.autograd.grad(y, leaves, dy)
    for g, t in zip(got, (x, w1, w3, w2, comb)):
        assert (g.device.type, g.shape, g.dtype) == (device, t.shape,
                                                     t.dtype)
    with torch.no_grad():
        y0 = K.moe_ffn(*leaves, active, max_active=4)
    y1 = K.moe_ffn(x, w1, w3, w2, comb, active, max_active=4)
    assert y0.grad_fn is None and y1.grad_fn is None
    if device == "cpu":
        assert torch.equal(y0, y.detach()) and torch.equal(y1, y0)
