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

The kernel's precision plan is pinned here too: on the card it takes
each of its eight products on mma.sync, in f32 as three TF32 products
(3xTF32, csrc/common.cuh), in bf16 with dA and dB rounded to bf16 as
operands and c H as the forward rounds it. At one expert, its operands
split that way and summed in IEEE f32 stay within the card's gates of
``jax.vjp``, where a single TF32 product does not; and dx's long chain
of mma accumulations over 32 experts, each emulated as a round toward
zero, the order of the kernel's items, clusters and sums, stays within
the f32 gate with the split and misses it without.

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

from test_torch_ssd_bwd import tf32_einsum  # noqa: E402

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


# --------------------------------------- the CUDA kernel's precision plan

@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "1xtf32"])
def test_tf32_split_holds_the_f32_gate_and_one_tf32_product_does_not(
        monkeypatch, split):
    """One expert at granite-moe's widths (d 1024, f 512) and the dense
    train step's 32 tokens, f32: moe_ffn_bwd_plain with the operands of
    each of its eight products (A, B, G; dx's two; dW1, dW3, dW2) split
    as 3xTF32 (lo·hi + hi·lo + hi·hi) keeps every gradient within 2e-5
    of its largest magnitude of jax.vjp of the dense path (the kernel's
    f32 gate on the card); with a single TF32 product some gradient
    misses it. The products' sums are IEEE f32 here, not the tensor
    core's accumulation, and one expert is not the kernel's long sum
    over 32: test_dx_chain_over_32_experts_... models those for dx."""
    E = 1
    arrs = ffn_inputs(27, 32, 1024, 512, E, ())
    want = jax_vjp(arrs, jnp.float32, E)
    x, w1, w3, w2, comb, dy = (torch.tensor(a, dtype=torch.float32)
                               for a in arrs)
    calls = []
    monkeypatch.setattr(torch, "einsum",
                        tf32_einsum(torch.einsum, split, calls))
    got = K.moe_ffn_bwd_plain(x, w1, w3, w2, comb, torch.ones(E, dtype=bool),
                              dy, max_active=E)
    assert len(calls) == 8
    errs = {n: rel_err(g, w) for n, g, w in zip(NAMES, got, want)}
    if split:
        assert max(errs.values()) <= TOL["f32"], errs
    else:
        assert max(errs.values()) > TOL["f32"], errs



def rz_f32(v):
    """float64 to the f32 value next to it toward zero, in float64."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r).double()


def kernel_dx(da, db, w1, w3, split, rnd=rz_f32, clusters=30, fs=32):
    """dx = sum_e dA W1[e]^T + dB W3[e]^T (f32 operands) summed as
    csrc/moe_ffn_bwd.cu sums it at 32 tokens: the (slot, strip of ``fs``
    columns) items slot-major, an even contiguous share per cluster (30
    at granite's shape on the H100), each cluster's accumulator taking
    an item's W1 then W3 product over its strip 8 columns at a time, as
    lo·hi, hi·lo, hi·hi mma.sync m16n8k8 (``split``) or hi·hi alone,
    each mma rounding its exact sum to f32 by ``rnd`` (toward zero by
    default); then the clusters'
    parts summed in f32 as the reduce kernel sums them (8 warps an
    eighth each in order, then the eighths in order)."""
    from test_torch_ssd_bwd import tf32

    def parts(t):
        hi = tf32(t.float()).double()
        return hi, tf32((t - hi).float()).double()
    (E, d, f), T = w1.shape, da.shape[1]
    n = E * (f // fs)
    acc = torch.zeros(clusters, T, d, dtype=torch.float64)
    for c in range(clusters):
        for it in range(c * n // clusters, (c + 1) * n // clusters):
            e, s = divmod(it, f // fs)
            for w, g in ((w1, da), (w3, db)):
                for k in range(s * fs, (s + 1) * fs, 8):
                    (wh, wl), (gh, gl) = (parts(w[e][:, k:k + 8].double()),
                                          parts(g[e][:, k:k + 8].double()))
                    for a, b in (((gh, wl), (gl, wh), (gh, wh)) if split
                                 else ((gh, wh),)):
                        acc[c] = rnd(acc[c] + a @ b.T)
    eighths = [sum((acc[q].float() for q in range(
        w * clusters // 8, (w + 1) * clusters // 8)),
        torch.zeros(T, d)) for w in range(8)]
    return sum(eighths, torch.zeros(T, d))


def nearest_f32(v):
    return v.float().double()


# split, each mma's rounding, the limit of dx's error, whether it holds
CHAIN = {"3xtf32": (True, rz_f32, TOL["f32"], True),
         "1xtf32": (False, rz_f32, TOL["f32"], False),
         "3xtf32-nearest": (True, nearest_f32, 2e-6, True)}


@pytest.mark.parametrize("case", CHAIN)
def test_dx_chain_over_32_experts_holds_the_f32_gate_with_the_split(case):
    """All of granite-moe's 32 experts at d 1024, f 512 and the dense
    train step's 32 tokens, f32: dx formed from the f32 dA and dB as the
    kernel forms it (kernel_dx: its order of items, clusters and sums,
    each mma rounding toward zero, a tensor core's f32 accumulation as
    modelled here) is within 2e-5 of its largest magnitude of jax.vjp's
    dx with the 3xTF32 split, and not with a single TF32 product. With
    each mma rounding to nearest it is within 2e-6: the truncation, over
    about 400 mma a cluster, is what lifts dx's error towards the gate."""
    split, rnd, limit, holds = CHAIN[case]
    E = 32
    arrs = ffn_inputs(29, 32, 1024, 512, E, ())
    want = jax_vjp(arrs, jnp.float32, E)[0]
    x, w1, w3, w2, comb, dy = (torch.tensor(a, dtype=torch.float32)
                               for a in arrs)
    del arrs
    a = torch.einsum("td,edf->etf", x, w1)
    b = torch.einsum("td,edf->etf", x, w3)
    g = torch.einsum("td,efd->etf", dy, w2)
    s, c = torch.sigmoid(a), comb.T[..., None]
    da, db = c * g * b * s * (1 + a * (1 - s)), c * g * a * s
    err = rel_err(kernel_dx(da, db, w1, w3, split, rnd), want)
    assert (err <= limit) == holds, err

def test_bf16_roundings_of_the_kernel_stay_within_tol_of_jax_vjp():
    """The same expert and tokens with bf16 x, dy and weights, emulating
    the kernel's bf16 path: A, B and G in f32 from the bf16 operands
    (exact products, f32 sums), dA and dB rounded to bf16 as the operands
    of dW1, dW3 and dx, c H rounded to bf16 for dW2 (as the forward
    rounds it), dcombine from H in f32, each gradient rounded to its
    dtype: within 2e-2 of each gradient's largest magnitude of jax.vjp of
    the dense path in bf16."""
    E = 1
    arrs = ffn_inputs(28, 32, 1024, 512, E, ())
    want = jax_vjp(arrs, jnp.bfloat16, E)
    x, w1, w3, w2, dy = (torch.tensor(a).to(torch.bfloat16).float()
                         for a in (arrs[0], arrs[1], arrs[2], arrs[3],
                                   arrs[5]))
    c = torch.tensor(arrs[4], dtype=torch.float32)[:, 0, None]
    bf = lambda t: t.to(torch.bfloat16).float()   # noqa: E731
    a, b, g = x @ w1[0], x @ w3[0], dy @ w2[0].T
    s = torch.sigmoid(a)
    h = a * s * b
    da, db = bf(c * g * b * s * (1 + a * (1 - s))), bf(c * g * a * s)
    got = [(da @ w1[0].T + db @ w3[0].T), (x.T @ da)[None],
           (x.T @ db)[None], (bf(c * h).T @ dy)[None], (g * h).sum(-1)[:, None]]
    got = [t.to(torch.bfloat16) for t in got[:4]] + [got[4]]
    for name, gt, w in zip(NAMES, got, want):
        assert rel_err(gt, w) <= TOL["bf16"], (name, rel_err(gt, w))
