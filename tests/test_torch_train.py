"""The port's training path against the JAX package on the CPU: the
synthetic data, cross_entropy, the fused chunked head, loss_fn and its
gradient for every parameter leaf (router included), grouped_ffn's
hand-written gradient (its plain version; the CUDA kernel is held to it
in tests/test_torch_gpu.py), AdamW and its schedule, make_train_step
over three steps, gradient accumulation, and a checkpoint written by the
port's CLI that the JAX package restores. Weights cross by the bridge;
inputs come from numpy seeds. Tolerances: losses 2e-5, gradients and
updated params 1e-4 of each leaf's largest magnitude, the optimizer's
pieces 1e-6."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import data as JDATA  # noqa: E402
from repro import optim as JOPT  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.launch.train import make_train_step as j_make_train_step  # noqa
from repro.models import dispatch as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import data as TDATA  # noqa: E402
from repro_torch import optim as TOPT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import (grouped_ffn, grouped_ffn_bwd,  # noqa: E402
                                 grouped_ffn_bwd_plain, grouped_ffn_plain)
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models import dispatch as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

LOSS_TOL = 2e-5
LEAF_TOL = 1e-4
OPT_TOL = 1e-6


def tiny_moe(B):
    """tests/test_train_integration.py's TINY_MOE, built from either
    package's config classes."""
    return B.ArchConfig(
        name="tiny-moe", family="moe", num_layers=2, d_model=64, d_ff=0,
        vocab_size=128,
        attn=B.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        moe=B.MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))


def dense(archs):
    return archs["llama3-8b"].reduced(num_layers=2, max_d_model=64,
                                      max_vocab=128)


CONFIGS = {"tiny-moe": (tiny_moe(JB), tiny_moe(TB)),
           "dense": (dense(JARCHS), dense(ARCHS))}
# (mode, k0, m_l): batch k0 0 restricts the 4 experts to the batch's top
# 2, so some picks fall outside the set and get weight 0
POLICIES = {"off": ("off", 0, 0), "batch": ("batch", 1, 2),
            "batch-k0-0": ("batch", 0, 2)}


def policies(name):
    mode, k0, m_l = POLICIES[name]
    return (JB.XSharePolicy(mode=mode, k0=k0, m_l=m_l),
            TB.XSharePolicy(mode=mode, k0=k0, m_l=m_l))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params(tp):
    """The port's params as the JAX package's tree (jnp arrays)."""
    return jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, JAX params, port params), the same
    numbers on both sides (drawn by the port's initializer, which the
    JAX package's init_params matches in keys, shapes and dtypes)."""
    out = {}
    for name, (jc, tc) in CONFIGS.items():
        tp = bridge.init_params(tc, seed=0, device="cpu")
        out[name] = (jc, tc, jax_params(tp), tp)
    return out


def tokens(vocab, batch=2, seq=24, seed=0):
    lm = JDATA.SyntheticLM(vocab, name="train-test", branch=4)
    return next(JDATA.batches(lm, batch=batch, seq_len=seq, seed=seed))


def leaf_err(t, j) -> float:
    """max |t - j| over the leaf's largest |j|."""
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j, np.float32)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def assert_leaves_close(ttree, jtree, tol):
    jflat = bridge.flatten(to_np(jtree))
    tflat = bridge.flatten(ttree)
    assert sorted(jflat) == sorted(tflat)
    errs = {k: leaf_err(tflat[k], jflat[k]) for k in jflat}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])


def torch_grads(cfg, params, toks, **kw):
    leaves = bridge.unflatten({k: v.detach().requires_grad_(True)
                               for k, v in bridge.flatten(params).items()})
    loss, _ = TMD.loss_fn(cfg, leaves, torch.as_tensor(toks), **kw)
    flat = bridge.flatten(leaves)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), bridge.unflatten(dict(zip(flat, grads)))


# -------------------------------------------------------------- data ---

def test_synthetic_data_equals_the_jax_packages():
    for kw in (dict(), dict(branch=4, zipf_a=1.5)):
        j = JDATA.SyntheticLM(300, name="gpqa", **kw)
        t = TDATA.SyntheticLM(300, name="gpqa", **kw)
        np.testing.assert_array_equal(t.succ, j.succ)
        np.testing.assert_array_equal(t.succ_w, j.succ_w)
        np.testing.assert_array_equal(
            t.sample(np.random.default_rng(5), 3, 17),
            j.sample(np.random.default_rng(5), 3, 17))
        for jb, tb, _ in zip(JDATA.batches(j, batch=2, seq_len=9, seed=3),
                             TDATA.batches(t, batch=2, seq_len=9, seed=3),
                             range(3)):
            np.testing.assert_array_equal(tb, jb)
    names = ("gpqa", "aime2025", "mmlu-pro", "aa-lcr")
    jf = JDATA.make_dataset_family(256, names)
    tf = TDATA.make_dataset_family(256, names)
    assert list(tf) == list(jf)
    np.testing.assert_array_equal(
        TDATA.mixed_request_batch(tf, seq_len=12, seed=4),
        JDATA.mixed_request_batch(jf, seq_len=12, seed=4))


# ------------------------------------------------------------ losses ---

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) > 0.4
    for m in (None, mask):
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        got = TL.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                               None if m is None else torch.tensor(m))
        assert abs(float(got) - float(want)) <= LOSS_TOL
    none = TL.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                            torch.zeros((3, 7), dtype=torch.bool))
    assert float(none) == 0.0        # no live position: 0, not NaN


@pytest.mark.parametrize("chunk", [5, 512])
def test_fused_head_ce_matches_jax(models, chunk):
    """A chunk of 5 does not divide the 23 positions: the last chunk is
    short in the port and padded and masked in the JAX package. Also
    against the head and cross_entropy unfused, and its gradient."""
    jc, tc, jp, tp = models["tiny-moe"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 23, 64)).astype(np.float32)
    t = rng.integers(0, 128, (2, 23)).astype(np.int32)
    want, jgx = jax.jit(jax.value_and_grad(
        lambda x_: JMD._fused_head_ce(jc, jp, x_, jnp.asarray(t),
                                      chunk=chunk)))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = TMD._fused_head_ce(tc, tp, tx, torch.tensor(t), chunk=chunk)
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
    (gx,) = torch.autograd.grad(got, tx)
    assert leaf_err(gx, jgx) <= LEAF_TOL
    logits = TMD.lm_head_apply(tc, tp, torch.tensor(x))
    plain = TL.cross_entropy(logits, torch.tensor(t))
    assert abs(float(got.detach()) - float(plain)) <= LOSS_TOL


# (config, policy, remat of the JAX reference)
GRAD_CASES = [("tiny-moe", "off", False), ("tiny-moe", "batch", True),
              ("dense", "off", False)]


@pytest.fixture(scope="module")
def jax_grads(models):
    out = {}
    toks = jnp.asarray(tokens(128))
    for name, pol, remat in GRAD_CASES:
        jc, _, jp, _ = models[name]
        jpol, _ = policies(pol)
        f = jax.jit(jax.value_and_grad(
            lambda p: JMD.loss_fn(jc, p, toks, policy=jpol, remat=remat)[0]))
        out[name, pol] = f(jp)
    return out


@pytest.mark.parametrize("name,pol,_", GRAD_CASES)
def test_loss_fn_matches_jax_with_and_without_remat(models, jax_grads,
                                                    name, pol, _):
    _, tc, _, tp = models[name]
    _, tpol = policies(pol)
    want = float(jax_grads[name, pol][0])
    toks = torch.as_tensor(tokens(128))
    with torch.no_grad():
        losses = [float(TMD.loss_fn(tc, tp, toks, policy=tpol,
                                    remat=remat)[0])
                  for remat in (False, True)]
    assert losses[0] == losses[1]
    assert abs(losses[0] - want) <= LOSS_TOL


@pytest.mark.parametrize("name,pol,remat", GRAD_CASES)
def test_loss_gradient_matches_jax_for_every_leaf(models, jax_grads, name,
                                                  pol, remat):
    """torch.autograd through the port's loss (the sorted dispatch's
    GroupedFFN with grouped_ffn_bwd_plain, the router, attention, the
    fused head) against jax.grad of the JAX package's, leaf by leaf. The
    port runs with the other remat setting than the reference did, so
    each side's remat is held against the other's plain backward."""
    _, tc, _, tp = models[name]
    _, tpol = policies(pol)
    jl, jg = jax_grads[name, pol]
    loss, grads = torch_grads(tc, tp, tokens(128), policy=tpol,
                              remat=not remat)
    assert abs(float(loss) - float(jl)) <= LOSS_TOL
    assert_leaves_close(grads, jg, LEAF_TOL)
    if name == "tiny-moe":
        assert float(grads["layers"]["moe"]["wg"].abs().max()) > 0


@pytest.mark.parametrize("pol", ["off", "batch-k0-0"])
def test_route_gradient_reaches_the_router_like_jax(pol):
    """wg's gradient through the gate weights w (the top-k softmax, or
    the restricted top-k under the batch policy) and through lb_loss."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    wg = (0.3 * rng.standard_normal((16, 4))).astype(np.float32)
    r = rng.standard_normal((40, 2)).astype(np.float32)
    jpol, tpol = policies(pol)
    jm = JB.MoEConfig(num_experts=4, top_k=2, d_ff_expert=8)
    tm = TB.MoEConfig(num_experts=4, top_k=2, d_ff_expert=8)

    def jf(wg_):
        _, w, _, aux = JM.route({"wg": wg_}, jnp.asarray(x), jm, jpol)
        return (w * r).sum() + aux["lb_loss"]
    want = jax.jit(jax.grad(jf))(jnp.asarray(wg))
    twg = torch.tensor(wg, requires_grad=True)
    _, w, _, aux = TM.route({"wg": twg}, torch.tensor(x), tm, tpol)
    ((w * torch.tensor(r)).sum() + aux["lb_loss"]).backward()
    assert leaf_err(twg.grad, want) <= LEAF_TOL


def test_sorted_dispatch_gradients_match_jax():
    """gather_tokens, the grouped FFN and combine_scatter pass gradients
    to the rows, the gate weights and the three expert weights as
    jax.grad of the JAX package's sorted_expert_ffn does (dropped and
    masked pairs included)."""
    rng = np.random.default_rng(3)
    T, d, E, f, k = 24, 16, 4, 12, 2
    x = rng.standard_normal((T, d)).astype(np.float32)
    w1, w3 = (0.3 * rng.standard_normal((2, E, d, f))).astype(np.float32)
    w2 = (0.3 * rng.standard_normal((E, f, d))).astype(np.float32)
    idx = np.argsort(-rng.standard_normal((T, E)), 1)[:, :k].astype(np.int32)
    idx[:3] = -1
    w = (rng.random((T, k)) + 0.1).astype(np.float32)
    w[:3] = 0.0
    w[5, 1] = 0.0
    r = rng.standard_normal((T, d)).astype(np.float32)
    args = (x, w1, w3, w2, w)

    def jf(x_, w1_, w3_, w2_, w_):
        y = JD.sorted_expert_ffn(x_, w1_, w3_, w2_, jnp.asarray(idx), w_,
                                 block_t=8)
        return (y * r).sum()
    want = jax.jit(jax.grad(jf, argnums=tuple(range(5))))(
        *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y = TD.sorted_expert_ffn(ts[0], ts[1], ts[2], ts[3], torch.tensor(idx),
                             ts[4], block_t=8)
    (y * torch.tensor(r)).sum().backward()
    for t, j in zip(ts, want):
        assert leaf_err(t.grad, j) <= 2e-5


# ------------------------------------------------- grouped_ffn_bwd ---

def bwd_case(block_t, seed=11):
    """A plan over 3 of 4 experts (expert 3 gets no row) whose padded
    buffer ends in invalid tiles, rows gathered as the model gathers
    them, and a random output gradient on every row."""
    rng = np.random.default_rng(seed)
    T, d, E, f, k = 40, 16, 4, 24, 2
    logits = rng.standard_normal((T, 3))
    idx = np.argsort(-logits, 1)[:, :k].astype(np.int32)
    w = np.full((T, k), 0.5, np.float32)
    plan = TD.dispatch_plan(torch.tensor(idx), torch.tensor(w), E,
                            block_t=block_t)
    xs = TD.gather_tokens(torch.tensor(
        rng.standard_normal((T, d)).astype(np.float32)), plan)
    w1, w3 = torch.tensor((0.3 * rng.standard_normal((2, E, d, f))
                           ).astype(np.float32))
    w2 = torch.tensor((0.3 * rng.standard_normal((E, f, d))
                       ).astype(np.float32))
    dys = torch.tensor(rng.standard_normal(tuple(xs.shape)
                                           ).astype(np.float32))
    assert (plan.tile_valid == 0).any() and 3 not in set(
        plan.tile_eid[plan.tile_valid > 0].tolist())
    return plan, xs, w1, w3, w2, dys


@pytest.mark.parametrize("block_t", [8, 128])
def test_grouped_ffn_bwd_plain_matches_jax_vjp_and_autograd(block_t):
    plan, xs, w1, w3, w2, dys = bwd_case(block_t)
    got = grouped_ffn_bwd_plain(xs, w1, w3, w2, plan.tile_eid,
                                plan.tile_valid, dys, block_t=block_t)
    jplan = JD.DispatchPlan(*[jnp.asarray(np.asarray(v))
                              if isinstance(v, torch.Tensor) else v
                              for v in plan])
    _, vjp = jax.vjp(lambda *a: JD.grouped_ffn_jnp(*a, jplan),
                     *(jnp.asarray(t.numpy()) for t in (xs, w1, w3, w2)))
    want = vjp(jnp.asarray(dys.numpy()))
    leaves = [t.clone().requires_grad_(True) for t in (xs, w1, w3, w2)]
    ys = grouped_ffn_plain(*leaves, plan.tile_eid, plan.tile_valid,
                           block_t=block_t)
    auto = torch.autograd.grad(ys, leaves, dys)
    for g, j, a in zip(got, want, auto):
        assert leaf_err(g, j) <= LOSS_TOL
        assert leaf_err(g, a.numpy()) <= LOSS_TOL
    dw1 = got[1]
    assert float(dw1[3].abs().max()) == 0.0       # the expert with no rows
    rows = (plan.tile_valid == 0).repeat_interleave(block_t)
    assert float(got[0][rows].abs().max()) == 0.0  # invalid tiles


BF16_TOL = 2e-2   # tests/test_kernels.py's bf16 tolerance


def bf16_kernel_rounding(xs, w1, w3, w2, plan, dys):
    """grouped_ffn_bwd's bf16 kernel as its rounding goes, in f32 on
    bf16 values: A, B and G summed in f32 from bf16 operands; dA, dB and
    H rounded to bf16 between the passes; dxs and the weight gradients
    summed in f32 from those and rounded to bf16 once. Invalid tiles
    give zero rows and add nothing to a weight gradient."""
    P, d = xs.shape
    E, _, f = w1.shape
    bt = plan.block_t
    nt = P // bt

    def bf(t):
        return t.to(torch.bfloat16).float()
    live = (plan.tile_valid != 0).float()[:, None, None]
    eid = plan.tile_eid.long()
    x = xs.reshape(nt, bt, d)
    dy = dys.reshape(nt, bt, d) * live
    w1g, w3g, w2g = w1[eid], w3[eid], w2[eid]
    a = torch.einsum("tbd,tdf->tbf", x, w1g)
    b = torch.einsum("tbd,tdf->tbf", x, w3g)
    g = torch.einsum("tbd,tfd->tbf", dy, w2g)
    s = torch.sigmoid(a)
    da = bf(g * b * s * (1 + a * (1 - s)) * live)
    db = bf(g * a * s * live)
    h = bf(a * s * b * live)
    dxs = bf(torch.einsum("tbf,tdf->tbd", da, w1g)
             + torch.einsum("tbf,tdf->tbd", db, w3g))

    def per_expert(eq, u, v):
        t = torch.einsum(eq, u, v)
        return bf(torch.zeros((E,) + t.shape[1:]).index_add_(0, eid, t))
    return (dxs.reshape(P, d), per_expert("tbd,tbf->tdf", x, da),
            per_expert("tbd,tbf->tdf", x, db),
            per_expert("tbf,tbd->tfd", h, dy))


def test_bf16_backward_rounding_stays_within_tol_of_jax_vjp():
    """The bf16 kernel's error budget at granite-moe's expert widths (d
    1024, f 512, E 32; 24 tokens top-8, block_t 16): rounding dA, dB and
    H to bf16 between the passes, as the kernel does, keeps every
    gradient within bf16's TOL of its largest magnitude against jax.vjp
    of grouped_ffn_jnp on the same bf16-rounded inputs."""
    rng = np.random.default_rng(23)
    T, d, E, f, k = 24, 1024, 32, 512, 8
    logits = rng.standard_normal((T, E))
    idx = np.argsort(-logits, 1)[:, :k].astype(np.int32)
    w = np.full((T, k), 1.0 / k, np.float32)
    plan = TD.dispatch_plan(torch.tensor(idx), torch.tensor(w), E,
                            block_t=16)

    def bf16_values(*shape, scale=1.0):
        t = torch.tensor((scale * rng.standard_normal(shape)
                          ).astype(np.float32))
        return t.to(torch.bfloat16).float()
    xs = TD.gather_tokens(bf16_values(T, d), plan)
    w1, w3 = bf16_values(E, d, f, scale=0.02), bf16_values(E, d, f,
                                                           scale=0.02)
    w2 = bf16_values(E, f, d, scale=0.02)
    dys = bf16_values(*xs.shape, scale=0.01)
    got = bf16_kernel_rounding(xs, w1, w3, w2, plan, dys)
    jplan = JD.DispatchPlan(*[jnp.asarray(np.asarray(v))
                              if isinstance(v, torch.Tensor) else v
                              for v in plan])
    _, vjp = jax.vjp(lambda *a: JD.grouped_ffn_jnp(*a, jplan),
                     *(jnp.asarray(t.numpy()) for t in (xs, w1, w3, w2)))
    want = vjp(jnp.asarray(dys.numpy()))
    errs = [leaf_err(g, j) for g, j in zip(got, want)]
    assert max(errs) <= BF16_TOL, errs
    assert min(errs) > 0   # the rounding is there, and measured
    assert (plan.tile_valid == 0).any()


def test_grouped_ffn_goes_through_its_gradient_under_autograd():
    """With grad enabled the wrapper is GroupedFFN, whose backward is
    grouped_ffn_bwd (its plain version here); under no_grad nothing is
    recorded and no backward can run."""
    plan, xs, w1, w3, w2, dys = bwd_case(8, seed=12)
    leaves = [t.clone().requires_grad_(True) for t in (xs, w1, w3, w2)]
    ys = grouped_ffn(*leaves, plan.tile_eid, plan.tile_valid, block_t=8)
    assert type(ys.grad_fn).__name__ == "GroupedFFNBackward"
    got = torch.autograd.grad(ys, leaves, dys)
    want = grouped_ffn_bwd(xs, w1, w3, w2, plan.tile_eid, plan.tile_valid,
                           dys, block_t=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert grouped_ffn(*leaves, plan.tile_eid, plan.tile_valid,
                           block_t=8).grad_fn is None


# --------------------------------------------------------- optimizer ---

def random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": (1e-3 * rng.standard_normal((2, 3))
                        ).astype(np.float32)}}


def test_adamw_schedule_and_clipping_match_jax():
    jsched = JOPT.cosine_schedule(3e-3, 3, 10)
    tsched = TOPT.cosine_schedule(3e-3, 3, 10)
    jupdate = jax.jit(lambda g, s, p: JOPT.adamw_update(g, s, p, lr=jsched))
    jclip = jax.jit(lambda g: JOPT.clip_by_global_norm(g, 1.0))
    for s in range(12):
        assert abs(float(tsched(torch.tensor(s))) - float(
            jsched(jnp.asarray(s)))) <= OPT_TOL * 3e-3
    params = random_tree(0)
    jp, tp = params, bridge.from_numpy(params, device="cpu")
    js, ts = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
    for step in range(3):
        grads = random_tree(10 + step)
        jg, jn = jclip(grads)
        tg, tn = TOPT.clip_by_global_norm(
            bridge.from_numpy(grads, device="cpu"), 1.0)
        assert abs(float(tn) - float(jn)) <= OPT_TOL * float(jn)
        assert_leaves_close(tg, jg, OPT_TOL)
        jp, js = jupdate(jg, js, jp)
        tp, ts = TOPT.adamw_update(tg, ts, tp, lr=tsched)
        assert int(ts.step) == int(js.step) == step + 1
        assert_leaves_close(tp, jp, OPT_TOL)
        assert_leaves_close(ts.mu, js.mu, OPT_TOL)
        assert_leaves_close(ts.nu, js.nu, OPT_TOL)


# ------------------------------------------------------- train step ---

def test_three_train_steps_match_jax(models):
    """At the CLI's default lr, 3e-4. AdamW moves an element by about lr
    whatever its gradient's size, so an element whose gradient is of the
    order of eps (1e-8) moves by an amount its last bits decide: at 3e-3
    the two packages' w1 drifted 1.1e-4 of its largest magnitude apart
    that way."""
    jc, tc, jp, tp = models["tiny-moe"]
    lr_j = JOPT.cosine_schedule(3e-4, 1, 3)
    lr_t = TOPT.cosine_schedule(3e-4, 1, 3)
    jstep = jax.jit(j_make_train_step(jc, lr=lr_j))
    tstep = make_train_step(tc, lr=lr_t)
    jo, to = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
    for s in range(3):
        toks = tokens(128, seed=s)
        jp, jo, jm = jstep(jp, jo, jnp.asarray(toks))
        tp, to, tm = tstep(tp, to, toks)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LEAF_TOL
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            LEAF_TOL * float(jm["grad_norm"])
    assert_leaves_close(tp, jp, LEAF_TOL)
    assert not any(t.requires_grad for t in bridge.flatten(tp).values())


def test_gradient_accumulation_equals_the_whole_batch(models):
    """Two microbatches of 2 against one batch of 4 (the dense config:
    its loss is a mean over tokens, so the two are the same function)."""
    _, tc, _, tp = models["dense"]
    toks = tokens(128, batch=4)
    outs = [make_train_step(tc, accum_steps=a)(tp, TOPT.adamw_init(tp),
                                                toks)
            for a in (1, 2)]
    (p1, _, m1), (p2, _, m2) = outs
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= \
        1e-5 * float(m1["grad_norm"])
    for k, v in bridge.flatten(p1).items():
        assert leaf_err(bridge.flatten(p2)[k], v.numpy()) <= 1e-5, k


def test_port_training_lowers_the_loss(models):
    _, tc, _, tp = models["tiny-moe"]
    step = make_train_step(tc, lr=TOPT.cosine_schedule(3e-3, 5, 20),
                           remat=False, capacity_factor=4.0)
    lm = TDATA.SyntheticLM(tc.vocab_size, name="train-test", branch=4)
    stream = TDATA.batches(lm, batch=8, seq_len=64, seed=0)
    opt, losses = TOPT.adamw_init(tp), []
    for _ in range(20):
        tp, opt, m = step(tp, opt, next(stream))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_cli_checkpoint_restores_in_the_jax_package(tmp_path, capsys):
    """python -m repro_torch.launch.train --device cpu --reduced, then
    the JAX package restores the checkpoint and its loss on the restored
    params equals the port's on the trained ones."""
    from repro.checkpoint import restore_checkpoint
    from repro_torch.checkpoint import restore_checkpoint as t_restore
    from repro_torch.launch import train
    path = str(tmp_path / "ck")
    arch = "granite-moe-1b-a400m"
    train.main(["--arch", arch, "--reduced", "--steps", "3", "--batch",
                "2", "--seq", "24", "--device", "cpu", "--ckpt", path])
    assert "saved" in capsys.readouterr().out
    jc, tc = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    target = bridge.init_params(tc, seed=9, device="cpu")
    jp = restore_checkpoint(path, jax.tree_util.tree_map(
        jnp.zeros_like, jax_params(target)))
    tp = t_restore(path, target)
    toks = tokens(tc.vocab_size, batch=1, seq=16, seed=5)
    want = float(JMD.loss_fn(jc, jp, jnp.asarray(toks), remat=False)[0])
    with torch.no_grad():
        got = float(TMD.loss_fn(tc, tp, torch.as_tensor(toks))[0])
    assert abs(got - want) <= LOSS_TOL


# (arch, batch, seq): the audio family's K-codebook frames and the VLM's
# prefix (musicgen-large's reduced config has a prefix_len too), and
# granite-moe at 1 x 4 tokens, whose MoE layers take the dense path
CLI_RUNS = [("musicgen-large", 2, 16), ("paligemma-3b", 2, 16),
            ("granite-moe-1b-a400m", 1, 4)]


@pytest.mark.parametrize("arch,batch,seq", CLI_RUNS,
                         ids=[a for a, _, _ in CLI_RUNS])
def test_cli_trains_on_the_references_inputs(arch, batch, seq, capsys,
                                             monkeypatch):
    """python -m repro_torch.launch.train --reduced --steps 1 on the CPU:
    its printed loss equals make_train_step's (remat off, as in the CLI)
    on the same batch (K codebook frames, (B, S, K), for the audio
    family, as the reference's CLI streams) and the same prefix, a
    (batch, prefix_len, d_model) N(0, 1) draw of a torch.Generator
    seeded with --seed, drawn here on its own, for a config with
    prefix_len. The MoE model at 1 x 4 tokens runs moe_ffn's gradient
    once per layer and grouped_ffn never; the dense families neither."""
    import sys
    from repro_torch.launch import train
    km = sys.modules["repro_torch.kernels.moe_ffn"]
    calls = {"moe_ffn_bwd": 0, "grouped_ffn": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(km, "moe_ffn_bwd",
                        counting("moe_ffn_bwd", km.moe_ffn_bwd))
    monkeypatch.setattr(km, "_grouped_ffn",
                        counting("grouped_ffn", km._grouped_ffn))
    train.main(["--arch", arch, "--reduced", "--steps", "1", "--batch",
                str(batch), "--seq", str(seq), "--seed", "3", "--device",
                "cpu"])
    printed = next(ln for ln in capsys.readouterr().out.splitlines()
                   if ln.startswith("step")).split()[3]
    cli_calls = dict(calls)
    tc = ARCHS[arch].reduced()
    books = tc.num_codebooks if tc.family == "audio" else 1
    toks = next(TDATA.batches(TDATA.SyntheticLM(tc.vocab_size, name=arch),
                              batch=batch, seq_len=seq, seed=3,
                              num_codebooks=books))
    assert toks.shape == (batch, seq) + ((books,) if books > 1 else ())
    prefix = None
    if tc.prefix_len:
        prefix = torch.randn((batch, tc.prefix_len, tc.d_model),
                             generator=torch.Generator().manual_seed(3))
    params = bridge.init_params(tc, seed=3, device="cpu")
    _, _, m = make_train_step(tc, remat=False)(
        params, TOPT.adamw_init(params), toks, prefix)
    assert printed == f"{float(m['loss']):.4f}"
    layers = tc.num_layers if tc.family == "moe" else 0
    assert cli_calls == {"moe_ffn_bwd": layers, "grouped_ffn": 0}


def test_prefix_embeds_and_unported_train_inputs_raise(models):
    """A train step whose batch is not a multiple of accum_steps raises
    ValueError, with prefix embeddings too (they are split with the
    tokens); with a batch that splits, the prefix reaches the loss."""
    _, tc, _, tp = models["tiny-moe"]
    with pytest.raises(ValueError):
        make_train_step(tc, accum_steps=3)(tp, TOPT.adamw_init(tp),
                                           tokens(128, batch=4))
    pe = torch.ones((4, 3, tc.d_model))
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(tc, accum_steps=3)(tp, TOPT.adamw_init(tp),
                                           tokens(128, batch=4), pe)
    _, _, m = make_train_step(tc, accum_steps=2)(
        tp, TOPT.adamw_init(tp), tokens(128, batch=4), pe)
    with torch.no_grad():
        plain = TMD.loss_fn(tc, tp, torch.as_tensor(tokens(128, batch=4)))[0]
    assert torch.isfinite(m["loss"]) and float(m["loss"]) != float(plain)


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_and_hybrid_train_on_the_cpu(name):
    """The SSM and hybrid families train on the CPU through SsdScan (the
    plain scan forward, ssd_scan_bwd_plain backward; on the card the two
    kernels, tests/test_torch_gpu.py): remat on and off give the same
    loss and gradients, and the SSM weights get one. Their gradients
    against jax.grad are in tests/test_torch_ssd_bwd.py."""
    from repro_torch.launch.train import loss_and_grads
    cfg = ARCHS[name].reduced(num_layers=2, max_d_model=64, max_vocab=128)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(tokens(128, batch=2, seq=20))
    (l0, g0), (l1, g1) = (loss_and_grads(cfg, params, toks, remat=r)
                          for r in (False, True))
    assert torch.isfinite(l0) and float(l0) == float(l1)
    f0, f1 = bridge.flatten(g0), bridge.flatten(g1)
    for k in f0:
        torch.testing.assert_close(f1[k], f0[k], atol=1e-6, rtol=1e-5)
    for k in ("in_x", "in_dt", "A_log", "out_proj"):
        assert float(f0[f"layers/ssm/{k}"].abs().max()) > 0, k
