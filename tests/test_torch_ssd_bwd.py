"""The SSD scan's gradient on the CPU: ``ssd_scan_bwd_plain`` (the
specification the CUDA kernel csrc/ssd_scan_bwd.cu is held to on the
card, tests/test_torch_gpu.py) against ``jax.vjp`` of the JAX package's
``models/ssm.py ssd_chunked`` and against ``torch.autograd`` of the
port's own ``ssd_scan_plain``; ``ssd_scan``'s routing through
``SsdScan`` under autograd; and the reduced mamba2-370m and zamba2-1.2b
loss gradients against ``jax.grad`` of the JAX ``loss_fn``.

Inputs come from numpy seeds. dt is drawn as softplus(randn - 5) (~0.007,
real Mamba2's range) where the JAX reference is the yardstick: at large
dt (softplus(randn), ~0.8) and long chunks its ddt and dA are NaN (it
takes exp before masking, models/ssm.py:123, and 0 · inf = NaN in the
masked branch's gradient), so there the port is held to float64
autograd of its own plain forward instead, and a test shows both sides.
Tolerances, of each gradient's largest magnitude: 2e-5 in f32, 2e-2
with bf16 inputs (their rounding of y, dx, dB and dC), 1e-10 in
float64, 1e-4 for the loss gradients (tests/test_torch_train.py's
LEAF_TOL).

The kernel's precision plan is pinned here too: it takes every f32
product on the tensor cores as three TF32 products (3xTF32, csrc/
common.cuh), and ``ssd_scan_bwd_plain`` with its products rounded that
way stays within the card's f32 gate (1e-4) of float64, where a single
TF32 product does not."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402

TOL = {"f32": 2e-5, "bf16": 2e-2, "f64": 1e-10}
LEAF_TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "d_init_state")


def inputs(seed, B, S, nh, hd, g, ds, *, init, d_final, dt_shift=-5.0):
    """x, dt, A, Bm, Cm, init_state, dy, d_final as float64 numpy arrays
    (init_state and d_final None unless asked for)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return rng.standard_normal(shape) * scale
    x = r(B, S, nh, hd, scale=0.5)
    dt = np.logaddexp(r(B, S, nh) + dt_shift, 0.0)          # softplus
    A = -np.exp(r(nh, scale=0.3))
    Bm, Cm = r(B, S, g, ds, scale=0.3), r(B, S, g, ds, scale=0.3)
    st = r(B, nh, hd, ds, scale=0.2) if init else None
    dy = r(B, S, nh, hd)
    df = r(B, nh, hd, ds) if d_final else None
    return x, dt, A, Bm, Cm, st, dy, df


def rel_err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def port_bwd(arrs, chunk, dtype):
    """ssd_scan_bwd_plain on the arrays, x, Bm, Cm and dy in ``dtype``."""
    x, dt, A, Bm, Cm, st, dy, df = arrs
    t = lambda a, dt_=torch.float32: None if a is None else \
        torch.tensor(a).to(dt_)                             # noqa: E731
    return K.ssd_scan_bwd_plain(
        t(x, dtype), t(dt), t(A), t(Bm, dtype), t(Cm, dtype), t(dy, dtype),
        chunk=chunk, init_state=t(st), d_final=t(df))


def jax_bwd(arrs, chunk, dtype):
    """jax.vjp of ssd_chunked on the same arrays (a zero cotangent on the
    final state for d_final None); d_init_state None without init."""
    x, dt, A, Bm, Cm, st, dy, df = arrs
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    f32 = jnp.float32
    prim = [jnp.asarray(x, jd), jnp.asarray(dt, f32), jnp.asarray(A, f32),
            jnp.asarray(Bm, jd), jnp.asarray(Cm, jd)]
    if st is not None:
        prim.append(jnp.asarray(st, f32))

    def f(*a):
        return ssd_chunked(*a[:5], chunk, a[5] if len(a) > 5 else None)

    @jax.jit
    def grads(dy_, df_, *a):
        (_, fin), vjp = jax.vjp(f, *a)
        return vjp((dy_, jnp.zeros_like(fin) if df_ is None else df_))
    got = grads(jnp.asarray(dy, jd), None if df is None
                else jnp.asarray(df, f32), *prim)
    return [np.asarray(jnp.asarray(g_, f32)) for g_ in got]


# (B, S, nh, hd, g, ds, chunk): a ragged last chunk in every case
SHAPES = [(2, 70, 4, 32, 1, 16, 32), (2, 70, 4, 32, 2, 16, 32),
          (1, 37, 2, 32, 2, 16, 16)]


@pytest.mark.parametrize("init,d_final", [(False, False), (True, False),
                                          (False, True), (True, True)],
                         ids=["none", "init", "dfinal", "both"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["g1", "g2", "g2-short"])
def test_plain_backward_matches_jax_vjp(shape, init, d_final):
    """f32: every gradient within 2e-5 of its largest magnitude."""
    arrs = inputs(sum(shape), *shape[:6], init=init, d_final=d_final)
    got = port_bwd(arrs, shape[6], torch.float32)
    want = jax_bwd(arrs, shape[6], torch.float32)
    if not init:
        got = got[:5]
    assert len(got) == len(want)
    for name, g_, w in zip(NAMES, got, want):
        assert g_.dtype == torch.float32
        assert rel_err(g_, w) <= TOL["f32"], (name, rel_err(g_, w))


@pytest.mark.parametrize("g", [1, 2])
def test_plain_backward_bf16_inputs_match_jax_vjp(g):
    """x, Bm, Cm and dy in bf16: dx, dBm, dCm come back in bf16, and
    every gradient is within 2e-2 of its largest magnitude."""
    shape = (2, 70, 4, 32, g, 16, 32)
    arrs = inputs(5 + g, *shape[:6], init=True, d_final=True)
    got = port_bwd(arrs, 32, torch.bfloat16)
    want = jax_bwd(arrs, 32, torch.bfloat16)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    for name, g_, w in zip(NAMES, got, want):
        assert rel_err(g_, w) <= TOL["bf16"], (name, rel_err(g_, w))


def autograd_plain(arrs, chunk, dtype=torch.float64):
    """torch.autograd of ssd_scan_plain on the arrays, in ``dtype``."""
    x, dt, A, Bm, Cm, st, dy, df = arrs
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (x, dt, A, Bm, Cm) + ((st,) if st is not None
                                             else ())]
    y, fin = K.ssd_scan_plain(*leaves[:5], chunk=chunk,
                              init_state=leaves[5] if st is not None
                              else None)
    outs, cots = [y], [torch.tensor(dy, dtype=dtype)]
    if df is not None:
        outs.append(fin)
        cots.append(torch.tensor(df, dtype=dtype))
    return torch.autograd.grad(outs, leaves, cots)


@pytest.mark.parametrize("dt_shift", [0.0, -5.0], ids=["dt0.8", "dt0.007"])
@pytest.mark.parametrize("shape", [(1, 300, 2, 32, 1, 16, 256),
                                   (2, 70, 4, 32, 2, 16, 32)],
                         ids=["chunk256", "chunk32"])
def test_plain_backward_matches_float64_autograd(shape, dt_shift):
    """In float64 the written-out gradient is autograd's of the plain
    forward to rounding, at large dt too (chunk 256, dt ~ 0.8: a chunk
    decays by exp(-100) and cum_i - cum_j reaches ~+200 above the
    diagonal)."""
    arrs = inputs(11, *shape[:6], init=True, d_final=True,
                  dt_shift=dt_shift)
    chunk = shape[6]
    got = K.ssd_scan_bwd_plain(
        *[torch.tensor(a) for a in arrs[:5]], torch.tensor(arrs[6]),
        chunk=chunk, init_state=torch.tensor(arrs[5]),
        d_final=torch.tensor(arrs[7]))
    want = autograd_plain(arrs, chunk)
    for name, g_, w in zip(NAMES, got, want):
        assert g_.dtype == torch.float64
        assert rel_err(g_, w.numpy()) <= TOL["f64"], name


def test_jax_reference_gradient_is_nan_at_large_decay_and_the_ports_is_not():
    """The reference's own fault (models/ssm.py:123 takes exp(seg) before
    the mask): at dt ~ 0.8 and a chunk of 256, jax.vjp gives NaN in ddt
    and dA, while dx, dBm, dCm and d_init_state stay finite and agree.
    The port masks before exp: every gradient finite and equal to
    float64 autograd of its plain forward within 2e-5."""
    shape = (1, 300, 2, 32, 1, 16, 256)
    arrs = inputs(3, *shape[:6], init=True, d_final=False, dt_shift=0.0)
    jg = jax_bwd(arrs, 256, torch.float32)
    assert np.isnan(jg[1]).any() and np.isnan(jg[2]).any()
    got = port_bwd(arrs, 256, torch.float32)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    want = autograd_plain(arrs, 256)
    for name, g_, w in zip(NAMES, got, want):
        assert rel_err(g_, w.numpy()) <= TOL["f32"], name
    for i in (0, 3, 4, 5):                  # JAX's finite gradients agree
        assert np.isfinite(jg[i]).all()
        assert rel_err(got[i], jg[i]) <= TOL["f32"], NAMES[i]


def test_ssd_scan_under_autograd_routes_to_ssd_scan_fn():
    """On the CPU, with inputs that require grad, ssd_scan is SsdScan: no
    launch is counted, its gradient is ssd_scan_bwd_plain's bit for bit
    (init_state's too; None for an input that was None), and under
    no_grad it is the plain forward. On meta the backward propagates
    shapes and dtypes."""
    arrs = inputs(7, 2, 40, 4, 32, 2, 16, init=True, d_final=True)
    x, dt, A, Bm, Cm, st, dy, df = (torch.tensor(a, dtype=torch.float32)
                                    for a in arrs)
    before = K.launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, st)]
    y, fin = K.ssd_scan(*leaves[:5], chunk=16, init_state=leaves[5])
    assert type(y.grad_fn).__name__ == "SsdScanBackward"
    got = torch.autograd.grad((y, fin), leaves, (dy, df))
    want = K.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=16,
                                init_state=st, d_final=df)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    # the final state unread (the train path): d_final None
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y, _ = K.ssd_scan(*leaves, chunk=16)
    got = torch.autograd.grad(y, leaves, dy)
    want = K.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=16)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    with torch.no_grad():
        y0, _ = K.ssd_scan(*leaves, chunk=16)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())
    meta = [t.to("meta").requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    ym, _ = K.ssd_scan(*meta, chunk=16)
    gm = torch.autograd.grad(ym, meta, torch.empty_like(ym))
    for g_, t in zip(gm, (x, dt, A, Bm, Cm)):
        assert (g_.device.type, g_.shape, g_.dtype) == ("meta", t.shape,
                                                        t.dtype)
    assert K.launch_counts() == before


# ------------------------------------------- the loss gradient, reduced

SSM_NAMES = ["mamba2-370m", "zamba2-1.2b"]


def reduced(archs, name):
    """2 layers, d 64 (head dim 32, state 16, chunk 32)."""
    return archs[name].reduced(num_layers=2, max_d_model=64, max_vocab=128)


@pytest.fixture(scope="module")
def ssm_grads():
    """(port config, port params, tokens, JAX loss, JAX grads) per arch:
    2 x 70 tokens, so three chunks of 32 with a ragged last one."""
    out = {}
    toks = np.random.default_rng(4).integers(0, 128, (2, 70))
    for name in SSM_NAMES:
        jc, tc = reduced(JARCHS, name), reduced(ARCHS, name)
        tp = bridge.init_params(tc, seed=0, device="cpu")
        jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
        f = jax.jit(jax.value_and_grad(
            lambda p: JMD.loss_fn(jc, p, jnp.asarray(toks), remat=False)[0]))
        out[name] = (tc, tp, toks, *f(jp))
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", SSM_NAMES)
def test_ssm_loss_gradient_matches_jax_for_every_leaf(ssm_grads, name,
                                                      remat):
    """loss_and_grads of the reduced model (SsdScan with
    ssd_scan_bwd_plain at each SSM layer) against jax.grad of the JAX
    loss_fn: the loss within 2e-5, every leaf within 1e-4 of its largest
    magnitude, remat on and off."""
    tc, tp, toks, jl, jg = ssm_grads[name]
    assert tc.ssm.chunk_size == 32 and toks.shape[1] % 32
    loss, grads = loss_and_grads(tc, tp, torch.as_tensor(toks), remat=remat)
    assert abs(float(loss) - float(jl)) <= 2e-5
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = bridge.flatten(grads)
    assert sorted(jflat) == sorted(tflat)
    errs = {k: rel_err(tflat[k], jflat[k]) for k in jflat}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_TOL, (worst, errs[worst])
    assert float(tflat["layers/ssm/A_log"].abs().max()) > 0


# --------------------------------------- the CUDA kernel's precision plan

def tf32(t):
    """f32 rounded to TF32 as cvt.rna.tf32.f32 rounds: 10 mantissa bits,
    ties away from zero (half an ulp added to the magnitude's bits, the
    13 low bits cleared)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_einsum(real, split, calls):
    """torch.einsum with every two-operand f32 product taken as the
    kernel's mma.sync takes it: split (a = hi + lo, hi = tf32(a), lo =
    tf32(a - hi); lo·hi + hi·lo + hi·hi summed in f32, in that order) or
    a single TF32 product hi·hi. Other calls go to ``real``."""
    def einsum(eq, *ops):
        if len(ops) != 2 or any(o.dtype != torch.float32 for o in ops):
            return real(eq, *ops)
        calls.append(eq)
        a, b = ops
        ah, bh = tf32(a), tf32(b)
        if not split:
            return real(eq, ah, bh)
        al, bl = tf32(a - ah), tf32(b - bh)
        return real(eq, al, bh) + real(eq, ah, bl) + real(eq, ah, bh)
    return einsum


@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "1xtf32"])
@pytest.mark.parametrize("nh,ds,chunk", [(4, 128, 256), (8, 64, 128)],
                         ids=["mamba2", "zamba2"])
def test_tf32_split_holds_the_f32_gate_and_one_tf32_product_does_not(
        monkeypatch, nh, ds, chunk, split):
    """At mamba2-370m's widths reduced to 4 heads (hd 64, ds 128, chunk
    256) and zamba2-1.2b's reduced to 8 (ds 64, chunk 128), S 512, dt ~
    0.8 (the train phases' draw), dy 0 at the last position:
    ssd_scan_bwd_plain in f32 with every two-operand product split as
    3xTF32 keeps every gradient within 1e-4 of its largest magnitude of
    float64 (SCAN_BWD_TOL, the kernel's f32 gate on the card); with a
    single TF32 product some gradient misses it."""
    x, dt, A, Bm, Cm, _, dy, _ = inputs(25, 1, 512, nh, 64, 1, ds,
                                        init=False, d_final=False,
                                        dt_shift=0.0)
    dy[:, -1] = 0
    arrs = (x, dt, A, Bm, Cm, dy)
    exact = K.ssd_scan_bwd_plain(*[torch.tensor(a) for a in arrs],
                                 chunk=chunk)
    calls = []
    monkeypatch.setattr(torch, "einsum",
                        tf32_einsum(torch.einsum, split, calls))
    got = K.ssd_scan_bwd_plain(
        *[torch.tensor(a, dtype=torch.float32) for a in arrs], chunk=chunk)
    assert len(calls) >= 9     # every product of the plain version
    errs = {n: rel_err(g_, w.numpy()) for n, g_, w in zip(NAMES, got, exact)}
    if split:
        assert max(errs.values()) <= 1e-4, errs
    else:
        assert max(errs.values()) > 1e-4, errs
