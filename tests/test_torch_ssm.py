"""The port's SSM and hybrid families against the JAX package on the CPU.

- the SSD scan's plain version against the Pallas kernel (interpret
  mode) and its sequential oracle with heads pre-broadcast (g = nh, the
  Pallas contract), and against ``ssm.ssd_chunked`` with groups, an
  initial state and a ragged last chunk;
- the Mamba2 block (full sequence and one-token recurrence);
- reduced mamba2-370m and zamba2-1.2b (attn_every 2: three shared-block
  applications, the last group ragged): forward logits, prefill plus 8
  decode steps with per-slot active masks, every cache key, and cache
  surgery.

Tolerances: the scan 1e-4 in f32 (tests/test_kernels.py,
tests/test_ssm.py: chunked against sequential) and 5e-2 in bf16; model
logits 2e-5 in f32. Same weights on both sides (JAX init, carried over
by the bridge), inputs from numpy."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.kernels.ops import ssd_chunk_scan  # noqa: E402
from repro.kernels.ref import ssd_chunk_ref  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

SCAN_TOL = {"f32": 1e-4, "bf16": 5e-2}
LOGIT_TOL = 2e-5
NAMES = ["mamba2-370m", "zamba2-1.2b"]


def small(archs, name):
    if name == "zamba2-1.2b":
        return dataclasses.replace(
            archs[name].reduced(num_layers=5, max_d_model=128,
                                max_vocab=256), attn_every=2)
    return archs[name].reduced(num_layers=2, max_d_model=128, max_vocab=256)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def scan_inputs(seed, B, S, nh, hd, g, ds, init=False, dt_shift=0.0):
    """f32 numpy inputs of the scan, drawn as tests/test_kernels.py does;
    dt = softplus(randn + dt_shift)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, nh)) + dt_shift,
                      0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, g, ds)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, g, ds)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((B, nh, hd, ds)) * 0.2).astype(np.float32) \
        if init else None
    return x, dt, A, Bm, Cm, st


def torch_scan(x, dt, A, Bm, Cm, st, *, chunk, dtype=torch.float32):
    return K.ssd_scan_plain(
        torch.tensor(x).to(dtype), torch.tensor(dt), torch.tensor(A),
        torch.tensor(Bm).to(dtype), torch.tensor(Cm).to(dtype), chunk=chunk,
        init_state=None if st is None else torch.tensor(st))


# ------------------------------------------------------------ the scan ----

@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,bh", [
    (2, 64, 4, 32, 16, 16, 2), (1, 100, 8, 64, 32, 32, 8),
    (2, 256, 2, 64, 128, 128, 2), (1, 48, 4, 32, 64, 64, 4),
])
def test_ssd_scan_plain_matches_pallas_and_ref(B, S, nh, hd, ds, chunk, bh):
    """The sweeps of tests/test_kernels.py, heads pre-broadcast (g = nh)."""
    x, dt, A, Bm, Cm, _ = scan_inputs(S, B, S, nh, hd, nh, ds)
    y, st = torch_scan(x, dt, A, Bm, Cm, None, chunk=chunk)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    yk, sk = ssd_chunk_scan(*jargs, chunk=chunk, block_h=bh, interpret=True)
    yr, sr = ssd_chunk_ref(*jargs)
    for ref_y, ref_s in ((yk, sk), (yr, sr)):
        close(y, ref_y, SCAN_TOL["f32"])
        close(st, ref_s, SCAN_TOL["f32"])


def test_ssd_scan_plain_bf16_matches_pallas_and_ref():
    B, S, nh, hd, ds = 1, 64, 2, 32, 16
    x, dt, A, Bm, Cm, _ = scan_inputs(7, B, S, nh, hd, nh, ds)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
          for a in (x, Bm, Cm)]                       # the bf16 values
    y, st = torch_scan(bf[0], dt, A, bf[1], bf[2], None, chunk=32,
                       dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
             jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16))
    yk, sk = ssd_chunk_scan(*jargs, chunk=32, block_h=2, interpret=True)
    yr, sr = ssd_chunk_ref(*jargs)
    for ref_y, ref_s in ((yk, sk), (yr, sr)):
        close(y, ref_y, SCAN_TOL["bf16"])
        close(st, ref_s, SCAN_TOL["bf16"])


@pytest.mark.parametrize("B,S,nh,hd,g,ds,chunk,init", [
    (2, 70, 4, 32, 1, 16, 32, True),     # ragged tail, shared group, state
    (1, 100, 8, 32, 2, 16, 32, False),   # two groups
    (2, 37, 4, 16, 4, 8, 64, True),      # one chunk shorter than chunk
    (1, 24, 2, 16, 1, 8, 8, True),       # chunk-aligned
])
def test_ssd_scan_plain_matches_ssd_chunked(B, S, nh, hd, g, ds, chunk,
                                            init):
    """The model's own function: Bm / Cm per group, an initial state, a
    sequence that is not a chunk multiple."""
    x, dt, A, Bm, Cm, st0 = scan_inputs(S + g, B, S, nh, hd, g, ds, init)
    y, st = torch_scan(x, dt, A, Bm, Cm, st0, chunk=chunk)
    yr, sr = jax.jit(JS.ssd_chunked, static_argnums=5)(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), chunk,
        init_state=None if st0 is None else jnp.asarray(st0))
    close(y, yr, SCAN_TOL["f32"])
    close(st, sr, SCAN_TOL["f32"])


@pytest.mark.parametrize("B,S,nh,hd,g,ds,chunk,init", [
    (2, 100, 4, 32, 1, 16, 32, False),   # ragged tail, no initial state
    (1, 70, 4, 32, 2, 16, 16, True),     # two groups, initial state
])
def test_ssd_scan_plain_matches_ssd_chunked_small_dt(B, S, nh, hd, g, ds,
                                                     chunk, init):
    """dt ~ 0.01, Mamba2's own range: a chunk decays by only ~exp(-0.3),
    so the state carried across chunks dominates the later ones."""
    x, dt, A, Bm, Cm, st0 = scan_inputs(S + 5, B, S, nh, hd, g, ds, init,
                                        dt_shift=-5.0)
    y, st = torch_scan(x, dt, A, Bm, Cm, st0, chunk=chunk)
    yr, sr = jax.jit(JS.ssd_chunked, static_argnums=5)(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), chunk,
        init_state=None if st0 is None else jnp.asarray(st0))
    close(y, yr, SCAN_TOL["f32"])
    close(st, sr, SCAN_TOL["f32"])


def test_ssd_scan_wrapper_routes_by_device():
    """A CPU tensor takes the plain version (no launch counted), and so
    does a meta tensor, whose outputs have the plain version's shapes and
    dtypes; a device with no kernel raises."""
    x, dt, A, Bm, Cm, st0 = scan_inputs(3, 1, 20, 2, 32, 1, 16, True)
    before = K.ssd_scan.launches
    args = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    y, st = K.ssd_scan(*args, chunk=8, init_state=torch.tensor(st0))
    yp, sp = K.ssd_scan_plain(*args, chunk=8, init_state=torch.tensor(st0))
    assert torch.equal(y, yp) and torch.equal(st, sp)
    ym, sm = K.ssd_scan(*[a.to("meta") for a in args], chunk=8)
    assert (ym.device.type, ym.shape, ym.dtype) == ("meta", y.shape, y.dtype)
    assert (sm.shape, sm.dtype) == (st.shape, st.dtype)
    assert K.ssd_scan.launches == before
    assert "ssd_scan" in K.KERNELS

    class Elsewhere:        # a tensor on a device with no kernel
        device = torch.device("xpu")
    with pytest.raises(ValueError):
        K.ssd_scan(Elsewhere(), *args[1:], chunk=8)


# ---------------------------------------------------------- the block -----

CFG = (JSSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=2,
                  chunk_size=8),
       SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=2,
                 chunk_size=8))
D = 64


@pytest.fixture(scope="module")
def block():
    jp = JS.init_ssm(jax.random.PRNGKey(0), CFG[0], D, jnp.float32)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 0.3),
              A_log=jnp.linspace(-0.5, 0.5, jp["A_log"].shape[0]))
    tp = bridge.from_numpy(to_np(jp), device="cpu")
    x = (np.random.default_rng(1).standard_normal((2, 21, D)) * 0.5
         ).astype(np.float32)
    return jp, tp, x


def test_ssm_forward_and_decode_match_jax(block):
    jp, tp, x = block
    jforward = jax.jit(JS.ssm_forward, static_argnums=(2, 3, 4))
    jdecode = jax.jit(JS.ssm_decode, static_argnums=(3, 4, 5))
    jy, ((jcx, jcB, jcC), jst) = jforward(jp, jnp.asarray(x[:, :18]),
                                          CFG[0], D, 1e-5)
    ty, ((tcx, tcB, tcC), tst) = TS.ssm_forward(tp, torch.tensor(x[:, :18]),
                                                CFG[1], D, 1e-5)
    close(ty, jy, SCAN_TOL["f32"])
    for t, j in ((tcx, jcx), (tcB, jcB), (tcC, jcC), (tst, jst)):
        close(t, j, SCAN_TOL["f32"])
    jc, tc = ((jcx, jcB, jcC), jst), ((tcx, tcB, tcC), tst)
    for t in range(18, 21):
        jy, jc = jdecode(jp, jnp.asarray(x[:, t]), jc, CFG[0], D, 1e-5)
        ty, tc = TS.ssm_decode(tp, torch.tensor(x[:, t]), tc, CFG[1], D,
                               1e-5)
        close(ty, jy, SCAN_TOL["f32"])
        close(tc[1], jc[1], SCAN_TOL["f32"])


def test_ssm_full_equals_prefill_then_decode_and_continuation(block):
    """Inside the port: S tokens at once == S-3 tokens then 3 recurrence
    steps, and == two segments, the second from the first's conv tails
    and state (tests/test_ssm.py, mirrored)."""
    _, tp, x = block
    xt = torch.tensor(x)
    y_full, (conv_full, st_full) = TS.ssm_forward(tp, xt, CFG[1], D, 1e-5)
    cut = 18
    y1, cache = TS.ssm_forward(tp, xt[:, :cut], CFG[1], D, 1e-5)
    close(y1, y_full[:, :cut].numpy(), 1e-4)
    outs = []
    for t in range(cut, xt.shape[1]):
        y_t, cache = TS.ssm_decode(tp, xt[:, t], cache, CFG[1], D, 1e-5)
        outs.append(y_t)
    close(torch.stack(outs, 1), y_full[:, cut:].numpy(), 1e-4)
    conv1, st1 = TS.ssm_forward(tp, xt[:, :13], CFG[1], D, 1e-5)[1]
    y2, (conv2, st2) = TS.ssm_forward(tp, xt[:, 13:], CFG[1], D, 1e-5,
                                      init_conv=conv1, init_state=st1)
    close(y2, y_full[:, 13:].numpy(), 1e-4)
    close(st2, st_full.numpy(), 1e-4)
    for a, b in zip(conv2, conv_full):
        assert torch.equal(a, b)


def test_softplus_matches_jax_above_20():
    v = np.array([-30.0, -1.0, 0.0, 5.0, 19.9, 20.5, 40.0], np.float32)
    close(TS.softplus(torch.tensor(v)), jax.nn.softplus(jnp.asarray(v)), 1e-6)


# ---------------------------------------------------------- the models ----

@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    jcfg, tcfg = small(JARCHS, name), small(ARCHS, name)
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(to_np(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_reduced_configs_cover_the_shapes_they_claim(pair):
    jcfg, tcfg, _, _ = pair
    assert tcfg.ssm.chunk_size == 32 and tcfg.ssm.d_state == 16 and \
        tcfg.ssm.head_dim == 32
    if tcfg.family == "hybrid":
        assert TMD._num_shared_apps(tcfg) == JMD._num_shared_apps(jcfg) == 3
        assert TMD._ssm_segments(tcfg) == [(0, 0, 2), (1, 2, 4), (2, 4, 5)]
        full = ARCHS["zamba2-1.2b"]
        segs = TMD._ssm_segments(full)
        assert len(segs) == 7 and segs[-1] == (6, 36, 38)
    else:
        assert TMD._ssm_segments(tcfg) == [(None, 0, 2)]


def test_forward_matches_jax(pair):
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40))
    ref, _ = jax.jit(lambda p, t: JMD.forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    out, aux = TMD.forward(tcfg, tp, torch.tensor(toks))
    close(out, ref, LOGIT_TOL)
    assert aux == {}


def test_prefill_and_decode_steps_match_jax(pair):
    """70-token prompts (two chunks of 32 and a tail), then 8 decode steps
    with per-slot active masks: logits within 2e-5 and every cache key
    equal after each step."""
    jcfg, tcfg, jp, tp = pair
    B, S = 3, 70
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc, _ = jax.jit(lambda p, t: JMD.prefill(jcfg, p, t, cache_len=96))(
        jp, jnp.asarray(prompts))
    tl, tc, aux = TMD.prefill(tcfg, tp, torch.tensor(prompts), cache_len=96)
    jdecode = jax.jit(lambda c, t, a: JMD.decode_step(jcfg, jp, t, c,
                                                      active=a))
    close(tl, jl, LOGIT_TOL)
    assert aux == {} and sorted(tc) == sorted(jc)
    keys = {"ssm": {"cur_len", "conv_x", "conv_B", "conv_C", "state"}}
    keys["hybrid"] = keys["ssm"] | {"shared_k", "shared_v"}
    assert set(tc) == keys[tcfg.family]
    assert tc["state"].dtype == torch.float32
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(8):
        active = np.ones(B, bool)
        active[step % B] = step < 5          # slots drop in and out
        jl, jc, _ = jdecode(jc, jnp.asarray(tok[:, None]),
                            jnp.asarray(active))
        tl, tc, _ = TMD.decode_step(tcfg, tp, torch.tensor(tok[:, None]), tc,
                                    active=torch.tensor(active))
        close(tl, jl, LOGIT_TOL)
        np.testing.assert_array_equal(tc["cur_len"].numpy(),
                                      np.asarray(jc["cur_len"]))
        for key in sorted(set(tc) - {"cur_len"}):
            close(tc[key], jc[key], LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)


def test_cache_surgery_matches_jax(pair):
    """insert_request and evict_slot(scrub=True) cover every new key."""
    jcfg, tcfg, jp, tp = pair
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    _, jreq, _ = jax.jit(lambda p, t: JMD.prefill(jcfg, p, t, cache_len=16))(
        jp, jnp.asarray(prompts))
    _, treq, _ = TMD.prefill(tcfg, tp, torch.tensor(prompts), cache_len=16)
    jb = JMD.init_cache(jcfg, 3, 16, jnp.float32)
    tb = TMD.init_cache(tcfg, 3, 16, torch.float32)
    assert {k: tuple(v.shape) for k, v in tb.items()} == \
        {k: tuple(v.shape) for k, v in jb.items()}
    jb = JMD.insert_request(jb, jreq, 2, src=1)
    tb = TMD.insert_request(tb, treq, 2, src=1)
    for key in jb:
        close(tb[key], jb[key], LOGIT_TOL)
    assert tb["cur_len"].tolist() == [0, 0, 10]
    tb = TMD.evict_slot(tb, 2)
    assert tb["cur_len"].tolist() == [0, 0, 0]
    assert float(tb["state"][:, 2].abs().max()) > 0
    jb = JMD.evict_slot(jb, 2, scrub=True)
    tb = TMD.evict_slot(tb, 2, scrub=True)
    for key in jb:
        assert float(tb[key][:, 2].abs().max() if key != "cur_len"
                     else tb[key][2]) == 0.0, key
        close(tb[key], jb[key], 0)
