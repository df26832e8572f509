"""The port's launch layer and the helpers the JAX package exports,
against the JAX package on the CPU: ``Engine.make_scheduler(decode_chunk=)``
(plain and speculative), ``configs.shapes``, ``kernels.ops`` (the byte
models exactly; each wrapper against the JAX one, whose Pallas kernel
runs in interpret mode), ``models.param_count``, ``models.moe.init_moe``,
``core.routing``'s ``router_probs`` and ``dispatch_combine_weights``,
``launch.serve`` (``make_prefill``, ``make_serve_step`` and the CLI),
``launch.inputs`` and ``launch.roofline``.

Weights come from JAX through the bridge; inputs from numpy seeds.
Tolerances: tests/test_kernels.py's (2e-5 f32, 2e-2 bf16; the SSD scan
1e-4 / 5e-2); integer outputs and pure arithmetic exact (the roofline's
float formulas within a relative 1e-12)."""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import XSharePolicy as JPolicy  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.core import routing as JR  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.launch import inputs as JIN  # noqa: E402
from repro.launch import roofline as JRF  # noqa: E402
from repro.launch import serve as JSERVE  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs.base import XSharePolicy  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: E402
from repro_torch.core import routing as TR  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.launch import inputs as TIN  # noqa: E402
from repro_torch.launch import roofline as TRF  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import param_count  # noqa: E402
from repro_torch.models.dispatch import (dispatch_plan,  # noqa: E402
                                         gather_tokens)
from repro_torch.models.moe import init_moe  # noqa: E402
from repro_torch.serving import Engine, SpecScheduler  # noqa: E402

MOE = "granite-moe-1b-a400m"
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SCAN_TOL = {"f32": 1e-4, "bf16": 5e-2}
MODES = ("off", "batch", "spec", "ep")


def small(archs, name=MOE):
    return archs[name].reduced(num_layers=2, max_d_model=128, max_vocab=256)


def to_torch(tree):
    return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def both(a, name):
    """One f32 numpy array as the same values in JAX and in torch."""
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def dtype_name(dt) -> str:
    """A torch or numpy dtype in numpy's spelling."""
    return str(dt).replace("torch.", "")


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = small(JARCHS), small(ARCHS)
    jp = j_init(jcfg, jax.random.PRNGKey(1))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=to_torch(jp))


# ------------------------------------- make_scheduler(decode_chunk=) ---

def scheduled(eng, prompts, lens, **kw):
    sched = eng.make_scheduler(num_slots=2, decode_chunk=4, **kw)
    for p, n in zip(prompts, lens):
        sched.submit(p, n)
    states = sched.run()
    return sched, [(np.stack(s.tokens), s.finish_reason) for s in states]


@pytest.mark.parametrize("spec", [False, True])
def test_make_scheduler_takes_a_decode_chunk_like_jax(moe, spec):
    """An engine built with decode_chunk 8 gives a scheduler of chunk 4
    (a SpecScheduler with a draft model): four requests through two
    slots give the JAX scheduler's tokens and finish reasons. The engine
    builds one bundle of step functions per chunk and keeps it."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, moe["tcfg"].vocab_size, size=s)
               .astype(np.int32) for s in (12, 9, 12, 15)]
    lens = [6, 13, 10, 7]
    kw = dict(cache_len=64, decode_chunk=8)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if spec:
        jkw.update(draft=(moe["jcfg"], moe["jp"]), spec_len=2)
        tkw.update(draft=(moe["tcfg"], moe["tp"]), spec_len=2)
    jeng = JEngine(moe["jcfg"], moe["jp"], **jkw)
    teng = Engine(moe["tcfg"], moe["tp"], **tkw)
    _, want = scheduled(jeng, prompts, lens)
    sched, got = scheduled(teng, prompts, lens)
    assert isinstance(sched, SpecScheduler) == spec
    assert sched.fns.decode_chunk == 4
    for (gt, gr), (wt, wr) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        assert gr == wr == "completed"
    sched.release()
    again = teng.make_scheduler(num_slots=2, decode_chunk=4)
    assert again.fns is sched.fns
    assert sorted(teng._fns_by_chunk) == [4, 8]
    assert teng.make_scheduler(num_slots=2).fns is teng._fns_by_chunk[8]


def test_loop_pool_keeps_each_chunks_running_batch_apart(moe):
    """The running batch (and on the card its captured graphs) is keyed
    by the chunk: schedulers of chunk 4 and 8 hold two states, and a
    second scheduler of chunk 4 borrows the first one's."""
    eng = Engine(moe["tcfg"], moe["tp"], cache_len=64, decode_chunk=8,
                 device="cpu")
    prompt = np.arange(10, dtype=np.int32)
    toks = []
    for chunk in (4, 8, 4):
        sched = eng.make_scheduler(num_slots=2, decode_chunk=chunk)
        st = sched.submit(prompt, 9)
        sched.run()
        toks.append(np.stack(st.tokens))
        sched.release()
    keys = sorted(k[0][-1] for k in eng.loops._states)
    assert keys == [4, 8] and len(eng.loops.states()) == 2
    np.testing.assert_array_equal(toks[0], toks[1])
    np.testing.assert_array_equal(toks[0], toks[2])


# ------------------------------------------------------ configs.shapes ---

def test_shapes_equal_jax():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSHAPES[name])
        assert get_shape(name) is s


# ------------------------------------------------- kernels.ops bytes ---

def test_ops_byte_models_equal_jax_exactly():
    for na in (0, 1, 5.48, 32):
        for d, f in ((1024, 512), (7168, 2048)):
            for db in (1, 2, 4):
                for T, k in ((0, 0), (8, 8), (40, 2)):
                    assert TOPS.moe_step_bytes(
                        na, d, f, db, tokens=T, top_k=k) == \
                        JOPS.moe_step_bytes(na, d, f, db, tokens=T, top_k=k)
    for T in (8, 64, 1024):
        for E in (4, 32, 256):
            for C in (1, 16):
                for g in (1, 4):
                    assert TOPS.dispatch_einsum_bytes(T, E, C, 1024, 2, g) \
                        == JOPS.dispatch_einsum_bytes(T, E, C, 1024, 2, g)
            for k in (1, 2, 8):
                for bt in (8, 128):
                    for ma in (None, 3, 16):
                        assert TOPS.dispatch_sorted_bytes(
                            T, k, E, 1024, 4, bt, ma) == \
                            JOPS.dispatch_sorted_bytes(T, k, E, 1024, 4, bt,
                                                       ma)


# ---------------------------------------------- kernels.ops wrappers ---

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("max_active", [None, 3, 99])
def test_xshare_moe_ffn_matches_jax(dt, max_active):
    """max_active None is E, and a larger one is clamped to E."""
    T, d, E, f = 8, 64, 6, 128
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w1, w3, w2 = [(rng.standard_normal(s) * 0.05).astype(np.float32)
                  for s in ((E, d, f), (E, d, f), (E, f, d))]
    active = np.zeros(E, bool)
    active[[0, 2, 5]] = True
    combine = np.where(active, rng.random((T, E)), 0).astype(np.float32)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = [both(a, dt)
                                              for a in (x, w1, w3, w2)]
    ref = JOPS.xshare_moe_ffn(jx, j1, j3, j2, jnp.asarray(combine),
                              jnp.asarray(active), max_active=max_active,
                              block_f=64)
    before = K.moe_ffn.launches
    out = TOPS.xshare_moe_ffn(tx, t1, t3, t2, torch.tensor(combine),
                              torch.tensor(active), max_active=max_active)
    assert K.moe_ffn.launches == before      # the CPU takes the plain one
    assert out.dtype == DTYPES[dt][1] and out.shape == (T, d)
    close(out, ref, DTYPES[dt][2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_xshare_grouped_ffn_matches_jax(dt):
    """The port's dispatch plan (top-2 of 4, 24 tokens, block_t 8), an
    invalid tail tile included."""
    T, d, E, f, k = 24, 64, 4, 96, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w1, w3, w2 = [(rng.standard_normal(s) * 0.05).astype(np.float32)
                  for s in ((E, d, f), (E, d, f), (E, f, d))]
    idx, w = TR.topk_route(torch.tensor(rng.standard_normal((T, E)),
                                        dtype=torch.float32), k)
    plan = dispatch_plan(idx, w, E, block_t=8)
    xs = gather_tokens(torch.tensor(x), plan).numpy()
    eid = plan.tile_eid.numpy()
    valid = plan.tile_valid.numpy().copy()
    valid[-1] = 0
    (jxs, txs), (j1, t1), (j3, t3), (j2, t2) = [
        both(a.astype(np.float32), dt) for a in (xs, w1, w3, w2)]
    ref = JOPS.xshare_grouped_ffn(jxs, j1, j3, j2, jnp.asarray(eid),
                                  jnp.asarray(valid), block_t=8, block_f=32)
    before = K.grouped_ffn.launches
    out = TOPS.xshare_grouped_ffn(txs, t1, t3, t2, torch.tensor(eid),
                                  torch.tensor(valid), block_t=8)
    assert K.grouped_ffn.launches == before
    close(out, ref, DTYPES[dt][2])
    assert not out[-8:].float().abs().sum()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_decode_matches_jax(dt):
    B, H, Hkv, dh, S = 3, 4, 2, 32, 40
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k, v = [rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
            for _ in range(2)]
    lengths = np.array([40, 17, 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = [both(a, dt) for a in (q, k, v)]
    ref = JOPS.flash_decode(jq, jk, jv, jnp.asarray(lengths), block_s=16)
    before = K.decode_attention.launches
    out = TOPS.flash_decode(tq, tk, tv, torch.tensor(lengths))
    assert K.decode_attention.launches == before
    close(out, ref, DTYPES[dt][2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssd_chunk_scan_matches_jax(dt):
    """B / C heads pre-broadcast (the reference's contract), S not a
    multiple of the chunk."""
    Bsz, S, nh, hd, ds, chunk = 2, 40, 4, 32, 16, 16
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((Bsz, S, nh, hd)) * 0.5).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((Bsz, S, nh)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    Bm, Cm = [(rng.standard_normal((Bsz, S, nh, ds)) * 0.3).astype(
        np.float32) for _ in range(2)]
    (jx, tx), (jB, tB), (jC, tC) = [both(a, dt) for a in (x, Bm, Cm)]
    y_ref, st_ref = JOPS.ssd_chunk_scan(jx, jnp.asarray(dtv), jnp.asarray(A),
                                        jB, jC, chunk=chunk, block_h=2)
    before = K.ssd_scan.launches
    y, st = TOPS.ssd_chunk_scan(tx, torch.tensor(dtv), torch.tensor(A), tB,
                                tC, chunk=chunk)
    assert K.ssd_scan.launches == before
    assert y.dtype == DTYPES[dt][1] and st.dtype == torch.float32
    close(y, y_ref, SCAN_TOL[dt])
    close(st, st_ref, SCAN_TOL[dt])


def test_ops_are_exported_like_jax():
    import repro.kernels as JK
    for name in JOPS.__all__:
        assert getattr(K, name) is getattr(TOPS, name)
        assert hasattr(JK, name)
    assert TOPS.__all__ == JOPS.__all__


# ------------------------------------------ param_count and init_moe ---

@pytest.mark.parametrize("stack", [None, 3])
@pytest.mark.parametrize("arch", [MOE, "deepseek-r1-proxy"])
def test_init_moe_keys_shapes_dtypes_like_jax(arch, stack):
    """deepseek-r1-proxy's layer has shared experts; granite's has none."""
    m = ARCHS[arch].reduced(max_experts=4).moe
    jm = JARCHS[arch].reduced(max_experts=4).moe
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        tp = init_moe(m, 64, dt, stack=stack, device="cpu")
        jp = j_init_moe(jax.random.PRNGKey(0), jm, 64, jdt, stack=stack)
        assert list(tp) == list(jp)
        for key, t in tp.items():
            assert tuple(t.shape) == jp[key].shape, key
            assert dtype_name(t.dtype) == dtype_name(jp[key].dtype), key
        assert param_count(tp) == j_param_count(jp)
    g = torch.Generator().manual_seed(4)
    a = init_moe(m, 64, torch.float32, generator=g, device="cpu")
    b = init_moe(m, 64, torch.float32, seed=4, device="cpu")
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
        assert abs(float(a[key].std()) - 0.02) < 0.005


def test_param_count_equals_jax(moe):
    assert param_count(moe["tp"]) == j_param_count(moe["jp"])
    own = bridge.init_params(moe["tcfg"], device="cpu")
    assert param_count(own) == j_param_count(moe["jp"])


# ------------------------------------------------------------ routing ---

@pytest.mark.parametrize("bias", [False, True])
def test_router_probs_match_jax(bias):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((9, 32)).astype(np.float32)
    wg = rng.standard_normal((32, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) if bias else None
    jl, jp = JR.router_probs(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wg),
                             None if b is None else jnp.asarray(b))
    tl, tp = TR.router_probs(torch.tensor(x).to(torch.bfloat16),
                             torch.tensor(wg),
                             None if b is None else torch.tensor(b))
    assert tl.dtype == tp.dtype == torch.float32
    close(tl, jl, 2e-5)
    close(tp, jp, 2e-5)


def test_dispatch_combine_weights_match_jax():
    """A masked slot (-1) routes nowhere, as jax.nn.one_hot drops it."""
    rng = np.random.default_rng(13)
    E = 6
    idx = np.stack([rng.permutation(E)[:2] for _ in range(7)]).astype(
        np.int32)
    idx[3, 1] = -1
    w = rng.random((7, 2)).astype(np.float32)
    jd, jc = JR.dispatch_combine_weights(jnp.asarray(idx), jnp.asarray(w), E)
    td, tc = TR.dispatch_combine_weights(torch.tensor(idx), torch.tensor(w),
                                         E)
    assert td.dtype == torch.bool
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    close(tc, jc, 2e-5)


# ---------------------------------------------------------- launch.serve ---

@pytest.mark.parametrize("policy", ["off", "batch"])
def test_make_prefill_and_serve_step_match_jax(moe, policy):
    """A prefill of 3 x 10 tokens, then two decode steps of the greedy
    token: logits within 2e-5, the same greedy tokens, the same aux
    (integer counts exact)."""
    pol = dict(mode="batch", k0=1, m_l=1) if policy == "batch" else {}
    jpre = JSERVE.make_prefill(moe["jcfg"], cache_len=32)
    tpre = TSERVE.make_prefill(moe["tcfg"], cache_len=32)
    jstep = JSERVE.make_serve_step(moe["jcfg"], policy=JPolicy(**pol))
    tstep = TSERVE.make_serve_step(moe["tcfg"], policy=XSharePolicy(**pol))
    toks = np.random.default_rng(4).integers(
        0, moe["tcfg"].vocab_size, (3, 10)).astype(np.int32)
    jl, jc, _ = jpre(moe["jp"], jnp.asarray(toks))
    with torch.no_grad():
        tl, tc, _ = tpre(moe["tp"], torch.tensor(toks))
    close(tl, jl, 2e-5)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl[..., :moe["jcfg"].vocab_size], -1))
        np.testing.assert_array_equal(
            tl[..., :moe["tcfg"].vocab_size].argmax(-1).numpy(), nxt)
        jl, jc, jaux = jstep(moe["jp"], jnp.asarray(nxt[:, None], jnp.int32),
                             jc)
        with torch.no_grad():
            tl, tc, taux = tstep(moe["tp"], torch.tensor(nxt[:, None]), tc)
        jl, tl = jl[:, -1], tl[:, -1]
        close(tl, jl, 2e-5)
        np.testing.assert_array_equal(tc["cur_len"].numpy(),
                                      np.asarray(jc["cur_len"]))
        assert sorted(taux) == sorted(jaux)
        for key, v in taux.items():
            ref = np.asarray(jaux[key])
            if np.issubdtype(ref.dtype, np.integer):
                np.testing.assert_array_equal(v.numpy(), ref)
            else:
                close(v, ref, 2e-5)


def masked(text: str):
    """A CLI's printed lines with every number replaced by #."""
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in text.splitlines()]


CLI = ["--arch", MOE, "--reduced", "--batch", "3", "--prompt-len", "12",
       "--new-tokens", "6"]


@pytest.mark.parametrize("args", [["--policy", "off"],
                                  ["--policy", "batch", "--k0", "1",
                                   "--m-l", "2"],
                                  ["--policy", "ep", "--m-g", "1"],
                                  ["--policy", "spec", "--spec-len", "2"]],
                         ids=["off", "batch", "ep", "spec"])
def test_serve_cli_prints_the_reference_lines(capsys, args):
    """Each policy (spec with a draft of spec_len 2) prints the JAX CLI's
    lines: generated, OTPS / steps, accepted drafts when speculating,
    activated experts; main returns the tokens it generated."""
    toks, stats = TSERVE.main(CLI + args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert toks.shape == (3, 6) and stats.new_tokens == 18
    want = ["generated: (#, #)", "OTPS #  steps #"]
    if "--spec-len" in args:
        want.append("mean accepted drafts/step: #")
    want.append("mean activated experts/layer: # (selected set #, gate "
                "mass #)")
    assert masked(out) == want


def test_serve_cli_lines_equal_the_jax_clis(capsys):
    JSERVE.main(CLI)
    jout = capsys.readouterr().out
    TSERVE.main(CLI + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert masked(tout) == masked(jout)
    assert tout.splitlines()[0] == jout.splitlines()[0]


def test_serve_cli_spec_policy_needs_a_draft_as_in_jax():
    """--policy spec without --spec-len: the plain decode step has no
    verify shape, and both packages raise the same ValueError."""
    with pytest.raises(ValueError, match="spec_shape"):
        TSERVE.main(CLI + ["--policy", "spec", "--device", "cpu"])


def test_serve_cli_draft_takes_the_targets_vocabulary():
    """The reference's draft is cfg.reduced(num_layers=2,
    max_d_model=128); the port's is the same with the target's
    vocabulary (49 155 at full width, 1024 at --reduced)."""
    for reduce in (False, True):
        cfg, jcfg = ARCHS[MOE], JARCHS[MOE]
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        d = TSERVE.draft_config(cfg)
        ref = jcfg.reduced(num_layers=2, max_d_model=128)
        assert d.vocab_size == cfg.vocab_size
        assert dataclasses.asdict(d) == dataclasses.asdict(
            dataclasses.replace(ref, vocab_size=cfg.vocab_size))
        assert (ref.vocab_size == cfg.vocab_size) == reduce
    assert TSERVE.draft_config(ARCHS[MOE]).vocab_size == 49155


# --------------------------------------------------------- launch.inputs ---

def spec_of(x):
    return tuple(x.shape), dtype_name(x.dtype)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_inputs_equal_jax_for_every_shape(arch):
    """force_window_for, policy_for, decode_cache_len, and input_specs'
    shapes and dtypes key by key (meta tensors against jax.eval_shape's
    structs); nothing is allocated."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert TIN.force_window_for(cfg, shape) == \
            JIN.force_window_for(jcfg, jshape)
        assert dataclasses.asdict(TIN.policy_for(cfg, shape)) == \
            dataclasses.asdict(JIN.policy_for(jcfg, jshape))
        assert TIN.decode_cache_len(cfg, shape) == \
            JIN.decode_cache_len(jcfg, jshape)
        got = bridge.flatten(TIN.input_specs(cfg, shape))
        want = bridge.flatten(JIN.input_specs(jcfg, jshape))
        assert sorted(got) == sorted(want)     # eval_shape sorts keys
        for key, t in got.items():
            assert t.device.type == "meta"
            assert spec_of(t) == spec_of(want[key]), (name, key)


def test_input_specs_take_a_float8_cache_on_meta():
    """A float8 cache (the reference's only caller of one plans qwen3 and
    musicgen at decode_32k) is no error on meta: only the card refuses
    one."""
    for arch in ("qwen3-moe-235b-a22b", "musicgen-large"):
        shape = SHAPES["decode_32k"]
        got = bridge.flatten(TIN.input_specs(
            ARCHS[arch], shape, cache_dtype=torch.float8_e4m3fn))
        want = bridge.flatten(JIN.input_specs(
            JARCHS[arch], JSHAPES["decode_32k"],
            cache_dtype=jnp.float8_e4m3fn))
        assert {k: spec_of(v) for k, v in got.items()} == \
            {k: spec_of(v) for k, v in want.items()}
        assert dtype_name(got["cache/kv_k"].dtype) == "float8_e4m3fn"


# ------------------------------------------------------- launch.roofline ---

def rel_eq(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0), (a, b)


def policies(P):
    return {m: P(mode=m, k0=1, m_l=16, m_r=4, m_g=4) for m in MODES}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_roofline_model_equals_jax(arch):
    """param_counts, model_flops, analytic_flops, expected_selected,
    bottleneck_shard_load and analytic_bytes at the default model_shards
    (16, the reference's), every shape x policy mode, with no window and
    with the forced one."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    tc, jc = TRF.param_counts(cfg), JRF.param_counts(jcfg)
    assert tc.keys() == jc.keys()
    for k in tc:
        rel_eq(tc[k], jc[k])
    tpols, jpols = policies(XSharePolicy), policies(JPolicy)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        rel_eq(TRF.model_flops(cfg, shape), JRF.model_flops(jcfg, jshape))
        for window in (None, TIN.LONG_CTX_WINDOW):
            rel_eq(TRF.analytic_flops(cfg, shape, window),
                   JRF.analytic_flops(jcfg, jshape, window))
            for m in MODES:
                for cb in (1, 2):
                    rel_eq(TRF.analytic_bytes(
                               cfg, shape, window=window, policy=tpols[m],
                               num_devices=256, cache_bytes_per_el=cb),
                           JRF.analytic_bytes(
                               jcfg, jshape, window=window, policy=jpols[m],
                               num_devices=256, cache_bytes_per_el=cb))
        if cfg.moe is None:
            continue
        e = cfg.moe
        for m in MODES:
            for B in (1, 8, shape.global_batch):
                sel = TRF.expected_selected(e.num_experts, e.top_k, B,
                                            tpols[m])
                rel_eq(sel, JRF.expected_selected(e.num_experts, e.top_k,
                                                  B, jpols[m]))
                for shards in (1, 8, 16):
                    rel_eq(TRF.bottleneck_shard_load(sel, shards, tpols[m]),
                           JRF.bottleneck_shard_load(sel, shards, jpols[m]))


@pytest.mark.parametrize("split", [False, True])
def test_step_terms_on_a_record(split):
    """The analytic fields equal JAX's; the terms divide by the H100's
    constants (not the reference's); without a config the record's own
    figures are used."""
    cfg, jcfg = ARCHS[MOE], JARCHS[MOE]
    shape, jshape = SHAPES["decode_32k"], JSHAPES["decode_32k"]
    rec = {"flops_per_device": 3.0e12, "bytes_per_device": 4.0e9,
           "collective_bytes_per_device": 5.0e6}
    if split:
        rec.update(collective_bytes_inside_loop=2.0e6,
                   collective_bytes_outside_loop=1.0e6)
    pol = dict(mode="batch", k0=1, m_l=16)
    got = TRF.step_terms(rec, 16, cfg, shape, window=None, accum=2,
                         policy=XSharePolicy(**pol))
    want = JRF.step_terms(rec, 16, jcfg, jshape, window=None, accum=2,
                          policy=JPolicy(**pol))
    for key in ("hlo_flops_per_device_raw", "hlo_bytes_per_device_raw",
                "analytic_flops_global", "analytic_bytes_global",
                "collective_trip_correction", "model_flops",
                "useful_ratio"):
        rel_eq(got[key], want[key])
    trips = cfg.num_layers * 2
    coll = 2.0e6 * trips + 1.0e6 if split else 5.0e6 * trips
    rel_eq(got["compute_s"], got["analytic_flops_global"] / 16 / 989e12)
    rel_eq(got["memory_s"], got["analytic_bytes_global"] / 16 / 3.35e12)
    rel_eq(got["collective_s"], coll / 450e9)
    rel_eq(want["collective_s"] * JRF.ICI_BW / TRF.LINK_BW,
           got["collective_s"])
    assert got["dominant"] == max(
        ("compute", got["compute_s"]), ("memory", got["memory_s"]),
        ("collective", got["collective_s"]), key=lambda kv: kv[1])[0]
    raw = TRF.step_terms(rec, 16)
    rel_eq(raw["compute_s"], 3.0e12 / TRF.PEAK_FLOPS)
    rel_eq(raw["memory_s"], 4.0e9 / TRF.HBM_BW)
    assert (TRF.PEAK_FLOPS, TRF.PEAK_FLOPS_F32, TRF.HBM_BW, TRF.LINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)


@pytest.mark.parametrize("mode,gb", [("off", 2.633), ("batch", 1.605)])
def test_one_card_decode_bytes_of_granite(mode, gb):
    """Granite's served decode step (B 8, cache 512) on one card
    (model_shards 1): the expert weights of the expected selected set,
    once, plus the rest of the weights, the cache and the activations,
    worked out from the reference's own pieces. The 16 shards of the
    reference's default count more experts than the model has."""
    cfg, jcfg = ARCHS[MOE], JARCHS[MOE]
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=8,
                                cache_len=512)
    jshape = dataclasses.replace(JSHAPES["decode_32k"], global_batch=8,
                                 cache_len=512)
    pol = dict(mode="batch", k0=1, m_l=8) if mode == "batch" else \
        dict(mode="off")
    got = TRF.analytic_bytes(cfg, shape, policy=XSharePolicy(**pol),
                             num_devices=1, model_shards=1)
    e, L, d = jcfg.moe, jcfg.num_layers, jcfg.d_model
    per_exp = 3 * d * e.d_ff_expert
    sel = JRF.expected_selected(e.num_experts, e.top_k, 8, JPolicy(**pol))
    want = (JRF.param_counts(jcfg)["total"] * 2
            - L * per_exp * (e.num_experts - sel) * 2
            + JRF._cache_bytes(jcfg, jshape, None) * (1 + 2 / 512)
            + 8 * d * L * 8 * 2)
    assert got == pytest.approx(want, rel=1e-6)
    assert round(got / 1e9, 3) == gb
    assert TRF.analytic_bytes(cfg, shape, policy=XSharePolicy(**pol),
                              num_devices=1) > 2 * got


def test_new_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the CLI and init_moe raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSERVE.main(CLI)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_moe(ARCHS[MOE].moe, 64, torch.float32)
    init_moe(ARCHS[MOE].moe, 64, torch.float32, device="cpu")
