"""The port's planning half of the launch layer against the JAX package
on the CPU: ``repro_torch.sharding``, ``dispatch_plan(pad_shards=)``
under a mesh context, ``launch.partition`` leaf by leaf for the 10
assigned archs at five meshes, ``launch.dryrun`` (``per_device_gb``,
the record's analytic block and roofline row, meta traces whose output
shapes and dtypes equal ``jax.eval_shape``'s), the e4m3 cache through
prefill and decode, and ``launch.report`` / ``gen_experiments`` /
``hillclimb``.

JAX's partition rules read ``mesh.shape`` only, so they run on a
``jax.sharding.AbstractMesh`` here; a PartitionSpec is compared as a
tuple padded with None to its tensor's rank. Tolerances: per-card GB at
a relative 1e-9, the roofline's float formulas at 1e-12, logits at the
bf16 TOL 2e-2 (tests/test_kernels.py); integer outputs, specs, cache
bytes and greedy tokens exact."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import sharding as JSH  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import assigned_names  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import inputs as JIN  # noqa: E402
from repro.launch import partition as JPT  # noqa: E402
from repro.launch import roofline as JRF  # noqa: E402
from repro.launch.serve import make_prefill as j_make_prefill  # noqa: E402
from repro.launch.serve import make_serve_step as j_make_serve  # noqa: E402
from repro.launch.train import make_train_step as j_make_train  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.dispatch import dispatch_plan as j_dispatch_plan  # noqa
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import sharding as TSH  # noqa: E402
from repro_torch.bridge import flatten  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.base import XSharePolicy  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import gen_experiments as GE  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.launch import inputs as TIN  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import partition as TPT  # noqa: E402
from repro_torch.launch import report as RP  # noqa: E402
from repro_torch.launch import roofline as TRF  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402
from repro_torch.models.dispatch import dispatch_plan  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "32x8": ((32, 8), ("data", "model")),
          "2x32x8": ((2, 32, 8), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
BATCHES = (1, 4, 128, 256)
F8 = (jnp.float8_e4m3fn, torch.float8_e4m3fn)


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), TM.make_mesh_compat(shape, axes)


def jspec(p, rank=None):
    """A PartitionSpec as the port's tuple: padded with None to rank."""
    t = tuple(p)
    return t + (None,) * ((rank or len(t)) - len(t))


def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def j_params_sds(jcfg, dtype=jnp.bfloat16):
    return jax.eval_shape(lambda: j_init(jcfg, jax.random.PRNGKey(0), dtype))


# ---------------------------------------------------------------- sharding

def test_mesh_context_state_nesting_and_model_axis():
    """The same module state in and out of a context, nested contexts
    restored in order, and the model axis of (2, 4) and (2, 16, 16)."""
    for mod in (JSH, TSH):
        assert mod.current_mesh() is None and mod.model_axis_size() == 1
    outer = TM.make_mesh_compat((2, 4), ("data", "model"))
    inner = TM.make_mesh_compat((2, 16, 16), ("pod", "data", "model"))
    with TSH.mesh_context(outer):
        assert TSH.current_mesh() is outer and TSH.model_axis_size() == 4
        with TSH.mesh_context(inner):
            assert TSH.current_mesh() is inner
            assert TSH.model_axis_size() == 16
        assert TSH.current_mesh() is outer and TSH.model_axis_size() == 4
    assert TSH._STATE == {"mesh": None} and TSH.model_axis_size() == 1
    assert TM.make_host_mesh().shape == {
        "data": max(1, torch.cuda.device_count()), "model": 1}
    assert TM.make_production_mesh().shape == {"data": 32, "model": 8}
    assert TM.make_production_mesh(multi_pod=True).size == 512


@pytest.mark.parametrize("top_k", [1, 8])
def test_dispatch_plan_under_a_mesh_equals_jax(top_k):
    """Under a (2, 4) mesh context the tile axis pads to a multiple of
    block_t * 4, as JAX's does with its mesh default, pad_shards=4 (an
    AbstractMesh cannot stand in for JAX's context: its
    model_axis_size reads mesh.devices). pad_shards=1 gives the
    unpadded plan, which is also the plan outside a context."""
    rng = np.random.default_rng(top_k)
    T, E = 40, 16
    idx = np.stack([rng.permutation(E)[:top_k] for _ in range(T)]
                   ).astype(np.int32)
    idx[3] = -1
    w = rng.random((T, top_k)).astype(np.float32)
    w[5, 0] = 0.0
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    mesh = TM.make_mesh_compat((2, 4), ("data", "model"))

    def same(got, want):
        for f in got._fields:
            g, x = getattr(got, f), getattr(want, f)
            if isinstance(g, int):
                assert g == x, f
            else:
                assert np.array_equal(g.numpy(), np.asarray(x)), f

    with TSH.mesh_context(mesh):
        padded = dispatch_plan(ti, tw, E, block_t=8)
        unpadded = dispatch_plan(ti, tw, E, block_t=8, pad_shards=1)
    want = j_dispatch_plan(jnp.asarray(idx), jnp.asarray(w), E, block_t=8,
                           pad_shards=4)
    same(padded, want)
    assert padded.padded_rows % (8 * 4) == 0
    same(unpadded, j_dispatch_plan(jnp.asarray(idx), jnp.asarray(w), E,
                                   block_t=8, pad_shards=1))
    same(dispatch_plan(ti, tw, E, block_t=8), unpadded._replace())


# -------------------------------------------------------------- partition

@pytest.mark.parametrize("arch", assigned_names())
def test_partition_rules_equal_jax_leaf_by_leaf(arch):
    """param / opt / cache / token / logits / prefix specs and the batch
    and sequence axes, at (16, 16), (2, 16, 16), (32, 8), (2, 32, 8) and
    (2, 4), batches 1, 4, 128 and 256, FSDP on and off."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    sds = j_params_sds(jcfg)
    params = bridge.init_params(cfg, dtype=torch.bfloat16, device="meta")
    flat = flatten(params)
    jflat = {path_str(p): x for p, x in
             jax.tree_util.tree_flatten_with_path(sds)[0]}
    assert set(jflat) == set(flat)
    for key, t in flat.items():      # the meta init: JAX's shapes, dtypes
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
            (jflat[key].shape, str(jflat[key].dtype)), key
    for name in MESHES:
        jm, tm = meshes(name)
        for fsdp in (True, False):
            want = {path_str(p): s for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        JPT.param_specs(jcfg, jm, sds, fsdp=fsdp),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))[0]}
            got = flatten(TPT.param_specs(cfg, tm, params, fsdp=fsdp))
            for key, t in flat.items():
                assert got[key] == jspec(want[key], t.ndim), (name, key)
                assert len(got[key]) == t.ndim
        ospec = TPT.opt_specs(TPT.param_specs(cfg, tm, params))
        assert ospec.step == () and flatten(ospec.nu) == flatten(ospec.mu)
        for B in BATCHES:
            assert TPT.batch_axes(tm, B) == JPT.batch_axes(jm, B)
            assert TPT.seq_axes(tm, B) == JPT.seq_axes(jm, B)
            jc = JPT.cache_specs(jcfg, jm, B)
            tc = TPT.cache_specs(cfg, tm, B)
            assert set(tc) == set(jc)
            for k, s in tc.items():
                assert s == jspec(jc[k], len(s)), (name, B, k)
            assert TPT.token_spec(cfg, tm, B) == \
                jspec(JPT.token_spec(jcfg, jm, B))
            assert TPT.prefix_spec(cfg, tm, B) == \
                jspec(JPT.prefix_spec(jcfg, jm, B))
            for ws in (True, False):
                assert TPT.logits_spec(cfg, tm, B, with_seq=ws) == \
                    jspec(JPT.logits_spec(jcfg, jm, B, with_seq=ws))


# ------------------------------------------------------------------ dryrun

def j_per_device_gb(sds_tree, spec_tree, mesh):
    """The reference's per_device_gb. Importing repro.launch.dryrun asks
    XLA for 512 host devices through the environment; the tests' JAX has
    started with the conftest's 8 already, and the variable is put back
    so that no later subprocess inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import per_device_gb
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return per_device_gb(sds_tree, spec_tree, mesh)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "zamba2-1.2b",
                                  "musicgen-large"])
def test_per_device_gb_equals_jax(arch):
    """params, f32 optimizer moments and the decode cache (bf16 and
    e4m3) per card, at each mesh."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    sds = j_params_sds(jcfg)
    f32 = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), sds)
    params = bridge.init_params(cfg, dtype=torch.bfloat16, device="meta")
    p32 = {k: torch.empty(t.shape, device="meta")
           for k, t in flatten(params).items()}
    shape, jshape = SHAPES["decode_32k"], JSHAPES["decode_32k"]
    for name in MESHES:
        jm, tm = meshes(name)
        js = JPT.param_specs(jcfg, jm, sds)
        ts = TPT.param_specs(cfg, tm, params)
        for tree, jtree in ((params, sds), (p32, f32)):
            got = DR.per_device_gb(tree, ts, tm)
            assert got == pytest.approx(j_per_device_gb(jtree, js, jm),
                                        rel=1e-9)
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), F8):
            jc = JIN.input_specs(jcfg, jshape, jnp.bfloat16,
                                 cache_dtype=jdt)["cache"]
            tc = TIN.input_specs(cfg, shape, torch.bfloat16,
                                 cache_dtype=tdt)["cache"]
            B = shape.global_batch
            got = DR.per_device_gb(tc, TPT.cache_specs(cfg, tm, B), tm)
            want = j_per_device_gb(jc, JPT.cache_specs(jcfg, jm, B), jm)
            assert got == pytest.approx(want, rel=1e-9)


def j_eval_shape(jcfg, jshape, cache_dtype=None):
    """jax.eval_shape of the reference dry run's step for a combination
    (its policy, window and accum choices), outside any mesh."""
    sds = j_params_sds(jcfg)
    ins = JIN.input_specs(jcfg, jshape, jnp.bfloat16, cache_dtype=cache_dtype)
    fw = JIN.force_window_for(jcfg, jshape) if jshape.kind != "train" \
        else None
    pol = JIN.policy_for(jcfg, jshape)
    if jshape.kind == "train":
        accum = 8 if JRF.param_counts(jcfg)["total"] > 50e9 else 1
        fn = j_make_train(jcfg, policy=pol, remat=True,
                          capacity_factor=1.25, accum_steps=accum)
        return jax.eval_shape(
            lambda p, *a: fn(p, j_adamw_init(p), *a), sds, ins["tokens"],
            *([ins["prefix_embeds"]] if "prefix_embeds" in ins else []))
    if jshape.kind == "prefill":
        fn = j_make_prefill(jcfg, cache_len=jshape.seq_len + 512,
                            force_window=fw, capacity_factor=1.25)
        return jax.eval_shape(fn, sds, ins["tokens"],
                              ins.get("prefix_embeds"))
    fn = j_make_serve(jcfg, policy=pol, force_window=fw, capacity_factor=1.25)
    return jax.eval_shape(fn, sds, ins["tokens"], ins["cache"])


def leaves(tree):
    """[(shape, dtype name)] of a traced output, in a fixed order: a
    nested dict by sorted path, a tuple in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    dt = str(tree.dtype).replace("torch.", "")
    return [(tuple(tree.shape), dt)]


def same_outputs(got, want, kind):
    """The port's step outputs against eval_shape's: train (params, opt,
    metrics), prefill / decode (logits, cache, aux)."""
    if kind == "train":
        (tp, to, tm), (jp, jo, jm) = got, want
        assert leaves(tp) == leaves(jp)
        assert leaves(to.step) == leaves(jo.step)
        assert leaves(to.mu) == leaves(jo.mu)
        assert leaves(to.nu) == leaves(jo.nu)
        assert leaves(tm) == leaves(jm)
        return
    (tl, tc, ta), (jl, jc, ja) = got, want
    assert leaves(tl) == leaves(jl)
    assert leaves(tc) == leaves(jc)
    assert sorted(ta) == sorted(ja)
    assert leaves(ta) == leaves(ja)


SMALL = [("granite-moe-1b-a400m", "moe"), ("mamba2-370m", "ssm"),
         ("zamba2-1.2b", "hybrid"), ("musicgen-large", "audio"),
         ("llama3-8b", "dense"), ("paligemma-3b", "vlm")]


@pytest.mark.parametrize("arch,family", SMALL)
def test_meta_traces_of_every_family_give_eval_shapes(arch, family):
    """Train, prefill and decode at 2 layers, d 256 on a (2, 4) mesh (the
    reference's tests/test_dryrun_small.py cut), and the record's
    analytic block and roofline row."""
    cfg = ARCHS[arch].reduced(num_layers=2, max_d_model=256)
    jcfg = JARCHS[arch].reduced(num_layers=2, max_d_model=256)
    assert cfg.family == family
    mesh = TM.make_mesh_compat((2, 4), ("data", "model"))
    for kind, seq in (("train", 64 + cfg.prefix_len),
                      ("prefill", 64 + cfg.prefix_len), ("decode", 64)):
        kw = dict(name=f"{kind}_small", seq_len=seq, global_batch=4,
                  kind=kind, cache_len=64)
        shape, jshape = ShapeConfig(**kw), JShape(**kw)
        same_outputs(DR.trace(cfg, shape, mesh), j_eval_shape(jcfg, jshape),
                     kind)


def record_row_equals_jax(rec, cfg, jcfg, shape, jshape, mesh, *,
                          policy, jpolicy, cbe=2):
    """The record's analytic row against JAX's step_terms on the same
    analytic inputs, at the reference's 16-way model axis (JAX has no
    figure for the collectives); the port's own row at the mesh's."""
    fw = TIN.force_window_for(cfg, shape) if shape.kind != "train" else None
    accum = 8 if shape.kind == "train" and \
        TRF.param_counts(cfg)["total"] > 50e9 else 1
    z = {"flops_per_device": 0.0, "bytes_per_device": 0.0,
         "collective_bytes_per_device": 0.0}
    ours = TRF.step_terms({}, rec["devices"], cfg, shape, window=fw,
                          accum=accum, policy=policy, cache_bytes_per_el=cbe)
    want = JRF.step_terms(z, rec["devices"], jcfg, jshape, window=fw,
                          accum=accum, policy=jpolicy,
                          cache_bytes_per_el=cbe)
    for k in ("analytic_flops_global", "analytic_bytes_global",
              "collective_trip_correction", "model_flops", "useful_ratio"):
        assert ours[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert ours["compute_s"] * TRF.PEAK_FLOPS == pytest.approx(
        want["compute_s"] * JRF.PEAK_FLOPS, rel=1e-12)
    assert ours["collective_s"] is None and rec["collective_s"] is None
    mine = TRF.step_terms({}, rec["devices"], cfg, shape, window=fw,
                          accum=accum, policy=policy, cache_bytes_per_el=cbe,
                          model_shards=mesh.shape["model"])
    for k in ("compute_s", "memory_s", "dominant", "analytic_bytes_global"):
        assert rec[k] == mine[k], k
    assert rec["dominant"] == max(("compute", rec["compute_s"]),
                                  ("memory", rec["memory_s"]),
                                  key=lambda kv: kv[1])[0]
    for k in ("flops_per_device", "peak_hbm_gb", "collectives", "compile_s"):
        assert k not in rec


def analytic_want(jcfg, jshape, jm, cache_dtype=None):
    sds = j_params_sds(jcfg)
    js = JPT.param_specs(jcfg, jm, sds)
    want = {"params_gb": j_per_device_gb(sds, js, jm)}
    if jshape.kind == "train":
        want["opt_gb"] = 2.0 * j_per_device_gb(jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), sds),
            js, jm)
    if jshape.kind == "decode":
        c = JIN.input_specs(jcfg, jshape, jnp.bfloat16,
                            cache_dtype=cache_dtype)["cache"]
        want["cache_gb"] = j_per_device_gb(
            c, JPT.cache_specs(jcfg, jm, jshape.global_batch), jm)
    return {k: round(v, 3) for k, v in want.items()}


def lower_and_trace(monkeypatch, cfg, shape, mesh, **kw):
    """lower_one's record and the outputs of the one trace it runs."""
    seen, trace = [], DR.trace

    def keep(*a, **k):
        seen.append(trace(*a, **k))
        return seen[-1]

    monkeypatch.setattr(DR, "trace", keep)
    rec = DR.lower_one(cfg, shape, mesh, **kw)
    assert len(seen) == 1
    return rec, seen[0]


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_full_size_granite_moe_records_and_traces(monkeypatch, shape_name):
    """granite-moe-1b-a400m at full size on the single-pod H100 mesh:
    the record's keys and analytic block against JAX's per_device_gb,
    its row against JAX's step_terms, and the trace's outputs against
    eval_shape's."""
    arch = "granite-moe-1b-a400m"
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    jm, tm = meshes("32x8")
    rec, out = lower_and_trace(monkeypatch, cfg, shape, tm)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["devices"]) == \
        (arch, shape_name, "32x8", 256)
    assert rec["policy"] == JIN.policy_for(jcfg, jshape).mode
    assert rec["trace_s"] > 0
    assert rec["analytic"] == analytic_want(jcfg, jshape, jm)
    pol = TIN.policy_for(cfg, shape)
    record_row_equals_jax(rec, cfg, jcfg, shape, jshape, tm, policy=pol,
                          jpolicy=JIN.policy_for(jcfg, jshape))
    same_outputs(out, j_eval_shape(jcfg, jshape), shape.kind)


def test_full_size_qwen3_decode_with_an_e4m3_cache(monkeypatch):
    """qwen3-moe-235b-a22b at decode_32k with an e4m3 cache on the
    multi-pod mesh: the cache counted at 1 byte an element, the trace's
    outputs (the cache in e4m3) against eval_shape's."""
    arch = "qwen3-moe-235b-a22b"
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    shape, jshape = SHAPES["decode_32k"], JSHAPES["decode_32k"]
    jm, tm = meshes("2x32x8")
    rec, out = lower_and_trace(monkeypatch, cfg, shape, tm,
                               cache_dtype=F8[1], extra_tags={"tag": 1})
    assert rec["tag"] == 1
    assert rec["analytic"] == analytic_want(jcfg, jshape, jm, F8[0])
    record_row_equals_jax(rec, cfg, jcfg, shape, jshape, tm,
                          policy=TIN.policy_for(cfg, shape),
                          jpolicy=JIN.policy_for(jcfg, jshape), cbe=1)
    assert out[1]["kv_k"].dtype == torch.float8_e4m3fn
    same_outputs(out, j_eval_shape(jcfg, jshape, F8[0]), "decode")


def test_dryrun_cli_writes_and_merges_records(tmp_path, capsys):
    out = tmp_path / "dry.json"
    for _ in range(2):
        DR.main(["--arch", "granite-moe-1b-a400m", "--shape", "long_500k",
                 "--out", str(out)])
    DR.main(["--arch", "granite-moe-1b-a400m", "--shape", "long_500k",
             "--multi-pod", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert sorted(r["mesh"] for r in recs) == ["2x32x8", "32x8"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all("dom=memory" in ln for ln in lines)


def test_dryrun_all_traces_in_processes(monkeypatch, tmp_path, capsys):
    """--all over a cut matrix (one arch, one shape, both meshes): the
    worker processes' records reach --out, and the exit code is 0."""
    monkeypatch.setattr(DR, "assigned_names", lambda: ["mamba2-370m"])
    monkeypatch.setattr(DR, "SHAPES", {"long_500k": SHAPES["long_500k"]})
    out = tmp_path / "all.json"
    with pytest.raises(SystemExit) as done:
        DR.main(["--all", "--out", str(out)])
    assert done.value.code == 0
    recs = json.loads(out.read_text())
    assert sorted(r["mesh"] for r in recs) == ["2x32x8", "32x8"]
    assert "0 failures" in capsys.readouterr().out


# ------------------------------------------------- the e4m3 cache on the CPU

def test_f8_cache_prefill_and_decode_equal_jax():
    """A reduced granite-moe, the same f32 weights on both sides (drawn
    by the port's seeded initializer, handed to JAX as numpy): prefill
    with an e4m3 cache, then 3 greedy decode steps. The cache bytes are
    bit-equal to JAX's after each step, the logits within TOL, the
    tokens identical."""
    arch = "granite-moe-1b-a400m"
    cfg = ARCHS[arch].reduced(num_layers=2, max_d_model=128, max_vocab=256)
    jcfg = JARCHS[arch].reduced(num_layers=2, max_d_model=128,
                                max_vocab=256)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(params))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 10)).astype(np.int32)
    jl, jc, _ = j_prefill(jcfg, jparams, jnp.asarray(toks), cache_len=24,
                          cache_dtype=F8[0])
    tl, tc, _ = prefill(cfg, params, torch.from_numpy(toks), cache_len=24,
                        cache_dtype=F8[1])

    def same_cache():
        for k in ("kv_k", "kv_v"):
            assert tc[k].dtype == torch.float8_e4m3fn
            got = tc[k].view(torch.uint8).numpy()
            want = np.asarray(jc[k]).view(np.uint8)
            assert np.array_equal(got, want), k
        assert np.array_equal(tc["cur_len"].numpy(), np.asarray(jc["cur_len"]))

    for step in range(4):
        same_cache()
        want = np.asarray(jl, np.float32)
        got = tl.float().numpy()
        np.testing.assert_allclose(got, want.reshape(got.shape), atol=2e-2,
                                   rtol=2e-2)
        nxt = got.reshape(3, -1).argmax(-1)
        assert np.array_equal(nxt, want.reshape(3, -1).argmax(-1))
        if step == 3:
            break
        jl, jc, _ = j_decode_step(jcfg, jparams, jnp.asarray(nxt[:, None]),
                                  jc)
        tl, tc, _ = decode_step(cfg, params,
                                torch.from_numpy(nxt[:, None]).int(), tc)


def test_f8_cache_gap_to_a_bf16_cache():
    """Why an e4m3 step is held bit-equal, not within TOL, to a bf16 step
    on the dequantized cache (chip_smoke.py's f8 gate), at the card's
    depth (48 layers) and weight dtype (bf16, on both sides), reduced
    width, 3 teacher-forced steps after an e4m3 prefill.

    Each step writes its own new K / V row, which the e4m3 cache rounds
    and the bf16 one does not, so the two paths' logits differ in the
    reference itself: JAX's gap is not 0. The port's gap is of the same
    order (within a factor of 2 of JAX's), and so is the port's
    disagreement with JAX on the e4m3 path (printed). And the port's
    e4m3 step equals, bit for bit, its bf16 step whose writes round
    through e4m3 first: the gate's reference."""
    from repro_torch.models import attention as A
    arch = "musicgen-large"
    cfg = ARCHS[arch].reduced(num_layers=48, max_d_model=128, max_vocab=256)
    jcfg = JARCHS[arch].reduced(num_layers=48, max_d_model=128,
                                max_vocab=256)
    params = bridge.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                device="cpu")
    jparams = jax.tree_util.tree_map(   # numpy holds bf16 as f32
        lambda a, t: jnp.asarray(a, jnp.bfloat16 if t.dtype == torch.bfloat16
                                 else a.dtype),
        bridge.to_numpy(params), params)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32, cfg.num_codebooks)).astype(np.int32)
    jl, jc8, _ = j_prefill(jcfg, jparams, jnp.asarray(toks), cache_len=40,
                           cache_dtype=F8[0])
    _, tc8, _ = prefill(cfg, params, torch.from_numpy(toks), cache_len=40,
                        cache_dtype=F8[1])
    jcb = {k: v if k == "cur_len" else v.astype(jnp.bfloat16)
           for k, v in jc8.items()}
    tcb = {k: v.clone() if k == "cur_len" else v.to(torch.bfloat16)
           for k, v in tc8.items()}
    tcr = {k: v.clone() for k, v in tcb.items()}
    write = A.update_cache

    def rounded(cache, new, cur_len, *, window=None):
        return write(cache, new.to(F8[1]).to(new.dtype), cur_len,
                     window=window)

    nxt = np.asarray(jl, np.float32).argmax(-1)
    for _ in range(3):
        tok = nxt[:, None]
        jl8, jc8, _ = j_decode_step(jcfg, jparams, jnp.asarray(tok), jc8)
        jlb, jcb, _ = j_decode_step(jcfg, jparams, jnp.asarray(tok), jcb)
        tl8, tc8, _ = decode_step(cfg, params, torch.from_numpy(tok), tc8)
        tlb, tcb, _ = decode_step(cfg, params, torch.from_numpy(tok), tcb)
        A.update_cache = rounded
        try:
            tlr, tcr, _ = decode_step(cfg, params, torch.from_numpy(tok),
                                      tcr)
        finally:
            A.update_cache = write
        assert torch.equal(tl8, tlr)
        j8 = np.asarray(jl8, np.float32)
        jax_gap = np.abs(j8 - np.asarray(jlb, np.float32)).max()
        port_gap = (tl8.float() - tlb.float()).abs().max().item()
        noise = np.abs(tl8.float().numpy().reshape(j8.shape) - j8).max()
        print(f"e4m3 vs bf16 writes: JAX {jax_gap:.3g}, port {port_gap:.3g};"
              f" port vs JAX on e4m3 {noise:.3g}")
        assert jax_gap > 0
        assert jax_gap / 2 <= port_gap <= 2 * jax_gap
        nxt = j8.reshape(tok.shape[0], *tok.shape[2:], -1).argmax(-1)


# ------------------------------------------ report, gen_experiments, hillclimb

def fake_record(arch, shape, mesh, devices, **kw):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "devices": devices,
           "policy": "off", "trace_s": 0.5,
           "analytic": {"params_gb": 1.0, "cache_gb": 0.25},
           "compute_s": 2e-3, "memory_s": 1e-3, "collective_s": None,
           "dominant": "compute", "analytic_flops_global": 5.12e14,
           "analytic_bytes_global": 2.56e11, "model_flops": 4e14,
           "useful_ratio": 0.78125}
    rec.update(kw)
    return rec


def test_report_and_gen_experiments_rows(tmp_path, capsys):
    recs = [fake_record("b-arch", "decode_32k", "32x8", 256),
            fake_record("a-arch", "train_4k", "2x32x8", 512,
                        dominant="memory", memory_s=3e-3)]
    rows = RP.dryrun_table(recs).splitlines()[2:]
    assert rows == [
        "| a-arch | train_4k | 2x32x8 | off | 1.250 | params=1.0 + "
        "cache=0.25 | 1.00e+12 | 5.00e+08 | n/a | 0.5 |",
        "| b-arch | decode_32k | 32x8 | off | 1.250 | params=1.0 + "
        "cache=0.25 | 2.00e+12 | 1.00e+09 | n/a | 0.5 |"]
    assert RP.roofline_table(recs).splitlines()[2:] == [
        "| b-arch | decode_32k | 2.00e-03 | 1.00e-03 | n/a | **compute** "
        "| 4.00e+14 | 5.12e+14 | 0.781 |"]
    dry = tmp_path / "dry.json"
    dry.write_text(json.dumps(recs))
    RP.main([str(dry)])
    assert "## Roofline (single-pod 32x8)" in capsys.readouterr().out
    hill = [dict(fake_record("musicgen-large", "decode_32k", "32x8", 256,
                             memory_s=m, analytic={"params_gb": 0.02,
                                                   "cache_gb": c}),
                 experiment=e, hypothesis="h")
            for e, m, c in (("musicgen/0-baseline", 8e-3, 6.5),
                            ("musicgen/1-beyond-f8cache", 4e-3, 3.25))]
    (tmp_path / "hill.json").write_text(json.dumps(hill))
    out = tmp_path / "EXP.md"
    GE.main(["--dryrun", str(dry), "--hillclimb",
             str(tmp_path / "hill.json"), "--out", str(out)])
    text = out.read_text()
    assert text.startswith(GE.HEADER)
    assert "| b-arch | decode_32k | 2.000 | 1.000 | n/a | **compute** " \
        "| 4.00e+14 | 0.781 |" in text
    assert "| a-arch | train_4k |" not in text.split("§Roofline")[1]
    assert "| musicgen/1-beyond-f8cache | h | 2.000 | 4.000 | n/a | " \
        "compute | 3.270 |" in text
    assert "memory term 8.000 -> 4.000 ms (-50%); cache 6.5 -> 3.25 GB" \
        in text
    for tpu in ("v5e", "197", "819", "TPU"):
        assert tpu not in GE.HEADER


def test_hillclimb_runs_the_three_experiments(monkeypatch, tmp_path):
    """The experiment list with lower_one stubbed: each call's policy,
    cache dtype and FSDP flag, in the reference's order, less the
    no-seqpar ablation."""
    calls = []

    def stub(cfg, shape, mesh, *, policy=None, cache_dtype=None, fsdp=True):
        calls.append((cfg.name, shape.name, policy, cache_dtype, fsdp))
        return fake_record(cfg.name, shape.name, "32x8", mesh.size)

    monkeypatch.setattr(HC, "lower_one", stub)
    out = tmp_path / "hill.json"
    recs = HC.main(["--out", str(out)])
    ep = XSharePolicy(mode="ep", k0=1, m_g=4, num_groups=8)
    assert calls == [
        ("qwen3-moe-235b-a22b", "decode_32k", XSharePolicy(mode="off"),
         None, True),
        ("qwen3-moe-235b-a22b", "decode_32k",
         XSharePolicy(mode="batch", k0=1, m_l=16), None, True),
        ("qwen3-moe-235b-a22b", "decode_32k", ep, None, True),
        ("qwen3-moe-235b-a22b", "decode_32k", ep, torch.float8_e4m3fn, True),
        ("musicgen-large", "decode_32k", None, None, True),
        ("musicgen-large", "decode_32k", None, torch.float8_e4m3fn, True),
        ("zamba2-1.2b", "train_4k", None, None, True),
        ("zamba2-1.2b", "train_4k", None, None, False)]
    assert [r["experiment"] for r in recs] == [
        "qwen3/0-vanilla-topk", "qwen3/1-paper-xshare-batch",
        "qwen3/2-beyond-ep-aware", "qwen3/3-beyond-ep+f8cache",
        "musicgen/0-baseline", "musicgen/1-beyond-f8cache",
        "zamba2/0-baseline-fsdp", "zamba2/1-beyond-nofsdp"]
    assert json.loads(out.read_text()) == recs
