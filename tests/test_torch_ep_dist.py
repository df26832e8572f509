"""Expert parallelism with one process per shard (``ep.DistEPExecutor``,
started by ``ep.dist.spawn`` over gloo on the CPU) against the JAX
package's shard_map executor on make_ep_mesh(4) (the 8 emulated devices
of tests/conftest.py) and against the port's one-process EPExecutor and
sorted dispatch.

The ranks run in one module-scoped spawn per S (4 and 2), both started
together before JAX's outputs are computed, so they run meanwhile; the
rank bodies are tests/torch_ep_ranks.py, and each test reads what they
returned; a rank that waits RANK_TIMEOUT_S in a collective raises. At
S 4: tests/test_torch_ep.py's CASES (y within 2e-5 of JAX's, every
EPStats field and max_rows equal, y bit-equal to the one-process
executor and to sorted_expert_ffn; its k1, k2 and k8 are also the top_k
1, 2 and 8 bit-equality cases), update_placement on every rank (from
raw counts too, within the rank's expert memory), and a call under
(emulated) CUDA graph capture refused. At S 2: top_k 1, 2 and 8
bit-equal, and Engine(dispatch="ep") served by two ranks whose trees
hold only their experts: tokens equal "sorted"'s, continuous equal
lockstep, again after a placement update cut into the engine's tensors
in place."""
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import ep as JEP  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.ep.placement import plan_placement as jplan  # noqa: E402
from repro.sharding import make_ep_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import ep as EP  # noqa: E402
from repro_torch.configs.base import MoEConfig, XSharePolicy  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.ep import dist as DIST  # noqa: E402
from repro_torch.launch import roofline as RF  # noqa: E402
from repro_torch.models import dispatch as TD  # noqa: E402
from repro_torch.models.moe import route  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

import torch_ep_ranks as RANKS  # noqa: E402
from test_torch_ep import (CASES, D, E, F, TOL,  # noqa: E402
                           clamp_reference, hot_load, make_case, placements,
                           routing, small)

FIELDS = ("computed_rows", "tile_rows", "sent_rows", "a2a_bytes",
          "count_matrix")
S4_CASES = [(c[0], 4) + c[2:] for c in CASES]
BIT_K = (1, 2, 8)
NEW = 8
RANK_TIMEOUT_S = 120.0


def np_weights():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(s) * 0.2).astype(np.float32)
            for s in ((E, D, F), (E, D, F), (E, F, D))]


def bit_calls(S):
    """top_k 1, 2, 8 on the contiguous and a replicated placement."""
    calls = []
    for k in BIT_K:
        x, idx, w = routing(37, k, seed=S * k)
        for tag, pl in (("contig", EP.contiguous_placement(E, S)),
                        ("rep", EP.plan_placement(hot_load(), S,
                                                  replicate_hot=2,
                                                  max_replicas=3))):
            calls.append((f"bit_k{k}_{tag}", pl, x, idx, w, None))
    return calls


def sparse_load():
    """Raw counts of a step that routed to two experts of contiguous
    shard 0: the other 14 at 0."""
    load = np.zeros(E)
    load[[1, 2]] = [5.0, 3.0]
    return load


def one_process(call, weights):
    """The one-process EPExecutor's (y, stats) and sorted_expert_ffn's y
    on the full weights."""
    _, pl, x, idx, w, mr = call
    args = [torch.tensor(a) for a in (x, *weights, idx, w)]
    ex = EP.EPExecutor(pl.num_shards, pl, device="cpu", max_rows=mr)
    return ex(*args), TD.sorted_expert_ffn(*args)


@pytest.fixture(scope="module")
def weights():
    return np_weights()


def case_inputs(case):
    """test_torch_ep's inputs of a case; the alg6 routing from the port's
    router (held equal to JAX's by tests/test_torch_selection.py), which
    spares a JAX compile."""
    if case[4] != "alg6":
        return make_case(case)
    T, k = case[2], case[3]
    x, _, _ = routing(T, k, 7)
    rng = np.random.default_rng(8)
    p = {"wg": torch.tensor(rng.standard_normal((D, E)), dtype=torch.float32)}
    idx, w, _, _ = route(p, torch.tensor(x), MoEConfig(E, k, F),
                         XSharePolicy(mode="ep", k0=1, m_g=1, num_groups=8))
    return x, idx.numpy().astype(np.int32), w.numpy().astype(np.float32)


@pytest.fixture(scope="module")
def s4_calls():
    calls = []
    for case in S4_CASES:
        x, idx, w = case_inputs(case)
        tpl, _ = placements(4, case[5])
        calls.append((case[0], tpl, x, idx, w, case[6]))
    return calls


@pytest.fixture(scope="module")
def granite():
    """The reduced granite's config and a host tree with the JAX
    package's keys, shapes and dtypes (jax.eval_shape of its
    init_params), drawn with numpy: N(0, 0.02), norm scales 1."""
    jcfg, tcfg = small(JARCHS), small(ARCHS)
    shapes = jax.eval_shape(lambda: JMD.init_params(jcfg,
                                                    jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    flat = {k: (np.ones(s.shape) if k.split("/")[-1].endswith("norm")
                else rng.standard_normal(s.shape) * 0.02).astype(s.dtype)
            for k, s in bridge.flatten(shapes).items()}
    return tcfg, bridge.unflatten(flat)


@pytest.fixture(scope="module")
def started(weights, s4_calls, granite):
    """Both spawns, started together: futures of the S 4 and S 2 ranks'
    results."""
    x, idx, w = routing(24, 2, seed=4)
    pl = EP.contiguous_placement(E, 4)
    cfg, host = granite
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    pl2, load = serve_start()
    with ThreadPoolExecutor(2) as pool:
        s4 = pool.submit(
            DIST.spawn, RANKS.suite, 4, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S, args=(weights, s4_calls),
            kwargs=dict(update=(pl, hot_load(), x, idx, w,
                                hot_load()[::-1].copy(), sparse_load()),
                        capture=(pl, x, idx, w)))
        s2 = pool.submit(
            DIST.spawn, RANKS.suite, 2, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S, args=(weights, bit_calls(2)),
            kwargs=dict(serve=(cfg, host, prompts, NEW, pl2, load)))
        yield s4, (s2, prompts)


@pytest.fixture(scope="module")
def jax_refs(started, s4_calls, weights):
    """JAX's EPExecutor on make_ep_mesh(4) for every S 4 case, computed
    while the ranks run (one executor per placement and max_rows, so
    cases of one shape share a compile)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices (tests/conftest.py)")
    execs, out = {}, {}
    for case, call in zip(S4_CASES, s4_calls):
        name, S, _, _, _, place, mr = case
        _, _, x, idx, w, _ = call
        key = (place, mr)
        if key not in execs:
            execs[key] = JEP.EPExecutor(make_ep_mesh(S), placements(S,
                                                                    place)[1],
                                        max_rows=mr)
        jy, jst = execs[key](*[jnp.asarray(a)
                               for a in (x, *weights, idx, w)])
        out[name] = (np.asarray(jy), jst)
    return out


@pytest.fixture(scope="module")
def ranks4(started):
    return started[0].result()


@pytest.fixture(scope="module")
def ranks2(started):
    s2, prompts = started[1]
    return s2.result(), prompts


def serve_start():
    """A placement with a replica (expert_cap 9 at S 2), and a load that
    replicates another expert at the same table shape."""
    pl = EP.plan_placement(np.ones(E), 2, replicate_hot=1, max_replicas=2)
    load = np.ones(E)
    load[9] = 4.0
    return pl, load


def check_ranks_agree(outs, name):
    """Every rank holds the same gathered y and EPStats."""
    r0 = outs[0]["calls"][name]
    for o in outs[1:]:
        r = o["calls"][name]
        assert torch.equal(r["y"], r0["y"]) and torch.equal(r["ffn"],
                                                            r0["ffn"])
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(r["stats"], f),
                                          getattr(r0["stats"], f))
    return r0


@pytest.mark.parametrize("case", S4_CASES, ids=[c[0] for c in S4_CASES])
def test_ranks_match_jax_shard_map(jax_refs, ranks4, s4_calls, weights,
                                   case):
    """y within 2e-5 of JAX's EPExecutor on 4 devices, every EPStats
    field and max_rows equal; bit-equal to the one-process executor
    (y and stats) and to sorted_expert_ffn (the clamp: on the routing
    whose dropped pairs are zeroed); each rank holds expert_cap stacks."""
    name, S, T, k, kind, place, mr = case
    call = next(c for c in s4_calls if c[0] == name)
    _, tpl, x, idx, w, _ = call
    jy, jst = jax_refs[name]
    r = check_ranks_agree(ranks4, name)
    y, st = r["y"], r["stats"]
    np.testing.assert_allclose(y.numpy(), jy, atol=TOL, rtol=TOL)
    (y1, st1), _ = one_process(call, weights)
    assert torch.equal(y, y1)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f),
                                      np.asarray(getattr(jst, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(st, f), getattr(st1, f))
    assert st.max_rows == jst.max_rows == st1.max_rows
    np.testing.assert_array_equal(r["counts"], st.count_matrix)
    ws = w if mr != 3 else clamp_reference(idx, w, tpl, st.max_rows)
    ref = TD.sorted_expert_ffn(*[torch.tensor(a)
                                 for a in (x, *weights, idx, ws)])
    assert torch.equal(y, ref)
    assert torch.equal(r["ffn"], y1 if mr == 3 else ref)
    for rank, o in enumerate(ranks4):
        held = o["calls"][name]["held"]
        assert [h[0] for h in held] == [tpl.expert_cap] * 3
        np.testing.assert_array_equal(o["calls"][name]["local_eids"],
                                      tpl.local_eids[rank])


@pytest.mark.parametrize("k", BIT_K)
@pytest.mark.parametrize("S", [2, 4])
def test_ranks_bit_equal_sorted(ranks4, ranks2, s4_calls, weights, S, k):
    """top_k 1, 2, 8: y and EPStats equal the one-process executor's, y
    equals sorted dispatch's, bit for bit; at S 2 on the contiguous and
    a replicated placement, at S 4 the CASES k1, k2, k8 (contiguous; the
    replicated placement at S 4 is the case replicated_S4)."""
    if S == 4:
        outs, calls = ranks4, [c for c in s4_calls if c[0] == f"k{k}"]
    else:
        outs = ranks2[0]
        calls = [c for c in bit_calls(S) if c[0].startswith(f"bit_k{k}_")]
    assert calls
    for call in calls:
        r = check_ranks_agree(outs, call[0])
        (y1, st1), ref = one_process(call, weights)
        assert torch.equal(r["y"], y1) and torch.equal(r["y"], ref)
        assert torch.equal(r["ffn"], ref)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(r["stats"], f),
                                          getattr(st1, f))


def test_update_placement_same_on_every_rank(ranks4, weights):
    """Every rank adopts the same placement (the one-process executor's)
    and version; the recut experts give sorted's y; hysteresis skips the
    repeat on every rank; a load that differs on one rank is refused by
    every rank."""
    kw = dict(replicate_hot=1, max_replicas=4)
    ex = EP.EPExecutor(4, EP.contiguous_placement(E, 4), device="cpu",
                       max_expert_cap=EP.even_cap(E, 4, **kw), **kw)
    assert ex.update_placement(hot_load())
    x, idx, w = routing(24, 2, seed=4)
    ref = TD.sorted_expert_ffn(*[torch.tensor(a)
                                 for a in (x, *weights, idx, w)])
    for rank, o in enumerate(ranks4):
        u = o["update"]
        assert u["changed"] and u["version"] == ex.placement.version == 1
        np.testing.assert_array_equal(u["hosts"], ex.placement.hosts)
        np.testing.assert_array_equal(u["local_eids"],
                                      ex.placement.local_eids[rank])
        assert torch.equal(u["y"], ref)
        assert u["again"] is False and u["skipped"] == 1
        assert u["odd"] is not None and "different placements" in u["odd"]


def test_update_placement_from_raw_counts_within_rank_memory(ranks4):
    """Raw counts with 14 of 16 experts at 0: the unbounded planner (the
    JAX package's) piles those 14 onto one shard; a DistEPExecutor plans
    within its max_expert_cap (by default the even split, 4), as the
    one-process executor does under the same bound, on every rank; a
    first placement above an explicit max_expert_cap is refused."""
    load = sparse_load()
    assert EP.plan_placement(load, 4).expert_cap == \
        jplan(load, 4).expert_cap == 14
    ex = EP.EPExecutor(4, EP.contiguous_placement(E, 4), device="cpu",
                       max_expert_cap=EP.even_cap(E, 4))
    assert ex.update_placement(load) and ex.placement.expert_cap == 4
    for o in ranks4:
        sp = o["update"]["sparse"]
        assert sp["changed"] and sp["bound"] == sp["cap"] == 4
        np.testing.assert_array_equal(sp["hosts"], ex.placement.hosts)
        assert sp["refused"] is not None and \
            "max_expert_cap 4" in sp["refused"]


@pytest.mark.parametrize("S", [2, 4])
def test_plan_placement_bounded_per_shard(S):
    """max_per_shard: no shard above it, every expert hosted; a bound the
    unbounded plan already keeps gives the JAX package's placement; a
    bound below the even split raises."""
    rng = np.random.default_rng(S)
    loads = [hot_load(), sparse_load(), rng.random(E),
             np.arange(E, dtype=np.float64) ** 2]
    for load in loads:
        for kw in (dict(), dict(replicate_hot=2, max_replicas=S)):
            even = EP.even_cap(E, S, **kw)
            pl = EP.plan_placement(load, S, max_per_shard=even, **kw)
            assert pl.expert_cap == even
            held = [set(int(e) for e in r if e >= 0) for r in pl.local_eids]
            for e in range(E):
                n = int(pl.nhosts[e])
                assert n == (S if kw and e in np.lexsort(
                    (np.arange(E), -load))[:2] else 1)
                assert all(e in held[int(h)] for h in pl.hosts[e, :n])
            free = jplan(load, S, **kw)
            same = EP.plan_placement(load, S, max_per_shard=free.expert_cap,
                                     **kw)
            np.testing.assert_array_equal(same.hosts, free.hosts)
            np.testing.assert_array_equal(same.local_eids, free.local_eids)
            with pytest.raises(ValueError, match="need"):
                EP.plan_placement(load, S, max_per_shard=even - 1, **kw)


def test_capture_refused_on_every_rank(ranks4, weights):
    x, idx, w = routing(24, 2, seed=4)
    ref = TD.sorted_expert_ffn(*[torch.tensor(a)
                                 for a in (x, *weights, idx, w)])
    for o in ranks4:
        c = o["capture"]
        assert c["msg"] is not None and "CUDA graph" in c["msg"] \
            and "gloo" in c["msg"] and "lockstep=True" in c["msg"]
        assert torch.equal(c["after"], ref)


def test_engine_on_two_ranks_equals_sorted(ranks2, granite):
    """Each rank serves from a tree whose MoE leaves hold its expert_cap
    experts; tokens equal dispatch="sorted"'s on the full tree,
    continuous == lockstep, and again after update_placement with the
    experts cut into the engine's tensors in place."""
    outs, prompts = ranks2
    cfg, host = granite
    full = bridge.from_numpy(host, device="cpu")
    ref, _ = Engine(cfg, full, cache_len=64, dispatch="sorted",
                    device="cpu").generate(prompts, NEW)
    pl, load = serve_start()
    one = EP.EPExecutor(2, pl, device="cpu", replicate_hot=1,
                        max_replicas=2, max_expert_cap=pl.expert_cap)
    assert one.update_placement(load)
    L, _, d, f = host["layers"]["moe"]["w1"].shape
    for rank, o in enumerate(outs):
        s = o["served"]
        assert s["held"] == (L, pl.expert_cap, d, f)
        np.testing.assert_array_equal(s["cont"], ref)
        np.testing.assert_array_equal(s["lock"], ref)
        np.testing.assert_array_equal(s["after"], ref)
        assert s["changed"] and s["version"] == 1
        assert s["cap"] == pl.expert_cap == one.placement.expert_cap
        want = bridge.cut_experts(host, one.placement.local_eids[rank],
                                  device="cpu")["layers"]["moe"]["w1"]
        assert torch.equal(s["moe_w1"], want)


def test_cut_experts_from_numpy_and_torch(granite):
    """The cut reads the JAX package's numpy tree and the port's torch
    tree alike: expert leaves (layers/moe/w1, w3, w2) cut along the
    expert axis, -1 padding read as expert 0, other leaves whole; into=
    copies in place and refuses another expert_cap."""
    cfg, host = granite
    eids = np.array([3, 7, -1])
    a = bridge.cut_experts(host, eids, device="cpu")
    full = bridge.from_numpy(host, device="cpu")
    b = bridge.cut_experts(full, eids, device="cpu")
    fa, fb, ff = (bridge.flatten(t) for t in (a, b, full))
    assert fa.keys() == ff.keys()
    for key, t in ff.items():
        assert torch.equal(fa[key], fb[key])
        if bridge.is_expert_leaf(key):
            assert torch.equal(fa[key], t[:, [3, 7, 0]])
        else:
            assert torch.equal(fa[key], t)
    w1 = a["layers"]["moe"]["w1"]
    ptr = w1.data_ptr()
    bridge.cut_experts(full, np.array([1, 2, 3]), device="cpu", into=a)
    assert w1.data_ptr() == ptr and torch.equal(w1, ff["layers/moe/w1"][:,
                                                                       1:4])
    with pytest.raises(ValueError, match="expert_cap"):
        bridge.cut_experts(full, np.array([1, 2]), device="cpu", into=a)
    with pytest.raises(ValueError, match="DistEPExecutor"):
        Engine(cfg, b, cache_len=64, dispatch="sorted",
               device="cpu").generate(np.zeros((1, 4), np.int32), 2)


def test_backends_refused_without_cards(monkeypatch):
    """NCCL wants a card per rank: on the CPU, or with more ranks than
    cards, it raises before any process starts; an unknown backend
    raises; nothing switches backend on its own."""
    with pytest.raises(ValueError, match="CUDA"):
        DIST.spawn(RANKS.suite, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="one of"):
        DIST.spawn(RANKS.suite, 2, backend="mpi", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="card per rank"):
        DIST.check_backend("nccl", 4)
    assert DIST.check_backend("nccl", 1).type == "cuda"
    assert DIST.check_backend("gloo", 4).type == "cuda"


def test_exchange_bound_from_measured_bytes(ranks4):
    """launch/roofline.py's collective term on a stats' a2a_bytes: the
    busiest rank's bytes over LINK_BW, a bound per layer call."""
    st = ranks4[0]["calls"]["k8"]["stats"]
    busiest = int(st.a2a_bytes.max())
    assert RF.ep_collective_bytes(st) == busiest
    assert RF.ep_collective_bytes(st.a2a_bytes) == busiest
    terms = RF.roofline_terms(0.0, 0.0, RF.ep_collective_bytes(st))
    assert terms["collective_s"] == busiest / 450e9
    assert terms["dominant"] == "collective"


def test_padded_exchange_bytes(ranks4):
    """What a rank's exchange moves in blocks of M rows a peer: counts,
    payload and int32 expert ids out, rows back, to each of S - 1 peers.
    With no clamp (M = T_loc·k) that is at least the occupied rows'
    bytes beside the counts (a2a_bytes counts the count vectors both
    ways, 2·S·4); under the clamp a2a_bytes counts the routed rows,
    dropped ones too, and may exceed it."""
    for name in ("k8", "clamp"):
        st = ranks4[0]["calls"][name]["stats"]
        M = st.max_rows
        got = RF.ep_padded_exchange_bytes(4, M, D, 4)
        assert got == 3 * 4 + 3 * M * D * 4 + 3 * M * 4 + 3 * M * D * 4
    assert M == 3 and got < RF.ep_collective_bytes(st)
    st = ranks4[0]["calls"]["k8"]["stats"]
    assert st.max_rows == 40 // 4 * 8
    assert RF.ep_padded_exchange_bytes(4, st.max_rows, D, 4) - 3 * 4 >= \
        RF.ep_collective_bytes(st) - 2 * 4 * 4
