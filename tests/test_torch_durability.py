"""Crash-tolerant serving in the port against the JAX package's: fault
campaigns, checkpoints, the journal, snapshots and the front door.

The same weights (initialized in JAX, carried over by
``bridge.from_numpy``) and prompts go through both packages at the
reduced granite-moe of tests/test_frontdoor.py. What must hold:
  * a seed gives the same fault campaign on both sides, field for field;
  * each fault kind ends the same requests with the same reasons and
    tokens, and a NaN quarantine leaves co-batched slots bit-exact;
  * checkpoints, journals and snapshots written by either side read back
    on the other, bf16 bit-exact and int64 kept;
  * the port's front door streams greedy tokens, and a kill-and-recover
    — also of a crash the JAX front door wrote — loses no request and
    replays bit-identically (fidelity 1.0).
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import FrontDoor as JFrontDoor  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import journal as jjournal  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.serving import (Engine, Fault, FaultInjector,  # noqa: E402
                                 FrontDoor, RequestCancelled,
                                 ShuttingDown, SimulatedCrash, read_journal,
                                 recover, sample_campaign)
from repro_torch.serving import journal as tjournal  # noqa: E402
from repro_torch.serving.errors import (REASON_CANCELLED,  # noqa: E402
                                        REASON_COMPLETED, REASON_FAULT,
                                        REASON_NUMERICS)

NEW = 12


def small(archs):
    return archs["granite-moe-1b-a400m"].reduced(
        num_layers=2, max_d_model=128, max_vocab=256)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small(JARCHS), small(ARCHS)
    jp = j_init(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (3, 12), 0, jcfg.vocab_size))
    return jcfg, tcfg, jp, tp, prompts


@pytest.fixture(scope="module")
def engine(setup):
    _, tcfg, _, tp, _ = setup
    return Engine(tcfg, tp, cache_len=128, decode_chunk=4, device="cpu")


@pytest.fixture(scope="module")
def jengine(setup):
    jcfg, _, jp, _, _ = setup
    return JEngine(jcfg, jp, cache_len=128, decode_chunk=4)


@pytest.fixture(scope="module")
def spec_engine(setup):
    """Self-draft speculative engine: every round journals a burst."""
    _, tcfg, _, tp, _ = setup
    return Engine(tcfg, tp, cache_len=128, draft=(tcfg, tp), spec_len=3,
                  device="cpu")


@pytest.fixture(scope="module")
def free(engine, jengine, setup):
    """The uninterrupted greedy tokens, equal in both packages."""
    prompts = setup[4]
    mine, _ = engine.generate(prompts, NEW)
    theirs, _ = jengine.generate(prompts, NEW)
    np.testing.assert_array_equal(mine, np.asarray(theirs))
    return mine


def stream_tokens(stream):
    return np.asarray([int(t) for t in stream.tokens])


def drained(sched):
    assert all(s is None for s in sched._slots)
    assert not sched._active.any()
    assert not sched._queue and not sched._incoming
    assert all(st.status in ("done", "shed") for st in sched._states)
    sched.check_invariants()


# ------------------------------------------------------------- faults ----

@pytest.mark.parametrize("p_crash", [0.0, 1.0])
@pytest.mark.parametrize("seed", [0, 3, 10, 25])
def test_sample_campaign_matches_jax(seed, p_crash):
    kw = dict(num_requests=8, num_slots=4, horizon_steps=32,
              p_crash=p_crash)
    mine = sample_campaign(seed, **kw).faults
    theirs = jfaults.sample_campaign(seed, **kw).faults
    assert [dataclasses.asdict(f) for f in mine] == \
        [dataclasses.asdict(f) for f in theirs]


FAULT_CASES = {
    # NaN logits on slot 1 at global step 5 of three co-batched slots
    "nan": (dict(num_slots=3), [Fault("nan_logits", slot=1, step=5)]),
    # two insert failures inside a retry budget of 3
    "insert_transient": (dict(num_slots=2, max_retries=3),
                         [Fault("insert_fail", rid=1, times=2)]),
    # failures past the budget shed the afflicted request alone
    "insert_permanent": (dict(num_slots=2, max_retries=2),
                         [Fault("insert_fail", rid=1, times=99)]),
}


def serve_with_faults(eng, prompts, sched_kw, faults, injector_cls):
    inj = injector_cls([dataclasses.replace(f) for f in faults])
    sched = eng.make_scheduler(faults=inj, invariants=True,
                               retry_backoff_s=0.001, **sched_kw)
    staggered = sched_kw["num_slots"] < 3     # insert_request path
    for b in range(3):
        sched.submit(prompts[b], NEW, arrival_s=0.01 * b if staggered
                     else 0.0)
    states = sched.run()
    drained(sched)
    return [(st.status, st.finish_reason,
             [int(t) for t in st.tokens]) for st in states], inj, sched


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_fault_kinds_match_jax(case, engine, jengine, setup, free):
    """The port's Scheduler under one fault: the same outcome per
    request as the JAX package's (status, reason, tokens), and every
    request the fault did not hit is token-exact with the fault-free
    run."""
    prompts = setup[4]
    sched_kw, faults = FAULT_CASES[case]
    jfaults_ = [jfaults.Fault(**dataclasses.asdict(f)) for f in faults]
    mine, inj, sched = serve_with_faults(engine, prompts, sched_kw, faults,
                                         FaultInjector)
    theirs, jinj, _ = serve_with_faults(jengine, prompts, sched_kw,
                                        jfaults_, jfaults.FaultInjector)
    assert mine == theirs
    assert inj.log == jinj.log
    hit = {"nan": REASON_NUMERICS, "insert_transient": None,
           "insert_permanent": REASON_FAULT}[case]
    for b, (status, reason, toks) in enumerate(mine):
        if b == 1 and hit is not None:
            assert reason == hit
            np.testing.assert_array_equal(toks, free[b][:len(toks)])
        else:
            assert reason == REASON_COMPLETED
            np.testing.assert_array_equal(toks, free[b])
    if case == "nan":
        assert len(mine[1][2]) == 6       # 1 prefill token + 5 steps
    if case == "insert_transient":
        assert sched.retries >= 2


def test_stall_and_slow_prefill_count_as_stalls(engine, setup):
    """A host delay before a prefill and before a decode round each
    trip the step-time watchdog; the requests still complete."""
    prompts = setup[4]
    inj = FaultInjector([Fault("slow_prefill", rid=0, delay_s=0.05),
                         Fault("stall_decode", step=1, delay_s=0.05)])
    sched = engine.make_scheduler(num_slots=2, faults=inj, invariants=True,
                                  watchdog_s=0.03)
    for b in range(2):
        sched.submit(prompts[b], 8, arrival_s=0.01 * b)
    states = sched.run()
    drained(sched)
    assert all(st.status == "done" for st in states)
    assert sched.stall_events >= 2
    assert {"slow_prefill", "stall_decode"} <= {e[0] for e in inj.log}


def test_spec_scheduler_quarantines_a_nan_round(spec_engine, setup, free):
    """SpecScheduler takes faults= too: a NaN on slot 0's verify logits
    in round 1 sheds that request only; the other stays greedy-exact."""
    prompts = setup[4]
    inj = FaultInjector([Fault("nan_logits", slot=0, step=1)])
    sched = spec_engine.make_scheduler(num_slots=2, faults=inj,
                                       invariants=True)
    for b in range(2):
        sched.submit(prompts[b], NEW)
    states = sched.run()
    drained(sched)
    assert states[0].finish_reason == REASON_NUMERICS
    np.testing.assert_array_equal(np.stack(states[0].tokens),
                                  free[0][:len(states[0].tokens)])
    assert states[1].finish_reason == REASON_COMPLETED
    np.testing.assert_array_equal(np.stack(states[1].tokens), free[1])


# --------------------------------------------------------- checkpoint ----

def ckpt_tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b16": rng.standard_normal((5,)).astype(np.float32),
            "slots": np.array([2 ** 40, -1, 7], np.int64),
            "layers": [{"a": rng.standard_normal((2,)).astype(np.float32)},
                       {"a": rng.standard_normal((2,)).astype(np.float32)}],
            "pair": (np.arange(3, dtype=np.int32),
                     np.float64(0.5) * np.ones(2))}


def as_torch(t):
    return {"w": torch.tensor(t["w"]),
            "b16": torch.tensor(t["b16"]).to(torch.bfloat16),
            "slots": t["slots"],
            "layers": [{"a": torch.tensor(x["a"])} for x in t["layers"]],
            "pair": (torch.tensor(t["pair"][0]), t["pair"][1])}


def as_jax(t):
    return {"w": jnp.asarray(t["w"]),
            "b16": jnp.asarray(t["b16"], jnp.bfloat16),
            "slots": t["slots"],
            "layers": [{"a": jnp.asarray(x["a"])} for x in t["layers"]],
            "pair": (jnp.asarray(t["pair"][0]), t["pair"][1])}


def check_restored_torch(out, want):
    assert out["b16"].dtype == torch.bfloat16
    assert torch.equal(out["b16"], want["b16"])            # bit-exact
    assert out["slots"].dtype == np.int64
    np.testing.assert_array_equal(out["slots"], want["slots"])
    assert torch.equal(out["w"], want["w"])
    assert torch.equal(out["layers"][1]["a"], want["layers"][1]["a"])
    assert isinstance(out["pair"], tuple)
    assert torch.equal(out["pair"][0], want["pair"][0])
    assert out["pair"][1].dtype == np.float64


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_cross_reads(writer, tmp_path):
    """A checkpoint either side writes: the same keys and stored arrays
    through both loaders, and a restore on either side gives bf16
    bit-exact and int64 unnarrowed."""
    base = np.random.default_rng(4)
    t = ckpt_tree(base)
    path = str(tmp_path / "ck")
    if writer == "port":
        tckpt.save_checkpoint(path, as_torch(t), step=3, extra={"k": 1})
    else:
        jckpt.save_checkpoint(path, as_jax(t), step=3, extra={"k": 1})
    (tf, tm), (jf, jm) = tckpt.load_checkpoint(path), \
        jckpt.load_checkpoint(path)
    assert sorted(tf) == sorted(jf) == tm["keys"] == jm["keys"]
    assert "layers/1/a" in tf and "pair/0" in tf
    for k in tf:
        np.testing.assert_array_equal(tf[k], jf[k])
    assert tm["step"] == 3 and tm["extra"] == {"k": 1}
    check_restored_torch(tckpt.restore_checkpoint(path, as_torch(t)),
                         as_torch(t))
    jout = jckpt.restore_checkpoint(path, as_jax(t))
    assert jout["b16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jout["b16"], np.float32),
                                  np.asarray(as_jax(t)["b16"], np.float32))
    assert jout["slots"].dtype == np.int64
    np.testing.assert_array_equal(jout["slots"], t["slots"])


def test_checkpoint_refuses_a_shape_mismatch(tmp_path):
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {"a": torch.zeros(4)})
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(path, {"b": torch.zeros(3)})


# ----------------------------------------------- journal and snapshots ----

SIDES = {"port": tjournal, "jax": jjournal}


def write_journal(side, path):
    """submit, admit, tokens, a cancel, a finish — and a torn tail."""
    w = SIDES[side].JournalWriter(path, fsync_every=2)
    for rid in range(3):
        w.append("submit", rid=rid, prompt=[rid, 5, 6], max_new=8,
                 arrival_s=0.0, spec=rid == 2)
    w.append("admit", rid=0)
    w.append("token", rid=0, i=0, tok=[11, 12])
    w.append("token", rid=1, i=0, tok=[21])
    w.append("token", rid=0, i=2, tok=[13])
    w.append("finish", rid=1, reason="completed", n_tokens=1)
    w.append("cancel", rid=2)
    w.append("token", rid=0, i=3, tok=[14])        # buffered, then torn
    assert w.abandon(torn_bytes=5) == 1


def write_snapshot(side, path):
    mod = SIDES[side]
    snap = mod.Snapshot(next_rid=3, seq=6, total_steps=8, round_idx=2,
                        slot_rids=np.array([0, -1], np.int64),
                        slot_cur_len=np.array([5, 0], np.int64))
    if side == "jax":
        snap.rng_key = np.asarray(jax.random.PRNGKey(7))
    else:
        snap.torch_rng_state = torch.Generator().manual_seed(7) \
            .get_state().numpy()
    snap.requests = {0: {"prompt": np.array([0, 5, 6], np.int32),
                         "tokens": [11, 12], "max_new": 8, "reason": None,
                         "spec": False},
                     1: {"prompt": np.array([1, 5, 6], np.int32),
                         "tokens": [21], "max_new": 8,
                         "reason": "completed", "spec": False}}
    snap.queue = [0]
    mod.save_snapshot(path, snap)


def comparable(table):
    return {rid: dict(r, prompt=np.asarray(r["prompt"]).tolist(),
                      tokens=[int(t) for t in r["tokens"]])
            for rid, r in table.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_and_snapshot_cross_read(writer, tmp_path):
    """Files one side writes read back and fold to the same request
    table on both sides: the torn tail is skipped, the cancel flag and
    the spec flag survive, and the snapshot's slot tables stay int64."""
    jp, sp = str(tmp_path / "wal"), str(tmp_path / "snap")
    write_journal(writer, jp)
    write_snapshot(writer, sp)
    tables = {}
    for side, mod in SIDES.items():
        tail = mod.read_journal(jp)
        assert tail.torn and len(tail.records) == 9
        snap = mod.load_snapshot(sp)
        assert snap.slot_rids.dtype == np.int64
        assert snap.round_idx == 2 and snap.next_rid == 3
        tables[side] = comparable(mod.fold_records(tail.records, base=snap))
        # idempotent: replaying the journal twice changes nothing
        again = mod.fold_records(tail.records + tail.records, base=snap)
        assert comparable(again) == tables[side]
    assert tables["port"] == tables["jax"]
    t = tables["port"]
    assert t[0]["tokens"] == [11, 12, 13] and t[0]["reason"] is None
    assert t[1]["reason"] == "completed"
    assert t[2]["cancel_requested"] and t[2]["spec"]
    port_snap = tjournal.load_snapshot(sp)
    assert (port_snap.rng_key is None) == (writer == "port")
    assert (port_snap.torch_rng_state is None) == (writer == "jax")


# --------------------------------------------------------- front door ----

def test_streaming_cancel_and_drain(engine, setup, free):
    """Tokens consumed live equal generate()'s; a mid-stream cancel ends
    its stream with an exact prefix; drain closes admissions."""
    prompts = setup[4]
    door = engine.make_frontdoor(num_slots=2)
    streams = [door.submit(prompts[b], NEW) for b in range(2)]
    live = list(streams[0])
    assert len(live) == NEW
    long = door.submit(prompts[2], 100)
    it = iter(long)
    got = [next(it), next(it)]
    assert door.cancel(long.rid)
    rest = list(it)
    door.drain(timeout=120.0)
    assert door.crashed is None
    for b in range(2):
        assert streams[b].finish_reason == REASON_COMPLETED
        np.testing.assert_array_equal(streams[b].result(timeout=1.0),
                                      free[b])
    assert long.finish_reason == REASON_CANCELLED
    n = len(got) + len(rest)
    assert 2 <= n < 100
    np.testing.assert_array_equal(stream_tokens(long)[:NEW],
                                  free[2][:min(n, NEW)])
    with pytest.raises(RequestCancelled):
        long.result(timeout=1.0)
    with pytest.raises(ShuttingDown):
        door.submit(prompts[0], 4)


def crash_and_recover(eng, prompts, tmp_path, faults, *, n=3, snap_every=1,
                      fsync_every=8, door_cls=FrontDoor, rec_engine=None,
                      **submit_kw):
    jp = os.path.join(tmp_path, "wal.journal")
    sp = os.path.join(tmp_path, "snap")
    door = door_cls(eng, num_slots=2, journal_path=jp,
                    snapshot_path=sp if snap_every else None,
                    snapshot_every_rounds=snap_every,
                    fsync_every=fsync_every,
                    faults=FaultInjector(faults) if door_cls is FrontDoor
                    else jfaults.FaultInjector(faults)).start()
    streams = [door.submit(prompts[b], NEW, **submit_kw) for b in range(n)]
    door.drain(timeout=120.0)
    assert isinstance(door.crashed, (SimulatedCrash,
                                     jfaults.SimulatedCrash))
    assert all(s.done for s in streams)
    door2, report = recover(rec_engine or eng, journal_path=jp,
                            snapshot_path=sp if snap_every else None,
                            num_slots=2)
    assert report.requests == n
    assert report.resumed + report.terminal == n   # nothing lost
    door2.drain(timeout=120.0)
    assert door2.crashed is None
    return door, door2, report, jp


def check_recovered(door2, jp, free, n=3):
    for b in range(n):
        s = door2.streams[b]
        assert s.finish_reason == REASON_COMPLETED
        np.testing.assert_array_equal(stream_tokens(s), free[b])
    stats = door2.replay_stats()
    assert stats["mismatches"] == 0 and stats["fidelity"] == 1.0
    tail = read_journal(jp)
    assert not tail.torn
    assert {r["rid"] for r in tail.records if r["t"] == "finish"} == \
        set(range(n))


def test_kill_and_recover_bit_identical(engine, setup, free, tmp_path):
    """Crash entering round 2 with a torn write; recover from snapshot
    and journal tail: every stream bit-identical, and the dead
    incarnation's device cache released."""
    door, door2, report, jp = crash_and_recover(
        engine, setup[4], tmp_path,
        [Fault("crash_mid_round", step=2),
         Fault("journal_torn_write", nbytes=7)])
    assert report.snapshot_used and door.snapshots_written >= 1
    assert door._sched._cache is None
    check_recovered(door2, jp, free)


def test_crash_before_snapshot_recovers_from_journal_alone(
        engine, setup, free, tmp_path):
    door, door2, report, jp = crash_and_recover(
        engine, setup[4], tmp_path,
        [Fault("crash_before_snapshot", step=0)], n=2, fsync_every=1)
    assert door.snapshots_written == 0 and not report.snapshot_used
    check_recovered(door2, jp, free, n=2)


def test_torn_tail_recovery_no_snapshot(engine, setup, free, tmp_path):
    """fsync batch of 64 and no snapshots: the crash loses every token
    record and tears the next; recovery regenerates from the submits."""
    door, door2, report, jp = crash_and_recover(
        engine, setup[4], tmp_path,
        [Fault("crash_mid_round", step=1),
         Fault("journal_torn_write", nbytes=6)],
        n=2, snap_every=0, fsync_every=64)
    assert report.torn_tail and report.resumed == 2
    assert all(door2.streams[b].replayed == 0 for b in range(2))
    check_recovered(door2, jp, free, n=2)


@pytest.mark.parametrize("rec", ["spec", "plain"])
def test_spec_kill_and_recover(rec, engine, spec_engine, setup, free,
                               tmp_path):
    """Speculative requests crash mid-burst; recovered by a spec engine
    they replay speculatively, by a plain one they degrade to plain
    decoding — greedy-exact either way."""
    door, door2, report, jp = crash_and_recover(
        spec_engine, setup[4], tmp_path,
        [Fault("crash_mid_round", step=1),
         Fault("journal_torn_write", nbytes=7)],
        rec_engine=spec_engine if rec == "spec" else engine,
        spec=True)
    assert door._sched._dcache is None
    assert all(door2.streams[b].spec == (rec == "spec") for b in range(3))
    check_recovered(door2, jp, free)


def test_recovery_of_a_jax_crash(jengine, engine, setup, free, tmp_path):
    """The JAX front door crashes mid-round with a torn write; the
    port's recover() resumes from its journal and snapshot (its PRNG key
    seeds the port's generator) on the same weights: no request lost,
    every stream equal to the JAX package's greedy tokens."""
    _, door2, report, jp = crash_and_recover(
        jengine, setup[4], tmp_path,
        [jfaults.Fault("crash_mid_round", step=2),
         jfaults.Fault("journal_torn_write", nbytes=7)],
        door_cls=JFrontDoor, rec_engine=engine)
    assert report.snapshot_used
    check_recovered(door2, jp, free)


def test_recover_restores_the_sampling_rng(setup, tmp_path):
    """Under temperature sampling, two recoveries from the same files
    give the same streams: the snapshot carries the generator's state."""
    _, tcfg, _, tp, prompts = setup
    eng = Engine(tcfg, tp, cache_len=128, decode_chunk=4, temperature=1.0,
                 device="cpu")
    jp = os.path.join(tmp_path, "wal.journal")
    sp = os.path.join(tmp_path, "snap")
    door = FrontDoor(eng, num_slots=2, journal_path=jp, snapshot_path=sp,
                     snapshot_every_rounds=1,
                     faults=FaultInjector([Fault("crash_mid_round",
                                                 step=2)])).start()
    for b in range(2):
        door.submit(prompts[b], NEW)
    door.drain(timeout=120.0)
    snap = tjournal.load_snapshot(sp)
    assert snap.torch_rng_state is not None and snap.rng_key is None
    runs = []
    for _ in range(2):
        with open(jp, "rb") as f:
            wal = f.read()
        door2, _ = recover(eng, journal_path=jp, snapshot_path=sp,
                           num_slots=2)
        door2.drain(timeout=120.0)
        runs.append([stream_tokens(door2.streams[b]).tolist()
                     for b in range(2)])
        with open(jp, "wb") as f:       # the same files for the next one
            f.write(wal)
    assert runs[0] == runs[1]


def test_chaos_campaign_survivors_equal_the_fault_free_run(
        engine, setup, free, tmp_path):
    """A seeded campaign with step faults and a crash, through the front
    door and recover(): nothing lost, each request either quarantined or
    equal to the fault-free run."""
    inj = sample_campaign(10, num_requests=3, num_slots=2,
                          horizon_steps=NEW, p_crash=1.0)
    kinds = {f.kind for f in inj.faults}
    assert "crash_mid_round" in kinds and "nan_logits" in kinds
    jp = os.path.join(tmp_path, "wal.journal")
    sp = os.path.join(tmp_path, "snap")
    door = FrontDoor(engine, num_slots=2, journal_path=jp, snapshot_path=sp,
                     snapshot_every_rounds=1, faults=inj, max_retries=3,
                     retry_backoff_s=0.001).start()
    for b in range(3):
        door.submit(setup[4][b], NEW)
    door.drain(timeout=120.0)
    assert isinstance(door.crashed, SimulatedCrash)
    door2, report = recover(engine, journal_path=jp, snapshot_path=sp,
                            num_slots=2, faults=inj, max_retries=3,
                            retry_backoff_s=0.001)
    door2.drain(timeout=120.0)
    assert report.requests == 3 and door2.crashed is None
    for b in range(3):
        s = door2.streams[b]
        assert s.finish_reason in (REASON_COMPLETED, REASON_NUMERICS)
        want = free[b] if s.finish_reason == REASON_COMPLETED \
            else free[b][:len(s.tokens)]
        np.testing.assert_array_equal(stream_tokens(s), want)
