"""Rank bodies for tests/test_torch_ep_dist.py: what each process of an
expert-parallel group runs (``repro_torch.ep.dist.spawn`` imports them by
name in every rank, so this module imports neither JAX nor pytest).
Each returns host-side results for the test process to check."""
from __future__ import annotations

import torch

from repro_torch import bridge
from repro_torch import ep as EP
from repro_torch.serving import Engine


def _moe(weights):
    return {"moe": dict(zip(("w1", "w3", "w2"), weights))}


def _local(weights, eids, device="cpu"):
    m = bridge.cut_experts(_moe(weights), eids, device=device)["moe"]
    return m["w1"], m["w3"], m["w2"]


def _on(rk, *arrays):
    return [torch.as_tensor(a).to(rk.device) for a in arrays]


def layer_calls(rk, weights, calls):
    """Each call (name, placement, x, idx, w, max_rows) through a
    DistEPExecutor on this rank's own experts (on the rank's device):
    y and EPStats of ``__call__``, y of ``ffn``, grouped_ffn's launches
    in the two, and the shapes of the stacks held."""
    from repro_torch import kernels as K
    out = {}
    for name, pl, x, idx, w, mr in calls:
        ex = EP.DistEPExecutor(pl, device=rk.device, max_rows=mr)
        local = _local(weights, ex.local_eids, rk.device)
        x, idx, w = _on(rk, x, idx, w)
        before = K.grouped_ffn.launches
        y, st = ex(x, *local, idx, w)
        y2 = ex.ffn(x, *local, idx, w)
        out[name] = dict(y=y.cpu(), stats=st, ffn=y2.cpu(),
                         launches=K.grouped_ffn.launches - before,
                         counts=ex.exchange_counts(idx, w),
                         held=[tuple(t.shape) for t in local],
                         local_eids=ex.local_eids.copy())
    return out


def placement_update(rk, weights, pl, load, x, idx, w, odd_load, sparse):
    """update_placement on every rank, the experts cut again from the
    host copy, then: the version and tables each rank holds, y of the
    new placement; a second update with the same load (hysteresis); an
    update whose load differs on the last rank, which every rank must
    refuse; an update from raw counts with most experts at 0 (the
    placement each rank adopts); and a first placement above an explicit
    max_expert_cap (the refusal)."""
    kw = dict(replicate_hot=1, max_replicas=4)
    ex = EP.DistEPExecutor(pl, device=rk.device, **kw)
    args = [torch.tensor(a) for a in (x, idx, w)]
    changed = ex.update_placement(load)
    local = _local(weights, ex.local_eids)
    res = dict(changed=changed, version=ex.placement.version,
               hosts=ex.placement.hosts.copy(),
               local_eids=ex.local_eids.copy(),
               y=ex.ffn(args[0], *local, *args[1:]),
               again=ex.update_placement(load),
               skipped=ex.rebalances_skipped)
    odd = EP.DistEPExecutor(pl, device=rk.device, **kw)
    try:
        odd.update_placement(odd_load if rk.rank == rk.size - 1 else load)
        res["odd"] = None
    except RuntimeError as e:
        res["odd"] = str(e)
    E = pl.num_experts
    sp = EP.DistEPExecutor(EP.contiguous_placement(E, rk.size),
                           device=rk.device)
    res["sparse"] = dict(changed=sp.update_placement(sparse),
                         cap=sp.placement.expert_cap,
                         bound=sp.max_expert_cap,
                         hosts=sp.placement.hosts.copy())
    try:
        EP.DistEPExecutor(EP.plan_placement(sparse, rk.size),
                          device=rk.device, max_expert_cap=sp.max_expert_cap)
        res["sparse"]["refused"] = None
    except ValueError as e:
        res["sparse"]["refused"] = str(e)
    return res


def capture_refused(rk, weights, pl, x, idx, w):
    """The exchange called as if a CUDA graph were being captured on the
    current stream: it must raise before any collective runs (every rank
    raises at the same point, so none waits). Then a real call works."""
    ex = EP.DistEPExecutor(pl, device=rk.device)
    local = _local(weights, ex.local_eids)
    args = [torch.tensor(a) for a in (x, idx, w)]
    saved = (torch.cuda.is_available, torch.cuda.is_current_stream_capturing)
    torch.cuda.is_available = lambda: True
    torch.cuda.is_current_stream_capturing = lambda: True
    try:
        ex.ffn(args[0], *local, *args[1:])
        msg = None
    except RuntimeError as e:
        msg = str(e)
    finally:
        torch.cuda.is_available, torch.cuda.is_current_stream_capturing = \
            saved
    return dict(msg=msg, after=ex.ffn(args[0], *local, *args[1:]))


def captured_on_card(rk, weights, pl, x, idx, w):
    """A real CUDA graph capture around the EP layer on the card, after
    an eager warm-up: the capture must raise (it would otherwise hang or
    record nothing of the exchange). Returns the message."""
    ex = EP.DistEPExecutor(pl, device=rk.device)
    local = _local(weights, ex.local_eids, rk.device)
    x, idx, w = _on(rk, x, idx, w)
    side = torch.cuda.Stream(rk.device)
    side.wait_stream(torch.cuda.current_stream(rk.device))
    with torch.cuda.stream(side):
        ex.ffn(x, *local, idx, w)
    torch.cuda.current_stream(rk.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=side):
            ex.ffn(x, *local, idx, w)
        return None
    except RuntimeError as e:
        return str(e)


def suite(rk, weights, calls, update=None, capture=None, serve=None,
          card_capture=None):
    """Everything one spawn of S ranks runs for a test module (on one
    thread a rank: the test workers share the host's cores)."""
    torch.set_num_threads(1)
    out = {"calls": layer_calls(rk, weights, calls)}
    if update is not None:
        out["update"] = placement_update(rk, weights, *update)
    if capture is not None:
        out["capture"] = capture_refused(rk, weights, *capture)
    if serve is not None:
        out["served"] = served(rk, *serve)
    if card_capture is not None:
        out["card_capture"] = captured_on_card(rk, weights, *card_capture)
    return out


def served(rk, cfg, host_params, prompts, new, pl, load):
    """Engine(dispatch="ep") on this rank's cut of the host copy, under
    a DistEPExecutor: continuous and lockstep tokens; after
    update_placement and the experts cut again into the engine's own
    tensors, continuous tokens again."""
    kw = dict(replicate_hot=1, max_replicas=2)
    ex = EP.DistEPExecutor(pl, device=rk.device, **kw)
    tp = bridge.cut_experts(host_params, ex.local_eids, device=rk.device)
    held = tuple(tp["layers"]["moe"]["w1"].shape)
    eng = Engine(cfg, tp, cache_len=64, dispatch="ep", device=rk.device)
    with EP.ep_context(ex):
        cont, _ = eng.generate(prompts, new)
        lock, _ = eng.generate(prompts, new, lockstep=True)
        changed = ex.update_placement(load)
        bridge.cut_experts(host_params, ex.local_eids, device=rk.device,
                           into=eng.params)
        after, _ = eng.generate(prompts, new)
    return dict(cont=cont, lock=lock, after=after, held=held,
                changed=changed, version=ex.placement.version,
                cap=ex.placement.expert_cap,
                moe_w1=eng.params["layers"]["moe"]["w1"].clone())
