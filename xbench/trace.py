"""The traced run's device record: ``torch.profiler`` (CUPTI) over the
traced window, read into plain lists once the loop has ended.

Only the device's activity is traced: recording the host's operations
as well made a replayed granite step 7x slower on the card, the device
alone 2x (its thousands of small kernels each pay the tracer), so the
traced window reads nothing the host clock reads.

Kept from the trace: every device activity (kernels, copies, sets) with
its name, span and correlation id; the host's ``cudaGraphLaunch`` calls,
whose correlation ids mark the kernels of the replayed decode loops;
and the benchmark's own markers: the scheduler's time at each hook,
which says what the host was doing when the device idled. The hooks
add no synchronisation: the two clocks are tied by one
``cudaDeviceSynchronize`` at each edge of the traced window, the
scheduler's time read just before it. Times come out in seconds on the
scheduler's clock.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    argument lists: ``void (anonymous namespace)::k<128>(Args)`` -> ``k``."""
    base = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    base = "".join(out).split("(")[0].strip().split(" ")[-1]
    return base.split("::")[-1] or name[:64]


class Tracer:
    """Start once, mark host spans, stop once."""

    def __init__(self):
        self.prof = None
        self.marks: List[Tuple[str, float]] = []   # (name, host time)
        self.edges: List[float] = []               # scheduler time of syncs
        self.clock = None                          # () -> scheduler time

    def _edge(self) -> None:
        import torch
        if torch.cuda.is_available():
            self.edges.append(self.clock())
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._edge()

    @contextmanager
    def mark(self, name: str):
        """A marker at a hook: its time on the scheduler's clock."""
        if self.prof is not None:
            self.marks.append((name, self.clock()))
        yield

    def stop(self) -> Dict:
        """Stop the profiler and read its events without building the
        profiler's per-event Python objects."""
        import torch
        self._edge()
        try:
            events = torch._C._autograd._disable_profiler().events()
        except (AttributeError, RuntimeError):
            self.prof.stop()
            events = self.prof.profiler.kineto_results.events()
        self.prof = None
        dev, launches, syncs = [], [], []
        for ev in events:
            kind = str(ev.device_type())
            name = ev.name()
            if kind.endswith("CUDA") and not bool(
                    getattr(ev, "is_user_annotation", lambda: False)()):
                s = _ns(ev, "start")
                dev.append((name, s, s + _ns(ev, "duration"),
                            int(ev.correlation_id())))
            elif name.startswith("cudaGraphLaunch"):
                launches.append((_ns(ev, "start"), int(ev.correlation_id())))
            elif name.startswith("cudaDeviceSynchronize"):
                syncs.append(_ns(ev, "start"))
        return self._align(dev, launches, sorted(syncs))

    def _align(self, dev, launches, syncs) -> Dict:
        """Shift every event onto the scheduler's clock by the mean
        offset between the edges' synchronisations (the trace's first
        and last) and the scheduler's times read just before them."""
        pairs = list(zip((syncs[0], syncs[-1]), self.edges)) \
            if syncs and len(self.edges) == 2 else []
        off = float(np.mean([s / 1e9 - t for s, t in pairs])) \
            if pairs else 0.0
        graph = {c for _, c in launches}
        return {
            "device": [(n, s / 1e9 - off, e / 1e9 - off, c in graph)
                       for n, s, e, c in dev],
            "graph_launches": sorted(s / 1e9 - off for s, _ in launches),
            "marks": [(name, t, t) for name, t in self.marks],
        }


def union_s(spans, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of (start, end) spans."""
    iv = sorted((max(s, lo), min(e, hi)) for s, e in spans
                if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] no span covers."""
    iv = sorted((max(s, lo), min(e, hi)) for s, e in spans
                if e > lo and s < hi)
    gaps, t = [], lo
    for s, e in iv:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_phases(trace: Dict) -> List[Tuple[float, float, str]]:
    """What the host was doing, from the markers and graph launches:
    from the pump's return to the round's graph launch it admits
    (prefill and cache inserts); from the launch to the round's hook the
    decode round (replay and harvest); from the hook to the next pump's
    return the benchmark's clients and the scheduler's bookkeeping."""
    pumps = sorted(e for n, _, e in trace["marks"] if n == "keep_alive")
    hooks = sorted(s for n, s, _ in trace["marks"] if n == "on_round")
    launches = trace["graph_launches"]
    out = []
    for i, p in enumerate(pumps):
        nxt_l = next((g for g in launches if g >= p), None)
        nxt_h = next((h for h in hooks if h >= p), None)
        nxt_p = pumps[i + 1] if i + 1 < len(pumps) else None
        if nxt_l is not None and (nxt_p is None or nxt_l < nxt_p):
            out.append((p, nxt_l, "admission"))
            if nxt_h is not None:
                out.append((nxt_l, nxt_h, "decode_round"))
                if nxt_p is not None:
                    out.append((nxt_h, nxt_p, "clients_and_bookkeeping"))
        elif nxt_p is not None:
            out.append((p, nxt_p, "admission"))
    return out


def breakdown(trace: Dict, lo: float, hi: float) -> Dict:
    """The device operations that took most time in [lo, hi], and the
    idle time by what the host was doing, ten of each."""
    ops: Dict[str, float] = {}
    for name, s, e, _ in trace["device"]:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + d
    spans = [(s, e) for _, s, e, _ in trace["device"]]
    phases = host_phases(trace)
    idle: Dict[str, float] = {}
    for gs, ge in idle_gaps(spans, lo, hi):
        mid = 0.5 * (gs + ge)
        what = next((n for s, e, n in phases if s <= mid < e), "other")
        idle[what] = idle.get(what, 0.0) + (ge - gs)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
