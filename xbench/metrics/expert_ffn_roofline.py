"""The decode steps' routed-expert FFN against its roofline: over the
rounds replayed while the profiler ran (the traced window and the
rounds that close it), the least time the calls' work
needs (xbench/work.py ``expert_ffn``: the activated experts' weights
read once, the live rows read and written once, 6 d f operations a
routed pair) over the device time of the kernels that computed it,
the ones the data file beside this reader names, counted where the
trace ties them to a decode graph's launch."""
import json
from pathlib import Path

from xbench import work
from xbench.trace import short_name

NAMES = set(json.loads((Path(__file__).parent
                        / "expert_ffn_roofline.kernels.json")
                       .read_text())["kernels"])


def read(run):
    if run.trace is None:
        return None
    dev = sum(e - s for n, s, e, graph in run.trace["device"]
              if graph and short_name(n) in NAMES)
    if dev <= 0:
        return None
    least = 0.0
    for r in run.rounds[run.rounds_before_trace:]:
        if r.activated is None:
            continue
        for i, per_layer in enumerate(r.activated):
            live = sum(1 for _, _, take in r.entries if take > i)
            if not live:
                continue
            for a in per_layer:
                c = work.expert_ffn(run.cfg, live, float(a))
                least += work.least_s(c["flops"], c["bytes"])
    return 100.0 * least / dev
