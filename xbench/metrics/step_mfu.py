"""The whole model step against the chip's peaks: the least time the
window's steps need (every decode step of the rounds that end inside
it, with its live rows, their attended KV and the program's activated
expert counter; every prefill whose first token came inside it), from
xbench/work.py, over the window's wall time."""
import math

from xbench import work


def read(run):
    least = 0.0
    for r in run.rounds:
        if not run.in_window(r.t_end) or r.activated is None:
            continue
        for i, per_layer in enumerate(r.activated):
            live, attended = 0, 0
            for rid, before, take in r.entries:
                if take > i:
                    live += 1
                    attended += len(run.requests[rid].prompt) + before + i
            if live:
                c = work.decode_step(run.cfg, live, list(per_layer),
                                     attended)
                least += work.least_s(c["flops"], c["bytes"])
    for s in run.requests.values():
        if not math.isnan(s.t_first) and run.in_window(s.t_first):
            c = work.prefill(run.cfg, len(s.prompt))
            least += work.least_s(c["flops"], c["bytes"])
    return 100.0 * least / (run.t_close - run.t_open)
