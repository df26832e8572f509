"""Share of the window in which the scheduler was admitting: the union
of each request's [admitted, first token] span (its prefill and the
first token's read-back, as the scheduler timestamps them)."""
import math

from xbench.trace import union_s


def read(run):
    spans = [(s.t_admitted, s.t_first) for s in run.requests.values()
             if not math.isnan(s.t_first) and not math.isnan(s.t_admitted)]
    return 100.0 * union_s(spans, run.t_open, run.t_close) / \
        (run.t_close - run.t_open)
