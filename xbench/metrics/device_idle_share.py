"""Share of the traced window in which no operation ran on the device:
one minus the union of the traced device activities over it."""
from xbench.trace import union_s


def read(run):
    if run.trace is None or not run.trace["device"]:
        return None
    spans = [(s, e) for _, s, e, _ in run.trace["device"]]
    busy = union_s(spans, run.trace_open, run.trace_close)
    return 100.0 * (1.0 - busy / (run.trace_close - run.trace_open))
