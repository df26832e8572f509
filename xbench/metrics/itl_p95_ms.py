"""95th percentile of the gap each output token waited, over every token
a request received after its first inside the window: a delivery's gap
is the time since the request's previous delivery over the tokens it
brought, so a stall between rounds shows."""
import numpy as np


def read(run):
    gaps = []
    for s in run.requests.values():
        prev = None
        for t, k in sorted(s.deliveries):
            if prev is not None and run.in_window(t):
                gaps.extend([(t - prev) / k] * k)
            prev = t
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
