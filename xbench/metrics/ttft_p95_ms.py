"""95th percentile, over every request sent inside the window, of the
time from its send to its first token."""
import math

import numpy as np


def read(run):
    vals = [s.t_first - s.arrival for s in run.requests.values()
            if run.t_open <= s.arrival <= run.t_close
            and not math.isnan(s.t_first)]
    return float(np.percentile(vals, 95)) * 1e3 if vals else None
