"""Host wall time of a decode step: over the rounds that end inside the
window, the sum of each round's span over the sum of its steps. A round
runs from the later of the previous round's end and the last first
token of the admissions before it, to its own end."""
import math


def read(run):
    firsts = sorted(s.t_first for s in run.requests.values()
                    if not math.isnan(s.t_first))
    wall, steps = 0.0, 0
    for prev, r in zip(run.rounds, run.rounds[1:]):
        if not run.in_window(r.t_end):
            continue
        start = max([prev.t_end] + [t for t in firsts
                                    if prev.t_end < t < r.t_end])
        wall += r.t_end - start
        steps += run.chunk
    return 1e3 * wall / steps if steps else None
