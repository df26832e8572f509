"""Output tokens delivered inside the window, first tokens included,
over the window's seconds."""


def read(run):
    n = sum(k for s in run.requests.values() for t, k in s.deliveries
            if run.in_window(t))
    return n / (run.t_close - run.t_open)
