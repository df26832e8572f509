"""Process start to the window's opening: imports, drawing the inputs,
building the kernels where the checkout has none, capturing the decode
graphs, and the warm-up's serving."""
import math


def read(run):
    return None if math.isnan(run.setup_s) else run.setup_s
