"""Experts a MoE layer read in a decode step: the program's own counter
(``step_aux["activated_experts"]``), averaged over the layers and the
steps of the rounds that end inside the window."""
import numpy as np


def read(run):
    vals = [r.activated for r in run.rounds
            if run.in_window(r.t_end) and r.activated is not None]
    return float(np.mean(np.concatenate(vals))) if vals else None
