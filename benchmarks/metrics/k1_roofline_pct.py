"""k1_roofline_pct: the least time of the traced K1 launches, from the
frozen count of one LM iteration (benchmarks/roofline.py) times the LM
iterations their lanes ran, over K1's profiled time."""

from benchmarks import roofline


def read(run):
    tr = run.recorded
    if tr is None or "iterations_traced" not in run.counters:
        return None
    t = tr.kernel_s("lm_opt_kernel")
    if t <= 0:
        return None
    c = run.counters
    return 100.0 * roofline.k1_bound_s(c["horizon"], c["samples"], c["obstacles"],
                                       c["iterations_traced"]) / t
