"""k4_roofline_pct: the least time of the traced K4 launches
(``propagate_kernel``), from the frozen count of benchmarks/roofline.py on
the fields of the traced calls' sigmas, over K4's profiled time."""


def read(run):
    tr = run.recorded
    bound = run.counters.get("k4_bound_s")
    if tr is None or bound is None:
        return None
    t = tr.kernel_s("propagate_kernel")
    return 100.0 * bound / t if t > 0 else None
