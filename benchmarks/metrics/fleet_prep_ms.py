"""fleet_prep_ms: device milliseconds per traced call of every operation
other than kernel K1 (``lm_opt_kernel``): the plan fit and the world's
payload inside the mega solve's graph.  The traced calls' inputs are drawn
before the window and their outputs read after the trace, so the harness's
own work is not in it."""


def read(run):
    tr = run.recorded
    if tr is None or not tr.ops or tr.kernel_s("lm_opt_kernel") <= 0:
        return None
    other = sum(op.dur_s for op in tr.ops) - tr.kernel_s("lm_opt_kernel")
    return 1e3 * other / tr.calls
