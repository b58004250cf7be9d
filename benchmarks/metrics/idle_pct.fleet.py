"""The device's idle share of the traced window: 100 (1 - busy / window),
busy the union of the device operations the profiler recorded.  Kernels the
profiler does not see (inside some CUDA graph WHILE bodies) count as idle."""


def read(run):
    tr = run.recorded
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
