"""k5_roofline_pct: the least time of the traced K5 launches
(``sample_kernel``), the bytes of each frame's box layer in and vehicle map
out and the global prior read once, over the memory rate
(benchmarks/roofline.py), over K5's profiled time."""

from benchmarks import roofline


def read(run):
    tr = run.recorded
    n_bytes = run.counters.get("k5_bytes")
    if tr is None or n_bytes is None:
        return None
    t = tr.kernel_s("sample_kernel")
    return 100.0 * roofline.bound_s(n_bytes, 0.0) / t if t > 0 else None
