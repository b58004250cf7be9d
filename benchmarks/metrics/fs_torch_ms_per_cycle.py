"""fs_torch_ms_per_cycle: device milliseconds per traced cycle of the
operations that are not the port's own kernels (lm_*, riccati, propagate,
sample): the costmap build's plain PyTorch, the noise, the plan fit and the
stages around the loop; not the harness's draws and reads, which are kept
out of the trace (``benchmarks.run.back_to_back``).  The profiler does not
see the kernels inside the LM loop's CUDA graph WHILE body, so the hybrid
step's own PyTorch is not counted."""

OWN = ("lm_", "riccati", "propagate_kernel", "sample_kernel", "fields_kernel")


def read(run):
    tr = run.recorded
    cycles = run.counters.get("cycles_traced")
    if tr is None or not tr.ops or not cycles:
        return None
    other = sum(op.dur_s for op in tr.ops if not any(k in op.name for k in OWN))
    return 1e3 * other / cycles
