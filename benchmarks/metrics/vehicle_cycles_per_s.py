"""vehicle_cycles_per_s: simulated vehicles times the planning cycles they
completed, over the window from the first timed call's start to the
synchronised end of the last."""


def read(run):
    return run.items / (run.t1 - run.t0) if run.calls else None
