"""solves_per_s: the solves of every completed call over the time from the
first timed call's start to the synchronised end of the last."""


def read(run):
    return run.items / (run.t1 - run.t0) if run.calls else None
