"""cc_start_ms_per_cycle: the device time of the CCNMPC rounds' start graphs
per traced cycle: the ``replay.start`` spans whose parent is a
``ccnmpc.round`` span (the rollout, the covariance along it, the
tightening, the plan fit and the loop's start), over the traced cycles.  A
program without round spans gives None."""

from benchmarks import program_spans


def read(run):
    found = program_spans.recorded()
    n = program_spans.cycles(run)
    if not found or not n:
        return None
    rounds = {s.id for s in found if s.name == "ccnmpc.round"}
    starts = [s for s in found if s.name == "replay.start" and s.parent in rounds
              and s.device_start_ns is not None]
    if not starts:
        return None
    return 1e3 * sum(program_spans.device_s(s) for s in starts) / n
