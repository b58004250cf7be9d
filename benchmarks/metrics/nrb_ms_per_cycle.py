"""nrb_ms_per_cycle: the NRB-RRT planner's time on the card per traced
cycle: the device intervals of the ``run.replay`` spans whose parent is an
``nrb.plan`` span (one replay of the planner's graph a cycle: the plan fit,
the draws, the tree, the tape, its rollout and the brake), over the traced
cycles.  A program without such spans gives None."""

from benchmarks import program_spans


def read(run):
    found = program_spans.recorded()
    n = program_spans.cycles(run)
    if not found or not n:
        return None
    plans = {s.id for s in found if s.name == "nrb.plan"}
    replays = [s for s in found if s.name == "run.replay" and s.parent in plans
               and s.device_start_ns is not None]
    if not replays:
        return None
    return 1e3 * sum(program_spans.device_s(s) for s in replays) / n
