"""frenet_feasible_pct: the share of the lattice's (lane, candidate) pairs
that were feasible over the traced calls, as the program counts them: 100
x ``frenet.FEASIBLE`` (summed on the card) over ``frenet.CANDIDATES``.  A
program without these counters gives None."""

import sys


def read(run):
    profiling = sys.modules.get("cilqr_tpu_torch.utils.profiling")
    counters = getattr(profiling, "counters", None)
    counts = counters() if counters is not None else {}
    feasible, candidates = counts.get("frenet.FEASIBLE"), counts.get("frenet.CANDIDATES")
    if feasible is None or not candidates:
        return None
    return 100.0 * feasible / candidates
