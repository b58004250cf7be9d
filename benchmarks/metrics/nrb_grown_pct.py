"""nrb_grown_pct: the share of the tree's growth iterations that added a
risk-admissible node over the traced calls, as the program counts them: 100
x ``nrb_rrt.GROWN`` (summed on the card) over ``nrb_rrt.DRAWS`` (lanes x
iterations).  A program without these counters gives None."""

import sys


def read(run):
    profiling = sys.modules.get("cilqr_tpu_torch.utils.profiling")
    counters = getattr(profiling, "counters", None)
    counts = counters() if counters is not None else {}
    grown, draws = counts.get("nrb_rrt.GROWN"), counts.get("nrb_rrt.DRAWS")
    if grown is None or not draws:
        return None
    return 100.0 * grown / draws
