"""lm_lane_use_pct: per traced solve, the lanes' mean LM iterations over the
steps the device loop ran (the largest count of the solve), averaged over
the traced solves; read from the solves' outputs."""


def read(run):
    return run.counters.get("lm_lane_use_pct")
