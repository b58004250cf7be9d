"""lm_loop_ms_per_cycle: the device-side LM loop's time on the card per
traced cycle: the device intervals of the program's loop spans (one launch
of the loop graph, whose WHILE body the profiler does not see), over the
traced cycles."""

from benchmarks import program_spans


def read(run):
    loops = program_spans.loops(program_spans.recorded())
    n = program_spans.cycles(run)
    if not loops or not n:
        return None
    return 1e3 * sum(program_spans.device_s(s) for s in loops) / n
