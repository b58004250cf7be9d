"""lm_step_us: the device-side LM loop's time on the card per LM step: the
device intervals of the program's loop spans over the steps the loops ran
(each span keeps the count the host reads after the loop)."""

from benchmarks import program_spans


def read(run):
    loops = program_spans.loops(program_spans.recorded())
    steps = sum(s.steps or 0 for s in loops)
    if not loops or not steps:
        return None
    return 1e6 * sum(program_spans.device_s(s) for s in loops) / steps
