"""The device's idle share of the traced window: 100 (1 - busy / window),
busy the union of the device operations the profiler recorded and the
device intervals of the program's LM loop spans (the WHILE bodies the
profiler does not see), each placed on the trace's timeline at the loop's
first condition kernel (``program_spans.placed``)."""

from benchmarks import program_spans


def read(run):
    tr = run.recorded
    found = program_spans.recorded()
    if tr is None or tr.window_s <= 0 or not program_spans.loops(found):
        return None
    return 100.0 * (1.0 - program_spans.busy_s(tr.ops, found) / tr.window_s)
