"""host_issue_ms_per_cycle: the program's own host time per traced cycle:
inside its entry calls' spans and outside the spans in which the host waits
for the card (the step count's read, the tracer's anchor): the dispatch,
the copies' and replays' issue, the records, and the profiler's own cost on
the host."""

from benchmarks import program_spans


def read(run):
    found = program_spans.recorded()
    n = program_spans.cycles(run)
    if not found or not n:
        return None
    return 1e3 * program_spans.host_issue_s(found) / n
