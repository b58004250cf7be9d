"""What the program records of its own stages over the traced calls: the
spans of ``cilqr_tpu_torch.utils.profiling`` (on while the profiler runs),
read where the program has them.  A program that records none gives None,
and so does every reader built on it.

A span has a name, an id, its parent's id (None: an entry call), its call's
id, a host interval in Unix-epoch ns (the profiler's clock), whether the
host waits for the card inside it, and, for a device span, the interval on
the card between two CUDA events around what it enqueued, on the same
clock; the device loop's span (``LOOP``) also keeps the LM steps it ran.
"""

from __future__ import annotations

import sys

from benchmarks import trace

#: the span of the LM loop's one launch on the card (a CUDA graph WHILE node)
LOOP = "replay.loop"


def recorded():
    """The program's spans of the traced calls, or None."""
    profiling = sys.modules.get("cilqr_tpu_torch.utils.profiling")
    read = getattr(profiling, "spans", None)
    found = read() if read is not None else None
    return found or None


def cycles(run):
    """The traced cycles: the full stack counts them (``cycles_traced``), a
    Monte-Carlo call is one."""
    n = run.counters.get("cycles_traced")
    if n is None and run.recorded is not None:
        n = run.recorded.calls
    return n or None


def loops(found) -> list:
    """The device loop's spans with a device interval."""
    return [s for s in found or () if s.name == LOOP and s.device_start_ns is not None]


def device_s(s) -> float:
    return (s.device_end_ns - s.device_start_ns) * 1e-9


def placed(ops, found) -> list:
    """The device loop's intervals on the trace's timeline (``trace.Op``).
    The profiler sees the loop graph's first condition (``lm_continue_kernel``,
    outside the WHILE body), but its conversion of the card's times to the
    host's clock can stray from the program's by milliseconds in a session;
    so each loop, in order, starts at the first such kernel after the end of
    the one before, and lasts its own device time.  Where the trace lacks a
    loop's opening kernel, every loop keeps the program's clock."""
    conds = sorted(op.start_s for op in ops if "lm_continue" in op.name)
    own = sorted(loops(found), key=lambda s: s.device_start_ns)
    out, i, free = [], 0, float("-inf")
    for s in own:
        while i < len(conds) and conds[i] < free:
            i += 1
        if i == len(conds):
            return [trace.Op(LOOP, s.device_start_ns * 1e-9, device_s(s)) for s in own]
        out.append(trace.Op(LOOP, conds[i], device_s(s)))
        free = conds[i] + device_s(s)
    return out


def busy_s(ops, found) -> float:
    """The union of the profiler's operations and the device loop's
    intervals (``placed``), each counted once."""
    return trace.busy_seconds(sorted(list(ops) + placed(ops, found), key=lambda op: op.start_s))


def host_issue_s(found) -> float:
    """Host seconds inside the entry calls (the spans with no parent) and
    outside the spans in which the host waits for the card."""
    total = 0.0
    for e in (s for s in found if s.parent is None):
        waits = sorted((max(s.start_ns, e.start_ns), min(s.end_ns, e.end_ns)) for s in found
                       if s.wait and s.call == e.call)
        waited, end = 0, e.start_ns
        for a, b in waits:
            a = max(a, end)
            if b > a:
                waited += b - a
                end = b
        total += (e.end_ns - e.start_ns - waited) * 1e-9
    return total
