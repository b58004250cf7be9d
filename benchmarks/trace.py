"""The device trace of a traced run, reduced to what the per-layer metrics
read: every device operation (name, start, duration), the busy time (the
union of the operations' intervals) and the traced window's length on the
host clock, between two synchronisations.

``torch.profiler`` records the card alone (``activities=[CUDA]``), which
keeps its own cost on the host small.  It does not see the kernels that run
inside a CUDA graph's WHILE body on every path.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch


class Op(NamedTuple):
    name: str
    start_s: float
    dur_s: float


class Trace(NamedTuple):
    ops: list          # [Op], sorted by start
    busy_s: float      # union of the operations' intervals
    window_s: float    # host clock from the synchronised start to the synchronised end
    calls: int         # timed calls inside the window

    def kernel_s(self, part: str) -> float:
        """Seconds of the operations whose name holds ``part``."""
        return sum(op.dur_s for op in self.ops if part in op.name)


class Recorder:
    """``with Recorder() as rec: ...; rec.calls = n`` then ``rec.result()``."""

    def __init__(self):
        self.calls = 0
        self._prof = None
        self._t = (0.0, 0.0)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t = (time.perf_counter(), 0.0)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._t = (self._t[0], time.perf_counter())
        self._prof.__exit__(*exc)
        return False

    def result(self) -> Trace:
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            ops.append(Op(e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
        ops.sort(key=lambda op: op.start_s)
        return Trace(ops, busy_seconds(ops), self._t[1] - self._t[0], self.calls)


def busy_seconds(ops) -> float:
    """Length of the union of the intervals of ``ops`` (sorted by start)."""
    busy, end = 0.0, None
    for op in ops:
        s, e = op.start_s, op.start_s + op.dur_s
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list, at most 96 characters."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.startswith("void "):
        n = n[5:]
    return (n.split("(")[0].strip() or name)[:96]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    between operations, each named by the operation that ends it."""
    by_name = {}
    for op in tr.ops:
        k = short(op.name)
        by_name[k] = by_name.get(k, 0.0) + op.dur_s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for op in tr.ops:
        if end is not None and op.start_s > end:
            gaps.append(("before " + short(op.name), op.start_s - end))
        end = op.start_s + op.dur_s if end is None else max(end, op.start_s + op.dur_s)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps[:top]]}
