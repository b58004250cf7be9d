"""Tracing & phase timing — the port's observability layer.

Port of ``cilqr_tpu/utils/profiling.py``: structured phase timers in place
of the reference's ad-hoc instrumentation (std::chrono around run_step,
clock() phase timers in the costmap, the ``compute_time`` telemetry
topic), and a ``torch.profiler`` trace in place of the ``jax.profiler``
one.  ``PhaseTimer.timed`` waits for the card with
``torch.cuda.synchronize`` where ``jax.block_until_ready`` waited for the
TPU.

Spans name the stages of the program: the entry calls, the copies into and
out of a capture, the graph replays, the device-side LM loop (whose kernels
the profiler does not see inside the WHILE body) and the host's waits.
Tracing is on while a ``torch.profiler`` session is active, or inside
``tracing()``.  Off, a span site reads two flags and returns a shared null
context: no clock read, no allocation, no CUDA event.  On, each span keeps
its name, its id, its parent's, its call's (the outermost span's: one entry
call), its host interval, and with ``device`` the interval on the card
between two CUDA events it enqueues around its block.  Host times are
Unix-epoch ns (``time.time_ns``), the clock the profiler converts its
events' times to (``start_ns()``, the Chrome trace's ``ts``).  A device
interval is placed on it by an anchor: at the first device span on a card
the tracer waits for the card, then stamps an event between two host
reads (the narrowest of a few tries), and takes the middle.  ``spans()``
gives the spans out, in memory; ``counters()`` the change of the launch
counters (``graphs.COUNTERS``, ``loop_cuda.LAUNCHES``), of the host counters
the program's modules enter in ``HOST_COUNTERS`` (those summed on a card
are read into them by ``device_counters()``, while tracing) and of the
captures (``graphs.CAPTURES``, ``CAPTURE_S``, ``EVICTIONS``) over the
traced calls.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from typing import Dict, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler  # ``_is_profiler_enabled``: a plain flag

_clock = time.time_ns  # the host's stamps: Unix-epoch ns, as the profiler's events
_TRACING = 0           # depth of ``tracing()`` blocks
_SESSION = None        # what the tracer has recorded since ``reset``
_HOST_TID, _DEVICE_TID = 0x5A4E0, 0x5A4E1  # the spans' rows in a Chrome trace
#: host counters (module, attribute) that ``counters()`` reads besides the
#: launch counters: the modules that keep them enter them on import
HOST_COUNTERS: list = []
#: counters kept on a card (``DeviceCounter``), as (start, read) pairs of
#: functions: ``start()`` runs as each traced entry call begins and drops,
#: without a host read, what the card counted before (untraced work);
#: ``read()`` adds what it counted since to a host counter of
#: ``HOST_COUNTERS`` (a host read: run by ``device_counters()``, only while
#: tracing)
DEVICE_COUNTERS: list = []


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts (NamedTuples
    included)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait for every CUDA device that holds a tensor of ``tree``; nothing
    for CPU tensors.  Returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    >>> t = PhaseTimer()
    >>> with t.phase("solve"):
    ...     run()
    >>> t.summary()["solve"]["mean_ms"]

    Note: CUDA launches are asynchronous — wait for the card inside the
    phase (``block_until_ready``), or use ``timed``, for honest numbers.
    """

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._acc[name].append(seconds)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its outputs' devices, record the wall time,
        return the outputs."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        block_until_ready(out)
        self._acc[name].append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self._acc.items():
            n = len(v)
            mean = sum(v) / n
            out[k] = {
                "count": n,
                "total_ms": 1e3 * sum(v),
                "mean_ms": 1e3 * mean,
                "max_ms": 1e3 * max(v),
                "min_ms": 1e3 * min(v),
            }
        return out

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the host and the card (CPU and CUDA
    activities; the CPU alone where PyTorch has no CUDA), written on exit
    as a Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir`` (view it
    in chrome://tracing or Perfetto), with the program's spans (``tracing``)
    on the profiler's clock: a row of host spans and a row of the device
    intervals."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _write_spans(path, spans())


def _write_spans(path: str, found: list) -> None:
    """Adds ``found`` to the Chrome trace at ``path`` (``ts`` in us after its
    ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc.setdefault("traceEvents", [])
    for tid, label in ((_HOST_TID, "cilqr_tpu_torch spans"),
                       (_DEVICE_TID, "cilqr_tpu_torch spans on the card")):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": label}})
    for s in found:
        args = {"id": s.id, "parent": s.parent, "call": s.call, "wait": s.wait,
                "steps": s.steps, "index": s.index}
        ends = [(_HOST_TID, s.start_ns, s.end_ns)]
        if s.device_start_ns is not None:
            ends.append((_DEVICE_TID, s.device_start_ns, s.device_end_ns))
        for tid, t0, t1 in ends:
            events.append({"ph": "X", "cat": "cilqr_span", "name": s.name, "pid": pid,
                           "tid": tid, "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
                           "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


def annotate(name: str):
    """A named range inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


# ------------------------------------------------------------------- spans
class Span(NamedTuple):
    """One span as ``spans()`` gives it out: times in Unix-epoch ns."""

    name: str
    id: int
    parent: Optional[int]           # the span it lies in (None: an entry call)
    call: int                       # the entry call's id (its outermost span's)
    start_ns: int                   # the host's interval
    end_ns: int
    wait: bool                      # the host waits for the card inside it
    device_start_ns: Optional[int]  # what the block enqueued, on the card
    device_end_ns: Optional[int]
    steps: Optional[int]            # the LM steps its device loop ran (``attach``)
    index: Optional[int] = None     # its place in a sequence of like spans (``span(index=)``)


class _Null:
    """A span site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def attach(self, steps: int) -> None:
        pass


_NULL = _Null()


def span(name: str, device: Optional[torch.device] = None, wait: bool = False,
         index: Optional[int] = None):
    """A span of the block (see the module docstring).  ``device``: the
    card whose current stream the block enqueues on, whose interval the
    span records (a CPU device: none); ``wait``: the host waits for the
    card inside the block; ``index``: the block's place in a sequence of
    like blocks (an SQP round's).  Off, the shared null context."""
    if not (_profiler._is_profiler_enabled or _TRACING):
        return _NULL
    return _Live(name, device, wait, index)


def spanned(name: str):
    """A decorator: each call of the function is a span of ``name`` (an
    entry call where it is the outermost)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block without a profiler; the outermost block
    starts a new record (``reset``), which ``spans()`` and ``counters()``
    read afterwards."""
    global _TRACING
    if not _TRACING:
        reset()
    _TRACING += 1
    try:
        yield
    finally:
        _TRACING -= 1


def device_counters() -> None:
    """While tracing, runs each reader of ``DEVICE_COUNTERS`` (each reads
    its card: call it where the host has waited for the card, as after an
    LM loop's step count).  Off, nothing: no read, no synchronisation."""
    if _profiler._is_profiler_enabled or _TRACING:
        for _, read in DEVICE_COUNTERS:
            read()


class DeviceCounter:
    """A count kept in an int64 on each card, summed there (inside a graph
    too) and read by the host only while tracing into the host counter
    ``module.name``.  The constructor enters that counter in
    ``HOST_COUNTERS`` and its (``start``, ``read``) pair in
    ``DEVICE_COUNTERS``."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.totals: dict = {}   # device -> int64 (1,): what was counted on it
        self.read_at: dict = {}  # device -> that sum at its last read
        HOST_COUNTERS.append((module, name))
        DEVICE_COUNTERS.append((self.start, self.read))

    def total(self, device: torch.device) -> torch.Tensor:
        """``device``'s sum, made at its first use, outside any capture (a
        graph holds its address): a kernel adds to it in place."""
        total = self.totals.get(device)
        if total is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{self.name}'s total is made before a capture "
                                   "(in its warm-up)")
            total = self.totals[device] = torch.zeros(1, dtype=torch.int64, device=device)
        return total

    def add(self, t: torch.Tensor) -> None:
        """Adds ``t``'s sum to the total on its device, in stream order (a
        warm-up's work is thrown away: it counts none)."""
        from cilqr_tpu_torch.utils import graphs  # which imports this module

        total = self.total(t.device)
        if not graphs.warming_up():
            total.add_(t.sum())

    def start(self) -> None:
        """Zeroes each card's total in stream order (no host read), so that
        a traced call counts its own work alone."""
        for device, total in self.totals.items():
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                continue
            total.zero_()
            self.read_at[device] = 0

    def read(self) -> None:
        """Adds what each card counted since the last read to the host
        counter (a host read per card)."""
        for device, total in self.totals.items():
            n = int(total)
            setattr(self.module, self.name,
                    getattr(self.module, self.name) + n - self.read_at.get(device, 0))
            self.read_at[device] = n


def reset() -> None:
    """Drops what the tracer has recorded; the next span starts anew."""
    global _SESSION
    _SESSION = None


def spans() -> list:
    """The spans recorded since ``reset`` (``Span``, by id).  Reading a
    device interval waits for its end event: read after the traced calls
    have been synchronised."""
    s = _SESSION
    if s is None:
        return []
    return sorted((s.resolve(r) for r in s.records), key=lambda r: r.id)


def counters() -> dict:
    """Each counter's change over the traced calls (the entry calls: the
    outermost spans), by ``module.ATTRIBUTE``."""
    return {} if _SESSION is None else dict(_SESSION.counts)


def _counts() -> dict:
    from cilqr_tpu_torch.ops import loop_cuda
    from cilqr_tpu_torch.utils import graphs  # which imports this module

    c = {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": getattr(m, n)
         for m, n in graphs.COUNTERS + HOST_COUNTERS}
    c["loop_cuda.LAUNCHES"] = loop_cuda.LAUNCHES
    for n in ("CAPTURES", "CAPTURE_S", "EVICTIONS"):
        c[f"graphs.{n}"] = getattr(graphs, n)
    return c


def _card(device: Optional[torch.device]) -> Optional[int]:
    """The index of the card a device span records on, or None (no card)."""
    if device is None or device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


class _Session:
    """The spans recorded since ``reset``: closed ones (``records``), the
    open ones (``stack``), an anchor per card, the counters' change."""

    def __init__(self):
        self.records, self.stack, self.ids = [], [], 0
        self.anchors: dict = {}  # card -> (event, its time on the host's clock, half width)
        self.counts: dict = {}

    def anchor(self, card: int) -> None:
        """An event of ``card`` placed on the host's clock: the card idle,
        the narrowest of five host intervals around an event's record and
        its completion, and its middle.  A waiting span of its own."""
        with _Live("profiling.anchor", None, True):
            torch.cuda.synchronize(card)
            stream = torch.cuda.current_stream(card)
            best = None
            for _ in range(5):
                ev = torch.cuda.Event(enable_timing=True)
                t0 = _clock()
                ev.record(stream)
                ev.synchronize()
                t1 = _clock()
                if best is None or t1 - t0 < best[2] - best[1]:
                    best = (ev, t0, t1)
        ev, t0, t1 = best
        self.anchors[card] = (ev, (t0 + t1) // 2, (t1 - t0) // 2)

    def resolve(self, r: "_Live") -> Span:
        d0 = d1 = None
        if r.events is not None:
            card, e0, e1 = r.events
            ev, host, _ = self.anchors[card]
            e1.synchronize()
            d0 = host + round(ev.elapsed_time(e0) * 1e6)
            d1 = host + round(ev.elapsed_time(e1) * 1e6)
        return Span(r.name, r.id, r.parent, r.call, r.t0, r.t1, r.wait, d0, d1, r.steps, r.index)


def _session() -> _Session:
    global _SESSION
    if _SESSION is None:
        _SESSION = _Session()
    return _SESSION


class _Live:
    """A span site while tracing is on."""

    __slots__ = ("name", "device", "wait", "index", "id", "parent", "call", "t0", "t1", "events",
                 "steps", "session", "before")

    def __init__(self, name: str, device, wait: bool, index: Optional[int] = None):
        self.name, self.device, self.wait, self.index = name, device, wait, index
        self.events = self.steps = self.before = None

    def __enter__(self):
        s = self.session = _session()
        card = _card(self.device)
        if card is not None and card not in s.anchors:
            s.anchor(card)
        up = s.stack[-1] if s.stack else None
        s.ids += 1
        self.id = s.ids
        self.parent, self.call = (None, self.id) if up is None else (up.id, up.call)
        if up is None:
            self.before = _counts()
            for start, _ in DEVICE_COUNTERS:
                start()
        s.stack.append(self)
        self.t0 = _clock()
        if card is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(card))
            self.events = (card, start, torch.cuda.Event(enable_timing=True))
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[2].record(torch.cuda.current_stream(self.events[0]))
        self.t1 = _clock()
        s = self.session
        s.stack.pop()
        s.records.append(self)
        if self.before is not None:
            for k, v in _counts().items():
                s.counts[k] = s.counts.get(k, 0) + v - self.before.get(k, 0)
        return False

    def attach(self, steps: int) -> None:
        """The LM steps the block's device loop ran (read afterwards)."""
        self.steps = steps
