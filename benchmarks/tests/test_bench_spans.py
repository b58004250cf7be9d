"""CPU tests of the readers of the program's spans and counters: each fed a
run with a hand-built device trace and hand-built spans, held to an answer
worked out by hand; none reports without what it reads.

Run: ``python -m pytest benchmarks/tests -q`` from the repository root.
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path
from typing import NamedTuple, Optional

import pytest

from benchmarks import run as run_mod
from benchmarks import trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CAMPAIGN = ["campaign.full_stack_b8192", "campaign.mc_b8192"]
MS = 1_000_000  # ns
T0 = 1_790_000_000 * 10**9  # a Unix-epoch ns origin, as the profiler's
# an operation's start in seconds since 1970 (``trace.Op``) holds ~0.24 us:
# a few of them over a 40 ms window
PCT = 1e-3


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: int
    wait: bool = False
    device_start_ns: Optional[int] = None
    device_end_ns: Optional[int] = None
    steps: Optional[int] = None


def read(name: str, run):
    return run_mod.load_reader(name)(run)


def a_run(ops=(), window_s=0.1, calls=2, counters=None) -> run_mod.Run:
    r = run_mod.Run({}, {}, {}, 1, 1.0, True)
    ops = sorted(ops, key=lambda op: op.start_s)
    r.recorded = trace.Trace(ops, trace.busy_seconds(ops), window_s, calls)
    r.counters.update(counters or {})
    return r


def op(start_ms: float, dur_ms: float, name: str = "kernel") -> trace.Op:
    return trace.Op(name, (T0 + start_ms * MS) * 1e-9, dur_ms * 1e-3)


def at(ms: float) -> int:
    return T0 + int(ms * MS)


def call(first_id: int, start: float, loop: tuple, steps: int, wait: tuple, end: float) -> list:
    """One entry call (ms from the origin): a start replay, the loop span
    with its device interval ``loop`` and ``steps``, the host's wait."""
    i = first_id
    return [
        Span("entry.monte_carlo", i, None, i, at(start), at(end)),
        Span("replay.start", i + 1, i, i, at(start + 0.1), at(start + 0.2), False,
             at(loop[0] - 2.0), at(loop[0] - 0.1)),
        Span("replay.loop", i + 2, i, i, at(start + 0.2), at(start + 0.3), False,
             at(loop[0]), at(loop[1]), steps),
        Span("replay.count", i + 3, i, i, at(wait[0]), at(wait[1]), True),
    ]


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's tracer and graphs modules: ``found``
    holds the spans it gives out."""
    prof = types.ModuleType("cilqr_tpu_torch.utils.profiling")
    prof.found = []
    prof.spans = lambda: list(prof.found)
    graphs = types.ModuleType("cilqr_tpu_torch.utils.graphs")
    monkeypatch.setitem(sys.modules, prof.__name__, prof)
    monkeypatch.setitem(sys.modules, graphs.__name__, graphs)
    return types.SimpleNamespace(profiling=prof, graphs=graphs)


# two calls: loops of 9 ms (20 steps) and 8 ms (16 steps) on the card;
# the hosts' entries 12 and 10 ms long, of which 7 and 6 ms waiting
TWO_CALLS = (call(1, 0.0, (3.0, 12.0), 20, (4.0, 11.0), 12.0)
             + call(5, 20.0, (23.0, 31.0), 16, (24.0, 30.0), 30.0))


def test_loop_time_per_cycle_and_per_step(program):
    program.profiling.found = TWO_CALLS
    mc = a_run(calls=2)
    assert read("lm_loop_ms_per_cycle", mc) == pytest.approx(17.0 / 2, rel=1e-9)
    assert read("lm_step_us", mc) == pytest.approx(17e3 / 36, rel=1e-9)
    fs = a_run(calls=1, counters={"cycles_traced": 40})
    assert read("lm_loop_ms_per_cycle", fs) == pytest.approx(17.0 / 40, rel=1e-9)


def test_host_issue_leaves_out_the_waits(program):
    """(12 - 7) + (10 - 6) ms over 2 calls; then one more wait of 1 ms, a
    wait nested in another and one reaching past its entry's end and over
    another: each stretch of waiting counted once, inside its entry."""
    program.profiling.found = TWO_CALLS
    assert read("host_issue_ms_per_cycle", a_run(calls=2)) == pytest.approx(4.5, rel=1e-9)
    nested = TWO_CALLS + [Span("profiling.anchor", 9, 1, 1, at(1.0), at(2.0), True),
                          Span("nested", 10, 4, 1, at(5.0), at(6.0), True),
                          Span("late", 11, 5, 5, at(29.0), at(33.0), True)]
    program.profiling.found = nested
    assert read("host_issue_ms_per_cycle", a_run(calls=2)) == pytest.approx(4.0, rel=1e-9)


def opening(*starts_ms) -> list:
    """The loop graphs' first condition kernels, which the profiler sees."""
    return [op(t, 0.005, "lm_continue_kernel") for t in starts_ms]


def test_idle_share_with_loops_in_the_gaps(program):
    """Seen ops before each loop, the loops in the gaps between them: busy =
    ops + loops."""
    program.profiling.found = TWO_CALLS
    ops = [op(1.0, 1.9), op(12.5, 0.5), op(21.0, 1.9)] + opening(3.0, 23.0)
    # busy: 1.9 + 0.5 + 1.9 + 9 + 8 = 21.3 ms of a 40 ms window
    got = read("idle_pct.campaign", a_run(ops, window_s=0.040))
    assert got == pytest.approx(100.0 * (1.0 - 21.3 / 40.0), abs=PCT)
    assert read("idle_pct.fleet", a_run(ops, window_s=0.040)) == pytest.approx(
        100.0 * (1.0 - 4.31 / 40.0), abs=PCT)


def test_idle_share_counts_an_overlap_once(program):
    """Seen ops inside and across the loops' intervals are not counted
    twice: busy = [1, 12] + [21, 31] + [31.5, 32]."""
    program.profiling.found = TWO_CALLS
    ops = [op(1.0, 2.5), op(3.0, 0.2), op(11.0, 1.0), op(21.0, 2.5), op(30.0, 1.0),
           op(31.5, 0.5)] + opening(3.0, 23.0)
    got = read("idle_pct.campaign", a_run(ops, window_s=0.040))
    assert got == pytest.approx(100.0 * (1.0 - 21.5 / 40.0), abs=PCT)


def shifted(spans, ms: float) -> list:
    return [s._replace(device_start_ns=s.device_start_ns + int(ms * MS),
                       device_end_ns=s.device_end_ns + int(ms * MS))
            if s.device_start_ns is not None else s for s in spans]


@pytest.mark.parametrize("ms", [-7.9, 2.6, 6.0])
def test_idle_share_places_each_loop_at_its_opening_kernel(ms, program):
    """The program's device clock off the trace's by milliseconds (as the
    profiler's conversion of the card's times can stray in a session): each
    loop still starts at its first condition kernel, and the seen last
    iteration's kernels and second condition inside it are counted once."""
    ops = ([op(1.0, 1.9), op(12.5, 0.5), op(21.0, 1.9)] + opening(3.0, 23.0)
           + [op(11.5, 0.45), op(11.99, 0.005, "lm_continue_kernel"), op(30.6, 0.39)])
    program.profiling.found = TWO_CALLS
    want = read("idle_pct.campaign", a_run(ops, window_s=0.040))
    assert want == pytest.approx(100.0 * (1.0 - 21.3 / 40.0), abs=PCT)
    program.profiling.found = shifted(TWO_CALLS, ms)
    assert read("idle_pct.campaign", a_run(ops, window_s=0.040)) == pytest.approx(want, abs=PCT)


def test_idle_share_without_opening_kernels_keeps_the_programs_clock(program):
    """A trace without the loops' condition kernels: the loops where the
    program's clock puts them."""
    program.profiling.found = TWO_CALLS
    ops = [op(1.0, 1.9), op(12.5, 0.5), op(21.0, 1.9)]
    got = read("idle_pct.campaign", a_run(ops, window_s=0.040))
    assert got == pytest.approx(100.0 * (1.0 - 21.3 / 40.0), abs=PCT)
    program.profiling.found = shifted(TWO_CALLS, 1.0)  # loops now over 4-13 and 24-32 ms
    got = read("idle_pct.campaign", a_run(ops, window_s=0.040))
    assert got == pytest.approx(100.0 * (1.0 - (1.9 + 9.0 + 1.9 + 8.0) / 40.0), abs=PCT)


def test_setup_capture_seconds(program):
    program.graphs.CAPTURE_S = 3.25
    assert read("setup_capture_s", a_run()) == 3.25


NEW = ["lm_loop_ms_per_cycle", "lm_step_us", "idle_pct.campaign", "host_issue_ms_per_cycle",
       "setup_capture_s"]


@pytest.mark.parametrize("name", NEW)
def test_without_spans_or_counters_nothing_is_reported(name, program, monkeypatch):
    """A program without the tracer (its module lacks ``spans``, ``graphs``
    lacks the count), one that recorded nothing, or no module at all."""
    run = a_run([op(1.0, 1.0)], window_s=0.04, counters={"cycles_traced": 40})
    assert read(name, run) is None
    del program.profiling.spans
    assert read(name, run) is None
    monkeypatch.delitem(sys.modules, program.profiling.__name__)
    monkeypatch.delitem(sys.modules, program.graphs.__name__)
    assert read(name, run) is None


def test_loop_readers_need_a_device_interval(program):
    """Loop spans without a device interval (a CPU run) give nothing."""
    program.profiling.found = [s._replace(device_start_ns=None, device_end_ns=None)
                               for s in TWO_CALLS]
    for name in ("lm_loop_ms_per_cycle", "lm_step_us", "idle_pct.campaign"):
        assert read(name, a_run([op(1.0, 1.0)], window_s=0.04)) is None


def test_the_new_entries():
    """The readers' entries: the cells, layers, sources and what they move."""
    got = {m["name"]: m for m in SPEC["per_layer"] if m["name"] in NEW}
    assert list(got) == NEW and [m["name"] for m in SPEC["per_layer"][-5:]] == NEW
    for name in NEW[:4]:
        m = got[name]
        assert m["workloads"] == CAMPAIGN and m["moves"] == "vehicle_cycles_per_s"
        assert m["source"] == "program_span"
    assert got["setup_capture_s"]["workloads"] == [w["name"] for w in SPEC["workloads"]]
    assert (got["setup_capture_s"]["source"], got["setup_capture_s"]["moves"]) == (
        "program_counter", "setup_s")
    assert got["lm_loop_ms_per_cycle"]["layer"] == got["lm_step_us"]["layer"] == next(
        m["layer"] for m in SPEC["per_layer"] if m["name"] == "lm_lane_use_pct")
    assert got["idle_pct.campaign"]["layer"] == next(
        m["layer"] for m in SPEC["per_layer"] if m["name"] == "idle_pct.fleet")
