"""CPU tests of the cell ``campaign.frenet_prop_b8192``: its check guards the
lattice's rules and the propagation mode's map, not only the trajectory.
At a small batch (8 vehicles, 4 cycles) a sound run is correct; a run with
the front ego circle dropped from the obstacle test, with the curvature
rule dropped or in origin mode (the map not read: the winner's cost lacks
the map's term) is not, nor is the control (the reference in bfloat16 in
the program's place).

In the cell's own world the map never moves a choice (its lane is 10 m
wide: the lattice's +-3 m offsets stay on free cells, and the propagated
map's edges are sharp), and no winner passes a cell at the threshold, so
a doubled threshold changes no answer there: the cell cannot see it.  The
map's faults are planted again in the same deployment on a 5 m lane, where
the offsets of +-3 m end on the prior's occupied cells: there a run in
origin mode or with the map's threshold doubled is not correct, while a
sound run is.  Then the readers of ``frenet_ms_per_cycle`` and
``frenet_feasible_pct`` on hand-built spans and counters, and their
silence without them.

Run: ``python -m pytest benchmarks/tests -q`` from the repository root.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmarks import check as check_mod
from benchmarks import run as R
from benchmarks.tests.test_bench_spans import Span, a_run, at

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "campaign.frenet_prop_b8192"
SEED = 2 ** 31 + 99
SMALL = dict(batch=8, check_lanes=8, check_calls=1, cycles=4)


def small_cell(lane_width=None):
    """(run, traffic, state) of the cell at a small batch on the CPU, its
    lane ``lane_width`` m wide where given."""
    torch.set_num_threads(2)
    wl, config, cell, traffic = R.load_cell(SPEC, CELL, ROOT)
    if lane_width is not None:
        config = copy.deepcopy(config)
        config["world"]["town"]["lane_width"] = lane_width
    run = R.Run(wl, config, dict(cell, **SMALL), SEED, 0.2, False, device=torch.device("cpu"))
    return run, traffic, traffic.setup(run)


@pytest.fixture(scope="module")
def cell():
    return small_cell()


@pytest.fixture(scope="module")
def narrow():
    return small_cell(lane_width=5.0)


def checked(cell):
    run, traffic, state = cell
    state.reseed(run.seed)
    traffic.window(run, state)
    return traffic.check(run, traffic.release(run, state))


def planted(monkeypatch, change):
    """The lattice computed on ``change(p, fp, kappa_max)``'s arguments."""
    from cilqr_tpu_torch.models import frenet

    plan_steps = frenet.plan_steps

    def faulty(p, fp, plan_xy, plan_n, egos, obstacles, unc_map, sigmas, *, kappa_max):
        p, fp, kappa_max = change(p, fp, kappa_max)
        return plan_steps(p, fp, plan_xy, plan_n, egos, obstacles, unc_map, sigmas,
                          kappa_max=kappa_max)

    monkeypatch.setattr(frenet, "plan_steps", faulty)


def front_circle_dropped(monkeypatch):
    """Both ego circles tested at the rear circle's place."""
    planted(monkeypatch, lambda p, fp, k: (dataclasses.replace(p, ego_front=-p.ego_rear), fp, k))


def curvature_dropped(monkeypatch):
    planted(monkeypatch, lambda p, fp, k: (p, fp, torch.full_like(k, float("inf"))))


def map_not_read(monkeypatch):
    """Origin mode in propagation mode's place."""
    planted(monkeypatch, lambda p, fp, k: (p, dataclasses.replace(fp, mode="origin"), k))


def threshold_doubled(monkeypatch):
    planted(monkeypatch, lambda p, fp, k: (
        p, dataclasses.replace(fp, unc_threshold=2.0 * fp.unc_threshold), k))


@pytest.mark.parametrize("world", ["cell", "narrow"])
def test_sound_run_is_correct(world, request):
    checks = checked(request.getfixturevalue(world))
    assert R.judge(checks), checks


@pytest.mark.parametrize("world, fault", [
    ("cell", front_circle_dropped), ("cell", curvature_dropped), ("cell", map_not_read),
    ("narrow", map_not_read), ("narrow", threshold_doubled)], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_rule_fault_is_caught(world, fault, request, monkeypatch):
    fault(monkeypatch)
    checks = checked(request.getfixturevalue(world))
    assert not R.judge(checks), checks


def test_control_is_not_correct(cell):
    run, traffic, state = cell
    state.reseed(run.seed)
    traffic.window(run, state)
    values = traffic.control(run, traffic.release(run, state))
    assert not R.judge(check_mod.checks(values, run.cell["limits"])), values


# ------------------------------------------------------------- the readers
@pytest.fixture
def program(monkeypatch):
    prof = types.ModuleType("cilqr_tpu_torch.utils.profiling")
    prof.found, prof.counts = [], {}
    prof.spans = lambda: list(prof.found)
    prof.counters = lambda: dict(prof.counts)
    monkeypatch.setitem(sys.modules, prof.__name__, prof)
    return prof


def cycles(first_id: int, start: float, device_ms: tuple) -> list:
    """An entry call with one cycle per lattice replay's device ms: each
    cycle's world replay, its ``frenet.plan`` span holding a copy in, the
    lattice's replay and a copy out, and the advance's replay."""
    out = [Span("entry.full_stack", first_id, None, first_id, at(start), at(start + 90.0))]
    i = first_id + 1
    for k, ms in enumerate(device_ms):
        t = start + 20.0 * k
        out += [Span("full_stack.cycle", i, first_id, first_id, at(t), at(t + 1.0)),
                Span("run.replay", i + 1, i, first_id, at(t), at(t + 0.1), False, at(t),
                     at(t + 4.0)),
                Span("frenet.plan", i + 2, i, first_id, at(t + 0.1), at(t + 0.5)),
                Span("run.copy_in", i + 3, i + 2, first_id, at(t + 0.1), at(t + 0.2)),
                Span("run.replay", i + 4, i + 2, first_id, at(t + 0.2), at(t + 0.3), False,
                     at(t + 4.0), at(t + 4.0 + ms)),
                Span("run.copy_out", i + 5, i + 2, first_id, at(t + 0.3), at(t + 0.4)),
                Span("run.replay", i + 6, i, first_id, at(t + 0.5), at(t + 0.6), False,
                     at(t + 4.0 + ms), at(t + 4.5 + ms))]
        i += 7
    return out


def test_frenet_time_per_cycle(program):
    """The lattice's replays alone (not the world's or the advance's): 30 +
    50 + 40 + 60 ms over 4 traced cycles."""
    program.found = cycles(1, 0.0, (30.0, 50.0)) + cycles(30, 100.0, (40.0, 60.0))
    r = a_run(calls=2, counters={"cycles_traced": 4})
    assert R.load_reader("frenet_ms_per_cycle")(r) == pytest.approx(180.0 / 4, rel=1e-6)


def test_frenet_time_is_silent_without_plan_spans(program):
    """A lattice that is no span of its own (replays under the cycle alone),
    no spans, or no cycles: no value, and no error."""
    read = R.load_reader("frenet_ms_per_cycle")
    program.found = [s for s in cycles(1, 0.0, (30.0,)) if s.name != "frenet.plan"]
    assert read(a_run(calls=1, counters={"cycles_traced": 20})) is None
    program.found = []
    assert read(a_run(calls=1, counters={"cycles_traced": 20})) is None
    program.found = cycles(1, 0.0, (30.0,))
    assert read(a_run(calls=0)) is None


def test_feasible_share(program):
    program.counts = {"frenet.FEASIBLE": 2_950_000, "frenet.CANDIDATES": 5_898_240,
                      "frenet.PLANS": 40}
    assert R.load_reader("frenet_feasible_pct")(a_run()) == pytest.approx(
        100.0 * 2_950_000 / 5_898_240, rel=1e-12)


def test_feasible_share_is_silent_without_the_counters(program, monkeypatch):
    """A program that counts no feasible pairs (or no candidates), or has no
    tracer at all: no value, and no error."""
    read = R.load_reader("frenet_feasible_pct")
    program.counts = {"frenet.CANDIDATES": 5_898_240}
    assert read(a_run()) is None
    program.counts = {"frenet.FEASIBLE": 0, "frenet.CANDIDATES": 0}
    assert read(a_run()) is None
    monkeypatch.delitem(sys.modules, program.__name__)
    assert read(a_run()) is None
