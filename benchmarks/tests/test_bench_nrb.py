"""CPU tests of the cell ``campaign.nrb_rrt_b8192``: its check guards the
risk-bounded tree, not only the rollout.  At a small batch (16 vehicles, 2
cycles) a sound run is correct; a run whose trees grow over half the
iterations, whose risk bound is dropped (kappa = 0), whose draws come from
another key, or whose X is not the rollout of its U is not, nor is the
control (the reference in bfloat16 in the program's place).  Then the
readers of ``nrb_ms_per_cycle`` and ``nrb_grown_pct`` on hand-built spans
and counters, and their silence without them (a program without the
planner's span or counters).

Run: ``python -m pytest benchmarks/tests -q`` from the repository root.
"""

from __future__ import annotations

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
CELL = "campaign.nrb_rrt_b8192"
SEED = 2 ** 31 + 77
SMALL = dict(batch=16, check_lanes=16, check_calls=2, cycles=2)


@pytest.fixture(scope="module")
def cell():
    """(run, traffic, state) of the cell at a small batch on the CPU."""
    torch.set_num_threads(2)
    wl, config, cell, traffic = R.load_cell(SPEC, CELL, ROOT)
    run = R.Run(wl, config, dict(cell, **SMALL), SEED, 0.2, False, device=torch.device("cpu"))
    return run, traffic, traffic.setup(run)


def checked(cell):
    run, traffic, state = cell
    state.reseed(run.seed)
    traffic.window(run, state)
    return traffic.check(run, traffic.release(run, state))


def test_sound_run_is_correct(cell):
    checks = checked(cell)
    assert R.judge(checks), checks
    assert 0 < cell[0].counters["record"]["found_pct"] < 100


def with_params(**changed):
    """A fault: the planner runs with ``changed`` in its parameters."""
    def fault(state, monkeypatch):
        from cilqr_tpu_torch.models import nrb_rrt

        run_steps = nrb_rrt.run_steps

        def changed_run(p, np_, plan_xy, plan_n, egos, obstacles, sigmas, c):
            np2 = dataclasses.replace(np_, **changed)
            return run_steps(p, np2, plan_xy, plan_n, egos, obstacles, sigmas,
                             nrb_rrt.constants(p, np2, egos.dtype, egos.device))

        monkeypatch.setattr(nrb_rrt, "run_steps", changed_run)
    return fault


fewer_iterations = with_params(n_iters=48)
fewer_iterations.__name__ = "fewer_iterations"
no_risk_bound = with_params(risk_alpha=1.0)  # kappa = sqrt(0 / 1) = 0
no_risk_bound.__name__ = "no_risk_bound"
another_key = with_params(seed=1)
another_key.__name__ = "another_key"


def x_not_the_rollout(state, monkeypatch):
    """The plan's states moved by 1 cm after the first: U is still the tape."""
    from cilqr_tpu_torch.models import nrb_rrt

    run_steps = nrb_rrt.run_steps

    def moved(*args):
        res = run_steps(*args)
        X = res.X.clone()
        X[:, 1:, 1] += 0.01
        return res._replace(X=X)

    monkeypatch.setattr(nrb_rrt, "run_steps", moved)


@pytest.mark.parametrize("fault", [fewer_iterations, no_risk_bound, another_key,
                                   x_not_the_rollout], ids=lambda f: f.__name__)
def test_a_mechanism_fault_is_caught(cell, fault, monkeypatch):
    fault(cell[2], monkeypatch)
    checks = checked(cell)
    assert not R.judge(checks), checks


def test_control_is_not_correct(cell):
    run, traffic, state = cell
    state.reseed(run.seed)
    traffic.window(run, state)
    values = traffic.control(run, traffic.release(run, state))
    assert not R.judge(check_mod.checks(values, run.cell["limits"])), values


@pytest.fixture
def program(monkeypatch):
    prof = types.ModuleType("cilqr_tpu_torch.utils.profiling")
    prof.found, prof.counts = [], {}
    prof.spans = lambda: list(prof.found)
    prof.counters = lambda: dict(prof.counts)
    monkeypatch.setitem(sys.modules, prof.__name__, prof)
    return prof


def plans(first_id: int, start: float, device_ms: tuple) -> list:
    """An entry call with one plan per (replay's device ms), each holding
    its stage's replay, and a replay outside any plan (the noise stage's)."""
    out = [Span("entry.closed_loop", first_id, None, first_id, at(start), at(start + 50.0)),
           Span("run.replay", first_id + 1, first_id, first_id, at(start), at(start + 0.1),
                False, at(start), at(start + 0.4))]
    i = first_id + 2
    for k, ms in enumerate(device_ms):
        t = start + 10.0 * (k + 1)
        out += [Span("nrb.plan", i, first_id, first_id, at(t), at(t + 5.0)),
                Span("run.replay", i + 1, i, first_id, at(t), at(t + 0.1), False, at(t),
                     at(t + ms)),
                Span("nrb.counters", i + 2, i, first_id, at(t + 0.1), at(t + ms), True)]
        i += 3
    return out


def test_nrb_time_per_cycle(program):
    """The replays inside the plans, 150 + 250 + 50 + 150 ms over 4
    cycles; the replay outside a plan is not counted."""
    program.found = plans(1, 0.0, (150.0, 250.0)) + plans(20, 1000.0, (50.0, 150.0))
    r = a_run(calls=2, counters={"cycles_traced": 4})
    assert R.load_reader("nrb_ms_per_cycle")(r) == pytest.approx(600.0 / 4, rel=1e-6)


def test_nrb_time_is_silent_without_plan_spans(program):
    """Plans that are not spans (their replays under the entry), no spans at
    all, or no cycles: no value, and no error."""
    read = R.load_reader("nrb_ms_per_cycle")
    program.found = [s for s in plans(1, 0.0, (150.0,)) if s.name != "nrb.plan"]
    assert read(a_run(calls=1, counters={"cycles_traced": 20})) is None
    program.found = []
    assert read(a_run(calls=1, counters={"cycles_traced": 20})) is None
    program.found = plans(1, 0.0, (150.0,))
    assert read(a_run(calls=0)) is None


def test_nrb_grown_share(program):
    program.counts = {"nrb_rrt.GROWN": 300, "nrb_rrt.DRAWS": 1200, "nrb_rrt.PLANS": 2}
    assert R.load_reader("nrb_grown_pct")(a_run()) == pytest.approx(25.0)


def test_nrb_grown_is_silent_without_counters(program):
    """A program without the counters, or without draws: no value."""
    read = R.load_reader("nrb_grown_pct")
    program.counts = {}
    assert read(a_run()) is None
    program.counts = {"nrb_rrt.GROWN": 0, "nrb_rrt.DRAWS": 0}
    assert read(a_run()) is None
    del sys.modules["cilqr_tpu_torch.utils.profiling"].counters
    assert read(a_run()) is None
