"""CPU tests of the cell ``campaign.ccnmpc_b8192``: its check guards the
chance-constraint mechanism, not only the solve.  At a small batch (8
vehicles, 2 cycles) a sound run is correct; a run with the tightening
dropped (kappa = 0), with one SQP round in place of two, with the
covariance propagated without the process noise W, with a stale warm
start handed to the next cycle, or with the first round seeded with the
cold controls in place of the warm start is not, nor is the control (the reference
in bfloat16 in the program's place).  Then the
reader of ``cc_start_ms_per_cycle`` on hand-built spans, and its silence
without round spans (a program whose rounds are not spans).

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
CELL = "campaign.ccnmpc_b8192"
SEED = 2 ** 31 + 99
SMALL = dict(batch=8, check_lanes=8, check_calls=2, cycles=2)


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


def no_tightening(state, monkeypatch):
    # kappa = sqrt(-2 ln 1) = 0
    monkeypatch.setattr(state, "cc", dataclasses.replace(state.cc, delta=1.0))


def one_round(state, monkeypatch):
    monkeypatch.setattr(state, "cc", dataclasses.replace(state.cc, n_sqp=1))


def no_process_noise(state, monkeypatch):
    from cilqr_tpu_torch.models import ccnmpc

    propagate = ccnmpc.propagate_covariance
    monkeypatch.setattr(ccnmpc, "propagate_covariance", lambda p, X, U, S0, W: propagate(
        p, X, U, S0, torch.zeros_like(W)))


def stale_warm_start(state, monkeypatch):
    """The closed loop hands each cycle's planner the warm start one cycle
    late (at cycle 1 the cold controls again): every cycle's solve is sound
    on the inputs it got, so only the check of the hand-off sees it."""
    from cilqr_tpu_torch.sim import plant

    loop = plant.closed_loop_batched

    def late(*args, plan_step_batched, **kw):
        warm = []

        def step(noisy, U_warm):
            warm.append(U_warm)
            return plan_step_batched(noisy, warm[max(len(warm) - 2, 0)])

        return loop(*args, plan_step_batched=step, **kw)

    monkeypatch.setattr(plant, "closed_loop_batched", late)


def cold_first_round(state, monkeypatch):
    """The planner's first round starts from the cold controls, not from the
    warm start it was handed."""
    from cilqr_tpu_torch.models import ccnmpc, solver

    run_steps = ccnmpc.run_steps

    def cold(p, cc, noise, plan_xy, plan_n, egos, U_warm, *args, **kw):
        U = solver.initial_controls(p, egos.dtype, egos.device).expand_as(U_warm)
        return run_steps(p, cc, noise, plan_xy, plan_n, egos, U, *args, **kw)

    monkeypatch.setattr(ccnmpc, "run_steps", cold)


@pytest.mark.parametrize("fault", [no_tightening, one_round, no_process_noise,
                                   stale_warm_start, cold_first_round],
                         ids=lambda f: f.__name__)
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
    prof.found = []
    prof.spans = lambda: list(prof.found)
    monkeypatch.setitem(sys.modules, prof.__name__, prof)
    return prof


def rounds(first_id: int, start: float, device_ms: tuple) -> list:
    """An entry call with one round per (start replay's device ms): each
    round's start replay and loop, and a start replay outside any round."""
    out = [Span("entry.closed_loop", first_id, None, first_id, at(start), at(start + 50.0)),
           Span("replay.start", first_id + 1, first_id, first_id, at(start), at(start + 0.1),
                False, at(start), at(start + 9.0))]
    i = first_id + 2
    for k, ms in enumerate(device_ms):
        t = start + 10.0 * (k + 1)
        out += [Span("ccnmpc.round", i, first_id, first_id, at(t), at(t + 5.0)),
                Span("replay.start", i + 1, i, first_id, at(t), at(t + 0.1), False, at(t),
                     at(t + ms)),
                Span("replay.loop", i + 2, i, first_id, at(t + 0.1), at(t + 0.2), False,
                     at(t + ms), at(t + ms + 3.0), 20)]
        i += 3
    return out


def test_cc_start_time_per_cycle(program):
    """The start replays inside the rounds, 1.5 + 2.5 + 0.5 + 1.5 ms over
    40 cycles; the start replay outside a round is not counted."""
    program.found = rounds(1, 0.0, (1.5, 2.5)) + rounds(20, 100.0, (0.5, 1.5))
    r = a_run(calls=2, counters={"cycles_traced": 40})
    assert R.load_reader("cc_start_ms_per_cycle")(r) == pytest.approx(6.0 / 40, rel=1e-6)


def test_cc_start_is_silent_without_round_spans(program):
    """Rounds that are not spans (their solves' start replays under another
    entry), no spans at all, or no cycles: no value, and no error."""
    read = R.load_reader("cc_start_ms_per_cycle")
    program.found = [s for s in rounds(1, 0.0, (1.5, 2.5)) if s.name != "ccnmpc.round"]
    assert read(a_run(calls=1, counters={"cycles_traced": 20})) is None
    program.found = []
    assert read(a_run(calls=1, counters={"cycles_traced": 20})) is None
    program.found = rounds(1, 0.0, (1.5,))
    assert read(a_run(calls=0)) is None
