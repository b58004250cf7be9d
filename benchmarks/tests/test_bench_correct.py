"""CPU tests of what decides ``correct``: each cell driven through its
set-up, a short window and its check at a small batch (the program's plain
versions run on the CPU), first sound, then with the timed path broken
underneath, then with the control (the reference in bfloat16) in the
program's place.  A sound run must come out correct, every fault and the
control must not.

Run: ``python -m pytest benchmarks/tests -q`` from the repository root.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmarks import check as check_mod
from benchmarks import run as R

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 99
SMALL = dict(batch=8, check_lanes=8, check_calls=2, cycles=2)



@pytest.fixture(scope="module", params=[w["name"] for w in SPEC["workloads"]])
def cell(request):
    """(run, traffic, state) of a cell at a small batch on the CPU, set up once."""
    torch.set_num_threads(2)
    wl, config, cell, traffic = R.load_cell(SPEC, request.param, ROOT)
    run = R.Run(wl, config, dict(cell, **SMALL), SEED, 0.2, False, device=torch.device("cpu"))
    return run, traffic, traffic.setup(run)


def window(run, traffic, state, fault=None):
    """A window of the cell's traffic, its solves broken by ``fault``; the
    sampled lanes of the checked calls."""
    solve = state.solve
    state.reseed(run.seed)
    if fault is not None:
        # every traffic module's solve takes the egos (or the starts) last, (B, 4)
        state.solve = lambda *a: fault(state, a[-1].reshape(-1, 4), solve(*a))
    try:
        traffic.window(run, state)
    finally:
        state.solve = solve
    return traffic.release(run, state)


def cold(state, like):
    from cilqr_tpu_torch.models import solver

    U0 = solver.initial_controls(state.p, like.dtype, like.device)
    return U0.expand_as(like)


def unchanged(state, egos, res, lanes=slice(None)):
    """The solve hands back its start: the ego held over the horizon and the
    cold controls; a closed loop's vehicles never move."""
    if isinstance(res, tuple) and not hasattr(res, "_replace"):  # a closed loop's records
        final, rec = res[0].clone(), {k: v.clone() for k, v in res[1].items()}
        final[lanes] = egos[lanes]
        rec["start_pos"][:, lanes] = egos[lanes]
        return final, rec
    X, U = res.X.clone(), res.U.clone()
    X[lanes] = egos[lanes, None, :]
    U[lanes] = cold(state, res.U)[lanes]
    return res._replace(X=X, U=U)


def half_left_out(state, egos, res):
    """The second half of the batch is not solved."""
    return unchanged(state, egos, res, slice(egos.shape[0] // 2, None))


def altered(state, egos, res):
    """Every answer moved by one costmap cell (0.2 m in x) where it is made."""
    if isinstance(res, tuple) and not hasattr(res, "_replace"):
        rec = dict(res[1], noisy_pos=res[1]["noisy_pos"].clone())
        rec["noisy_pos"][..., 0] += 0.2
        return res[0], rec
    X = res.X.clone()
    X[..., 0] += 0.2
    return res._replace(X=X)


def test_sound_run_is_correct(cell):
    run, traffic, state = cell
    checks = traffic.check(run, window(run, traffic, state))
    assert R.judge(checks), checks


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered], ids=lambda f: f.__name__)
def test_fault_is_caught(cell, fault):
    run, traffic, state = cell
    checks = traffic.check(run, window(run, traffic, state, fault))
    assert not R.judge(checks), checks


def test_control_is_not_correct(cell):
    run, traffic, state = cell
    values = traffic.control(run, window(run, traffic, state))
    assert not R.judge(check_mod.checks(values, run.cell["limits"])), values
