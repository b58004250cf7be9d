"""CCNMPC as a closed-loop campaign on the port's graphed path
(``models/ccnmpc``, ``sim/plant.closed_loop_batched`` with the CCNMPC plan
step of ``sim/runner.make_plan_step``).

Each SQP round is one ``solver.solve`` whose stage runs the rollout, the
covariance, the tightening and the plan fit (a start graph on the card),
then the two-phase LM loop (K2 once per step).  Here, on the CPU, in
float64 on the benchmark's deployment (``benchmarks/configs/
ccnmpc_success1_n40.json``: N=40, the three ``success1`` obstacles, the
injected noise as W): the covariance and the grown half-axes against the
benchmark's plain reference (``benchmarks/reference/ccnmpc.py``) at 1e-10;
every round of a two-cycle closed loop at B=8 against the reference's cycle
on the same inputs, iterations equal and X, U at the BASELINE 1e-3 bar; on
a small world, the rounds with the captures replaced by eager replays
under a four-stream planner equal to ``solver.GRAPHS = False`` bit for bit,
K2's op once per step replay and none in the start, the spans and the
counters.  The ``cuda`` test holds the graphed closed loop to the eager one
on the card, bit for bit, with K2's launches equal by replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import world as world_mod
from benchmarks.reference import ccnmpc as ref_cc
from benchmarks.reference import cilqr as ref
from cilqr_tpu_torch.models import ccnmpc, dynamics, solver
from cilqr_tpu_torch.models.obstacles import make_static_obstacles
from cilqr_tpu_torch.models.reference_path import pad_global_plan
from cilqr_tpu_torch.sim import plant, runner
from cilqr_tpu_torch.utils import profiling
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams
from tests import test_torch_graph_ops as ops
from tests.test_torch_graph_loops import k2_op
from tests.test_torch_graph_ops import replays  # noqa: F401  (the fixture)

DEV = "cpu"  # the port allocates on the card unless told otherwise
ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmarks" / "configs" / "ccnmpc_success1_n40.json").read_text())
BAR = 1e-3  # BASELINE.md's control bar


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deployment(dtype, device=DEV, **solver_kw) -> dict:
    """The benchmark's deployment in ``dtype``: the port's parameters, the
    reference's, the route, the obstacles both ways, the noise and W."""
    p = dataclasses.replace(SolverParams(), **dict(CONFIG["solver"], **solver_kw))
    pr = ref.Params.from_config(dict(CONFIG["solver"], **solver_kw))
    w = CONFIG["world"]
    route, obs = world_mod.route(w), world_mod.obstacles(w)
    plan, n = pad_global_plan(p, route, dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=device)
    noise = NoiseParams(**CONFIG["noise"])
    return dict(p=p, pr=pr, plan=plan, n=n, route=torch.tensor(route, **kw),
                obs=torch.tensor(obs, **kw), noise=noise,
                ob=make_static_obstacles(p, obs[:, :2], obs[:, 3:5], obs[:, 2], **kw),
                sat=(torch.tensor(obs[:, :3], **kw), torch.tensor(obs[:, 3:5], **kw),
                     torch.ones(len(obs), **kw)),
                cc=ccnmpc.CCParams(**CONFIG["chance"]),
                chance=ref_cc.Chance(**CONFIG["chance"]),
                W=ccnmpc.process_noise(noise, dtype, device))


def starts(B: int, seed: int, dtype, device=DEV) -> torch.Tensor:
    """B starts at x uniform over the configuration's spread along the lane."""
    w = CONFIG["world"]
    x = np.random.default_rng(seed).uniform(0.0, w["start_spread_m"], B)
    s = np.tile(np.asarray(w["start"]), (B, 1))
    s[:, 0] += x
    return torch.tensor(s, dtype=dtype, device=device)


@pytest.mark.parametrize("seed", [0, 1])
def test_covariance_and_half_axes_equal_the_reference(seed):
    """``propagate_covariance`` from Sigma0 = W and the half-axes the cost
    derives from ``tightened_obstacles`` (the three real obstacles' slots),
    against the reference's recursion and its grown half-axes, at 1e-10;
    the padding slots keep their mask and position."""
    d = deployment(torch.float64)
    p, pr = d["p"], d["pr"]
    rng = np.random.default_rng(seed)
    egos = starts(8, seed, torch.float64) + torch.tensor(rng.normal(0, [0.2, 0.3, 0.5, 0.05],
                                                                    (8, 4)))
    U = torch.tensor(rng.uniform([-1.0, -0.3], [1.0, 0.3], (8, p.horizon, 2)))
    X = dynamics.rollout(p, egos, U)
    S = ccnmpc.propagate_covariance(p, X, U, d["W"], d["W"])
    want = ref_cc.covariance(pr, X, U, d["W"], d["W"])
    assert S.shape == (8, p.horizon + 1, 4, 4)
    torch.testing.assert_close(S, want, rtol=0, atol=1e-10)
    ob_t = ccnmpc.tightened_obstacles(p, d["cc"], d["ob"], S)
    M = d["obs"].shape[0]
    half = lambda k, extra: ob_t.dims[:, :M, :, k] / 2.0 + p.s_safe_a * (k == 0) \
        + p.s_safe_b * (k == 1) + p.ego_rad + extra
    a, b = ref_cc.half_axes(pr, d["chance"].kappa, d["obs"], S, p.horizon)
    torch.testing.assert_close(half(0, 0.0), a, rtol=0, atol=1e-10)
    torch.testing.assert_close(half(1, 1.0), b, rtol=0, atol=1e-10)
    assert bool((ob_t.dims[:, :M] > d["ob"].dims[:M]).all())
    assert torch.equal(ob_t.mask, d["ob"].mask)
    assert torch.equal(ob_t.pos, d["ob"].pos.expand_as(ob_t.pos))


@contextlib.contextmanager
def recorded_rounds():
    """Inside: every ``ccnmpc.solve_round`` call's (egos, U, result), as it
    runs."""
    calls, solve_round = [], ccnmpc.solve_round

    def wrapped(p, cc, plan_xy, plan_n, egos, U, *rest):
        res = solve_round(p, cc, plan_xy, plan_n, egos, U, *rest)
        calls.append((egos, U, res))
        return res

    ccnmpc.solve_round = wrapped
    try:
        yield calls
    finally:
        ccnmpc.solve_round = solve_round


def with_rounds(fn) -> tuple:
    """(fn(), the results of the rounds it ran)."""
    with recorded_rounds() as calls:
        out = fn()
    return out, [c[2] for c in calls]


def closed_loop(d: dict, x0s, draws, T: int):
    step = runner.make_plan_step("ccnmpc", d["p"], d["noise"], d["plan"], d["n"], d["ob"],
                                 cc_params=d["cc"])
    return plant.closed_loop_batched(d["p"], d["noise"], d["plan"], d["n"], x0s, None, T,
                                     obs_xyyaw=d["sat"][0], obs_size=d["sat"][1],
                                     obs_mask=d["sat"][2], noise_draws=draws,
                                     plan_step_batched=step)


def test_closed_loop_rounds_equal_the_reference():
    """Two cycles of 8 vehicles on the deployment in float64: each cycle's
    noisy pose is the true state plus sigma times the draw; each of its two
    rounds, run by the reference on the same pose and warm start (the cold
    controls at cycle 0, then the last cycle's plan), gives the same LM
    iterations and X, U within the bar; the second round's plan is the
    cycle's, and the next true state the plant's step on its first
    control."""
    d = deployment(torch.float64)
    p, pr, T, B = d["p"], d["pr"], 2, 8
    x0s = starts(B, 7, torch.float64)
    draws = torch.tensor(np.random.default_rng(8).normal(size=(T, B, 3)))
    with recorded_rounds() as calls:
        final, rec = closed_loop(d, x0s, draws, T)
    assert len(calls) == T * d["cc"].n_sqp
    sig = torch.tensor([d["noise"].sigma_x, d["noise"].sigma_y, d["noise"].sigma_theta],
                       dtype=torch.float64)
    warm = ref.initial_controls(pr, B, torch.float64, DEV)
    for c in range(T):
        state = rec["start_pos"][c]
        r = draws[c]
        noisy = state + torch.stack([sig[0] * r[:, 0], sig[1] * r[:, 1], torch.zeros(B),
                                     sig[2] * r[:, 2]], dim=-1)
        torch.testing.assert_close(rec["noisy_pos"][c], noisy, rtol=0, atol=1e-12)
        rounds = ref_cc.cycle(pr, d["chance"], d["route"], d["obs"], noisy, warm, d["W"])
        for i, want in enumerate(rounds):
            egos, U_in, got = calls[c * d["cc"].n_sqp + i]
            assert torch.equal(egos, rec["noisy_pos"][c])
            assert torch.equal(got.iterations.long(), want.iterations), (c, i)
            assert float((got.X - want.X).abs().max()) < BAR, (c, i)
            assert float((got.U - want.U).abs().max()) < BAR, (c, i)
        assert torch.equal(rec["J"][c], got.J) and torch.equal(rec["iterations"][c],
                                                                got.iterations)
        nxt = rec["start_pos"][c + 1] if c + 1 < T else final
        torch.testing.assert_close(nxt, ref.step(pr, state, got.U[:, 0]), rtol=0, atol=1e-12)
        warm = got.U


def small(dtype) -> dict:
    """The deployment at a small horizon (N=10, 4 LM iterations), the three
    obstacles within reach of starts near the first."""
    d = deployment(dtype, horizon=10, max_iterations=4, num_of_local_wpts=8,
                   closest_point_samples_per_wpt=5)
    d["x0s"] = starts(3, 30, dtype) + torch.tensor([12.0, 0.0, 0.0, 0.0], dtype=dtype)
    d["draws"] = torch.tensor(np.random.default_rng(31).normal(size=(3, 3, 3)), dtype=dtype)
    return d


@pytest.mark.parametrize("dtype", ops.DTYPES)
def test_staged_rounds_give_the_eager_bits(dtype, replays, monkeypatch):
    """The closed loop with the CCNMPC plan step, its rounds staged (a start
    graph and the step graph, replayed eagerly under a four-stream planner),
    equal to ``solver.GRAPHS = False`` on every record and on every round's
    result; one capture serves both rounds and every cycle (four graphs in
    all: the noise stage, the round's start and step, the advance); the
    start replays run no kernel op, K2's op runs once per step replay, a
    round's steps its largest iteration count; a second call on new starts
    replays without a capture.  K2 runs through its op (on the CPU: its
    plain version), as on the card."""
    from cilqr_tpu_torch.ops import riccati_cuda

    monkeypatch.setattr(riccati_cuda, "backward_forward_batched", k2_op)
    d = small(dtype)
    steps = 0
    for k in range(2):
        got, want = ops.graphed_and_eager(
            lambda: with_rounds(lambda: closed_loop(d, d["x0s"] + 0.3 * k, d["draws"], 3)),
            monkeypatch)
        assert ops.same(got, want), k
        assert len(got[1]) == 6
        steps += sum(int(r.iterations.max()) for r in got[1])
    assert ops.PlannedReplays.captures == 4
    names = [ops.op_names(pl) for pl in ops.PlannedReplays.planners]
    assert names.count([]) == 2 * 3 * 4  # per cycle the noise, two starts, the advance
    assert names.count(["riccati"]) == steps and len(names) == 24 + steps


def test_rounds_span_and_count_under_the_closed_loop(replays):
    """``closed_loop_batched``: the entry span ``entry.closed_loop``; per
    cycle the noise stage's graph, one ``ccnmpc.round`` span per round with
    its index, each holding its start replay and device loop, then the
    advance's graph; the rounds run, counted."""
    d = small(torch.float32)
    T, S = 3, d["cc"].n_sqp
    with profiling.tracing():
        closed_loop(d, d["x0s"], d["draws"], T)
    found = profiling.spans()
    (entry,) = [s for s in found if s.parent is None]
    assert entry.name == "entry.closed_loop"
    run = ["run.copy_in", "run.replay", "run.copy_out"]
    assert [s.name for s in found if s.parent == entry.id] == (
        run + ["ccnmpc.round"] * S + run) * T
    rounds = [s for s in found if s.name == "ccnmpc.round"]
    assert [s.index for s in rounds] == list(range(S)) * T
    for r in rounds:
        names = [s.name for s in found if s.parent == r.id]
        assert names == ["replay.copy_in", "replay.start", "replay.loop", "replay.copy_out",
                         "replay.count"]
    assert profiling.counters()["ccnmpc.ROUNDS"] == S * T


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_graphed_rounds_equal_eager_on_the_card(monkeypatch):
    """The closed loop with the CCNMPC plan step on the deployment, B=256 x
    3 cycles in float32: graphed (a start graph and a device loop per round)
    equal to ``solver.GRAPHS = False`` bit for bit on every record and every
    round's result, with K2's launches (counted by replay) and the rounds
    equal."""
    from cilqr_tpu_torch.ops import riccati_cuda
    from cilqr_tpu_torch.utils import graphs

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    d = deployment(torch.float32, dev)
    x0s = starts(256, 90, torch.float32, dev)
    draws = torch.tensor(np.random.default_rng(91).normal(size=(3, 256, 3)),
                         dtype=torch.float32, device=dev)
    out, counts = {}, {}
    for graphed in (True, False):
        monkeypatch.setattr(solver, "GRAPHS", graphed)
        k2, rounds = riccati_cuda.LAUNCHES, ccnmpc.ROUNDS
        out[graphed] = with_rounds(lambda: closed_loop(d, x0s, draws, 3))
        torch.cuda.synchronize()
        counts[graphed] = (riccati_cuda.LAUNCHES - k2, ccnmpc.ROUNDS - rounds)
    assert ops.same(out[True], out[False])
    its = sum(int(r.iterations.max()) for r in out[False][1])
    assert counts[True] == counts[False] == (its, 6)
    assert len(solver.CAPTURED) == 3  # the noise stage, a round, the advance
