"""The plain LM loop of ``models/solver.py`` as CUDA graphs.

``optimize`` is ``start_state`` then ``lm_step`` until every lane has
stopped; on the card the plain iteration replays as two captured graphs
(``solver.GRAPHS``).  On the CPU: the factored loop gives the loop it
replaced bit for bit (the replaced loop body is kept here as the reference)
at N=50 on the benchmark's egos; a step after every lane has stopped
changes no bit; the hoisted cost constants equal the inline ones they
replaced; the graph path's buffers and cache, with a stand-in for the
capture that replays the captured function eagerly, give the eager loop's
bits, and the cache copies in and evicts.  On the card (``cuda``, skipped
here): the graphed ``run_step`` (the plan fit in the start graph) and
``optimize`` equal the eager ones bit for bit, captured on one stream and
on four, a second call replays instead of capturing, and the capture
follows its inputs' device whichever card is current.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from cilqr_tpu_torch.models import costs, solver
from cilqr_tpu_torch.sim.example_scenario import example_scenario
from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import SolverParams

DEV = "cpu"  # the port allocates on the card unless told otherwise
DTYPES = (torch.float32, torch.float64)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs: the tier runs six workers at
    once, and these small eager loops only lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_inputs(p, dtype, device, B: int, seed: int = 2):
    """The benchmark's world at N=50 and B of its egos ``ego + N(0, 0.3)``."""
    plan, n, ego, U0, obstacles, unc = example_scenario(p, dtype, device=device)
    rng = np.random.default_rng(seed)
    egos = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (B, 4)), dtype=dtype,
                        device=device)
    return plan, n, egos, U0.expand(B, p.horizon, 2).contiguous(), obstacles, unc


def replaced_loop(p, plan, x0, U_init, obstacles, unc_map):
    """The LM loop as ``optimize`` wrote it before ``lm_step`` was factored
    out of it (one function, the iteration inline)."""
    def iteration(X, U, lamb):
        d, J = costs.all_cost_derivs_and_J(p, plan, X, U, obstacles, unc_map)
        k, K = solver.backward_from_derivs(p, d, X, U, lamb)
        return (*solver.forward_pass(p, X, U, k, K), J)

    X, U = solver.dynamics.rollout(p, x0, U_init), U_init
    batch = U_init.shape[:-2]
    kw = dict(dtype=X.dtype, device=X.device)
    J_old = torch.full(batch, torch.finfo(X.dtype).max, **kw)
    lamb = torch.full(batch, p.lamb_init, **kw)
    it = torch.zeros(batch, dtype=torch.int32, device=X.device)
    done = torch.zeros(batch, dtype=torch.bool, device=X.device)
    lamb_inv = torch.tensor(p.lamb_factor, **kw).reciprocal()
    for _ in range(p.max_iterations):
        if bool(done.all()):
            break
        X_new, U_new, J_new = iteration(X, U, lamb)
        accept = J_new < J_old
        take = (accept & ~done)[..., None, None]
        X = torch.where(take, X_new, X)
        U = torch.where(take, U_new, U)
        lamb_n = torch.where(accept, lamb * lamb_inv, lamb * p.lamb_factor)
        stop = torch.where(accept, (J_new - J_old).abs() < p.tolerance, lamb_n > p.lamb_max)
        J_old = torch.where(done, J_old, J_new)
        lamb = torch.where(done, lamb, lamb_n)
        it = torch.where(done, it, it + 1)
        done = done | stop
    return X, U, it, J_old, lamb


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("impl", ["seq", "pscan"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_factored_step_gives_the_replaced_loop(dtype, impl):
    """N=50, 16 of the benchmark's egos with obstacles and the map: every
    field equal bit for bit, and some lanes stop before others."""
    p = dataclasses.replace(SolverParams(), horizon=50, backward_impl=impl)
    plan, n, egos, U0, obstacles, unc = bench_inputs(p, dtype, DEV, 16)
    lp = solver.get_local_plan(p, plan, n, egos)
    got = solver.optimize(p, lp, egos, U0, obstacles, unc)
    assert same(got, replaced_loop(p, lp, egos, U0, obstacles, unc))
    assert len(set(got[2].tolist())) > 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_after_every_lane_stopped_changes_nothing(dtype):
    """A stopped lane keeps its state bit for bit under ``lm_step``: every
    lane stopped, then half of them (the others move)."""
    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, egos, U0, obstacles, unc = bench_inputs(p, dtype, DEV, 8, seed=3)
    lp = solver.get_local_plan(p, plan, n, egos)
    X, U, it, J, lamb = solver.optimize(p, lp, egos, U0, obstacles, unc)
    step = solver.plain_iteration(p, lp, obstacles, unc)
    lamb_inv = solver.damping_inverse(p, dtype, DEV)
    state = (X, U, lamb, J, it, torch.ones(8, dtype=torch.bool))
    assert same(solver.lm_step(p, step, lamb_inv, *state), state)
    start = solver.start_state(p, egos, U0)
    half = torch.arange(8) % 2 == 0
    mixed = start[:-1] + (half,)
    out = solver.lm_step(p, step, lamb_inv, *mixed)
    for a, b in zip(out[:-1], mixed[:-1]):
        assert torch.equal(a[half], b[half])
    assert not torch.equal(out[3][~half], mixed[3][~half])
    assert torch.equal(out[-1][half], half[half])


@pytest.mark.parametrize("dtype", DTYPES)
def test_hoisted_constants_equal_the_inline_ones(dtype):
    """``costs.consts`` holds what the cost functions built inline, and is
    built once per (params, dtype, device)."""
    p = dataclasses.replace(SolverParams(), w_pos=0.7, w_vel=0.3, w_acc=1.3, w_yawrate=2.9)
    kw = dict(dtype=dtype, device=DEV)
    c = costs.consts(p, dtype, torch.device(DEV))
    want = (torch.tensor([1.0, 0.0], **kw), torch.tensor([0.0, 1.0], **kw),
            torch.tensor([[p.w_acc, 0.0], [0.0, p.w_yawrate]], **kw),
            torch.diag(torch.tensor([p.w_pos, p.w_pos, p.w_vel, 0.0], **kw)),
            torch.tensor([p.w_pos, p.w_pos, p.w_vel, 0.0], **kw),
            torch.tensor([p.w_acc, p.w_yawrate], **kw))
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(c, want))
    assert costs.consts(p, dtype, torch.device(DEV)) is c
    assert costs.consts(dataclasses.replace(p, w_pos=0.8), dtype, torch.device(DEV)) is not c


class ReplayedEagerly:
    """Stands in for ``graphs.capture`` on the CPU: replay() runs the captured
    function again, as a replay runs its kernels again, and writes what it
    returns into the capture's outputs (``out``), as a replay writes a
    graph's outputs again."""

    captures = 0

    def __init__(self, fn, device, streams=1):
        type(self).captures += 1
        self.fn = fn
        self.out = fn()

    def replay(self):
        graphs.copy_outputs(self.out, self.fn())


@pytest.fixture
def eager_captures(monkeypatch):
    """``graphs.side_stream`` and ``graphs.capture`` replaced for the CPU."""
    monkeypatch.setattr(graphs, "side_stream", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "capture", ReplayedEagerly)


@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_path_buffers_on_cpu(dtype, monkeypatch, eager_captures):
    """``solver._optimize_graphed`` with the capture replaced by eager
    replays: the static buffers, the copies in and out and the cache give
    the eager loop's bits, unbatched and at B=5; a second call with new egos
    captures nothing; the oldest capture goes beyond the cache's ``kept``."""
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache(kept=2))
    p = dataclasses.replace(SolverParams(), horizon=30)
    plan, n, egos, U0, obstacles, unc = bench_inputs(p, dtype, DEV, 10, seed=4)
    for lanes, world in ((slice(0, 5), (obstacles, unc)), (slice(5, 10), (obstacles, unc)),
                         (0, (obstacles, unc)), (1, (obstacles, None))):
        e, u = egos[lanes], U0[lanes]
        lp = solver.get_local_plan(p, plan, n, e)
        before = ReplayedEagerly.captures
        got = solver._optimize_graphed(p, lp, e, u, *world)
        assert same(got, solver.optimize(p, lp, e, u, *world))
        assert ReplayedEagerly.captures - before == (0 if lanes == slice(5, 10) else 2)
        assert len(solver.CAPTURED) <= 2
    # the B=5 capture, the oldest, made room for the map-less one
    # (the key's (shape, dtype) of each input: x0 first, then the map's among them)
    assert [(k[3][0][0], (unc.values.shape, dtype) in k[3]) for k in solver.CAPTURED] == [
        (torch.Size([4]), True), (torch.Size([4]), False)]


def test_graph_cache_keeps_copies_in_and_evicts():
    """``graphs.GraphCache``: a miss makes the entry on clones of the call's
    tensors, a hit copies the call's tensors into the same buffers and makes
    nothing; beyond ``kept`` the oldest entry goes; ``clear`` drops all."""
    made = []

    def make(inputs):
        made.append(inputs)
        return (), [inputs[0] * 2], "held"

    cache = graphs.GraphCache(kept=2)
    a, b = torch.arange(3.0), torch.arange(3.0) + 10
    first = cache.load("a", [a], make)
    assert first.inputs[0] is not a and torch.equal(first.inputs[0], a)
    assert first.held == "held" and torch.equal(first.out[0], a * 2)
    again = cache.load("a", [b], make)
    assert again is first and len(made) == 1 and torch.equal(first.inputs[0], b)
    cache.load("b", [a], make)
    cache.load("c", [a], make)
    assert list(cache) == ["b", "c"] and len(made) == 3
    assert "a" not in cache and cache["b"].inputs[0] is made[1][0]
    cache.clear()
    assert len(cache) == 0


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("streams", [1, 4])
@pytest.mark.parametrize("impl", ["seq", "pscan"])
def test_graphed_run_step_equals_eager_on_the_card(impl, streams, monkeypatch):
    """``solver.run_step`` (the plan fit in the start graph) and
    ``solver.optimize`` on a given plan, on the card with obstacles and the
    map, unbatched (B=1) and at B=64, the graphs captured on ``streams``
    streams: graphed equal to ``GRAPHS = False`` bit for bit; a call on new
    egos replays the captured graphs."""
    dev = torch.device("cuda")
    monkeypatch.setattr(solver, "STREAMS", streams)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    p = dataclasses.replace(SolverParams(), horizon=50, backward_impl=impl)
    plan, n, egos, U0, obstacles, unc = bench_inputs(p, torch.float32, dev, 130, seed=5)
    for lanes in ((0, 1), (slice(2, 66), slice(66, 130))):
        results = []
        for i, lane in enumerate(lanes):
            e, u = egos[lane], U0[lane]
            lp = solver.get_local_plan(p, plan, n, e)
            monkeypatch.setattr(solver, "GRAPHS", True)
            held = dict(solver.CAPTURED)
            graphed = solver.run_step(p, plan, n, e, u, obstacles, unc)
            graphed_opt = solver.optimize(p, lp, e, u, obstacles, unc)
            if i:
                assert held.keys() == solver.CAPTURED.keys()
                assert all(solver.CAPTURED[k] is g for k, g in held.items())
            monkeypatch.setattr(solver, "GRAPHS", False)
            eager = solver.run_step(p, plan, n, e, u, obstacles, unc)
            eager_opt = solver.optimize(p, lp, e, u, obstacles, unc)
            torch.cuda.synchronize()
            assert same(graphed, eager) and same(graphed_opt, eager_opt)
            results.append(graphed)
        assert not torch.equal(results[0].U, results[1].U)
    assert len(solver.CAPTURED) == 4
    if streams > 1:
        for g in solver.CAPTURED.values():
            for graph in g.graphs:
                assert graph.stats.streams == streams
                assert graph.stats.dag_chain <= graph.stats.plan_chain < graph.stats.ops


def graphed_against_eager(dev: torch.device, current: int) -> None:
    """``_optimize_graphed`` on tensors of ``dev`` with card ``current`` the
    current one: equal to the eager loop bit for bit, at the capture and at
    a replay on new egos; the capture stays on ``dev``."""
    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, egos, U0, obstacles, unc = bench_inputs(p, torch.float32, dev, 16, seed=7)
    with torch.cuda.device(current):
        for lanes in (slice(0, 8), slice(8, 16)):
            e, u = egos[lanes], U0[lanes]
            lp = solver.get_local_plan(p, plan, n, e)
            got = solver._optimize_graphed(p, lp, e, u, obstacles, unc)
            torch.cuda.synchronize(dev)
            assert same(got, solver.optimize(p, lp, e, u, obstacles, unc, iteration=
                                             solver.plain_iteration(p, lp, obstacles, unc)))
            assert all(t.device == dev for t in got)
            assert torch.cuda.current_device() == current


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_graphed_solve_with_the_current_card_set(monkeypatch):
    """The capture and its replays on the card that is current, set
    explicitly."""
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    graphed_against_eager(torch.device("cuda", 0), 0)


@pytest.mark.cuda
@pytest.mark.skipif("torch.cuda.device_count() < 2", reason="needs two CUDA devices")
def test_graphed_solve_on_a_card_that_is_not_current(monkeypatch):
    """The capture and its replays on the last card while the first is the
    current one (as the sharded solver calls each card of its mesh in turn),
    and the sharded plain solve over every card graphed equal to eager."""
    from cilqr_tpu_torch.parallel import batch

    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    last = torch.cuda.device_count() - 1
    graphed_against_eager(torch.device("cuda", last), 0)
    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, egos, U0, obstacles, unc = bench_inputs(p, torch.float32, torch.device("cuda", 0),
                                                     8 * (last + 1), seed=8)
    fn, _ = batch.make_sharded_solver(p, batch.make_mesh(), obstacles, unc)
    outs = []
    for graphed in (True, False):
        monkeypatch.setattr(solver, "GRAPHS", graphed)
        outs.append(fn(plan, n, egos, U0)[0])
    assert same(outs[0], outs[1])
