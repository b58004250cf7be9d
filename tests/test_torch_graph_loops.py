"""The hybrid (K3) and two-phase (K2) LM loops as CUDA graphs (``solver.Iteration``).

On the card ``solver.optimize`` replays the loops of ``lm_cuda.fused_optimize``
(with a ``MapSampler``) and ``solver_batched.batched_optimize`` as a start
graph and a step graph, captured on ``solver.STREAMS`` streams, with K3 and
K2 as the ``torch.library`` ops ``cilqr_torch::lm_iter`` and
``cilqr_torch::riccati`` that the stream planner sees.  Here, on the CPU,
the ops run their plain versions: the loops' graph paths with the capture
replaced by eager replays under a four-stream planner give the eager loop's
bits; the ops' reads and writes are ordered against the ops around them; a
replay adds what its capture recorded to the launch counters, and the
warm-up and the capture add nothing; the graphs' key holds the route
(``route.plain_on_card()``), so a ``route.plain()`` block never replays a
graph captured on the kernels; the kernels are launched only inside their
ops.  The ``cuda`` tests hold the graphed loops to the eager ones on the
card.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from cilqr_tpu_torch.models import solver, solver_batched
from cilqr_tpu_torch.models.obstacles import Obstacles
from cilqr_tpu_torch.models.reference_path import get_local_plan
from cilqr_tpu_torch.ops import lm_cuda, riccati_cuda, route
from cilqr_tpu_torch.parallel import monte_carlo as mc
from cilqr_tpu_torch.sim.example_scenario import example_scenario
from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import SolverParams

DEV = "cpu"  # the port allocates on the card unless told otherwise
DTYPES = (torch.float32, torch.float64)
PORT = pathlib.Path(lm_cuda.__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs (six test workers share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def k3_op(p, world, plans, X, U, lamb, uext):
    """K3 through its op on any device (on the CPU: its plain version)."""
    return lm_cuda.iteration_op(p, world, plans, X, U, lamb, uext, 1)


def k2_op(p, d, X, U, lamb):
    """K2 (backward + rollout) through its op on any device."""
    return torch.ops.cilqr_torch.riccati(riccati_cuda.params_arg(p), d.l_x, d.l_xx, d.l_u,
                                         d.l_uu, X, U, lamb, True)


def hybrid_world(p, dtype, B: int, seed: int, device=DEV):
    """(plans, egos, U0, obstacles, one random map per scenario) on the
    example world."""
    plan, n, ego, U0, obstacles, unc = example_scenario(p, dtype, device=device)
    rng = np.random.default_rng(seed)
    egos = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (B, 4)), dtype=dtype,
                        device=device)
    H, W = unc.values.shape
    maps = mc.per_scenario_map(torch.tensor(rng.uniform(0.0, 100.0, (B, H, W)), dtype=dtype,
                                            device=device), unc.geom, unc.origin_xy,
                               unc.origin_yaw)
    U = U0.expand(B, p.horizon, 2).contiguous()
    return get_local_plan(p, plan, n, egos), egos, U, obstacles, maps


def per_lane_obstacles(obstacles: Obstacles, B: int, seed: int) -> Obstacles:
    """Obstacles grown per lane as ``ccnmpc.tightened_obstacles`` grows
    them (dims (B, M, N, 2), pos broadcast to (B, M, N, 4))."""
    grow = torch.tensor(np.random.default_rng(seed).uniform(0.0, 0.5, (B,) + tuple(
        obstacles.dims.shape)), dtype=obstacles.dims.dtype)
    dims = obstacles.dims + grow
    return Obstacles(dims, obstacles.pos.expand(dims.shape[:-1] + (4,)), obstacles.mask)


class PlannedEagerly:
    """Stands in for ``graphs.capture`` on the CPU: the capture runs the
    function once and records its launches (taken back), as a capture
    records its kernels; each replay runs it again under a stream planner
    without streams, writes what it returns into the capture's outputs
    (``out``) and adds the recorded launches, as a replay runs the captured
    kernels.  ``planners`` keeps each replay's plan."""

    captures = 0
    planners: list = []

    def __init__(self, fn, device, streams=1):
        type(self).captures += 1
        self.fn, self.streams = fn, streams
        out = []
        self.launches = graphs.record_launches(lambda: out.append(fn()))
        self.out = out[0]

    def replay(self):
        planner = graphs.StreamPlanner(self.streams)
        with graphs.uncounted(), planner:
            graphs.copy_outputs(self.out, self.fn())
        type(self).planners.append(planner)
        graphs.count_launches(self.launches)


@pytest.fixture
def planned_captures(monkeypatch):
    """The captures replaced by ``PlannedEagerly`` on ``solver.STREAMS``
    (4) streams, a cache of this test's own."""
    monkeypatch.setattr(graphs, "side_stream", lambda device: graphs.contextlib.nullcontext())
    monkeypatch.setattr(graphs, "capture", PlannedEagerly)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(PlannedEagerly, "planners", [])
    assert solver.STREAMS == 4


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def op_count(planner, name: str) -> int:
    return sum(o.name == name for o in planner.ops)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_loop_graph_path_gives_the_eager_bits(dtype, planned_captures):
    """``lm_cuda.hybrid_iteration`` with K3 through its op, the loop's graph
    path (``solver._optimize_graphed``) with the capture replaced by planned
    eager replays: X, U, iterations, J and lambda equal to the eager loop's
    and to ``fused_optimize``'s (the plain version here) on every lane; new
    egos replay without a capture; every step replay plans one K3 op."""
    p = dataclasses.replace(SolverParams(), horizon=12)
    for shift in (0.0, 0.4):
        plans, egos, U, obstacles, maps = hybrid_world(p, dtype, 5, seed=3)
        if shift:
            egos = egos + shift
            plans = get_local_plan(p, *example_scenario(p, dtype, device=DEV)[:2], egos)
        sampler = solver_batched.map_sampler(p, maps)
        it = lm_cuda.hybrid_iteration(p, plans, obstacles, sampler, k3_op)
        assert isinstance(it, solver.Iteration)
        before, planners = PlannedEagerly.captures, len(PlannedEagerly.planners)
        got = solver._optimize_graphed(p, plans, egos, U, iteration=it)
        want = solver.optimize(p, plans, egos, U, iteration=it)
        assert same(got, want)
        assert same(got, lm_cuda.fused_optimize(p, plans, egos, U, obstacles,
                                                unc_sampler=sampler))
        assert PlannedEagerly.captures - before == (2 if shift == 0.0 else 0)
        assert int(got[2].max()) > 1
        # the call's first replay is the start graph's, then one per iteration
        start, *steps = PlannedEagerly.planners[planners:]
        assert op_count(start, "lm_iter.default") == 0 and len(steps) == int(got[2].max())
        assert all(op_count(pl, "lm_iter.default") == 1 for pl in steps)


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_phase_loop_graph_path_gives_the_eager_bits(dtype, planned_captures, monkeypatch):
    """``solver_batched.batched_optimize`` with K2 through its op and per
    lane obstacles (as ``ccnmpc`` tightens them) and with shared ones and
    the map: the graph path with planned eager replays equal to the eager
    loop bit for bit; every step replay plans one K2 op."""
    monkeypatch.setattr(riccati_cuda, "backward_forward_batched", k2_op)
    p = dataclasses.replace(SolverParams(), horizon=12)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, dtype, device=DEV)
    plans, egos, U, _, _ = hybrid_world(p, dtype, 6, seed=5)
    for world in ((per_lane_obstacles(obstacles, 6, 7), None), (obstacles, unc)):
        it = solver_batched.two_phase_iteration(plans, *world)
        planners = len(PlannedEagerly.planners)
        got = solver._optimize_graphed(p, plans, egos, U, iteration=it)
        want = solver.optimize(p, plans, egos, U, iteration=it)
        assert same(got, want)
        plain = solver.optimize(p, plans, egos, U, iteration=solver.plain_iteration(
            dataclasses.replace(p, backward_impl="seq"), plans, *world))
        assert same(got, plain)
        start, *steps = PlannedEagerly.planners[planners:]
        assert op_count(start, "riccati.default") == 0 and len(steps) == int(got[2].max())
        assert all(op_count(pl, "riccati.default") == 1 for pl in steps)


def planned_step(p, it: solver.Iteration, plans, egos, U, n_streams: int):
    """The plan of what a step graph captures: one ``lm_step`` of the
    iteration ``it``, written back into the state."""
    state = solver.start_state(p, egos, U)
    step = it.build(p, plans, *it.world)
    lamb_inv = solver.damping_inverse(p, egos.dtype, egos.device)
    solver.lm_step(p, step, lamb_inv, *state)  # builds the cached constants, as the warm-up
    planner = graphs.StreamPlanner(n_streams)
    with planner:
        solver._assign(state, solver.lm_step(p, step, lamb_inv, *state))
    return planner


@pytest.mark.parametrize("kind", ["hybrid", "two_phase"])
def test_step_plans_order_every_dependency(kind, monkeypatch):
    """One step of each loop at N=50 (K3 / K2 through its op) planned on
    ``solver.STREAMS`` streams: every read after write, write after read
    and write after write pair is ordered by stream order or a chain of
    waits, the op planned once; the plan's chain lies within a list
    schedule's bound of the data's; with as many streams as the step is
    wide it is the data's."""
    from tests.test_torch_graph_streams import conflicts, dag_chain, happens_before

    p = dataclasses.replace(SolverParams(), horizon=50)
    plans, egos, U, obstacles, maps = hybrid_world(p, torch.float32, 4, seed=17)
    if kind == "hybrid":
        it = lm_cuda.hybrid_iteration(p, plans, obstacles, lm_cuda.MapSampler(p, maps), k3_op)
        op = "lm_iter.default"
    else:
        monkeypatch.setattr(riccati_cuda, "backward_forward_batched", k2_op)
        it = solver_batched.two_phase_iteration(plans, per_lane_obstacles(obstacles, 4, 17))
        op = "riccati.default"
    planner = planned_step(p, it, plans, egos, U, solver.STREAMS)
    ops = planner.ops
    assert op_count(planner, op) == 1
    hb = happens_before(ops)
    pairs = conflicts(ops)
    assert any(ops[a].stream != ops[b].stream for a, b in pairs)
    assert all(hb[b][ops[a].stream] >= ops[a].seq for a, b in pairs)
    stats = planner.stats
    assert stats.ops == len(ops) and stats.dag_chain == dag_chain(ops)
    assert stats.dag_chain <= stats.plan_chain <= stats.ops / stats.streams + stats.dag_chain
    wide = planned_step(p, it, plans, egos, U, 64).stats
    assert wide.plan_chain == wide.dag_chain == stats.dag_chain


class Placed(graphs.StreamPlanner):
    """A planner that puts the i-th op on ``streams[i]``."""

    def __init__(self, n: int, placement: list):
        super().__init__(n)
        self.placement = list(placement)

    def _place(self, deps, ready):
        return self.placement[len(self.ops)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_are_planned_with_their_reads_and_writes(dtype):
    """K3's and K2's ops on CPU tensors under the planner, each on another
    stream than its neighbours: one planned op each, reading every tensor
    argument and writing only new outputs; an op that reads an output waits
    for the op (read after write); an in-place write to an op's input on
    another stream waits for the op (write after read).  The results equal
    the plain versions'."""
    p = dataclasses.replace(SolverParams(), horizon=8)
    plans, egos, U, obstacles, maps = hybrid_world(p, dtype, 3, seed=9)
    from cilqr_tpu_torch.models import costs, dynamics

    X = dynamics.rollout(p, egos, U)
    lamb = torch.tensor([0.5, 1.0, 2.0], dtype=dtype)
    world = lm_cuda.prep_world(p, obstacles, None, torch.float32, device=DEV)
    prep = lm_cuda.prep_iteration(plans)
    world = world._replace(iteration=prep)
    want3 = lm_cuda.fused_iteration_plain(p, world, plans, X, U, lamb,
                                          lm_cuda.MapSampler(p, maps)(X[:, :p.horizon]))
    d, _ = costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, None)
    want2 = riccati_cuda.backward_forward_plain(p, d, X, U, lamb)

    uext = lm_cuda.MapSampler(p, maps)(X[:, :p.horizon])
    planner = Placed(3, [0, 1, 2, 0, 2])
    with planner:
        lamb2 = lamb * 1.0                                          # 0, stream 0
        got3 = k3_op(p, world, plans, X, U, lamb2, uext)            # 1, stream 1: reads lamb2
        J2 = got3[2] * 2.0                                          # 2, stream 2: reads K3's J
        got2 = k2_op(p, d, X, U, lamb2)                             # 3, stream 0: reads lamb2
        lamb2.add_(1.0)                                             # 4, stream 2: writes lamb2
    assert all(torch.equal(a, b) for a, b in zip(got3, want3))
    assert all(torch.equal(a, b) for a, b in zip(got2, want2))
    assert torch.equal(J2, want3[2] * 2.0)
    ops = planner.ops
    assert [o.name for o in ops] == ["mul.Tensor", "lm_iter.default", "mul.Tensor",
                                     "riccati.default", "add_.Tensor"]
    assert [o.stream for o in ops] == [0, 1, 2, 0, 2]
    key = planner._key
    # every tensor argument is a read (the plans' and obstacles' fields, for
    # the plain version, besides the kernel's payloads); the outputs are new
    # storages, and nothing else is written
    for t in (prep.table, prep.fit, X, U, lamb2, uext, world.obs, *plans, *obstacles):
        assert key(t) in ops[1].reads
    assert set(ops[1].writes) == {key(t) for t in got3}
    assert not set(ops[1].writes) & set(ops[1].reads)
    for t in (d.l_x, d.l_xx, d.l_u, d.l_uu, X, U, lamb2):
        assert key(t) in ops[3].reads
    assert set(ops[3].writes) == {key(t) for t in got2}
    # read after write across streams: K3 after lamb2's writer, J2 after K3
    assert ops[1].waits == (0,) and ops[2].waits == (1,)
    # K2 follows lamb2's writer on its own stream; the in-place write to
    # lamb2 on stream 2 waits for K2 on stream 0 (write after read; stream
    # 2 already follows K3, its other reader, through J2's wait)
    assert ops[3].waits == () and ops[4].waits == (3,)


@pytest.mark.parametrize("kind", ["hybrid", "two_phase"])
def test_launch_counters_advance_by_replays(kind, planned_captures, monkeypatch):
    """A stand-in for each kernel that counts as the kernel does (one per
    launch): the graphed loop's counter ends at the step replays, which is
    the eager loop's count (the largest iteration count), the warm-up and
    the capture counting nothing; the start graph adds nothing."""
    p = dataclasses.replace(SolverParams(), horizon=10)
    plans, egos, U, obstacles, maps = hybrid_world(p, torch.float64, 4, seed=11)
    if kind == "hybrid":
        def counted(*args):
            lm_cuda.ITER_LAUNCHES += 1
            return k3_op(*args)

        it = lm_cuda.hybrid_iteration(p, plans, obstacles, lm_cuda.MapSampler(p, maps), counted)
        read = lambda: lm_cuda.ITER_LAUNCHES
    else:
        def counted(*args):
            riccati_cuda.LAUNCHES += 1
            return k2_op(*args)

        monkeypatch.setattr(riccati_cuda, "backward_forward_batched", counted)
        it = solver_batched.two_phase_iteration(plans, obstacles)
        read = lambda: riccati_cuda.LAUNCHES
    for module, name in graphs.COUNTERS:
        monkeypatch.setattr(module, name, 0)
    got = solver._optimize_graphed(p, plans, egos, U, iteration=it)
    graphed = read()
    start, step = next(iter(solver.CAPTURED.values())).graphs
    assert sum(start.launches) == 0 and sum(step.launches) == 1
    for module, name in graphs.COUNTERS:
        setattr(module, name, 0)
    want = solver.optimize(p, plans, egos, U, iteration=it)
    assert same(got, want)
    assert graphed == read() == int(want[2].max()) > 1
    step.replay()
    assert read() == graphed + 1


def test_graph_key_holds_the_launch_route(planned_captures):
    """A loop captured on the kernels is not replayed inside
    ``route.plain()`` (its key differs, so it captures anew), nor the one
    captured there outside; on every later entry the plain route's capture
    serves again.  The key's last term is ``route.plain_on_card()``."""
    p = dataclasses.replace(SolverParams(), horizon=8, max_iterations=3)
    plans, egos, U, obstacles, maps = hybrid_world(p, torch.float32, 3, seed=13)
    it = lm_cuda.hybrid_iteration(p, plans, obstacles, lm_cuda.MapSampler(p, maps),
                                  lm_cuda.fused_iteration)
    solve = lambda: solver._optimize_graphed(p, plans, egos, U, iteration=it)
    keys = []
    for plain in (False, True, False, True):
        before = set(solver.CAPTURED)
        with route.plain() if plain else graphs.contextlib.nullcontext():
            solve()
        keys.append([k for k in solver.CAPTURED if k not in before])
    assert [len(k) for k in keys] == [1, 1, 0, 0]
    (kernel_key,), (plain_key,) = keys[:2]
    assert kernel_key[-1] is False and plain_key[-1] is True
    assert kernel_key[:-1] == plain_key[:-1]
    assert set(solver.CAPTURED) == {kernel_key, plain_key}


def test_a_bare_sampler_runs_the_loop_eagerly(planned_captures):
    """A sampler that is not a ``MapSampler`` (a bare closure over tensors a
    capture could not copy) gives the bare iteration: ``optimize`` runs it
    eagerly and captures nothing, with the same bits."""
    p = dataclasses.replace(SolverParams(), horizon=8)
    plans, egos, U, obstacles, maps = hybrid_world(p, torch.float32, 3, seed=15)
    sampler = lm_cuda.MapSampler(p, maps)
    bare = lm_cuda.hybrid_iteration(p, plans, obstacles, lambda Xb: sampler(Xb), k3_op)
    assert not isinstance(bare, solver.Iteration) and callable(bare)
    described = lm_cuda.hybrid_iteration(p, plans, obstacles, sampler, k3_op)
    assert same(solver.optimize(p, plans, egos, U, iteration=bare),
                solver._optimize_graphed(p, plans, egos, U, iteration=described))
    assert len(solver.CAPTURED) == 1


def calls_by_function(path: pathlib.Path) -> dict:
    """{callee's dotted name: [names of the functions (or module) whose
    bodies call it]} of one source file."""
    tree = ast.parse(path.read_text())
    out: dict = {}

    def visit(node, where):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Call):
                out.setdefault(ast.unparse(child.func), []).append(where)
            visit(child, where)

    visit(tree, "<module>")
    return out


def test_the_kernels_launch_only_inside_their_ops():
    """By the source: K2's and K3's entry points (``lib.cilqr_riccati``,
    ``lib.cilqr_lm_iter``) are called once each, in the CUDA implementation
    of their op; each op is called from one place, the launch function the
    wrappers call (``riccati_cuda._launch``; ``lm_cuda._launch_iteration``
    through ``iteration_op``); the op implementations are called by no file
    of the port and not by ``chip_smoke.py``, and the launch functions only
    from the wrappers (and the card's comparisons in ``chip_smoke.py``)."""
    ric = calls_by_function(PORT / "ops" / "riccati_cuda.py")
    lm = calls_by_function(PORT / "ops" / "lm_cuda.py")
    assert ric["lib.cilqr_riccati"] == ["_riccati_kernel"]
    assert lm["lib.cilqr_lm_iter"] == ["_lm_iter_kernel"]
    assert ric["torch.ops.cilqr_torch.riccati"] == ["_launch"]
    assert lm["torch.ops.cilqr_torch.lm_iter"] == ["iteration_op"]
    assert lm["iteration_op"] == ["_launch_iteration"]
    assert sorted(ric["_launch"]) == ["backward_batched", "backward_forward_batched"]
    assert lm["_launch_iteration"] == ["fused_iteration"]
    sources = [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]
    for f in sources:
        text = f.read_text()
        for name in ("_riccati_kernel", "_lm_iter_kernel", "cilqr_riccati(", "cilqr_lm_iter("):
            if f.name not in ("riccati_cuda.py", "lm_cuda.py"):
                assert name not in text, (f, name)
        calls = calls_by_function(f)
        if f.name not in ("riccati_cuda.py", "lm_cuda.py", "chip_smoke.py"):
            for name in ("riccati_cuda._launch", "lm_cuda._launch_iteration",
                         "lm_cuda.iteration_op"):
                assert name not in calls, (f, name)
    # both ops take tensors and write none of them, with a CPU and a CUDA
    # implementation each
    for op in (torch.ops.cilqr_torch.riccati.default, torch.ops.cilqr_torch.lm_iter.default):
        assert all(a.alias_info is None for a in op._schema.arguments)
        for key in ("CPU", "CUDA"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key)


def graphed_against_eager(dev: torch.device, current: int) -> None:
    """On the card ``dev`` with card ``current`` set: the hybrid loop
    (``fused_optimize`` with a ``MapSampler``) and the two-phase loop
    (``batched_optimize``, shared and per lane obstacles) graphed on
    ``solver.STREAMS`` streams and on one, each equal to ``GRAPHS = False``
    bit for bit on every lane, a second call on new egos replaying, the
    hybrid loop's step kernel and K2 counted once per step replay as the
    eager loop counts them."""
    p = dataclasses.replace(SolverParams(), horizon=50)
    unc = example_scenario(p, device=dev)[-1]
    with torch.cuda.device(current):
        for streams in (solver.STREAMS, 1):
            for seed in (21, 22):
                plans, egos, U, obstacles, maps = hybrid_world(p, torch.float32, 64, seed, dev)
                sampler = solver_batched.map_sampler(p, maps)
                lanes = per_lane_obstacles(Obstacles(*(t.cpu() for t in obstacles)), 64, seed)
                lanes = Obstacles(*(t.to(dev) for t in lanes))
                runs = {"hybrid": lambda: lm_cuda.fused_optimize(
                            p, plans, egos, U, obstacles, unc_sampler=sampler),
                        "two_phase": lambda: solver_batched.batched_optimize(
                            p, plans, egos, U, obstacles, unc),
                        "two_phase_lanes": lambda: solver_batched.batched_optimize(
                            p, plans, egos, U, lanes)}
                for name, run in runs.items():
                    out, counts = {}, {}
                    for graphed in (True, False):
                        solver.GRAPHS, solver.STREAMS = graphed, streams
                        lm_cuda.STEP_LAUNCHES = riccati_cuda.LAUNCHES = 0
                        out[graphed] = run()
                        torch.cuda.synchronize(dev)
                        counts[graphed] = (lm_cuda.STEP_LAUNCHES, riccati_cuda.LAUNCHES)
                    assert same(out[True], out[False]), (name, streams, seed)
                    assert counts[True] == counts[False], (name, counts)
                    assert sum(counts[True]) == int(out[True][2].max())
                    assert all(t.device == dev for t in out[True])
                    assert torch.cuda.current_device() == current


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_graphed_loops_equal_eager_on_the_card(monkeypatch):
    """The graphed hybrid and two-phase loops on the current card equal
    their eager loops bit for bit."""
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(solver, "GRAPHS", True)
    monkeypatch.setattr(solver, "STREAMS", solver.STREAMS)
    graphed_against_eager(torch.device("cuda", 0), 0)


@pytest.mark.cuda
@pytest.mark.skipif("torch.cuda.device_count() < 2", reason="needs two CUDA devices")
def test_graphed_loops_on_a_card_that_is_not_current(monkeypatch):
    """The captures and their replays on the last card while the first is
    the current one."""
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(solver, "GRAPHS", True)
    monkeypatch.setattr(solver, "STREAMS", solver.STREAMS)
    graphed_against_eager(torch.device("cuda", torch.cuda.device_count() - 1), 0)
