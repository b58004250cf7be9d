"""The hybrid LM step as one kernel over the lanes still running
(``lm_cuda.fused_step``, op ``cilqr_torch::lm_step``, ``csrc/lm.cu``
``lm_lanes_kernel`` + ``lm_step_kernel``).

The hybrid loop on a ``MapSampler`` brings its own step (``HybridStep``),
which ``solver.step`` runs in place of ``solver.lm_step``.  Here, on the
CPU, on float64 per-scenario maps built as the Monte-Carlo path builds them
(one frame for every scenario) and as the full stack does (each scenario's
own frame at its pose), with a done mask that mixes running and stopped
lanes: the step's plain version, the op's CPU implementation and the
loop through ``solver.step`` equal ``lm_step`` on the plain hybrid
iteration bit for bit; stopped lanes keep every state tensor; the list
pass's plain version is ``torch.nonzero(~done)`` in lane order; the
wrapper refuses what the kernel cannot take; a bare sampler still runs
``lm_step`` eagerly; the lane total counts ``it.sum()`` over a solve.  The
``cuda`` tests hold the kernel to its plain version and to K3's step on the
card, on the Monte-Carlo and full-stack stages' own maps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cilqr_tpu_torch.models import solver, solver_batched
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.models.reference_path import get_local_plan
from cilqr_tpu_torch.ops import gridmap, lm_cuda, riccati_cuda
from cilqr_tpu_torch.parallel import monte_carlo as mc
from cilqr_tpu_torch.sim.example_scenario import example_scenario
from cilqr_tpu_torch.utils import graphs, profiling
from cilqr_tpu_torch.utils.params import SolverParams
from tests.test_torch_graph_loops import PlannedEagerly, planned_captures  # noqa: F401

DEV = "cpu"  # the port allocates on the card unless told otherwise
KINDS = ("mc", "fs")
STATE = ("X", "U", "lamb", "J_old", "it", "done")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs (six test workers share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def maps_like(kind: str, values: torch.Tensor, egos: torch.Tensor, unc) -> unc_mod.UncertaintyMap:
    """One map per scenario over the example map's vehicle-frame geometry:
    "mc" as ``monte_carlo`` builds them (one frame for every scenario, the
    leaves broadcast), "fs" as the full stack does (each scenario's frame
    at its own pose)."""
    if kind == "mc":
        return mc.per_scenario_map(values, unc.geom, unc.origin_xy, unc.origin_yaw)
    B = values.shape[0]
    geom = gridmap.GridGeom(*(t.expand((B,) + tuple(t.shape)) for t in unc.geom))
    shift = torch.linspace(-0.4, 0.4, B, dtype=egos.dtype, device=egos.device)
    return unc_mod.UncertaintyMap(values, geom, egos[:, :2] - shift[:, None],
                                  egos[:, 3] + 0.1 * shift)


def world(kind: str, dtype=torch.float64, B: int = 6, seed: int = 3, horizon: int = 12):
    """(p, plans, egos, U, obstacles, sampler) on the example world, B egos
    ``ego + N(0, 0.3)`` and one random map per scenario (``maps_like``)."""
    p = dataclasses.replace(SolverParams(), horizon=horizon)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, dtype, device=DEV)
    rng = np.random.default_rng(seed)
    egos = torch.tensor(ego.numpy()[None, :] + rng.normal(0, 0.3, (B, 4)), dtype=dtype)
    H, W = unc.values.shape
    values = torch.tensor(rng.uniform(0.0, 100.0, (B, H, W)), dtype=dtype)
    U = U0.expand(B, p.horizon, 2).contiguous()
    sampler = lm_cuda.MapSampler(p, maps_like(kind, values, egos, unc))
    return p, get_local_plan(p, plan, n, egos), egos, U, obstacles, sampler


def bare(p, plans, obstacles, sampler, step=lm_cuda.fused_iteration_plain):
    """The hybrid iteration on a bare sampler: ``solver.lm_step`` runs it."""
    return lm_cuda.hybrid_iteration(p, plans, obstacles, lambda Xb: sampler(Xb), step)


def mixed_state(p, plans, egos, U, obstacles, sampler, stopped=(1, 3)) -> tuple:
    """The state after two plain steps, with the lanes ``stopped`` marked
    done (their lamb, J_old and it differ from the running lanes')."""
    it = bare(p, plans, obstacles, sampler)
    lamb_inv = solver.damping_inverse(p, egos.dtype, egos.device)
    state = solver.start_state(p, egos, U)
    for _ in range(2):
        state = solver.lm_step(p, it, lamb_inv, *state)
    done = torch.zeros_like(state[-1])
    done[list(stopped)] = True
    return state[:-1] + (done,)


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def op_args(p, plans, obstacles, sampler, G: int = 1) -> tuple:
    """The step op's arguments before the state, for CPU tensors."""
    world_ = lm_cuda.prep_world(p, obstacles, None, torch.float32, device=DEV)
    prep = lm_cuda.prep_iteration(plans)
    m = sampler.unc_map
    return (riccati_cuda.params_arg(p), prep.fit, prep.table, m.values,
            lm_cuda.prep_lane_maps(m), world_.obs, world_.has_obs, G, list(plans),
            list(obstacles), lm_cuda._unc_map_args(m))


def run_route(route_: str, p, plans, obstacles, sampler, state) -> tuple:
    """One step of the hybrid loop on the CPU by ``route_``: ``fused_step``,
    the described iteration's own step through ``solver.step``, or the op
    (in place, on clones)."""
    lamb_inv = solver.damping_inverse(p, state[0].dtype, state[0].device)
    if route_ == "fused_step":
        world_ = lm_cuda.prep_world(p, obstacles, None, torch.float32, device=DEV)
        return lm_cuda.fused_step(p, world_, plans, sampler, None, lamb_inv, *state)
    if route_ == "solver_step":
        it = lm_cuda.hybrid_iteration(p, plans, obstacles, sampler, lm_cuda.fused_iteration)
        built = it.build(p, plans, *it.world)
        assert isinstance(built, lm_cuda.HybridStep)
        return solver.step(p, built, lamb_inv, *state)
    out = tuple(t.clone() for t in state)
    total = torch.zeros(1, dtype=torch.int64)
    torch.ops.cilqr_torch.lm_step(*op_args(p, plans, obstacles, sampler), *out, total)
    assert int(total) == int((~state[-1]).sum())
    return out


@pytest.mark.parametrize("route_", ["fused_step", "solver_step", "op"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_step_is_lm_step_on_the_plain_hybrid_iteration(kind, route_):
    """The step's plain version by each route equals ``lm_step`` on the
    hybrid iteration of ``fused_iteration_plain`` and the sampler, bit for
    bit, on a mixed done mask (float64)."""
    p, plans, egos, U, obstacles, sampler = world(kind)
    state = mixed_state(p, plans, egos, U, obstacles, sampler)
    want = solver.lm_step(p, bare(p, plans, obstacles, sampler),
                          solver.damping_inverse(p, egos.dtype, egos.device), *state)
    got = run_route(route_, p, plans, obstacles, sampler, state)
    assert same(got, want)
    assert not same(want[:1], state[:1])  # the running lanes moved


@pytest.mark.parametrize("route_", ["fused_step", "op"])
@pytest.mark.parametrize("kind", KINDS)
def test_stopped_lanes_keep_their_state(kind, route_):
    """A lane marked done keeps X, U, lamb, J_old, it and done bit for bit;
    with every lane stopped nothing changes."""
    p, plans, egos, U, obstacles, sampler = world(kind)
    state = mixed_state(p, plans, egos, U, obstacles, sampler, stopped=(0, 2, 5))
    got = run_route(route_, p, plans, obstacles, sampler, state)
    stopped = state[-1]
    for name, a, b in zip(STATE, got, state):
        assert torch.equal(a[stopped], b[stopped]), name
    assert bool(got[-1][stopped].all())
    everything = state[:-1] + (torch.ones_like(stopped),)
    assert same(run_route(route_, p, plans, obstacles, sampler, everything), everything)


def masks(B: int) -> dict:
    rng = np.random.default_rng(B)
    one = torch.ones(B, dtype=torch.bool)
    one[B // 2] = False
    return {"none": torch.zeros(B, dtype=torch.bool), "all": torch.ones(B, dtype=torch.bool),
            "one": one, "random": torch.tensor(rng.uniform(size=B) < 0.5)}


@pytest.mark.parametrize("mask", ["none", "all", "one", "random"])
@pytest.mark.parametrize("B", [1, 7, 1025, 8192])
def test_list_pass_plain_is_nonzero_in_lane_order(B, mask):
    """``running_lanes`` on the CPU (the list pass's plain version): the
    first ``count`` entries are ``torch.nonzero(~done)`` in lane order, the
    rest -1."""
    done = masks(B)[mask]
    lanes, count = lm_cuda.running_lanes(done)
    want = torch.nonzero(~done).reshape(-1)
    n = int(count)
    assert lanes.dtype == count.dtype == torch.int32 and tuple(count.shape) == (1,)
    assert n == want.numel() and torch.equal(lanes[:n].long(), want)
    assert bool((lanes[n:] == -1).all())


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguous", "device"])
def test_state_checks_refuse(case):
    """``_check_mask``, which the launch function runs on every tensor the
    kernel reads or writes in place: a wrong shape, dtype, layout or device
    raises."""
    t = torch.zeros((4, 3), dtype=torch.float32)
    args = {"shape": (t, (4, 4), torch.float32, t.device),
            "dtype": (t, (4, 3), torch.float64, t.device),
            "contiguous": (t.t(), (3, 4), torch.float32, t.device),
            "device": (t, (4, 3), torch.float32, torch.device("meta"))}[case]
    with pytest.raises((ValueError, TypeError)):
        lm_cuda._check_mask("t", *args)
    lm_cuda._check_mask("t", t, (4, 3), torch.float32, t.device)


@pytest.mark.parametrize("case", ["cpu_state", "other_plans", "no_prep", "group_size"])
def test_launch_refuses(case):
    """The launch function refuses CPU tensors (the kernel runs on the
    card), a world prepared from other plans or not prepared, and a group
    size the kernels are not built for."""
    p, plans, egos, U, obstacles, sampler = world("mc", torch.float32)
    state = solver.start_state(p, egos, U)
    world_ = lm_cuda.prep_world(p, obstacles, None, torch.float32, device=DEV)
    prep = lm_cuda.prep_iteration(plans)
    kw = {}
    if case == "other_plans":
        prep = prep._replace(plans=get_local_plan(p, *example_scenario(p, device=DEV)[:2], egos))
    if case == "group_size":
        kw["G"] = 4
    if case != "no_prep":
        world_ = world_._replace(iteration=prep)
    geo = lm_cuda.prep_lane_maps(sampler.unc_map)
    lamb_inv = solver.damping_inverse(p, egos.dtype, egos.device)
    match = {"cpu_state": "expected a CUDA tensor", "other_plans": "prep_iteration",
             "no_prep": "prep_iteration", "group_size": "lanes per scenario"}[case]
    with pytest.raises(ValueError, match=match):
        lm_cuda._launch_step(p, world_, plans, sampler, geo, lamb_inv, *state, **kw)


def test_a_bare_sampler_runs_lm_step_eagerly(monkeypatch):
    """A bare sampler gives the bare iteration: no step of its own, so
    ``solver.step`` runs ``lm_step`` on it, once per iteration, with the
    bits of the described iteration's own step (a ``HybridStep``)."""
    p, plans, egos, U, obstacles, sampler = world("fs", torch.float32)
    it = bare(p, plans, obstacles, sampler, lm_cuda.fused_iteration)
    assert callable(it) and getattr(it, "lm_step", None) is None
    calls = []
    real = solver.lm_step
    monkeypatch.setattr(solver, "lm_step", lambda *a: calls.append(1) or real(*a))
    got = solver.optimize(p, plans, egos, U, iteration=it)
    assert len(calls) == int(got[2].max()) > 1
    described = lm_cuda.hybrid_iteration(p, plans, obstacles, sampler, lm_cuda.fused_iteration)
    assert isinstance(described.build(p, plans, *described.world), lm_cuda.HybridStep)
    assert same(solver.optimize(p, plans, egos, U, iteration=described), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_path_with_the_own_step_gives_the_eager_bits(dtype, planned_captures):  # noqa: F811
    """``fused_optimize`` with a ``MapSampler``: its loop's graph path
    (``solver._optimize_graphed``, captures replaced by planned eager
    replays) equals the eager loop and the loop on the plain iteration, on
    every lane; the iteration the capture builds is the ``HybridStep``."""
    p, plans, egos, U, obstacles, sampler = world("fs", dtype)
    it = lm_cuda.hybrid_iteration(p, plans, obstacles, sampler, lm_cuda.fused_iteration)
    assert isinstance(it.build(p, plans, *it.world), lm_cuda.HybridStep)
    got = solver._optimize_graphed(p, plans, egos, U, iteration=it)
    assert same(got, solver.optimize(p, plans, egos, U, iteration=it))
    assert same(got, solver.optimize(p, plans, egos, U,
                                     iteration=bare(p, plans, obstacles, sampler)))
    assert same(got, lm_cuda.fused_optimize(p, plans, egos, U, obstacles, unc_sampler=sampler))
    start, *steps = PlannedEagerly.planners
    assert len(steps) == int(got[2].max()) > 1


@pytest.mark.parametrize("kind", KINDS)
def test_lane_total_counts_the_iterations(kind):
    """The op run until every lane has stopped: its total is ``it.sum()``,
    the lane-steps run, and the state is the plain loop's."""
    p, plans, egos, U, obstacles, sampler = world(kind)
    state = tuple(t.clone() for t in solver.start_state(p, egos, U))
    total = torch.zeros(1, dtype=torch.int64)
    args = op_args(p, plans, obstacles, sampler)
    for _ in range(p.max_iterations):
        if bool(state[-1].all()):
            break
        torch.ops.cilqr_torch.lm_step(*args, *state, total)
    X, U_, lamb, J, it, _ = state
    assert int(total) == int(it.sum()) > 0
    want = solver.optimize(p, plans, egos, U, iteration=bare(p, plans, obstacles, sampler))
    assert same((X, U_, it, J, lamb), want)


def test_op_is_planned_as_one_op_that_writes_the_state():
    """Under a stream planner the step op is one planned op that reads its
    payloads and the plans' fields and writes the six state tensors and
    the lane total in place, and nothing else."""
    p, plans, egos, U, obstacles, sampler = world("mc")
    state = mixed_state(p, plans, egos, U, obstacles, sampler)
    total = torch.zeros(1, dtype=torch.int64)
    args = op_args(p, plans, obstacles, sampler)
    planner = graphs.StreamPlanner(2)
    with planner:
        torch.ops.cilqr_torch.lm_step(*args, *state, total)
    (op,) = [o for o in planner.ops if o.name == "lm_step.default"]
    key = planner._key
    assert set(op.writes) == {key(t) for t in (*state, total)}
    for t in (args[1], args[2], args[3], args[4], args[5], *plans):
        assert key(t) in op.reads


def test_opcheck_lm_step():
    """``torch.library.opcheck`` on the step op (N=8, B=3): its schema
    (the state written in place, nothing else) and its fake."""
    p, plans, egos, U, obstacles, sampler = world("fs", torch.float32, B=3, horizon=8)
    state = tuple(t.clone() for t in mixed_state(p, plans, egos, U, obstacles, sampler,
                                                 stopped=(1,)))
    torch.library.opcheck(torch.ops.cilqr_torch.lm_step.default,
                          (*op_args(p, plans, obstacles, sampler), *state,
                           torch.zeros(1, dtype=torch.int64)),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_lane_map_rows_carry_the_plain_samplers_bits(kind, dtype):
    """The geometry rows (``prep_lane_maps``) reproduce what
    ``uncertainty_sample_batched`` computes from the map: the map-frame
    coordinates of every state, the continuous cell index and the
    ``inside`` mask, bit for bit."""
    p, plans, egos, U, obstacles, sampler = world(kind, dtype)
    m = sampler.unc_map
    X = solver.start_state(p, egos, U)[0][:, :p.horizon]
    geo = lm_cuda.prep_lane_maps(m)
    B = X.shape[0]
    assert tuple(geo.shape) == (B, 16) and geo.is_contiguous() and geo.dtype == dtype
    col = lambda i: geo[:, i, None]
    cy, sy = torch.cos(m.origin_yaw).reshape(B, 1), torch.sin(m.origin_yaw).reshape(B, 1)
    local = unc_mod._to_map_frame(m, X, cy, sy)
    d0, d1 = X[..., 0] - col(0), X[..., 1] - col(1)
    assert torch.equal(col(2) * d0 + col(3) * d1, local[..., 0])
    assert torch.equal(-col(3) * d0 + col(2) * d1, local[..., 1])
    res = m.geom.resolution.reshape(B, 1)
    first = m.geom.center + 0.5 * m.geom.length - 0.5 * res
    ci = (first[:, None, :] - local) / res[:, :, None]
    assert torch.equal((col(4) - local[..., 0]) / col(6), ci[..., 0])
    assert torch.equal((col(5) - local[..., 1]) / col(6), ci[..., 1])
    lo = m.geom.center - 0.5 * m.geom.length
    hi = m.geom.center + 0.5 * m.geom.length
    inside = ((local >= lo[:, None, :]) & (local <= hi[:, None, :])).all(dim=-1)
    got = ((local[..., 0] >= col(7)) & (local[..., 0] <= col(8)) & (local[..., 1] >= col(9))
           & (local[..., 1] <= col(10)))
    assert torch.equal(got, inside) and bool(inside.any())
    assert torch.equal(geo[:, 11], (-1.0 / res)[:, 0]) and not bool(geo[:, 12:].any())
    i0, j0, _, _ = gridmap._corner_index(ci[..., 0], ci[..., 1], *m.values.shape[1:])
    assert torch.equal(lm_cuda.lane_cells_plain(m, X), i0 * m.values.shape[2] + j0)


def test_counters_are_entered_and_read_only_while_tracing(monkeypatch):
    """The step's launch counters are launch counters (``graphs.COUNTERS``),
    ``LANES_RUN`` a host counter that ``profiling.counters()`` reports, and
    its reader runs in ``profiling.device_counters()`` only while tracing;
    a warm-up (``graphs.building`` outside a capture) is ``warming_up``."""
    entered = {(m.__name__.rsplit(".", 1)[-1], n) for m, n in graphs.COUNTERS}
    assert {("lm_cuda", "LANE_LAUNCHES"), ("lm_cuda", "STEP_LAUNCHES")} <= entered
    assert (lm_cuda, "LANES_RUN") in [(m, n) for m, n in profiling.HOST_COUNTERS]
    assert (lm_cuda._LANES.start, lm_cuda._LANES.read) in profiling.DEVICE_COUNTERS
    calls = []
    monkeypatch.setattr(profiling, "DEVICE_COUNTERS", [
        (lambda: calls.append("start"), lambda: calls.append("read")),
        (lm_cuda._LANES.start, lm_cuda._LANES.read)])
    profiling.device_counters()
    assert not calls
    total = torch.tensor([7])
    monkeypatch.setattr(lm_cuda._LANES, "totals", {torch.device("cpu"): total})
    monkeypatch.setattr(lm_cuda._LANES, "read_at", {torch.device("cpu"): 3})
    monkeypatch.setattr(lm_cuda, "LANES_RUN", 0)
    with profiling.tracing():
        with profiling.span("entry.test"):  # untraced counts dropped as the call begins
            assert int(total) == 0 and calls == ["start"]
            total.add_(5)  # what the call's list passes count
            profiling.device_counters()
        assert calls == ["start", "read"] and profiling.counters()["lm_cuda.LANES_RUN"] == 5
    assert not graphs.warming_up()
    with graphs.building():
        assert graphs.warming_up()


def test_the_step_kernel_launches_only_inside_its_op():
    """By the source: the step kernel's entry point (``lib.cilqr_lm_step``)
    is called once, in the op's CUDA implementation, as is the list pass's
    (``lib.cilqr_lm_lanes``; also in ``running_lanes``, the list pass alone
    for the card's checks); the op is called from the launch function alone,
    the launch function from ``fused_step`` alone (and the card's
    comparisons in ``chip_smoke.py``), and no other file of the port names
    them."""
    from tests.test_torch_graph_loops import PORT, calls_by_function

    lm = calls_by_function(PORT / "ops" / "lm_cuda.py")
    assert lm["lib.cilqr_lm_step"] == ["_lm_step_kernel"]
    assert sorted(lm["lib.cilqr_lm_lanes"]) == ["_lm_step_kernel", "running_lanes"]
    assert lm["torch.ops.cilqr_torch.lm_step"] == ["_launch_step"]
    assert lm["_launch_step"] == ["fused_step"]
    assert lm["fused_step"] == ["lm_step"]
    for f in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]:
        if f.name in ("lm_cuda.py", "chip_smoke.py"):
            continue
        text = f.read_text()
        for name in ("_lm_step_kernel", "cilqr_lm_step(", "cilqr_lm_lanes(", "_launch_step"):
            assert name not in text, (f, name)
    op = torch.ops.cilqr_torch.lm_step.default
    written = [a.name for a in op._schema.arguments if a.alias_info is not None]
    assert written == list(STATE) + ["total"]
    assert all(a.alias_info.is_write for a in op._schema.arguments if a.alias_info is not None)


# ---------------------------------------------------------------- on the card
def card_world(kind: str, B: int, dev: torch.device) -> tuple:
    """(p, plans, egos, U, obstacles, sampler) of the stages' own maps at
    N=40: "mc" as ``monte_carlo(impl="fast")`` makes them (K4 on the 152x104
    prior under sampled sigmas, one frame), "fs" as the full stack's second
    cycle makes them (K5 and K4 at each vehicle's pose, warm-started), the
    second cycle's solve inputs taken through ``plan_step_batched``."""
    from cilqr_tpu_torch import CostmapParams, NoiseParams
    from cilqr_tpu_torch.ops import costmap as costmap_mod
    from cilqr_tpu_torch.ops import uncertainty_cuda
    from cilqr_tpu_torch.sim import plant

    p = SolverParams()
    plan, n, ego, U0, obstacles, _ = example_scenario(p, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if kind == "mc":
        sigma_hi = (0.16, 0.16, 0.017)
        cp = CostmapParams()
        center = (cp.x_position, cp.y_position)
        cp = mc.ensure_window_covers(cp, cp.rows, cp.cols, center, sigma_hi)
        band = uncertainty_cuda.make_band_plan(cp, cp.rows, cp.cols, center, sigma_hi)
        prior = torch.tensor(np.random.default_rng(4).uniform(0, 100, (cp.rows, cp.cols)), **f32)
        geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols, torch.float32, dev)
        s = mc.sample_scenarios(torch.Generator().manual_seed(0), B, ego.cpu(), sigma_hi=sigma_hi,
                                device=dev)
        maps = uncertainty_cuda.propagate_uncertainty_banded(cp, prior, geom, ego[3], s.sigmas,
                                                             band)
        umaps = mc.per_scenario_map(maps, geom, ego[:2], ego[3])
        U = U0.expand(B, p.horizon, 2).contiguous()
        return p, get_local_plan(p, plan, n, s.egos), s.egos, U, obstacles, \
            lm_cuda.MapSampler(p, umaps)
    cpf = CostmapParams()
    ggeom = gridmap.make_geom([110.0, -300.0], 0.5, 256, 256, torch.float32, dev)
    gmap = torch.tensor(np.random.default_rng(8).uniform(0, 100, (256, 256)), **f32)
    xr, yr = costmap_mod.corridor_center_bounds(cpf, plan, n)
    band = uncertainty_cuda.make_band_plan_bounds(cpf, cpf.rows, cpf.cols, xr, yr,
                                                  (cpf.sigma_x, cpf.sigma_y, cpf.sigma_theta))
    x0s = torch.tensor(ego.cpu().numpy()[None, :]
                       + np.random.default_rng(9).normal(0, 0.3, (B, 4)), **f32)
    draws = torch.randn((2, B, 3), generator=torch.Generator(device=dev).manual_seed(12), **f32)
    seen = []

    def hook(noisy, U_warm, umaps):
        seen.append((noisy.clone(), U_warm.clone(), unc_mod.UncertaintyMap(
            umaps.values.clone(), gridmap.GridGeom(*(t.clone() for t in umaps.geom)),
            umaps.origin_xy.clone(), umaps.origin_yaw.clone())))
        return solver_batched.run_steps_batched(p, plan, n, noisy, U_warm.contiguous(),
                                                obstacles, umaps, world_batched=True)

    plant.closed_loop_full_stack_batched(
        p, cpf, NoiseParams(), gmap, ggeom, plan, n, x0s, None, 2, obstacles=obstacles,
        obs_xyyaw=torch.tensor([[115.0, -305.0, 0.0], [130.0, -304.0, 0.2]], **f32),
        obs_size=torch.tensor([3.63, 1.84], **f32), obs_mask=torch.ones(2, **f32),
        band_plan=band, global_res=0.5, noise_draws=draws, plan_step_batched=hook)
    egos, U, umaps = seen[1]
    return p, get_local_plan(p, plan, n, egos), egos, U, obstacles, lm_cuda.MapSampler(p, umaps)


def k3_loop(p, plans, egos, U, obstacles, sampler):
    """The loop before the step kernel: ``lm_step`` around K3 and the
    sampler in PyTorch (the bare route), eagerly."""
    return solver.optimize(p, plans, egos, U,
                           iteration=bare(p, plans, obstacles, sampler, lm_cuda.fused_iteration))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("B", [8192, 10])
@pytest.mark.parametrize("kind", KINDS)
def test_step_kernel_against_its_plain_version_on_the_card(kind, B, monkeypatch):
    """On the MC and FS stages' own maps: the in-kernel sample equals
    ``MapSampler`` (widest |difference| 0, no cell index differs); the
    solve on the step kernel, graphed, equals its eager solve and the
    loop around K3 (the same arithmetic, bit for bit) and holds per lane
    to the plain version (inside ``route.plain()``) at K3's bars
    (``chip_smoke.check_lanes``: calm lanes' counts equal, chaotic lanes
    within their spread + 2); ``LANES_RUN`` over the traced solve is
    ``it.sum()``."""
    import chip_smoke as cs
    from cilqr_tpu_torch.ops import route

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    p, plans, egos, U, obstacles, sampler = card_world(kind, B, dev)
    X = solver.start_state(p, egos, U)[0]
    planes, cells = lm_cuda.lane_sample(p, sampler.unc_map, X)
    assert torch.equal(planes, sampler(X[:, :p.horizon]))
    assert torch.equal(cells.long(), lm_cuda.lane_cells_plain(sampler.unc_map, X[:, :p.horizon]))
    before = lm_cuda.LANES_RUN
    with profiling.tracing():
        with profiling.span("entry.test"):
            got = lm_cuda.fused_optimize(p, plans, egos, U, obstacles, unc_sampler=sampler)
    assert lm_cuda.LANES_RUN - before == int(got[2].sum())
    monkeypatch.setattr(solver, "GRAPHS", False)
    assert same(got, lm_cuda.fused_optimize(p, plans, egos, U, obstacles, unc_sampler=sampler))
    assert same(got, k3_loop(p, plans, egos, U, obstacles, sampler))
    L = min(B, 256)  # the first L lanes, against the plain version on those lanes alone
    m = sampler.unc_map
    tile = lambda t, k, dtype: t[:L].repeat((k,) + (1,) * (t.ndim - 1)).to(dtype)

    def plain(e, dtype=torch.float32):
        k = e.shape[0] // L
        leaf = lambda t: tile(t, k, dtype)
        plan, n, _, _, obs, _ = example_scenario(p, dtype, device=dev)
        sub_map = unc_mod.UncertaintyMap(leaf(m.values), gridmap.GridGeom(*map(leaf, m.geom)),
                                         leaf(m.origin_xy), leaf(m.origin_yaw))
        return lm_cuda.fused_optimize_plain(p, get_local_plan(p, plan, n, e), e, leaf(U), obs,
                                            unc_sampler=lm_cuda.MapSampler(p, sub_map))

    with route.plain():
        want32 = plain(egos[:L])
        want64 = plain(egos[:L].double(), torch.float64)
        nudged = cs.nudged_results(plain, egos[:L], 2)
    cs.check_lanes(f"step kernel {kind} B={B}", tuple(t[:L] for t in got), want32, want64, nudged,
                   chaotic_it_off=2, by_spread=True,
                   calm_it_off=cs.FS_CALM_IT_OFF if kind == "fs" else None)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("kind", KINDS)
def test_step_kernel_keeps_stopped_lanes_and_replays_two_kernels(kind, monkeypatch):
    """On the card: one kernel step on a mixed done mask keeps every
    stopped lane's state bit for bit and equals ``lm_step`` around K3 on
    the running ones; a step with every lane stopped changes nothing; the
    list pass equals its plain version; the loop's step graph holds two
    kernel nodes and nothing else (libcuda), and one replay of it under the
    profiler runs the list pass and the step kernel, no
    ``uncertainty_sample_batched`` range and no other kernel."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    p, plans, egos, U, obstacles, sampler = card_world(kind, 1024, dev)
    it = lm_cuda.hybrid_iteration(p, plans, obstacles, sampler, lm_cuda.fused_iteration)
    own = it.build(p, plans, *it.world)
    lamb_inv = solver.damping_inverse(p, torch.float32, dev)
    k3 = bare(p, plans, obstacles, sampler, lm_cuda.fused_iteration)
    state = solver.start_state(p, egos, U)
    for _ in range(3):
        state = solver.lm_step(p, k3, lamb_inv, *state)
    done = state[-1] | (torch.arange(egos.shape[0], device=dev) % 3 == 0)
    state = state[:-1] + (done,)
    for mask in (done, torch.ones_like(done)):
        # the kernel takes the dense state its loop makes (``solver.start_state``)
        start = tuple(t.clone(memory_format=torch.contiguous_format) for t in state[:-1]) + (
            mask.clone(),)
        lanes, count = lm_cuda.running_lanes(mask)
        want_lanes, want_count = lm_cuda.running_lanes_plain(mask)
        assert torch.equal(count, want_count)
        assert torch.equal(lanes[:int(count)], want_lanes[:int(count)])
        got = solver.step(p, own, lamb_inv, *(t.clone() for t in start))
        for a, b in zip(got, start):
            assert torch.equal(a[mask], b[mask])
        assert same(got, solver.lm_step(p, k3, lamb_inv, *start))
    solver.CAPTURED.clear()  # the full stack's stages that made the maps
    solver.optimize(p, plans, egos, U, iteration=it)
    (entry,) = solver.CAPTURED.values()
    step_graph = entry.graphs[1]
    assert cs.captured_nodes(step_graph) == (2, 2)  # (nodes, kernel nodes), by libcuda
    step_graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    kinds = sorted(next((k for k in ("lm_lanes_kernel", "lm_step_kernel") if k in n), n)
                   for n in names)
    assert kinds == ["lm_lanes_kernel", "lm_step_kernel"], names
    assert not any("uncertainty_sample_batched" in e.name for e in prof.events())
    assert step_graph.launches[[n for _, n in graphs.COUNTERS].index("STEP_LAUNCHES")] == 1
