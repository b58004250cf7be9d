"""K1, K4 and K5 as ``torch.library`` ops, and the stages around the LM
loops as CUDA graphs (``solver.run``, ``solver.solve``).

K1, K4 and K5 are the ops ``cilqr_torch::lm_opt``, ``cilqr_torch::propagate``
and ``cilqr_torch::sample``; their CPU implementations are the plain
versions.  Here, on the CPU: ``torch.library.opcheck`` on each op at small
sizes; each op equal, bit for bit, to the plain function it wraps; the ops
found by a recording dispatch mode in the paths that launch them; every
stage that the card captures (the mega solve, the closed loops' cycles,
the full stack's and the Monte-Carlo path's starts) running without a copy
from the host or a read of a tensor's value on the host, which a capture
cannot hold; and the graph paths, with the capture replaced by eager
replays under a four-stream planner, equal to ``solver.GRAPHS = False`` on
every record, a second call on new inputs replaying without a capture.
The ``cuda`` tests hold the graphed calls to the eager ones on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from cilqr_tpu_torch.models import solver, solver_batched
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.models.obstacles import make_static_obstacles
from cilqr_tpu_torch.models.reference_path import get_local_plan, pad_global_plan
from cilqr_tpu_torch.ops import costmap, gridmap, lm_cuda, route, sample_cuda, uncertainty_cuda
from cilqr_tpu_torch.parallel import monte_carlo as mc
from cilqr_tpu_torch.sim import perception, plant
from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import CostmapParams, NoiseParams, SolverParams
from tests.test_torch_graph_loops import PORT, calls_by_function

DEV = "cpu"  # the port allocates on the card unless told otherwise
DTYPES = (torch.float32, torch.float64)
aten = torch.ops.aten
# what a capture cannot hold: a tensor made from host values (copied to the
# card) and a tensor's value read on the host (a wait for the card)
HOST_OPS = {aten.lift_fresh, aten._local_scalar_dense, aten.nonzero, aten.masked_select,
            aten.is_nonzero, aten.item}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs (six test workers share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=DEV)


def world(dtype, B: int, seed: int, rows: int = 64, cols: int = 48) -> dict:
    """A small world: N=10, a (rows x cols) costmap, a 40x40 global map at
    1 m, one obstacle the barrier, the rasterization and the SAT check
    see, a 16x12 uncertainty map and B egos around the start."""
    p = dataclasses.replace(SolverParams(), horizon=10, max_iterations=4, num_of_local_wpts=8,
                            closest_point_samples_per_wpt=5)
    cp = dataclasses.replace(CostmapParams(), rows=rows, cols=cols, window_radius=3,
                             look_ahead_waypoints=10)
    rng = np.random.default_rng(seed)
    gm = np.zeros((40, 40))
    gm[10:30, 12:20] = rng.uniform(20.0, 100.0, (20, 8))
    s = np.linspace(0.0, 119.0, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s], axis=1)
    plan, n = pad_global_plan(p, plan_np, dtype=dtype, device=DEV)
    obs_xyyaw = np.array([[103.0, -305.5, 0.05]])
    obs_size = np.array([[4.5, 2.0]])
    obstacles = make_static_obstacles(p, obs_xyyaw[:, :2], obs_size, obs_xyyaw[:, 2],
                                      dtype=dtype, device=DEV)
    unc = unc_mod.make_uncertainty_map(rng.uniform(0.0, 100.0, (16, 12)), [3.0, 0.0], 0.5,
                                       [100.0, -305.6], 0.05, dtype=dtype, device=DEV)
    egos = t(np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.2, (B, 4)), dtype)
    U = solver.initial_controls(p, dtype=dtype, device=DEV).expand(B, p.horizon, 2).contiguous()
    return dict(p=p, cp=cp, gm=t(gm, dtype),
                gg=gridmap.make_geom([110.0, -300.0], 1.0, 40, 40, dtype=dtype, device=DEV),
                plan=plan, n=n, obstacles=obstacles, unc=unc, egos=egos, U=U,
                obs=(t(obs_xyyaw, dtype), t(obs_size, dtype), torch.ones(1, dtype=dtype)))


def lm_opt_args(w: dict, obstacles: bool = True, unc: bool = True) -> tuple:
    """K1's op arguments on the world, as ``lm_cuda.opt_op`` makes them."""
    p = w["p"]
    plans = get_local_plan(p, w["plan"], w["n"], w["egos"])
    ob, um = w["obstacles"] if obstacles else None, w["unc"] if unc else None
    prep = lm_cuda.prep_world(p, ob, um, torch.float32, DEV)
    args = (lm_cuda.riccati_cuda.params_arg(p), lm_cuda._fit_payload(plans).t().contiguous(),
            w["egos"], w["U"], prep.obs, prep.values, prep.scl, prep.has_obs, prep.has_unc, 1, 1,
            list(plans), [] if ob is None else list(ob), lm_cuda._unc_map_args(um))
    return args, (p, plans, w["egos"], w["U"], ob, um)


def frames(w: dict, B: int):
    """B vehicle frames (geometry, positions, yaws) on the global map and a
    bbox / semantic override pair of 16x12 frames with values around 90."""
    rng = np.random.default_rng(5)
    dtype = w["gm"].dtype
    centers = t(rng.uniform(-4.0, 4.0, (B, 2)), dtype)
    geoms = gridmap.GridGeom(centers, t(0.5, dtype).expand(B), t([8.0, 6.0], dtype).expand(B, 2))
    xys = t(np.array([110.0, -300.0]) + rng.uniform(-30.0, 30.0, (B, 2)), dtype)
    yaws = t(rng.uniform(-np.pi, np.pi, B), dtype)
    bbox = t(rng.choice([0.0, 90.0, 95.0, 100.0], (B, 16, 12)), dtype)
    semantic = t(rng.choice([0.0, 89.0, 91.0], (B, 16, 12)), dtype)
    return geoms, xys, yaws, bbox, semantic


def propagate_args(w: dict, B: int, fused: bool):
    """K4's op arguments on a 16x12 prior per scenario: fused (geometry, yaws,
    sigmas) or on the fields of ``prep_fields``."""
    dtype = w["gm"].dtype
    cp = dataclasses.replace(w["cp"], rows=16, cols=12)
    geoms, _, yaws, _, _ = frames(w, B)
    prior = t(np.random.default_rng(8).uniform(0.0, 100.0, (B, 16, 12)), dtype)
    sigmas = t(np.random.default_rng(9).uniform([0.02, 0.02, 0.005], [0.25, 0.25, 0.05], (B, 3)),
               dtype)
    plan = uncertainty_cuda.make_band_plan(cp, 16, 12, (0.0, 0.0), (0.25, 0.25, 0.05))
    config = uncertainty_cuda._config_arg(cp, plan.bands, plan.disc_radii)
    if fused:
        return (config, prior, [], list(geoms), yaws, sigmas, False, B), (
            cp, prior, geoms, yaws, sigmas, False, plan.bands, plan.disc_radii)
    fields = uncertainty_cuda.prep_fields(cp, geoms, yaws, sigmas, False, 16, 12, dtype)
    return (config, prior, list(fields), [], None, None, False, B), (
        cp, prior, fields, plan.bands, plan.disc_radii)


def same(a, b) -> bool:
    """Every tensor of two nests equal, bit for bit (and the nests alike)."""
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                            for x, y in zip(la, lb))


# ----------------------------------------------------------------- the ops
@pytest.mark.parametrize("case", ["world", "bare"])
def test_opcheck_lm_opt(case):
    """``torch.library.opcheck`` on K1's op: N=10, B=3, a 16x12 map (or no
    world at all)."""
    w = world(torch.float32, 3, seed=1)
    args, _ = lm_opt_args(w, obstacles=case == "world", unc=case == "world")
    torch.library.opcheck(torch.ops.cilqr_torch.lm_opt.default, args)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "fields"])
def test_opcheck_propagate(fused):
    """``torch.library.opcheck`` on K4's op, fused and on given fields: B=3,
    16x12 priors."""
    args, _ = propagate_args(world(torch.float32, 3, seed=2), 3, fused)
    torch.library.opcheck(torch.ops.cilqr_torch.propagate.default, args)


@pytest.mark.parametrize("overrides", [0, 1, 2], ids=["resample", "bbox", "bbox+semantic"])
def test_opcheck_sample(overrides):
    """``torch.library.opcheck`` on K5's op: B=3 frames of 16x12 cells on the
    40x40 map, alone and with the overrides."""
    w = world(torch.float32, 3, seed=3)
    geoms, xys, yaws, bbox, semantic = frames(w, 3)
    args = (list(geoms), 16, 12, w["gm"], list(w["gg"]), xys, yaws,
            bbox if overrides else None, semantic if overrides == 2 else None)
    torch.library.opcheck(torch.ops.cilqr_torch.sample.default, args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["world", "obstacles", "bare"])
def test_lm_opt_cpu_is_the_plain_version(dtype, case):
    """K1's op on the CPU equals ``fused_optimize_plain`` bit for bit, and so
    does ``fused_optimize``, which reaches it."""
    w = world(dtype, 3, seed=4)
    args, plain_args = lm_opt_args(w, obstacles=case != "bare", unc=case == "world")
    want = lm_cuda.fused_optimize_plain(*plain_args)
    assert same(torch.ops.cilqr_torch.lm_opt(*args), want)
    assert same(lm_cuda.fused_optimize(*plain_args), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "fields"])
def test_propagate_cpu_is_the_plain_version(dtype, fused):
    """K4's op on the CPU equals ``propagate_fused_plain`` /
    ``propagate_banded_plain`` bit for bit, and so do the entry points."""
    args, plain_args = propagate_args(world(dtype, 3, seed=5), 3, fused)
    if fused:
        want = uncertainty_cuda.propagate_fused_plain(*plain_args)
        cp, prior, geoms, yaws, sigmas, _, bands, disc = plain_args
        entry = uncertainty_cuda.propagate_uncertainty_banded(
            cp, prior, geoms, yaws, sigmas, uncertainty_cuda.BandPlan(bands, None, None, None,
                                                                      disc))
    else:
        want = uncertainty_cuda.propagate_banded_plain(*plain_args)
        entry = uncertainty_cuda.propagate_banded(*plain_args)
    assert want.dtype == dtype
    assert torch.equal(torch.ops.cilqr_torch.propagate(*args), want)
    assert torch.equal(entry, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("overrides", [0, 1, 2], ids=["resample", "bbox", "bbox+semantic"])
def test_sample_cpu_is_the_plain_version(dtype, overrides):
    """K5's op on the CPU equals ``sample_prior_batched_plain`` /
    ``vehicle_map_batched_plain`` bit for bit, and so do the entry points."""
    w = world(dtype, 3, seed=6)
    geoms, xys, yaws, bbox, semantic = frames(w, 3)
    bbox, semantic = (bbox if overrides else None), (semantic if overrides == 2 else None)
    got = torch.ops.cilqr_torch.sample(list(geoms), 16, 12, w["gm"], list(w["gg"]), xys, yaws,
                                       bbox, semantic)
    if overrides:
        want = sample_cuda.vehicle_map_batched_plain(geoms, 16, 12, w["gm"], w["gg"], xys, yaws,
                                                     bbox, semantic)
        entry = sample_cuda.vehicle_map_batched(geoms, 16, 12, w["gm"], w["gg"], xys, yaws, bbox,
                                                semantic)
    else:
        want = sample_cuda.sample_prior_batched_plain(geoms, 16, 12, w["gm"], w["gg"], xys, yaws)
        entry = sample_cuda.sample_prior_batched(geoms, 16, 12, w["gm"], w["gg"], xys, yaws)
    assert torch.equal(got, want) and torch.equal(entry, want)


class Recorder(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def test_the_paths_reach_the_ops_on_the_cpu():
    """A recording dispatch mode finds ``cilqr_torch::lm_opt`` once in the
    shared-world mega solve, and ``cilqr_torch::costmap_layers``,
    ``cilqr_torch::sample`` and ``cilqr_torch::propagate`` once each in the
    batched costmap build."""
    w = world(torch.float32, 3, seed=7)
    with Recorder() as rec:
        solver_batched.run_steps_batched(w["p"], w["plan"], w["n"], w["egos"], w["U"],
                                         w["obstacles"], w["unc"])
    assert rec.names.count("cilqr_torch::lm_opt") == 1
    with Recorder() as rec:
        obs_xyyaw, obs_size, obs_mask = w["obs"]
        costmap.build_local_costmap_batched(w["cp"], w["gm"], w["gg"], w["plan"], w["n"],
                                            w["egos"], obs_xyyaw[:, :2], obs_size,
                                            obs_xyyaw[:, 2], obs_mask, use_kernels=True)
    assert [n for n in rec.names if n.startswith("cilqr_torch::")] == [
        "cilqr_torch::costmap_layers", "cilqr_torch::sample", "cilqr_torch::propagate"]


def test_the_launch_functions_and_counters_are_entered():
    """Every kernel's launch counter is in ``graphs.COUNTERS`` (so a replay
    counts its kernels), and ``route.plain()`` blocks nest: the launch
    functions take their plain versions until the outermost block ends."""
    counters = {(m.__name__.rsplit(".", 1)[-1], n) for m, n in graphs.COUNTERS}
    assert counters >= {("lm_cuda", "LAUNCHES"), ("lm_cuda", "ITER_LAUNCHES"),
                        ("riccati_cuda", "LAUNCHES"), ("uncertainty_cuda", "LAUNCHES"),
                        ("sample_cuda", "LAUNCHES"), ("costmap_cuda", "LAUNCHES"),
                        ("cost_cuda", "LAUNCHES")}
    assert not route.plain_on_card()
    with route.plain():
        with route.plain():
            assert route.plain_on_card()
        assert route.plain_on_card()
    assert not route.plain_on_card()
    with pytest.raises(RuntimeError), route.plain():
        raise RuntimeError
    assert not route.plain_on_card()


def route_case(name: str) -> tuple:
    """One launch function on small float32 CPU inputs: (the function, its
    calls as [(arguments, the module and name of the plain version it
    runs inside ``route.plain()``, that version's arguments and keywords)])."""
    from cilqr_tpu_torch.models import costs, dynamics
    from cilqr_tpu_torch.ops import cost_cuda, costmap_cuda, riccati_cuda
    from tests.test_torch_costmap_cuda import planted_terms

    w = world(torch.float32, 3, seed=61)
    p, ob, B = w["p"], w["obstacles"], 3
    plans = get_local_plan(p, w["plan"], w["n"], w["egos"])
    X = dynamics.rollout(p, w["egos"], w["U"])
    lamb = torch.full((B,), p.lamb_init, device=DEV)
    planes = t(np.random.default_rng(62).uniform(-1.0, 1.0, (B, p.horizon, 3)), torch.float32)
    geoms, xys, yaws, bbox, semantic = frames(w, B)
    if name == "lm_cuda._launch":
        _, args = lm_opt_args(w)
        return lm_cuda._launch, [(args, lm_cuda, "fused_optimize_plain", args, {})]
    if name == "lm_cuda._launch_iteration":
        args = (p, lm_cuda.prep_world(p, ob, None, torch.float32, DEV), plans, X, w["U"], lamb,
                planes)
        return lm_cuda._launch_iteration, [(args, lm_cuda, "fused_iteration_plain", args, {})]
    if name == "riccati_cuda._launch":
        d, _ = costs.all_cost_derivs_and_J(p, plans, X, w["U"], ob, None)
        args = (p, d, X, w["U"], lamb)
        return riccati_cuda._launch, [(args + (True,), riccati_cuda, "backward_forward_plain",
                                       args, {}),
                                      (args + (False,), riccati_cuda, "backward_plain", args, {})]
    if name in ("uncertainty_cuda._launch", "uncertainty_cuda._launch_fused"):
        fused = name.endswith("fused")
        _, args = propagate_args(w, B, fused)
        plain = "propagate_fused_plain" if fused else "propagate_banded_plain"
        return getattr(uncertainty_cuda, name.split(".")[1]), [(args, uncertainty_cuda, plain,
                                                                args, {})]
    if name == "sample_cuda._launch":
        args = (geoms, 16, 12, w["gm"], w["gg"], xys, yaws)
        return sample_cuda._launch, [(args, sample_cuda, "sample_prior_batched_plain", args, {})]
    if name == "sample_cuda._launch_vehicle_map":
        args = (geoms, 16, 12, w["gm"], w["gg"], xys, yaws, bbox, semantic)
        return sample_cuda._launch_vehicle_map, [(args, sample_cuda, "vehicle_map_batched_plain",
                                                  args, {})]
    if name == "costmap_cuda._launch":
        args = planted_terms(B, 16, 12, 3, torch.float32, DEV, seed=63)
        return costmap_cuda._launch, [(args, costmap_cuda, "costmap_layers_plain", args, {})]
    if name == "lm_cuda._launch_step":
        sampler = lm_cuda.MapSampler(p, mc.per_scenario_map(
            t(np.random.default_rng(64).uniform(0.0, 100.0, (B, 16, 12)), torch.float32),
            w["unc"].geom, w["unc"].origin_xy, w["unc"].origin_yaw))
        world_ = lm_cuda.prep_world(p, ob, None, torch.float32, DEV)
        world_ = world_._replace(iteration=lm_cuda.prep_iteration(plans))
        state = solver.start_state(p, w["egos"], w["U"])
        lamb_inv = solver.damping_inverse(p, torch.float32, DEV)
        plain_args = (p, world_, plans, sampler, lamb_inv, *state)
        args = plain_args[:4] + (lm_cuda.prep_lane_maps(sampler.unc_map),) + plain_args[4:]
        return lm_cuda._launch_step, [(args, lm_cuda, "fused_step_plain", plain_args, {})]
    if name == "frenet_cuda._launch":
        from cilqr_tpu_torch.models import frenet
        from cilqr_tpu_torch.ops import frenet_cuda
        from tests.test_torch_frenet_kernel import case

        p_fr, fp, args = case("propagation", False, B=3)
        return frenet_cuda._launch, [((p_fr, fp) + tuple(args), frenet, "lattice_plain",
                                      (p_fr, fp) + tuple(args), {})]
    assert name == "cost_cuda._launch"
    prepared = tuple(lm_cuda.prep_iteration(plans))[:2]
    return cost_cuda._launch, [((p, plans, X, w["U"], ob, planes, prepared), costs,
                                "all_cost_derivs_and_J", (p, plans, X, w["U"], ob, None),
                                {"unc_planes": planes})]


ROUTE_CASES = ("lm_cuda._launch", "lm_cuda._launch_iteration", "riccati_cuda._launch",
               "uncertainty_cuda._launch", "uncertainty_cuda._launch_fused",
               "sample_cuda._launch", "sample_cuda._launch_vehicle_map",
               "costmap_cuda._launch", "cost_cuda._launch", "lm_cuda._launch_step",
               "frenet_cuda._launch")


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_the_route_sends_each_launch_function_to_its_plain_version(name, monkeypatch):
    """Inside ``route.plain()`` each of the eleven launch functions returns
    exactly what its plain version returns on the same inputs, calls it
    once itself and reaches no op of the port; outside, it takes the kernel's
    route (it refuses CPU tensors, or reaches its op, whose CPU
    implementation may run the plain version) and never calls the plain
    version itself."""
    import sys

    launch, calls = route_case(name)
    for args, module, plain_name, plain_args, plain_kw in calls:
        plain = getattr(module, plain_name)
        want = plain(*plain_args, **plain_kw)
        callers = []

        def spy(*a, **kw):
            callers.append(sys._getframe(1).f_code.co_name)
            return plain(*a, **kw)

        monkeypatch.setattr(module, plain_name, spy)
        with route.plain(), Recorder() as rec:
            got = launch(*args)
        assert same(got, want)
        assert callers == [launch.__name__]
        assert not [n for n in rec.names if n.startswith("cilqr_torch::")]
        callers.clear()
        refused = False
        with Recorder() as rec:
            try:
                launch(*args)
            except ValueError as e:
                assert "expected a CUDA tensor" in str(e)
                refused = True
        assert launch.__name__ not in callers
        assert refused or [n for n in rec.names if n.startswith("cilqr_torch::")]
        monkeypatch.setattr(module, plain_name, plain)


def test_k1_k4_k5_launch_only_inside_their_ops():
    """By the source: K1's, K4's and K5's entry points (``lib.cilqr_lm_opt``,
    ``lib.cilqr_propagate``, ``lib.cilqr_sample_prior``) are called in the
    CUDA implementations of their ops only (K4's through ``_run_kernel``,
    which those alone call), and each op from one function, which the
    wrappers' launch functions and CPU routes call; no other file of the
    port, nor ``chip_smoke.py``, calls an entry point or an op
    implementation."""
    lm = calls_by_function(PORT / "ops" / "lm_cuda.py")
    unc = calls_by_function(PORT / "ops" / "uncertainty_cuda.py")
    smp = calls_by_function(PORT / "ops" / "sample_cuda.py")
    assert lm["lib.cilqr_lm_opt"] == ["_lm_opt_kernel"]
    assert unc["lib.cilqr_propagate"] == ["_run_kernel"]
    assert sorted(unc["_run_kernel"]) == ["_propagate_kernel", "_propagate_kernel"]
    assert smp["lib.cilqr_sample_prior"] == ["_sample_kernel"]
    assert lm["torch.ops.cilqr_torch.lm_opt"] == ["opt_op"]
    assert sorted(lm["opt_op"]) == ["_launch", "fused_optimize"]
    assert unc["torch.ops.cilqr_torch.propagate"] == ["_op"]
    assert sorted(unc["_op"]) == ["_launch", "_launch_fused", "_propagate", "propagate_banded"]
    assert smp["torch.ops.cilqr_torch.sample"] == ["_op"]
    assert sorted(smp["_op"]) == ["_kernel_call", "sample_prior_batched", "vehicle_map_batched"]
    for f in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]:
        if f.name in ("lm_cuda.py", "uncertainty_cuda.py", "sample_cuda.py"):
            continue
        text = f.read_text()
        for name in ("_lm_opt_kernel", "_propagate_kernel", "_sample_kernel", "cilqr_lm_opt(",
                     "cilqr_propagate(", "cilqr_sample_prior("):
            assert name not in text, (f, name)


# ------------------------------------------------------- capture-safe stages
class HostFree(TorchDispatchMode):
    """Fails on an op that a CUDA graph capture cannot hold (``HOST_OPS``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_OPS:
            raise AssertionError(f"{func} inside a stage that the card captures")
        return func(*args, **(kwargs or {}))


def stages(w: dict, percept: bool):
    """The stages that the card captures, on the world: (name, stage)."""
    p, cp = w["p"], w["cp"]
    B = w["egos"].shape[0]
    dtype = w["egos"].dtype
    noise = NoiseParams(0.05, 0.04, 0.005)
    r = t(np.random.default_rng(11).normal(size=(B, 3)), dtype)
    obs3 = w["obs"]
    world_args = (w["egos"], w["U"], w["plan"], w["n"], w["obstacles"], w["unc"])
    sizes = obs3[1].expand(1, 2)
    obs = (1, obs3[0], sizes, obs3[2], obs3[2])
    per = None
    if percept:
        sim = perception.PerceptionSim(0, t([0.5, 0.0], dtype), 0.3)
        from cilqr_tpu_torch.models import tracker

        per = (sim, torch.full((), 0.1, dtype=dtype), tracker.init(dtype, batch=(B,), device=DEV),
               t(np.random.default_rng(12).normal(size=(B, 4)), dtype))
        obs = (1, obs3[0], sizes, obs3[2], torch.zeros(1, dtype=dtype))
    cm_kw = dict(use_kernels=True, band_plan=None, global_res=1.0, sigmas=None)
    glob, plan = (w["gm"], w["gg"]), (w["plan"], w["n"])
    maps = mc.per_scenario_map(t(np.random.default_rng(13).uniform(0, 100, (B, 16, 12)), dtype),
                               w["unc"].geom, w["unc"].origin_xy, w["unc"].origin_yaw)
    prior16 = t(np.random.default_rng(14).uniform(0, 100, (16, 12)), dtype)
    geom16 = gridmap.make_geom([3.0, 0.0], 0.5, 16, 12, dtype=dtype, device=DEV)
    sig = t(np.random.default_rng(15).uniform([0.02, 0.02, 0.005], [0.1, 0.1, 0.01], (B, 3)),
            dtype)
    S = solver.Stage
    return [
        ("mega", S(solver_batched._mega, world_args)),
        ("hybrid", S(solver_batched.hybrid_before, world_args[:5] + (maps,))),
        ("two_phase", S(solver_batched.two_phase_before, world_args)),
        ("mega cycle", S(plant._mega_cycle, (noise, r, w["egos"], w["U"], obs3,
                                             (w["plan"], w["n"], w["obstacles"], w["unc"])))),
        ("noise + SAT", S(plant._noisy_hits, (noise, r, w["egos"], obs3))),
        ("advance", S(plant._advance, (w["egos"], w["U"]))),
        ("full stack world", S(plant._full_stack_world, (cp, noise, r, w["egos"], glob, plan, obs,
                                                         cm_kw, per))),
        ("full stack start", S(plant._full_stack_before, (cp, noise, r, w["egos"], w["U"], glob,
                                                          plan, obs, cm_kw, per,
                                                          w["obstacles"]))),
        ("MC start", S(mc._fast_before, (
            dataclasses.replace(cp, rows=16, cols=12, window_radius=4), sig, w["egos"], w["U"],
            prior16, geom16, w["unc"].origin_xy, w["unc"].origin_yaw, w["plan"], w["n"],
            w["obstacles"], None))),
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("percept", [False, True], ids=["", "percept"])
def test_captured_stages_hold_no_host_copy_or_read(dtype, percept):
    """Each stage, after one eager run (the warm-up, which makes the shared
    constants), runs again under ``HostFree`` with the same result: no
    tensor made from host values, no value read on the host, as the
    capture on the card requires."""
    w = world(dtype, 3, seed=16)
    for name, stage in stages(w, percept):
        warm = stage.fn(w["p"], *stage.args)
        with HostFree():
            again = stage.fn(w["p"], *stage.args)
        assert same(again, warm), name


# ---------------------------------------- the graph paths with eager replays
class PlannedReplays:
    """Stands in for ``graphs.capture`` on the CPU: the capture runs the
    function once under ``HostFree`` and records its launches (taken back);
    each replay runs it again under a four-stream planner without streams,
    writes what it returns into the capture's outputs (``out``) and adds the
    recorded launches.  ``planners`` keeps each replay's plan."""

    captures = 0
    planners: list = []

    def __init__(self, fn, device, streams=1):
        type(self).captures += 1
        self.fn, self.streams = fn, streams
        out = []
        with graphs.building(), HostFree():
            self.launches = graphs.record_launches(lambda: out.append(fn()))
        self.out = out[0]

    def replay(self):
        planner = graphs.StreamPlanner(self.streams)
        with graphs.building(), graphs.uncounted(), planner:
            graphs.copy_outputs(self.out, self.fn())
        type(self).planners.append(planner)
        graphs.count_launches(self.launches)


@pytest.fixture
def replays(monkeypatch):
    """The stages staged on the CPU: ``graphs.replayable`` true outside a
    build, the captures replaced by ``PlannedReplays`` on ``solver.STREAMS``
    (4) streams, a cache of this test's own."""
    monkeypatch.setattr(graphs, "replayable", lambda x: not graphs._BUILDS)
    monkeypatch.setattr(graphs, "side_stream", lambda device: graphs.contextlib.nullcontext())
    monkeypatch.setattr(graphs, "capture", PlannedReplays)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(solver, "GRAPHS", True)
    monkeypatch.setattr(PlannedReplays, "planners", [])
    monkeypatch.setattr(PlannedReplays, "captures", 0)
    assert solver.STREAMS == 4


def graphed_and_eager(call, monkeypatch) -> tuple:
    """call() staged, then with ``solver.GRAPHS = False``."""
    got = call()
    monkeypatch.setattr(solver, "GRAPHS", False)
    want = call()
    monkeypatch.setattr(solver, "GRAPHS", True)
    return got, want


def op_names(planner) -> list:
    """The port's kernel ops among a replay's ops, in order."""
    names = [o.name.split(".")[0] for o in planner.ops]
    return [n for n in names if n in ("lm_opt", "lm_iter", "propagate", "sample", "riccati")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3])
def test_mega_solve_graph_path_gives_the_eager_bits(dtype, B, replays, monkeypatch):
    """``run_steps_batched(impl="mega")`` on a shared world: one graph
    (plan fit, world payload, K1's op) equal to the eager call bit for bit;
    two calls in a row on new egos replay it without a capture, each equal
    to its eager call; the replay runs K1's op once."""
    w = world(dtype, B, seed=20 + B)
    for k in range(3):
        egos = w["egos"] + 0.05 * k
        call = lambda: solver_batched.run_steps_batched(w["p"], w["plan"], w["n"], egos, w["U"],
                                                        w["obstacles"], w["unc"])
        got, want = graphed_and_eager(call, monkeypatch)
        assert same(got, want), k
    assert PlannedReplays.captures == 1 and len(solver.CAPTURED) == 1
    assert [op_names(pl) for pl in PlannedReplays.planners] == [["lm_opt"]] * 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_closed_loop_batched_graph_path_gives_the_eager_bits(dtype, replays, monkeypatch):
    """``closed_loop_batched``: one graph per cycle (noise, SAT, mega solve,
    dynamics step), every record and the final states equal to the eager
    loop's; a second call on new states replays without a capture; with a
    planner of its own the stages around it are graphs."""
    w = world(dtype, 3, seed=30)
    noise = NoiseParams(0.05, 0.04, 0.005)
    for k in range(2):
        draws = t(np.random.default_rng(31 + k).normal(size=(3, 3, 3)), dtype)
        call = lambda: plant.closed_loop_batched(
            w["p"], noise, w["plan"], w["n"], w["egos"] + 0.1 * k, None, 3,
            obstacles=w["obstacles"], unc_map=w["unc"], obs_xyyaw=w["obs"][0],
            obs_size=w["obs"][1], obs_mask=w["obs"][2], noise_draws=draws)
        got, want = graphed_and_eager(call, monkeypatch)
        assert same(got, want), k
    assert PlannedReplays.captures == 1
    assert all(op_names(pl) == ["lm_opt"] for pl in PlannedReplays.planners)
    assert len(PlannedReplays.planners) == 6

    def planner(noisy, U_warm):
        return solver_batched.run_steps_batched(w["p"], w["plan"], w["n"], noisy, U_warm,
                                                w["obstacles"], w["unc"], impl="two_phase")

    call = lambda: plant.closed_loop_batched(
        w["p"], noise, w["plan"], w["n"], w["egos"], None, 2, obstacles=w["obstacles"],
        obs_xyyaw=w["obs"][0], obs_size=w["obs"][1], obs_mask=w["obs"][2],
        noise_draws=draws[:2], plan_step_batched=planner)
    got, want = graphed_and_eager(call, monkeypatch)
    assert same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("percept", [False, True], ids=["", "percept"])
def test_full_stack_graph_path_gives_the_eager_bits(dtype, percept, replays, monkeypatch):
    """``closed_loop_full_stack_batched``: per cycle the start graph (the
    perception channel, the build with K5's and K4's ops, noise, SAT, plan
    fit, K3's payload), the step graph reading the maps where the start
    graph wrote them, the dynamics step's graph; every record and the final
    states equal to the eager loop's, with and without the perception
    channel; a second call replays without a capture; the start runs K5's
    and K4's ops once each (K3's wrapper takes its plain version directly
    on the CPU, no op: the step replays hold none)."""
    w = world(dtype, 3, seed=40)
    noise = NoiseParams(0.05, 0.04, 0.005)
    pc = perception.PerceptionSim(0, t([0.5, 0.0], dtype), 0.3) if percept else None
    for k in range(2):
        rng = np.random.default_rng(41 + k)
        draws, cam = t(rng.normal(size=(3, 3, 3)), dtype), t(rng.normal(size=(3, 3, 4)), dtype)
        call = lambda: plant.closed_loop_full_stack_batched(
            w["p"], w["cp"], noise, w["gm"], w["gg"], w["plan"], w["n"], w["egos"] + 0.1 * k,
            None, 3, w["obstacles"], *w["obs"], global_res=1.0, percept=pc,
            costmap_sigmas=(0.06, 0.05, 0.01), noise_draws=draws, camera_draws=cam)
        got, want = graphed_and_eager(call, monkeypatch)
        assert same(got, want), k
        assert set(got[1]) >= {"start_pos", "collided", "uncertainty_max"}
    assert PlannedReplays.captures == 3  # the start, the step, the dynamics step
    names = [op_names(pl) for pl in PlannedReplays.planners]
    assert names.count(["sample", "propagate"]) == 6
    assert {tuple(n) for n in names} == {("sample", "propagate"), ()}
    assert len(names) > 12  # 6 starts, 6 dynamics steps and the LM steps


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_stack_with_a_planner_of_its_own(dtype, replays, monkeypatch):
    """With ``plan_step_batched`` the stages before and after the planner
    are graphs, the planner runs as it runs: equal to the eager loop."""
    w = world(dtype, 3, seed=45)

    def planner(noisy, U_warm, umaps):
        return solver_batched.run_steps_batched(w["p"], w["plan"], w["n"], noisy, U_warm,
                                                w["obstacles"], umaps, world_batched=True)

    draws = t(np.random.default_rng(46).normal(size=(2, 3, 3)), dtype)
    call = lambda: plant.closed_loop_full_stack_batched(
        w["p"], w["cp"], NoiseParams(0.05, 0.04, 0.005), w["gm"], w["gg"], w["plan"], w["n"],
        w["egos"], None, 2, w["obstacles"], *w["obs"], global_res=1.0, noise_draws=draws,
        plan_step_batched=planner)
    got, want = graphed_and_eager(call, monkeypatch)
    assert same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("banded", [False, True], ids=["window", "bands"])
def test_monte_carlo_graph_path_gives_the_eager_bits(dtype, banded, replays, monkeypatch):
    """``monte_carlo(impl="fast")``: the propagation (K4's op), plan fit and
    K3's payload in the start graph; equal to the eager call bit for bit,
    twice on new samples (the second replays)."""
    w = world(dtype, 4, seed=50)
    cp = dataclasses.replace(w["cp"], rows=16, cols=12, window_radius=2)
    prior = t(np.random.default_rng(51).uniform(0, 100, (16, 12)), dtype)
    geom = gridmap.make_geom([3.0, 0.0], 0.5, 16, 12, dtype=dtype, device=DEV)
    hi = (0.1, 0.1, 0.01)
    band = uncertainty_cuda.make_band_plan(cp, 16, 12, (3.0, 0.0), hi) if banded else None
    for k in range(2):
        gen = torch.Generator(device=DEV).manual_seed(52 + k)
        s = mc.sample_scenarios(gen, 4, w["egos"][0], sigma_hi=hi, dtype=dtype, device=DEV)
        call = lambda: mc.monte_carlo(w["p"], cp, prior, geom, w["unc"].origin_xy,
                                      w["unc"].origin_yaw, w["plan"], w["n"], s, w["obstacles"],
                                      sigma_hi=hi, impl="fast", band_plan=band,
                                      center=(3.0, 0.0))
        got, want = graphed_and_eager(call, monkeypatch)
        assert same(got, want), k
    assert PlannedReplays.captures == 2


def test_plain_versions_run_the_stages_eagerly(replays, monkeypatch):
    """Inside ``route.plain()`` (K1's plain version is a whole LM loop read
    on the host) the mega solve captures nothing and gives the plain
    version's bits."""
    w = world(torch.float32, 3, seed=60)
    call = lambda: solver_batched.run_steps_batched(w["p"], w["plan"], w["n"], w["egos"], w["U"],
                                                    w["obstacles"], w["unc"])
    with route.plain():
        got = call()
    assert PlannedReplays.captures == 0 and len(solver.CAPTURED) == 0
    assert same(got, call())


# ------------------------------------------------------------- on the card
def card_world(dev, B: int, seed: int):
    """The example world on the card with B egos."""
    from cilqr_tpu_torch.sim.example_scenario import example_scenario

    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, device=dev)
    rng = np.random.default_rng(seed)
    egos = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (B, 4)),
                        dtype=torch.float32, device=dev)
    return p, plan, n, egos, U0.expand(B, p.horizon, 2).contiguous(), obstacles, unc


def eager_and_counts(call):
    """call() with ``solver.GRAPHS`` on and off: (results, K1/K3/hybrid
    step/K4/K5 launches) of each."""
    out, counts = {}, {}
    mods = (lm_cuda, uncertainty_cuda, sample_cuda)
    for graphed in (True, False):
        solver.GRAPHS = graphed
        lm_cuda.LAUNCHES = lm_cuda.ITER_LAUNCHES = lm_cuda.STEP_LAUNCHES = 0
        uncertainty_cuda.LAUNCHES = sample_cuda.LAUNCHES = 0
        out[graphed] = call()
        torch.cuda.synchronize()
        counts[graphed] = (lm_cuda.LAUNCHES, lm_cuda.ITER_LAUNCHES, lm_cuda.STEP_LAUNCHES) + tuple(
            m.LAUNCHES for m in mods[1:])
    return out, counts


@pytest.fixture
def card_graphs(monkeypatch):
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(solver, "GRAPHS", True)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("B", [1, 8, 256])
def test_graphed_mega_solve_equals_eager_on_the_card(B, card_graphs):
    """The shared-world mega solve as one graph equals ``GRAPHS = False`` bit
    for bit on every lane (X, U, iterations, J, lambda, the plan), one K1
    launch by replay, three calls in a row on new egos replaying one
    capture: K1's scenario counter is zeroed by every replay."""
    dev = torch.device("cuda", 0)
    p, plan, n, egos, U, obstacles, unc = card_world(dev, B, seed=70 + B)
    for k in range(3):
        e = egos + 0.05 * k
        out, counts = eager_and_counts(lambda: solver_batched.run_steps_batched(
            p, plan, n, e, U, obstacles, unc))
        assert same(out[True], out[False]), k
        assert counts[True] == counts[False] == (1, 0, 0, 0, 0)
        assert int(out[True].iterations.min()) >= 1
    assert len(solver.CAPTURED) == 1


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_graphed_closed_loops_equal_eager_on_the_card(card_graphs):
    """The full stack (B=64 x 2 cycles, with and without the perception
    channel) and ``monte_carlo(impl="fast")`` (B=64) graphed equal their
    eager calls on every record, with the same launch counts; so does
    ``closed_loop_batched`` (B=64 x 2)."""
    dev = torch.device("cuda", 0)
    p, plan, n, egos, U, obstacles, unc = card_world(dev, 64, seed=80)
    cp = CostmapParams()
    gm = torch.tensor(np.random.default_rng(81).uniform(0, 100, (256, 256)),
                      dtype=torch.float32, device=dev)
    gg = gridmap.make_geom([110.0, -300.0], 0.5, 256, 256, device=dev)
    obs = (torch.tensor([[115.0, -305.0, 0.0]], device=dev), torch.tensor([[3.63, 1.84]],
                                                                           device=dev),
           torch.ones(1, device=dev))
    draws = torch.tensor(np.random.default_rng(82).normal(size=(2, 64, 3)), dtype=torch.float32,
                         device=dev)
    cam = torch.tensor(np.random.default_rng(83).normal(size=(2, 64, 4)), dtype=torch.float32,
                       device=dev)
    noise = NoiseParams(0.05, 0.05, 0.005)
    for pc in (None, perception.PerceptionSim(0, torch.tensor([0.5, 0.0], device=dev), 0.3)):
        out, counts = eager_and_counts(lambda: plant.closed_loop_full_stack_batched(
            p, cp, noise, gm, gg, plan, n, egos, None, 2, obstacles, *obs, percept=pc,
            noise_draws=draws, camera_draws=cam))
        assert same(out[True], out[False]), pc
        assert counts[True] == counts[False] and counts[True][3:] == (2, 2)
    out, counts = eager_and_counts(lambda: plant.closed_loop_batched(
        p, noise, plan, n, egos, None, 2, obstacles, unc, *obs, noise_draws=draws))
    assert same(out[True], out[False]) and counts[True] == counts[False] == (2, 0, 0, 0, 0)
    cpm = dataclasses.replace(cp, window_radius=1)
    gen = torch.Generator(device=dev).manual_seed(84)
    s = mc.sample_scenarios(gen, 64, egos[0], sigma_hi=(0.16, 0.16, 0.017), device=dev)
    band = uncertainty_cuda.make_band_plan(cpm, cp.rows, cp.cols, (2.0, 0.0), (0.16, 0.16, 0.017))
    umap = unc_mod.make_uncertainty_map(np.random.default_rng(85).uniform(0, 100, (152, 104)),
                                        [2.0, 0.0], 0.2, egos[0, :2], 0.05, device=dev)
    out, counts = eager_and_counts(lambda: mc.monte_carlo(
        p, cpm, umap.values, umap.geom, umap.origin_xy, umap.origin_yaw, plan, n, s, obstacles,
        sigma_hi=(0.16, 0.16, 0.017), impl="fast", band_plan=band))
    assert same(out[True], out[False]) and counts[True] == counts[False]
    assert counts[True][3] == 1 and counts[True][2] == int(out[True].iterations.max())
    assert counts[True][1] == 0
