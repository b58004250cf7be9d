"""Experiment runner: closed-loop scenarios with wall-clock planning times.

Port of ``cilqr_tpu/sim/runner.py``, the analog of the reference's bring-up
+ record procedure (SURVEY.md §3.4: CARLA -> bridge -> vehiclepub ->
map_engine -> ilqr node -> rosbag record) as one function call:

  * ``run_experiment``: a Python cycle loop that measures the *wall-clock*
    planning time of each cycle (the std::chrono timing at
    ilqr_uncertainty_node.cpp:116-124) and streams records to the native
    experiment log (``utils.explog``); one vehicle, the batched planner at
    B=1 (kernel K1 on the card), with ``--full-stack`` a single-map costmap
    build per cycle (K4).
  * ``run_experiment_batch``: the reference's 10-run batch as one batched
    loop over the runs (``plant.closed_loop_batched``; with a costmap,
    ``plant.closed_loop_full_stack_batched``: K5 and K4 per cycle), with
    the algorithm's batched planner of ``make_plan_step`` in the loop.

**Noise.**  The JAX functions draw from ``seed``'s key; here every entry
point takes a ``torch.Generator`` or the standard-normal block pre-drawn
(``noise_draws``), and without either draws from a generator seeded with
``seed`` on the card.  The tests reproduce the JAX package's draws: per run
``split(split(key(seed), n_runs)[r], T)`` in the batch, ``split`` once per
cycle in ``run_experiment``.  NRB-RRT's own draws are derived from the
states it plans from (``utils.prng``), as the JAX package's are.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from cilqr_tpu_torch.models import ccnmpc, dynamics, frenet, nrb_rrt
from cilqr_tpu_torch.models import obstacles as obs_mod, solver, solver_batched
from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.sim import plant, scenarios
from cilqr_tpu_torch.utils import metrics as metrics_mod
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams


def build_scenario_inputs(p: SolverParams, scenario: scenarios.Scenario, dtype=torch.float32,
                          device=None):
    """Planner ellipse obstacles + SAT/costmap pose arrays for a scenario.

    Returns ``(ob, obs_xyyaw, obs_size, obs_mask)``.  ``ob`` is the
    ellipse-barrier set the planner consumes and covers the scenario's
    *vehicle* obstacles only.  The pose arrays additionally carry the
    scenario's SAT-only walls (Scenario.walls_xyyaw): they feed the SAT
    collision ground truth and the costmap bbox rasterization, but never
    the planner's ellipse channel — the information asymmetry of the
    CILQR vs CILQR_Base ablation.
    """
    device = resolve(device)
    xyyaw = scenario.obstacles_xyyaw
    M = xyyaw.shape[0]
    W = scenario.n_walls
    if M + W > p.max_obstacles:
        raise ValueError(
            f"scenario {scenario.name!r} needs {M + W} obstacle slots, "
            f"max_obstacles={p.max_obstacles}")
    ob = obs_mod.make_static_obstacles(
        p, xyyaw[:, :2], np.tile(np.asarray(scenario.obstacle_size), (M, 1)), xyyaw[:, 2],
        dtype=dtype, device=device)
    # SAT/costmap set: vehicles + walls, padded to max_obstacles (far away)
    sat_xyyaw = np.concatenate([xyyaw, scenario.walls_xyyaw], axis=0)
    sat_sizes = np.concatenate(
        [np.tile(np.asarray(scenario.obstacle_size), (M, 1)),
         np.tile(np.asarray(scenario.wall_size), (W, 1))], axis=0)
    pad = p.max_obstacles - M - W
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
    obs_xyyaw = t(np.concatenate([sat_xyyaw, np.full((pad, 3), 1e6)], axis=0))
    obs_size = t(np.concatenate([sat_sizes, np.ones((pad, 2))], axis=0))
    obs_mask = t(np.concatenate([np.ones(M + W), np.zeros(pad)]))
    return ob, obs_xyyaw, obs_size, obs_mask


#: The algorithm axis of the reference's comparison pipeline
#: (batch_dataprocess.py:458-463: CCNMPC / CILQR / CILQR_Base / Frenet /
#: NRB-RRT) plus the Frenet uncertainty ablations (Frenet/readme.md:1-15).
ALGORITHMS = (
    "cilqr",                # uncertainty-aware CILQR (the paper's method)
    "cilqr_base",           # CILQR without the uncertainty-map term
    "ccnmpc",               # chance-constrained NMPC (tightened ellipses)
    "frenet_origin",        # Frenet lattice, uncertainty ignored
    "frenet_expansion",     # Frenet lattice, chi-sigma inflated obstacles
    "frenet_propagation",   # Frenet lattice, propagated uncertainty costmap
    "nrb_rrt",              # risk-bounded kinodynamic RRT (DR chance bound)
)


def make_plan_step(algorithm: str, p: SolverParams, noise: NoiseParams, plan: torch.Tensor, n,
                   obstacles=None, unc_map=None, frenet_params=None, cc_params=None,
                   nrb_params=None):
    """Batched planner factory: ``(noisy (B, 4), U_warm (B, N, 2), umaps=None)
    -> SolveResult-like`` with a leading B on every field.

    One closed-loop / runner code path drives every algorithm of
    ``ALGORITHMS`` — the analog of swapping which planner node is launched
    (SURVEY.md §3.4) while CARLA / vehiclepub stay fixed.  The JAX package
    returns a single-lane step and vmaps it; the port's closed loops are
    batched, so its steps are too:

      * `cilqr`, `cilqr_base`: one ``solver_batched.run_steps_batched(
        impl="mega")`` call, K1 with no map or one map shared by the batch,
        the hybrid loop with K3 with one map per scenario (values
        (B, H, W), the full-stack loop's per-cycle costmaps); `cilqr_base`
        discards the map by definition;
      * `ccnmpc`: ``ccnmpc.run_steps`` with the noise's covariance W (the
        two-phase solve with K2 on per-lane tightened obstacles);
      * `frenet_*`: ``frenet.run_steps`` (``plan_steps`` as one graph on the
        card) in the name's mode, the noise's sigmas for expansion, the map
        for propagation, the curvature bound made once here;
      * `nrb_rrt`: ``nrb_rrt.run_steps`` (``plan_steps`` as one graph on the
        card) with the noise's sigmas, its constants made once here.

    ``umaps`` (the per-cycle costmap, else ``unc_map``) is read by `cilqr`
    and `frenet_propagation` only.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of {ALGORITHMS}")
    pick = lambda umaps: umaps if umaps is not None else unc_map
    if algorithm in ("cilqr", "cilqr_base"):
        aware = algorithm == "cilqr"

        def step(noisy, U_warm, umaps=None):
            m = pick(umaps) if aware else None
            return solver_batched.run_steps_batched(
                p, plan, n, noisy, U_warm.contiguous(), obstacles, m, impl="mega",
                world_batched=m is not None and m.values.ndim == 3)

        return step
    if algorithm == "ccnmpc":
        cc = cc_params if cc_params is not None else ccnmpc.CCParams()
        return lambda e, u, umaps=None: ccnmpc.run_steps(p, cc, noise, plan, n, e, u, obstacles)
    sig = torch.tensor([noise.sigma_x, noise.sigma_y, noise.sigma_theta], dtype=plan.dtype,
                       device=plan.device)
    if algorithm == "nrb_rrt":
        nrbp = nrb_params if nrb_params is not None else nrb_rrt.NRBParams()
        consts = nrb_rrt.constants(p, nrbp, plan.dtype, plan.device)
        return lambda e, u, umaps=None: nrb_rrt.run_steps(p, nrbp, plan, n, e, obstacles, sig,
                                                          consts)
    mode = algorithm.split("_", 1)[1]
    fp = frenet_params if frenet_params is not None else frenet.FrenetParams()
    if fp.mode != mode:
        fp = dataclasses.replace(fp, mode=mode)
    kappa = frenet.curvature_bound(p, plan.dtype, plan.device)
    if mode == "propagation":
        return lambda e, u, umaps=None: frenet.run_steps(p, fp, plan, n, e, obstacles,
                                                         pick(umaps), sig, kappa)
    return lambda e, u, umaps=None: frenet.run_steps(p, fp, plan, n, e, obstacles, None, sig,
                                                     kappa)


def nrb_params_for_scenario(p: SolverParams, scenario, base=None):
    """Corridor-feasible NRB-RRT sampling band for a scenario.

    Restricts lateral target sampling to the scenario's drivable band
    (``Scenario.lat_band``, the wall inner faces) minus the ego half-width
    + margin: lane-boundary knowledge every planner has from the route /
    map, even when its risk model is (by design) blind to the costmap.
    Without it the 2.1 m gauntlet lane collided 10/10 at sigma=0 because
    +-3 m lateral targets sat inside the walls.  No band (or a degenerate
    one) keeps ``base`` unchanged."""
    base = base if base is not None else nrb_rrt.NRBParams()
    band = getattr(scenario, "lat_band", None)
    if band is None:
        return base
    half = p.width / 2.0 + base.collision_margin
    lo = max(-base.lat_max, float(band[0]) + half)
    hi = min(base.lat_max, float(band[1]) - half)
    if hi <= lo:
        return base
    return dataclasses.replace(base, lat_lo=lo, lat_hi=hi)


def noise_block(shape, generator: Optional[torch.Generator] = None, noise_draws=None,
                seed: int = 0, dtype=torch.float32, device=None) -> torch.Tensor:
    """The standard-normal localization-noise block of a run: ``noise_draws``
    if given (checked against ``shape``), else one block from ``generator``,
    else from a generator on ``device`` seeded with ``seed``; on ``device``."""
    device = resolve(device)
    if noise_draws is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return plant._draws(generator, noise_draws, shape, dtype, device, "noise_draws")


def runs_first(rec: dict) -> dict:
    """(T, R, ...) records -> (R, T, ...), the JAX package's layout."""
    return {k: v.transpose(0, 1) for k, v in rec.items()}


def run_experiment_batch(p: SolverParams, noise: NoiseParams, plan_np: np.ndarray, x0: np.ndarray,
                         n_cycles: int, scenario: scenarios.Scenario, n_runs: int = 10,
                         seed: int = 0, dtype=torch.float32, algorithm: str = "cilqr",
                         frenet_params=None, cc_params=None, nrb_params=None,
                         costmap_params=None, global_map=None, global_geom=None,
                         generator: Optional[torch.Generator] = None, noise_draws=None,
                         device=None):
    """The reference's 10-run experiment batch (batch_dataprocess.py:386-447,
    471) as one batched loop over ``n_runs`` runs of a scenario: B = n_runs,
    every run from x0 with its own noise (``noise_draws`` (T, n_runs, 3)),
    planned by ``make_plan_step(algorithm)``; `nrb_rrt` samples in the
    scenario's corridor band (``nrb_params_for_scenario``) unless
    ``nrb_params`` is given.

    Without ``costmap_params``: ``plant.closed_loop_batched`` (no map, so
    `cilqr` plans as `cilqr_base` and `frenet_propagation` as
    `frenet_origin`).  With ``costmap_params`` / ``global_map`` /
    ``global_geom``: every cycle rebuilds each run's local uncertainty
    costmap from the global prior (``plant.closed_loop_full_stack_batched``:
    K5, then K4 over one full window of ``costmap_params.window_radius``,
    the JAX single-map build's; their plain versions for CPU tensors) for
    every algorithm, and `cilqr` (K3) and `frenet_propagation` read it.

    Returns ({"final_states": (n_runs, 4) array, "record": dict of
    (n_runs, n_cycles, ...) tensors}, metrics rows for
    ``utils.metrics.export_csv``).  The record is the batched loop's: it
    holds no per-cycle X / U (the JAX package's blind record, a vmapped
    single loop, does).
    """
    device = resolve(device)
    plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype, device=device)
    ob, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(p, scenario, dtype, device)
    x0s = torch.as_tensor(np.asarray(x0, np.float64), dtype=dtype,
                          device=device).expand(n_runs, 4).contiguous()
    draws = noise_block((n_cycles, n_runs, 3), generator, noise_draws, seed, dtype, device)
    obs_kw = dict(obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask)
    if algorithm == "nrb_rrt" and nrb_params is None:
        nrb_params = nrb_params_for_scenario(p, scenario)
    plan_step = make_plan_step(algorithm, p, noise, plan, n, obstacles=ob,
                               frenet_params=frenet_params, cc_params=cc_params,
                               nrb_params=nrb_params)
    if costmap_params is not None:
        xf, rec = plant.closed_loop_full_stack_batched(
            p, costmap_params, noise, global_map, global_geom, plan, n, x0s, None, n_cycles,
            obstacles=ob, plan_step_batched=plan_step, noise_draws=draws, **obs_kw)
    else:
        xf, rec = plant.closed_loop_batched(p, noise, plan, n, x0s, None, n_cycles, obstacles=ob,
                                            noise_draws=draws, plan_step_batched=plan_step,
                                            **obs_kw)
    rec = runs_first(rec)

    obs_xy = torch.as_tensor(scenario.obstacles_xyyaw[:, :2], dtype=dtype, device=device)
    per_run = metrics_mod.analyze_batch(rec["start_pos"], obs_xy, dt=p.timestep)
    collisions = rec["collided"].sum(dim=1).tolist()
    mean_it = rec["iterations"].double().mean(dim=1).tolist()
    rows = []
    for r in range(n_runs):
        row = metrics_mod.summary_row(f"{algorithm}/{scenario.name}/{r}",
                                      metrics_mod.map_values(lambda a, r=r: a[r], per_run))
        row["algorithm"] = algorithm
        row["collisions"] = int(collisions[r])
        row["mean_iterations"] = float(mean_it[r])
        rows.append(row)
    return {"final_states": xf.detach().cpu().numpy(), "record": rec}, rows


def run_algorithm_comparison(p: SolverParams, noise: NoiseParams, plan_np: np.ndarray,
                             x0: np.ndarray, n_cycles: int, scenario: scenarios.Scenario,
                             algorithms=ALGORITHMS, n_runs: int = 10, seed: int = 0,
                             dtype=torch.float32, costmap_params=None, global_map=None,
                             global_geom=None, generator: Optional[torch.Generator] = None,
                             noise_draws=None, device=None):
    """The full batch_dataprocess.py comparison (one sheet per algorithm,
    :459-502) in one call: every algorithm runs the same scenario on the
    same noise block (drawn once, or ``noise_draws``), returning {algorithm:
    (out, rows)} plus a flat row list ready for ``metrics.export_csv``.
    Pass the costmap/global-map arguments to run the full per-cycle
    map_engine pipeline (required for `cilqr` vs `cilqr_base` and
    `frenet_propagation` vs `frenet_origin` to differ — without a costmap
    the uncertainty-consuming variants degrade to their base algorithms).
    """
    device = resolve(device)
    draws = noise_block((n_cycles, n_runs, 3), generator, noise_draws, seed, dtype, device)
    results, all_rows = {}, []
    for algo in algorithms:
        out, rows = run_experiment_batch(
            p, noise, plan_np, x0, n_cycles, scenario, n_runs=n_runs, seed=seed, dtype=dtype,
            algorithm=algo, costmap_params=costmap_params, global_map=global_map,
            global_geom=global_geom, noise_draws=draws, device=device)
        results[algo] = (out, rows)
        all_rows.extend(rows)
    return results, all_rows


def _sync(t: torch.Tensor) -> None:
    """Wait for the card's queue where the JAX code blocks until ready."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_experiment(p: SolverParams, noise: NoiseParams, plan_np: np.ndarray, x0: np.ndarray,
                   n_cycles: int, scenario: Optional[scenarios.Scenario] = None,
                   seed: int = 0, dtype=torch.float32, log=None, algorithm: str = "cilqr",
                   costmap_params=None, global_map=None, global_geom=None,
                   generator: Optional[torch.Generator] = None, noise_draws=None, device=None):
    """Closed-loop run of one vehicle with per-cycle wall-clock planning times.

    Returns a dict of stacked per-cycle NumPy arrays (the /experiment bag
    payload) including the measured ``planning_time``; optionally appends
    every record to a native ``utils.explog.ExperimentLog``.  Each cycle
    calls the batched planner of ``make_plan_step`` at B=1 (for `cilqr`
    and `cilqr_base` K1 on the card) and waits for the card before it reads
    the clock; one warm-up call comes first.  ``noise_draws`` (T, 3).

    With ``costmap_params`` / ``global_map`` / ``global_geom`` set, every
    cycle rebuilds the local uncertainty costmap from the global prior at
    the true ego pose (``costmap.build_local_costmap``: K4 in its
    single-map form, its plain version for CPU tensors) and feeds it to the
    planner (read by `cilqr` and `frenet_propagation`); the
    separate ``costmap_time`` stream records its wall clock (the reference
    times only the ilqr node, ilqr_uncertainty_node.cpp:116-124, so
    ``planning_time`` stays the solver alone).
    """
    device = resolve(device)
    plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype, device=device)
    if scenario is not None:
        ob, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(p, scenario, dtype, device)
    else:
        ob = obs_xyyaw = obs_size = obs_mask = None
    solve = make_plan_step(algorithm, p, noise, plan, n, obstacles=ob)

    cm_fn = None
    if costmap_params is not None:
        if scenario is None:
            raise ValueError("costmap pipeline needs a scenario (obstacle set)")
        sizes = obs_size.expand(obs_xyyaw.shape[0], 2)

        def cm_fn(state):
            cm = costmap_mod.build_local_costmap(
                costmap_params, global_map, global_geom, plan, n, state, obs_xyyaw[:, :2], sizes,
                obs_xyyaw[:, 2], obs_mask, use_kernels=True)
            return unc_mod.UncertaintyMap(cm.uncertainty_map, cm.geom, cm.origin_xy,
                                          cm.origin_yaw)

    draws = noise_block((n_cycles, 3), generator, noise_draws, seed, dtype, device)
    state = torch.as_tensor(np.asarray(x0, np.float64), dtype=dtype, device=device)
    U_warm = solver.initial_controls(p, dtype=dtype, device=device)

    # warm up (kernel build, allocator) so recorded planning times reflect
    # the steady state (the reference node is likewise warm after its first
    # cycle)
    warm = solve(state[None], U_warm[None], None if cm_fn is None else cm_fn(state))
    _sync(warm.X)

    recs = {k: [] for k in ("start_time", "start_pos", "noisy_pos", "planning_time",
                            "X", "U", "J", "iterations", "collided")}
    if cm_fn is not None:
        recs["costmap_time"] = []
    t_start = time.time()
    for t in range(n_cycles):
        noisy = plant.inject_noise(noise, draws[t], state)
        umap = None
        if cm_fn is not None:
            t0 = time.perf_counter()
            umap = cm_fn(state)
            _sync(umap.values)
            recs["costmap_time"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        res = solve(noisy[None], U_warm[None], umap)
        _sync(res.X)
        planning_time = time.perf_counter() - t0

        hit = False
        if scenario is not None:
            hit = bool(plant.check_collisions(p, state, obs_xyyaw, obs_size, obs_mask))

        X, U = res.X[0].to(dtype), res.U[0].to(dtype)
        recs["start_time"].append(time.time() - t_start)
        recs["start_pos"].append(state.cpu().numpy())
        recs["noisy_pos"].append(noisy.cpu().numpy())
        recs["planning_time"].append(planning_time)
        recs["X"].append(X.cpu().numpy())
        recs["U"].append(U.cpu().numpy())
        recs["J"].append(float(res.J[0]))
        recs["iterations"].append(int(res.iterations[0]))
        recs["collided"].append(hit)
        if log is not None:
            log.append(start_time=recs["start_time"][-1], start_pos=recs["start_pos"][-1],
                       planning_time=planning_time, X=recs["X"][-1], U=recs["U"][-1])

        state = dynamics.step(p, state, U[0])
        U_warm = U

    return {k: np.asarray(v) for k, v in recs.items()}
