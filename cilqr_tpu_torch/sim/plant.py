"""Closed-loop plant: the replacement for CARLA + ros-bridge.

Port of ``cilqr_tpu/sim/plant.py``:

  * plant dynamics  = the kinematic bicycle the planner assumes (receding
    horizon: only U[0] is applied, ilqr_uncertainty_node.cpp:129)
  * localization noise = per-cycle N(0, sigma) on x/y/theta
    (ilqr_uncertainty_node.cpp:82-110: a feature of the experiment)
  * collision ground truth = SAT OBB checks against every obstacle
  * experiment record = per-cycle (start_pos, X, U, J, iterations) streams

``lax.scan`` over the cycles is a Python loop here that stacks the records.
On the card (``solver.GRAPHS``) the batched loops run each cycle as CUDA
graphs (``solver.run`` / ``solver.solve``), as the reference runs its
jitted cycle: ``closed_loop_batched`` one graph per cycle (noise, the SAT
check, the mega solve with K1, the dynamics step); the full stack a start
graph (the perception channel, the costmap build with K5 and K4, noise, the
SAT check, the plan fit and the hybrid loop's payload), one step graph
replay per LM iteration, which reads the maps where the start graph wrote
them, and a graph for the dynamics step.  The host replays graphs and reads
the done mask between step replays.  With another planner
(``plan_step_batched``) the stages around it are graphs and the planner
runs as it runs.

**Noise.**  JAX's PRNG stream cannot be reproduced, so ``inject_noise``
takes standard-normal draws instead of a key.  Every loop takes, in the
place of the JAX ``key``, a ``torch.Generator`` from which it draws one
(T, [B,] 3) block for the localization noise and, with ``percept``, one
(T, [B,] 4) block for the camera; or it takes the blocks pre-drawn
(``noise_draws``, ``camera_draws``), which is how the tests feed both
packages the same numbers.  ``per_run_keys`` of the JAX batched loop is
JAX key discipline (it makes a batched lane replay a single run's key) and
has no counterpart: pre-drawn blocks serve that purpose.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cilqr_tpu_torch.models import dynamics, solver, solver_batched, tracker
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.sim import collision, perception
from cilqr_tpu_torch.utils import profiling
from cilqr_tpu_torch.utils.device import constant
from cilqr_tpu_torch.utils.params import CostmapParams, NoiseParams, SolverParams


class AckermannCmd(NamedTuple):
    """The /carla/ego_vehicle/ackermann_cmd payload
    (ilqr_uncertainty_node.cpp:229-238)."""

    steering_angle: torch.Tensor        # = yaw-rate control (reference quirk)
    steering_angle_velocity: torch.Tensor
    speed: torch.Tensor                 # = current speed + accel
    acceleration: torch.Tensor
    jerk: torch.Tensor


def to_ackermann(speed: torch.Tensor, u0: torch.Tensor) -> AckermannCmd:
    """publishVehicleCmd semantics: speed + accel as the target speed, the
    yaw-rate control in the steering_angle field."""
    z = torch.zeros_like(speed)
    return AckermannCmd(u0[..., 1], z, speed + u0[..., 0], z, z)


class ExperimentRecord(NamedTuple):
    """Per-cycle /experiment payload (+ solver telemetry)."""

    start_pos: torch.Tensor   # (T, 4) true ego state at cycle start
    noisy_pos: torch.Tensor   # (T, 4) state fed to the planner
    X: torch.Tensor           # (T, N+1, 4) planned trajectories
    U: torch.Tensor           # (T, N, 2) planned controls
    J: torch.Tensor           # (T,)
    iterations: torch.Tensor  # (T,)
    collided: torch.Tensor    # (T,) any-obstacle SAT hit at cycle start


def inject_noise(noise: NoiseParams, r: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """N(0, sigma) on x, y, theta (ilqr_uncertainty_node.cpp:82-110) from the
    standard-normal draws r (..., 3) -> state (..., 4) with noise."""
    r = r.to(state.dtype)
    zero = torch.zeros_like(r[..., 0])
    return state + torch.stack([noise.sigma_x * r[..., 0], noise.sigma_y * r[..., 1], zero,
                                noise.sigma_theta * r[..., 2]], dim=-1)


def check_collisions(p: SolverParams, state: torch.Tensor, obs_xyyaw: torch.Tensor,
                     obs_size: torch.Tensor, obs_mask: torch.Tensor) -> torch.Tensor:
    """Any SAT overlap between the ego footprint and a live obstacle: state
    (..., 4) -> bool (...).  obs_xyyaw (M, 3); obs_size (2,) shared or (M, 2)."""
    M = obs_xyyaw.shape[0]
    sizes = obs_size.expand(M, 2)
    length = constant(p.length, state.dtype, state.device)
    width = constant(p.width, state.dtype, state.device)
    ego = (state[..., 0, None], state[..., 1, None], state[..., 3, None], length, width)
    hit = collision.is_collision(
        ego, (obs_xyyaw[:, 0], obs_xyyaw[:, 1], obs_xyyaw[:, 2], sizes[:, 0], sizes[:, 1]))
    return (hit & (obs_mask > 0)).any(dim=-1)


def _draws(generator, given, shape, dtype, device, what: str) -> torch.Tensor:
    """The pre-drawn block if given, else one standard-normal block of
    ``shape`` from the generator (drawn on its device), on ``device``."""
    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(given.shape)}")
        return given.to(device=device, dtype=dtype)
    if generator is None:
        raise ValueError(f"pass a torch.Generator or pre-drawn {what}")
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def _stack_records(recs: list) -> dict:
    return {k: torch.stack([r[k] for r in recs]) for k in recs[0]}


def closed_loop(p: SolverParams, noise: NoiseParams, plan_xy: torch.Tensor, plan_n,
                x0: torch.Tensor, generator: Optional[torch.Generator], n_cycles: int,
                obstacles=None, unc_map=None, obs_xyyaw=None, obs_size=None, obs_mask=None,
                plan_step=None, noise_draws=None):
    """Run ``n_cycles`` plan -> act cycles from x0 (4,) (apply U[0], receding
    horizon).  Returns (final state, ExperimentRecord).

    ``plan_step(noisy_state, U_warm) -> SolveResult-like`` swaps in another
    planner; the default is the CILQR solve.  ``noise_draws`` (T, 3): see
    the module docstring."""
    U_warm = solver.initial_controls(p, dtype=x0.dtype, device=x0.device)
    if plan_step is None:
        def plan_step(noisy, U_w):
            return solver.run_step(p, plan_xy, plan_n, noisy, U_w, obstacles, unc_map)
    draws = _draws(generator, noise_draws, (n_cycles, 3), x0.dtype, x0.device, "noise_draws")
    state, recs = x0, []
    for t in range(n_cycles):
        noisy = inject_noise(noise, draws[t], state)
        res = plan_step(noisy, U_warm)
        if obs_xyyaw is not None:
            hit = check_collisions(p, state, obs_xyyaw, obs_size, obs_mask)
        else:
            hit = torch.zeros((), dtype=torch.bool, device=x0.device)
        recs.append((state, noisy, res.X, res.U, res.J, res.iterations, hit))
        # apply only the first control (ilqr_uncertainty_node.cpp:129)
        state, U_warm = dynamics.step(p, state, res.U[0]), res.U
    return state, ExperimentRecord(*(torch.stack(c) for c in zip(*recs)))


def _obstacle_arrays(obs_xyyaw, obs_size, obs_mask, dtype, device):
    """(M, obs_xyyaw (M', 3), sizes (M', 2), mask (M',)): without obstacles
    one masked placeholder far away, so the costmap build has a row."""
    M = obs_xyyaw.shape[0] if obs_xyyaw is not None else 0
    if M:
        return M, obs_xyyaw, obs_size.expand(M, 2), obs_mask
    kw = dict(dtype=dtype, device=device)
    return 0, torch.full((1, 3), 1e6, **kw), torch.ones((1, 2), **kw), torch.zeros((1,), **kw)


def _percept_setup(percept, M: int, obs_mask: torch.Tensor):
    """The raster mask with the perceived obstacle taken out."""
    pi = percept.obs_index
    if not (0 <= pi < M):
        raise ValueError(f"percept.obs_index={pi} out of range for {M} obstacles")
    raster_mask = obs_mask.clone()
    raster_mask[pi] = 0.0
    return pi, raster_mask


def _camera(cp: CostmapParams, percept, plan_xy, plan_n, states, obs_now, sizes, pi, draws):
    """The camera's measurement in each tick's own vehicle-frame grid:
    (z (..., 4), valid (...)) for states (..., 4)."""
    center, _, _ = costmap_mod.corridor_geometry(cp, plan_xy, plan_n, states[..., :2],
                                                 states[..., 3])
    geom = costmap_mod.vehicle_geom(cp, center.to(states.dtype))
    return perception.bbox_measurement(cp, geom, states[..., :2], states[..., 3], obs_now[pi, :2],
                                       sizes[pi], obs_now[pi, 2], draws=draws,
                                       sigma=percept.bbox_sigma)


def closed_loop_full_stack(p: SolverParams, cp: CostmapParams, noise: NoiseParams,
                           global_map: torch.Tensor, global_geom, plan_xy: torch.Tensor, plan_n,
                           x0: torch.Tensor, generator: Optional[torch.Generator], n_cycles: int,
                           obstacles=None, obs_xyyaw=None, obs_size=None, obs_mask=None,
                           use_kernels: bool = False, plan_step=None, percept=None,
                           costmap_sigmas=None, noise_draws=None, camera_draws=None):
    """The complete two-node pipeline for one vehicle: every cycle rebuilds
    the local uncertainty costmap from the global prior (the map_engine
    node, local_costmap.cpp:172-310) and feeds it to the planner.

    The costmap is built at the true ego pose (the costmap node consumes
    raw odometry) while the solver sees the noisy pose (the planner node
    injects the localization noise): the reference's information flow.

    ``plan_step(noisy_state, U_warm, umap) -> SolveResult-like`` swaps in
    another planner.  ``percept`` (``sim.perception.PerceptionSim``) turns
    the perception channel on: obstacle ``percept.obs_index`` moves at
    ``percept.vel`` and is taken out of the bounding-box rasterization;
    each cycle the camera gives a noisy cell-space box of its true pose,
    the Kalman filter smooths it (``models.tracker.step``) and the tracked
    box is rasterized into ``semantic_lidar_map`` and overrides the vehicle
    map the propagation consumes.  The SAT ground truth still uses the true
    moving pose.  ``costmap_sigmas`` (3,) overrides the propagation sigmas
    of ``cp``.  ``use_kernels`` as in ``costmap.build_local_costmap``.
    ``noise_draws`` (T, 3) / ``camera_draws`` (T, 4): see the module
    docstring; the camera's draws are separate from the noise draws, so the
    noise is the same with ``percept`` on or off.

    Returns (final state, dict of (T, ...) records)."""
    dtype, dev = x0.dtype, x0.device
    U_warm = solver.initial_controls(p, dtype=dtype, device=dev)
    if plan_step is None:
        def plan_step(noisy, U_w, umap):
            return solver.run_step(p, plan_xy, plan_n, noisy, U_w, obstacles, umap)
    M, obs_xyyaw, sizes, obs_mask = _obstacle_arrays(obs_xyyaw, obs_size, obs_mask, dtype, dev)
    draws = _draws(generator, noise_draws, (n_cycles, 3), dtype, dev, "noise_draws")
    cm_raster_mask = obs_mask
    if percept is not None:
        pi, cm_raster_mask = _percept_setup(percept, M, obs_mask)
        kf = tracker.init(dtype=dtype, device=dev)
        cam = None
        if percept.bbox_sigma > 0.0:
            cam = _draws(generator, camera_draws, (n_cycles, 4), dtype, dev, "camera_draws")

    state, recs = x0, []
    for t in range(n_cycles):
        obs_now = obs_xyyaw
        tracked_box = tracked_valid = None
        if percept is not None:
            obs_now = obs_xyyaw.clone()
            obs_now[pi, :2] += (t * p.timestep) * percept.vel.to(dtype)
            z, tracked_valid = _camera(cp, percept, plan_xy, plan_n, state, obs_now, sizes, pi,
                                       None if cam is None else cam[t])
            kf, tracked_box = tracker.step(kf, z, tracked_valid)

        cm = costmap_mod.build_local_costmap(
            cp, global_map, global_geom, plan_xy, plan_n, state, obs_now[:, :2], sizes,
            obs_now[:, 2], cm_raster_mask, use_kernels=use_kernels, tracked_box=tracked_box,
            tracked_valid=tracked_valid, sigmas=costmap_sigmas)
        umap = unc_mod.UncertaintyMap(cm.uncertainty_map, cm.geom, cm.origin_xy, cm.origin_yaw)
        noisy = inject_noise(noise, draws[t], state)
        res = plan_step(noisy, U_warm, umap)
        if M:
            hit = check_collisions(p, state, obs_now, sizes, obs_mask)
        else:
            hit = torch.zeros((), dtype=torch.bool, device=dev)
        rec = {"start_pos": state, "noisy_pos": noisy, "J": res.J, "iterations": res.iterations,
               "collided": hit, "uncertainty_max": cm.uncertainty_map.max()}
        if percept is not None:
            rec.update(tracked_box=tracked_box, bbox_meas=z, bbox_valid=tracked_valid,
                       semantic_max=cm.semantic_lidar_map.max(), obs_pos=obs_now[pi, :2])
        recs.append(rec)
        state, U_warm = dynamics.step(p, state, res.U[0]), res.U
    return state, _stack_records(recs)


def _noisy_hits(p: SolverParams, noise: NoiseParams, r, states, obs):
    """The noisy states fed to the planner and the SAT check at the cycle's
    start (``obs`` = (obs_xyyaw, obs_size, obs_mask), or None: no hit)."""
    noisy = inject_noise(noise, r, states)
    if obs is None:
        return noisy, torch.zeros(states.shape[:1], dtype=torch.bool, device=states.device)
    return noisy, check_collisions(p, states, *obs)


def _advance(p: SolverParams, states, U):
    """The plant's step on the first control of U
    (ilqr_uncertainty_node.cpp:129)."""
    return dynamics.step(p, states, U[:, 0])


def _record(states, noisy, res, hits) -> dict:
    return {"start_pos": states, "noisy_pos": noisy, "J": res.J,
            "iterations": res.iterations, "collided": hits}


def _mega_cycle(p: SolverParams, noise: NoiseParams, r, states, U_warm, obs, world):
    """One cycle of ``closed_loop_batched`` on the mega solve: -> (record,
    next states, the plan's controls)."""
    noisy, hits = _noisy_hits(p, noise, r, states, obs)
    res = solver_batched.run_steps_batched(p, world[0], world[1], noisy, U_warm.contiguous(),
                                           *world[2:])
    return _record(states, noisy, res, hits), _advance(p, states, res.U), res.U


@profiling.spanned("entry.closed_loop")
def closed_loop_batched(p: SolverParams, noise: NoiseParams, plan_xy: torch.Tensor, plan_n,
                        x0s: torch.Tensor, generator: Optional[torch.Generator], n_cycles: int,
                        obstacles=None, unc_map=None, obs_xyyaw=None, obs_size=None,
                        obs_mask=None, noise_draws=None, plan_step_batched=None):
    """Closed loop over a scenario batch x0s (B, 4) on the fused path: every
    plan -> act cycle solves the whole batch through
    ``run_steps_batched(impl="mega")`` (kernel K1 on the card), on one
    shared world: on the card one CUDA graph per cycle.
    ``plan_step_batched(noisy_states, U_warm) -> batched SolveResult-like``
    swaps in another batched planner (the baselines of
    ``sim.runner.make_plan_step``).  ``noise_draws`` (T, B, 3).  Span
    (``utils.profiling``): the call, ``entry.closed_loop``.

    Returns (final states (B, 4), dict of (T, B, ...) records)."""
    B = x0s.shape[0]
    dtype, dev = x0s.dtype, x0s.device
    U_warm = solver.initial_controls(p, dtype=dtype, device=dev).expand(B, p.horizon, 2)
    draws = _draws(generator, noise_draws, (n_cycles, B, 3), dtype, dev, "noise_draws")
    obs = None if obs_xyyaw is None else (obs_xyyaw, obs_size, obs_mask)
    world = (plan_xy, plan_n, obstacles, unc_map)
    states, recs = x0s, []
    for t in range(n_cycles):
        if plan_step_batched is None:
            rec, states_next, U_warm = solver.run(p, solver.Stage(
                _mega_cycle, (noise, draws[t], states, U_warm, obs, world)))
        else:
            noisy, hits = solver.run(p, solver.Stage(_noisy_hits, (noise, draws[t], states, obs)))
            res = plan_step_batched(noisy, U_warm)
            rec, U_warm = _record(states, noisy, res, hits), res.U
            states_next = solver.run(p, solver.Stage(_advance, (states, res.U)))
        recs.append(rec)
        states = states_next
    return states, _stack_records(recs)


def _full_stack_world(p: SolverParams, cp: CostmapParams, noise: NoiseParams, r, states,
                      glob, plan, obs, cm_kw, percept):
    """A full-stack cycle up to the planner: the perception channel (with
    ``percept`` = (sim, t * dt, filter, camera draws)), the costmap build at
    the true states, the noise, the SAT check.  ``glob`` = (global_map,
    global_geom); ``plan`` = (plan_xy, plan_n); ``obs`` = (M, obs_xyyaw,
    sizes, obs_mask, raster mask); ``cm_kw`` the build's options.  ->
    (noisy states, the maps, the cycle's record so far, the filter)."""
    M, obs_xyyaw, sizes, obs_mask, raster_mask = obs
    dtype = states.dtype
    obs_now, boxes, valid, kf = obs_xyyaw, None, None, None
    if percept is not None:
        sim, tdt, kf, cam = percept
        obs_now = obs_xyyaw.clone()
        obs_now[sim.obs_index, :2] += tdt * sim.vel.to(dtype)
        zs, valid = _camera(cp, sim, *plan, states, obs_now, sizes, sim.obs_index, cam)
        kf, boxes = tracker.step(kf, zs, valid)
    cms = costmap_mod.build_local_costmap_batched(
        cp, *glob, *plan, states, obs_now[:, :2], sizes, obs_now[:, 2], raster_mask,
        tracked_boxes=boxes, tracked_valid=valid, **cm_kw)
    umaps = unc_mod.UncertaintyMap(cms.uncertainty_map, cms.geom, cms.origin_xy, cms.origin_yaw)
    noisy, hits = _noisy_hits(p, noise, r, states, (obs_now, sizes, obs_mask) if M else None)
    rec = {"start_pos": states, "noisy_pos": noisy, "collided": hits,
           "uncertainty_max": cms.uncertainty_map.amax(dim=(1, 2))}
    if percept is not None:
        rec.update(tracked_box=boxes, bbox_valid=valid,
                   semantic_max=cms.semantic_lidar_map.amax(dim=(1, 2)))
    return noisy, umaps, rec, kf


def _full_stack_before(p: SolverParams, cp: CostmapParams, noise: NoiseParams, r, states,
                       U_warm, glob, plan, obs, cm_kw, percept, obstacles):
    """A full-stack cycle up to the LM loop (a ``solver.solve`` stage):
    ``_full_stack_world``, then the plan fit and the iteration's payload
    (the hybrid loop's, K3; with per-scenario obstacles the two-phase
    loop's, K2, as ``run_steps_batched`` routes them)."""
    noisy, umaps, rec, kf = _full_stack_world(p, cp, noise, r, states, glob, plan, obs, cm_kw,
                                              percept)
    per_lane = obstacles is not None and obstacles.pos.ndim == 4
    before = solver_batched.two_phase_before if per_lane else solver_batched.hybrid_before
    x0, U_init, plans, iteration, _ = before(p, noisy, U_warm.contiguous(), *plan, obstacles,
                                             umaps)
    return x0, U_init, plans, iteration, (rec, kf)


def _full_record(rec: dict, res) -> dict:
    """The record in the order of its fields: start_pos, noisy_pos, J,
    iterations, collided, uncertainty_max[, the perception channel's]."""
    return {"start_pos": rec.pop("start_pos"), "noisy_pos": rec.pop("noisy_pos"), "J": res.J,
            "iterations": res.iterations, **rec}


@profiling.spanned("entry.full_stack")
def closed_loop_full_stack_batched(p: SolverParams, cp: CostmapParams, noise: NoiseParams,
                                   global_map: torch.Tensor, global_geom, plan_xy: torch.Tensor,
                                   plan_n, x0s: torch.Tensor,
                                   generator: Optional[torch.Generator], n_cycles: int,
                                   obstacles=None, obs_xyyaw=None, obs_size=None, obs_mask=None,
                                   band_plan=None, global_res: Optional[float] = None,
                                   percept=None, costmap_sigmas=None, plan_step_batched=None,
                                   use_kernels: bool = True, noise_draws=None,
                                   camera_draws=None):
    """The complete pipeline, batched: every plan -> act cycle, every
    scenario of x0s (B, 4) rebuilds its own vehicle-frame uncertainty
    costmap from the shared global map (``costmap.build_local_costmap_batched``:
    the resample kernel K5, then the propagation kernel K4 with per-scenario
    priors, frames and yaws) and replans through the hybrid solve
    (``run_steps_batched(impl="mega", world_batched=True)``: one step
    kernel per LM iteration, which samples each scenario's map).  Per
    scenario the information flow is that of
    ``closed_loop_full_stack``: costmap at the true pose, solver at the
    noisy pose.  Any B works.  On the card the cycle is CUDA graphs (see
    the module docstring).

    ``percept`` runs the camera -> Kalman filter -> ``semantic_lidar_map``
    channel per scenario.  ``plan_step_batched(noisy_states, U_warm, umaps)
    -> batched SolveResult-like`` swaps in another batched planner; the
    cycle then reads from the card only what the planner reads
    (``frenet.run_steps`` reads nothing: a cycle is three graph replays on
    the card, the world, the planner, the advance).
    ``band_plan``, ``global_res``, ``use_kernels`` and ``costmap_sigmas``
    go to ``build_local_costmap_batched``.  ``noise_draws`` (T, B, 3) /
    ``camera_draws`` (T, B, 4): see the module docstring.  Spans
    (``utils.profiling``): the call, each cycle, the records' stack; with a
    swapped planner, before the stack, the host's wait for the card while
    it reads the counters kept there (``profiling.device_counters``).

    Returns (final states (B, 4), dict of (T, B, ...) records)."""
    B = x0s.shape[0]
    dtype, dev = x0s.dtype, x0s.device
    U_warm = solver.initial_controls(p, dtype=dtype, device=dev).expand(B, p.horizon, 2)
    M, obs_xyyaw, sizes, obs_mask = _obstacle_arrays(obs_xyyaw, obs_size, obs_mask, dtype, dev)
    draws = _draws(generator, noise_draws, (n_cycles, B, 3), dtype, dev, "noise_draws")
    cm_raster_mask = obs_mask
    kf = cam = None
    if percept is not None:
        pi, cm_raster_mask = _percept_setup(percept, M, obs_mask)
        kf = tracker.init(dtype=dtype, batch=(B,), device=dev)
        if percept.bbox_sigma > 0.0:
            cam = _draws(generator, camera_draws, (n_cycles, B, 4), dtype, dev, "camera_draws")
    if costmap_sigmas is not None and not isinstance(costmap_sigmas, torch.Tensor):
        # numbers as a tensor once (rounded to the map's dtype in the build
        # as the numbers would be), not within every cycle
        costmap_sigmas = torch.tensor(costmap_sigmas, dtype=torch.float64, device=dev)
    glob, plan = (global_map, global_geom), (plan_xy, plan_n)
    obs = (M, obs_xyyaw, sizes, obs_mask, cm_raster_mask)
    cm_kw = dict(use_kernels=use_kernels, band_plan=band_plan, global_res=global_res,
                 sigmas=costmap_sigmas)

    states, recs = x0s, []
    for t in range(n_cycles):
        with profiling.span("full_stack.cycle"):
            per = None
            if percept is not None:
                tdt = torch.full((), t * p.timestep, dtype=dtype, device=dev)
                per = (percept, tdt, kf, None if cam is None else cam[t])
            if plan_step_batched is None:
                (X, U, it, J, lamb), (rec, kf) = solver.solve(p, solver.Stage(
                    _full_stack_before, (cp, noise, draws[t], states, U_warm, glob, plan, obs,
                                         cm_kw, per, obstacles)))
                res = solver.SolveResult(X, U, None, None, it, J, lamb)
            else:
                noisy, umaps, rec, kf = solver.run(p, solver.Stage(
                    _full_stack_world, (cp, noise, draws[t], states, glob, plan, obs, cm_kw,
                                        per)))
                res = plan_step_batched(noisy, U_warm, umaps)
            recs.append(_full_record(rec, res))
            U_warm = res.U.to(dtype)
            states = solver.run(p, solver.Stage(_advance, (states, U_warm)))
    if plan_step_batched is not None:
        # the swapped planner's counters kept on the card, read while tracing
        # (the cycles read nothing: the host waits for the card here alone)
        with profiling.span("full_stack.counters", wait=True):
            profiling.device_counters()
    with profiling.span("full_stack.records"):
        return states, _stack_records(recs)
