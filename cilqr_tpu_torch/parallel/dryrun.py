"""Dry run of the scale-out layer on a mesh of virtual shards.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
on a mesh of ``n_shards`` entries of one device, at tiny shapes, it runs

  1. the sharded solve with its metric reduction (``make_sharded_solver``);
  2. the sharded Monte-Carlo with per-scenario costmap propagation
     (``make_sharded_monte_carlo``);
  3. the sharded complete pipeline with the perception channel
     (``make_sharded_full_stack``), then 3b: the same per-chunk runs
     unsharded, each on its shard's generator, which the sharded run must
     equal (final states within 1e-5; the summary within 1e-4 relative on
     mean J and 1e-6 on the collision share).

``dryrun_multichip(8, device="cpu")`` prints one line, as the JAX version
does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cilqr_tpu_torch.utils.device import resolve


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_shards: int, device=None, seed: int = 0) -> dict:
    """Run the three phases on ``[device] * n_shards`` (the card unless
    ``device`` says otherwise); raises on any failed check.  Returns the
    line's numbers and prints the line."""
    from cilqr_tpu_torch.ops import gridmap
    from cilqr_tpu_torch.parallel import batch as pbatch, monte_carlo as mc
    from cilqr_tpu_torch.sim import perception, plant, scenarios
    from cilqr_tpu_torch.sim.example_scenario import example_scenario
    from cilqr_tpu_torch.sim.runner import build_scenario_inputs
    from cilqr_tpu_torch.utils.params import CostmapParams, NoiseParams, SolverParams

    dev = resolve(device)
    mesh = pbatch.make_mesh([dev] * n_shards)
    # tiny shapes: short horizon, small plan, 2 scenarios per shard
    p = dataclasses.replace(SolverParams(), horizon=8, max_iterations=3,
                            max_global_plan_points=64, num_of_local_wpts=8)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, torch.float32, dev)
    B = 2 * n_shards
    rng = np.random.default_rng(1)
    egos = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (B, 4)),
                        dtype=torch.float32, device=dev)
    U0s = U0.expand((B,) + tuple(U0.shape))

    fn, _ = pbatch.make_sharded_solver(p, mesh, obstacles=obstacles, unc_map=unc)
    res, metrics = fn(plan, n, egos, U0s)
    _require(tuple(res.U.shape) == (B, p.horizon, 2), f"sharded solve U shape {tuple(res.U.shape)}")
    _require(bool(torch.isfinite(res.U).all()) and bool(torch.isfinite(metrics.mean_J)),
             "sharded solve: non-finite U or mean J")

    # phase 2: scenario-sharded Monte-Carlo with per-scenario costmap
    # propagation (config 5 on tiny shapes)
    cp = dataclasses.replace(CostmapParams(), rows=16, cols=16, window_radius=4)
    prior = torch.tensor(np.random.default_rng(2).uniform(0, 100, (cp.rows, cp.cols)),
                         dtype=torch.float32, device=dev)
    geom = gridmap.make_geom([5.0, 0.0], cp.resolution, cp.rows, cp.cols, torch.float32, dev)
    samples = mc.sample_scenarios(torch.Generator().manual_seed(3), B, ego.cpu(), device=dev)
    mc_fn, _ = mc.make_sharded_monte_carlo(p, cp, mesh, obstacles=obstacles,
                                           map_shape=(cp.rows, cp.cols), map_center=(5.0, 0.0))
    mres, mmetrics = mc_fn(prior, geom, ego[:2], ego[3], plan, n, samples.sigmas, samples.egos)
    _require(bool(torch.isfinite(mres.U).all()) and bool(torch.isfinite(mmetrics.mean_J)),
             "sharded Monte-Carlo: non-finite U or mean J")

    # phase 3: the complete pipeline sharded, with the perception channel
    cpf = dataclasses.replace(CostmapParams(), rows=32, cols=24, window_radius=3,
                              look_ahead_waypoints=8)
    sc = scenarios.get_scenario("success1")
    ob_fs, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(p, sc, torch.float32, dev)
    gmap = torch.zeros((64, 64), dtype=torch.float32, device=dev)
    ggeom = gridmap.make_geom([100.0, -300.0], 1.0, 64, 64, torch.float32, dev)
    percept = perception.PerceptionSim(0, torch.tensor([0.5, 0.0], device=dev), bbox_sigma=0.2)
    world = dict(obstacles=ob_fs, obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
                 percept=percept)
    fs_fn, _ = pbatch.make_sharded_full_stack(p, cpf, mesh, n_cycles=2, **world)
    x0s = torch.tensor(np.asarray(sc.start)[None, :]
                       + np.random.default_rng(seed).normal(0, 0.2, (B, 4)),
                       dtype=torch.float32, device=dev)
    xf, rec, summary = fs_fn(gmap, ggeom, plan, n, x0s, seed)
    _require(bool(torch.isfinite(xf).all()) and bool(torch.isfinite(summary[0]))
             and tuple(rec["tracked_box"].shape[:2]) == (2, B),
             "sharded full stack: non-finite states or summary, or record shape")

    # phase 3b: equality with the unsharded per-chunk runs on the shards'
    # generators: a sharding fault that keeps values finite fails here
    b = B // n_shards
    chunks, j_sum, col_sum = [], 0.0, 0.0
    for i in range(n_shards):
        xf_i, rec_i = plant.closed_loop_full_stack_batched(
            p, cpf, NoiseParams(), gmap, ggeom, plan, n, x0s[i * b:(i + 1) * b],
            pbatch.shard_generator(seed, i, dev), 2, **world)
        chunks.append(xf_i)
        j_sum += float(rec_i["J"][-1].sum())
        col_sum += float(rec_i["collided"].any(dim=0).sum())
    fs_diff = float((xf - torch.cat(chunks)).abs().max())
    mean_J, col = float(summary[0]), float(summary[1])
    _require(fs_diff <= 1e-5, f"full stack vs the unsharded runs: max |d| {fs_diff:.3e}")
    _require(abs(mean_J - j_sum / B) <= 1e-4 * max(1.0, abs(j_sum / B)),
             f"summary mean J {mean_J} vs {j_sum / B}")
    _require(abs(col - col_sum / B) <= 1e-6, f"collision share {col} vs {col_sum / B}")

    out = dict(shards=n_shards, device=str(dev), batch=B, mean_J=float(metrics.mean_J),
               mean_iters=float(metrics.mean_iterations), mc_mean_J=float(mmetrics.mean_J),
               fs_mean_J=mean_J, fs_collision_frac=col, fs_max_abs_diff_vs_unsharded=fs_diff)
    print(f"dryrun_multichip OK: {n_shards} shards of {dev}, batch {B}, "
          f"mean_J={out['mean_J']:.3f}, mean_iters={out['mean_iters']:.2f}, "
          f"mc_mean_J={out['mc_mean_J']:.3f}, fs_mean_J={mean_J:.3f}, "
          f"fs_collision_frac={col:.3f}, fs_max_abs_diff_vs_unsharded={fs_diff:.2e}", flush=True)
    return out

