"""Per-object (wall vs parked car) SAT classification of the aware planner's
collisions at the reference noise ratio: the port of
``scripts/classify_failure_modes.py``.

Reruns the aware `cilqr` sweep cells at the reference ratio 0.017/0.16 in
the production setup of ``docs/sweep_r4_n50`` (horizon 40, the synthetic
town prior, the costmap matched at sigma 0.5, 50 runs x 160 cycles on the
JAX package's noise block) at w_uncertainty 5 (Experiment.launch:11) and 1,
sigma 0.375 and 0.5, each cell through ``sim.sweep.run_cell``, then sorts
every collided run by the objects its recorded poses SAT-hit: wall, parked
car, or both.  It backs the mechanism paragraph of ``docs/BASELINES.md``:
the aware planner's excess high-sigma failures are wall hits, and
w_uncertainty=1 brings the count back to the blind planner's.

    python -m cilqr_tpu_torch.scripts.classify_failure_modes [--device cuda]

The ego box is the SAT ground truth's 4.79 x 2.16 m.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.scripts import jax_noise
from cilqr_tpu_torch.sim import scenarios, sweep
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams

RATIO = 0.017 / 0.16
SIGMAS = (0.375, 0.5)
WEIGHTS = (("w5", 5.0), ("w1", 1.0))
EGO_L, EGO_W = 4.79, 2.16


def np_sat(ego, obs) -> bool:
    """Separating-axis overlap of two boxes (x, y, yaw, L, W), in float64."""
    def corners(x, y, yaw, L, W):
        hl, hw = L / 2, W / 2
        loc = np.array([[-hl, -hw], [hl, -hw], [hl, hw], [-hl, hw]])
        c, s = np.cos(yaw), np.sin(yaw)
        return np.stack([loc[:, 0] * c - loc[:, 1] * s + x, loc[:, 0] * s + loc[:, 1] * c + y],
                        -1)
    c1, c2 = corners(*ego), corners(*obs)
    axes = []
    for c in (c1, c2):
        for i, j in ((0, 1), (0, 3)):
            axes.append(np.arctan2(c[j, 1] - c[i, 1], c[j, 0] - c[i, 0]))
    for a in axes:
        ca, sa = np.cos(a), np.sin(a)
        p1 = c1[:, 0] * ca + c1[:, 1] * sa
        p2 = c2[:, 0] * ca + c2[:, 1] * sa
        if p1.max() < p2.min() or p2.max() < p1.min():
            return False
    return True


def classify(start_pos, collided, sc: scenarios.Scenario) -> tuple:
    """(collided runs, runs that hit a wall, runs that hit a car) of a
    record: start_pos (runs, T, 4), collided (runs, T).  A collided run's
    poses are tested in order until it has hit both kinds."""
    sp = np.asarray(start_pos, np.float64)
    coll = np.asarray(collided).sum(axis=-1) > 0
    cars = np.asarray(sc.obstacles_xyyaw, np.float64)
    car_L, car_W = float(sc.obstacle_size[0]), float(sc.obstacle_size[1])
    walls = np.asarray(sc.walls_xyyaw, np.float64)
    wall_L, wall_W = (float(v) for v in np.asarray(sc.wall_size))
    nw = nc = 0
    for r in np.where(coll)[0]:
        wall_hit = car_hit = False
        for t in range(sp.shape[1]):
            ego = (sp[r, t, 0], sp[r, t, 1], sp[r, t, 3], EGO_L, EGO_W)
            if not wall_hit:
                wall_hit = any(np_sat(ego, (w[0], w[1], w[2], wall_L, wall_W)) for w in walls)
            if not car_hit:
                car_hit = any(np_sat(ego, (o[0], o[1], o[2], car_L, car_W)) for o in cars)
            if wall_hit and car_hit:
                break
        nw += wall_hit
        nc += car_hit
    return int(coll.sum()), nw, nc


def run(n_runs: int = 50, n_cycles: int = 160, dtype=torch.float32, device=None, p=None,
        cp=None, global_map=None, global_geom=None, noise_draws=None) -> list:
    """One row per (weight, sigma): {"tag", "w_uncertainty", "sigma", "n_runs",
    "collided", "wall_hits", "car_hits"}.  ``p`` and ``cp`` default to the
    production setup (horizon 40, ``CostmapParams()``), ``p``'s
    w_uncertainty is each row's.  Without ``global_map`` the synthetic town
    prior is made; without ``noise_draws`` (n_cycles, n_runs, 3) the JAX
    package's block (``jax_noise``)."""
    device = resolve(device)
    sc = scenarios.make_gauntlet()
    cp_max = sweep.matched_costmap_params(cp if cp is not None else CostmapParams(), 0.5,
                                          0.5 * RATIO)
    if global_map is None:
        global_map, global_geom = sweep.synthetic_town_prior(dtype, device)
    draws = (jax_noise(n_cycles, n_runs, dtype, device) if noise_draws is None
             else torch.as_tensor(noise_draws, dtype=dtype, device=device))
    x0s = torch.as_tensor(np.asarray(sc.start, np.float64), dtype=dtype,
                          device=device).expand(n_runs, 4).contiguous()
    rows = []
    for tag, w_unc in WEIGHTS:
        p_w = dataclasses.replace(p if p is not None else SolverParams(horizon=40),
                                  w_uncertainty=w_unc)
        plan, n = rp.pad_global_plan(p_w, np.asarray(scenarios.plan_for("compare")), dtype=dtype,
                                     device=device)
        bands = sweep.sweep_band_plan(cp_max, plan, n)
        for s in SIGMAS:
            rec = sweep.run_cell("cilqr", p_w, cp_max, sc, plan, n, x0s, draws, s, s * RATIO,
                                 global_map, global_geom, True, bands)
            collided, nw, nc = classify(rec["start_pos"].cpu().numpy(),
                                        rec["collided"].cpu().numpy(), sc)
            rows.append(dict(tag=tag, w_uncertainty=w_unc, sigma=s, n_runs=n_runs,
                             collided=collided, wall_hits=nw, car_hits=nc))
    return rows


def line(row: dict) -> str:
    """The JAX script's printed line for one row."""
    return (f"cilqr {row['tag']} s={row['sigma']}: collided={row['collided']}/{row['n_runs']} "
            f"wall_hits={row['wall_hits']} car_hits={row['car_hits']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cilqr_tpu_torch.scripts.classify_failure_modes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(device=args.device):
        print(line(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
