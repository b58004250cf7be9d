"""NRB-RRT node-budget sensitivity: the port of
``scripts/nrb_budget_sensitivity.py``.

The NRB-RRT baseline's safety column in ``docs/BASELINES.md`` depends on
its tree budget ``NRBParams.n_iters``.  This runs the dense slaloms
(success1-3) at n_iters in {64, 96, 192} x 10 runs x 140 cycles through
``sim.runner.run_experiment_batch``, with the noise at the
Experiment.launch defaults on the JAX package's noise block
(``scripts.jax_noise``), and prints the JAX script's markdown table of
collision runs, the minimum obstacle distance and the mean speed.  On the
card each budget's tree is one CUDA graph (``models.nrb_rrt``).

    python -m cilqr_tpu_torch.scripts.nrb_budget_sensitivity [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from cilqr_tpu_torch.models import nrb_rrt
from cilqr_tpu_torch.scripts import jax_noise
from cilqr_tpu_torch.sim import runner, scenarios
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

BUDGETS = (64, 96, 192)
NAMES = ("success1", "success2", "success3")
HEADER = ("| scenario | n_iters | collision_runs | min_obstacle_distance | velocity_mean |\n"
          "|---|---|---|---|---|")


def rows(budgets=BUDGETS, names=NAMES, n_runs: int = 10, n_cycles: int = 140,
         dtype=torch.float32, device=None, noise_draws=None) -> list:
    """One row per (scenario, budget): {"scenario", "n_iters",
    "collision_runs", "n_runs", "min_obstacle_distance", "velocity_mean"}
    (unrounded).  Every cell runs the same noise block: ``noise_draws``
    (n_cycles, n_runs, 3), or the JAX package's (``jax_noise``)."""
    device = resolve(device)
    p = SolverParams()  # horizon 40, the production default
    noise = NoiseParams()  # Experiment.launch defaults (0.16/0.16/0.017)
    draws = (jax_noise(n_cycles, n_runs, dtype, device) if noise_draws is None
             else torch.as_tensor(noise_draws, dtype=dtype, device=device))
    out = []
    for name in names:
        sc = scenarios.get_scenario(name)
        plan = scenarios.plan_for(name)
        for n_iters in budgets:
            nrbp = dataclasses.replace(nrb_rrt.NRBParams(), n_iters=n_iters)
            _, rs = runner.run_experiment_batch(
                p, noise, plan, np.array(sc.start), n_cycles, sc, n_runs=n_runs, dtype=dtype,
                algorithm="nrb_rrt", nrb_params=nrbp, noise_draws=draws, device=device)
            out.append(dict(
                scenario=name, n_iters=n_iters, n_runs=n_runs,
                collision_runs=sum(1 for r in rs if r["collisions"] > 0),
                min_obstacle_distance=min(r["distance_to_obstacles_min"] for r in rs),
                velocity_mean=float(np.mean([r["velocity_mean"] for r in rs]))))
    return out


def table_line(row: dict) -> str:
    """The JAX script's table row."""
    return (f"| {row['scenario']} | {row['n_iters']} | {row['collision_runs']}/{row['n_runs']} | "
            f"{row['min_obstacle_distance']:.3f} | {row['velocity_mean']:.3f} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cilqr_tpu_torch.scripts.nrb_budget_sensitivity")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(HEADER, flush=True)
    for row in rows(device=args.device):
        print(table_line(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
