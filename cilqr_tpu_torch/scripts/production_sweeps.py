"""The production sigma-sweep grids of ``docs/BASELINES.md``, on the port.

Four grids, each ``sim.sweep.run_sigma_sweep`` on the gauntlet with the
CLI's sweep defaults (horizon 40, w_uncertainty 5, seed 0) and the JAX
package's noise block (``scripts.jax_noise``), 50 runs x 160 cycles:

  r4_n50       ``docs/sweep_r4_n50``: sigma_xy 0 ... 0.5 x the six sweep
               algorithms, ratio sigma_theta/sigma_xy 0.017/0.16, the
               synthetic town prior;
  r5_refratio  ``docs/sweep_r5_pallas_n50/refratio``: `cilqr` and
               `cilqr_base` at sigma 0.375 and 0.5, the reference ratio,
               the synthetic town prior;
  r5_theta02   ``.../theta02``: the same cells at ratio 0.2 on an all-free
               prior (the CLI's ``--free-prior``);
  r5_rot25     ``.../rot25``: ratio 0.2 with the course and route rotated
               by 25 degrees (``--rotate 25``, which implies the free prior).

Each grid's rows are written as ``sweep.json`` and ``sweep.md``
(``rows_to_json``, ``format_table``) under ``--out/<grid>/``, and compared
with the JAX rows cell by cell: collision runs,
the worlds whose outcome differs (from ``collided_mask``), and whether the
difference lies within the 4 of 50 worlds by which the JAX package's own
two paths differ (``docs/BASELINES.md``: 160-cycle float32 chaos).

    python -m cilqr_tpu_torch.scripts.production_sweeps [--grids r4_n50,...] [--no-kernels]
        [--out DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from cilqr_tpu_torch.ops import gridmap
from cilqr_tpu_torch.scripts import jax_noise
from cilqr_tpu_torch.sim import scenarios, sweep
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import SolverParams

REF_RATIO = 0.017 / 0.16
ENDPOINTS = (0.375, 0.5)
AWARE_BLIND = ("cilqr", "cilqr_base")
GRIDS = {
    "r4_n50": dict(sigmas=(0.0, 0.125, 0.25, 0.375, 0.5), algorithms=sweep.SWEEP_ALGORITHMS,
                   ratio=REF_RATIO, free_prior=False, rotate=0.0,
                   reference="docs/sweep_r4_n50/sweep.json"),
    "r5_refratio": dict(sigmas=ENDPOINTS, algorithms=AWARE_BLIND, ratio=REF_RATIO,
                        free_prior=False, rotate=0.0,
                        reference="docs/sweep_r5_pallas_n50/refratio/sweep.json"),
    "r5_theta02": dict(sigmas=ENDPOINTS, algorithms=AWARE_BLIND, ratio=0.2, free_prior=True,
                       rotate=0.0, reference="docs/sweep_r5_pallas_n50/theta02/sweep.json"),
    "r5_rot25": dict(sigmas=ENDPOINTS, algorithms=AWARE_BLIND, ratio=0.2, free_prior=True,
                     rotate=25.0, reference="docs/sweep_r5_pallas_n50/rot25/sweep.json"),
}
N_RUNS, N_CYCLES = 50, 160
SPREAD = 4  # worlds of 50 by which the JAX package's two paths differ per cell
ROOT = pathlib.Path(__file__).resolve().parents[2]


def run_grid(name: str, n_runs: int = N_RUNS, n_cycles: int = N_CYCLES, sigmas=None,
             algorithms=None, use_kernels: bool = True, dtype=torch.float32, device=None,
             town=None) -> list:
    """The rows of grid ``name`` (``GRIDS``), as the CLI's ``sweep`` runs
    it; ``sigmas`` / ``algorithms`` cut it to a subset, ``use_kernels=False``
    builds the costmaps on the oracle resample and propagation (the CLI's
    ``--no-kernels``).  ``town`` is the synthetic town prior (map,
    geometry), made here if not given."""
    device = resolve(device)
    g = GRIDS[name]
    p = dataclasses.replace(SolverParams(), horizon=40, w_uncertainty=5.0,
                            chord_frame_fit=abs(g["rotate"]) > 40.0)
    scenario = plan = None
    if g["rotate"]:
        scenario, plan = scenarios.rotate_scenario(
            scenarios.make_gauntlet(), scenarios.plan_for("compare"), float(np.deg2rad(g["rotate"])))
    if g["free_prior"]:
        gm = torch.zeros((512, 512), dtype=dtype, device=device)
        gg = gridmap.make_geom([115.0, -285.0], 0.5, 512, 512, dtype=dtype, device=device)
    else:
        gm, gg = town if town is not None else sweep.synthetic_town_prior(dtype, device)
    return sweep.run_sigma_sweep(
        sigmas if sigmas is not None else g["sigmas"],
        algorithms=algorithms if algorithms is not None else g["algorithms"],
        scenario=scenario, p=p, global_map=gm, global_geom=gg, n_runs=n_runs,
        n_cycles=n_cycles, sigma_theta_ratio=g["ratio"], use_kernels=use_kernels, dtype=dtype,
        plan=plan,
        noise_draws=jax_noise(n_cycles, n_runs, dtype, device), device=device)


def compare(rows: list, reference: list) -> list:
    """Per cell of ``rows``, its JAX row's collision runs and the worlds
    whose outcome differs: {"sigma_xy", "algorithm", "jax", "port",
    "worlds", "within"}."""
    ref = {(r["sigma_xy"], r["algorithm"]): r for r in reference}
    out = []
    for r in rows:
        j = ref[(r["sigma_xy"], r["algorithm"])]
        worlds = [i for i, (a, b) in enumerate(zip(r["collided_mask"], j["collided_mask"]))
                  if a != b]
        out.append(dict(sigma_xy=r["sigma_xy"], algorithm=r["algorithm"],
                        jax=j["collision_runs"], port=r["collision_runs"], worlds=worlds,
                        within=abs(r["collision_runs"] - j["collision_runs"]) <= SPREAD))
    return out


def comparison_table(name: str, cells: list) -> str:
    lines = [f"| grid | sigma_xy | algorithm | JAX collisions | port collisions | "
             f"differing worlds | within {SPREAD} of 50 |", "|---|---|---|---|---|---|---|"]
    for c in cells:
        lines.append(f"| {name} | {c['sigma_xy']} | {c['algorithm']} | {c['jax']} | {c['port']} | "
                     f"{' '.join(map(str, c['worlds'])) or '-'} | "
                     f"{'within' if c['within'] else 'OUTSIDE'} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cilqr_tpu_torch.scripts.production_sweeps")
    ap.add_argument("--grids", default=",".join(GRIDS))
    ap.add_argument("--no-kernels", action="store_true",
                    help="the oracle resample and propagation in the costmap build (no K5 / "
                         "K4): the port's second path, as the JAX package's XLA path is its")
    ap.add_argument("--out", default=str(ROOT / "docs" / "sweep_torch_h100"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.grids.split(",")
    town = None
    if any(not GRIDS[n]["free_prior"] for n in names):
        town = sweep.synthetic_town_prior(torch.float32, args.device)
    for name in names:
        rows = run_grid(name, use_kernels=not args.no_kernels, device=args.device, town=town)
        out = pathlib.Path(args.out) / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "sweep.json").write_text(sweep.rows_to_json(rows))
        (out / "sweep.md").write_text(sweep.format_table(rows) + "\n")
        print(f"## {name}\n\n{sweep.format_table(rows)}\n", flush=True)
        reference = json.loads((ROOT / GRIDS[name]["reference"]).read_text())
        print(comparison_table(name, compare(rows, reference)) + "\n", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
