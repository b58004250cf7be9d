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
two paths differ (``docs/BASELINES.md``: 160-cycle float32 chaos), or
within a grid's own measured bar (``spread``).

To tell float32 chaos from a bias, a grid runs in float64 (the kernels
compute in float32, so K1 and K3 run their plain versions, ``route.plain()``,
and the costmap its oracle: ``--no-kernels``), on a subset of its cells
(``--algorithms``, ``--sigmas``), or on the noise block moved by K units in
the last place (``--nudge-ulps``).

    python -m cilqr_tpu_torch.scripts.production_sweeps [--grids r4_n50,...] [--no-kernels]
        [--dtype float32|float64] [--algorithms cilqr,...] [--sigmas 0.375,...]
        [--nudge-ulps K] [--out DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import torch

from cilqr_tpu_torch.ops import gridmap, route
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
    # its aware cells' counts move by up to 3 of 50 when the noise moves by
    # 1-2 ulps (docs/sweep_torch_h100/r5_theta02_diag/): its bar is the JAX
    # paths' 4 plus that measured spread
    "r5_theta02": dict(sigmas=ENDPOINTS, algorithms=AWARE_BLIND, ratio=0.2, free_prior=True,
                       rotate=0.0, reference="docs/sweep_r5_pallas_n50/theta02/sweep.json",
                       spread=7),
    "r5_rot25": dict(sigmas=ENDPOINTS, algorithms=AWARE_BLIND, ratio=0.2, free_prior=True,
                     rotate=25.0, reference="docs/sweep_r5_pallas_n50/rot25/sweep.json"),
}
N_RUNS, N_CYCLES = 50, 160
SPREAD = 4  # worlds of 50 by which the JAX package's two paths differ per cell (a grid's
           # own "spread" where one is measured)
ROOT = pathlib.Path(__file__).resolve().parents[2]


def nudged(x: torch.Tensor, ulps: int) -> torch.Tensor:
    """x with every element moved by ``ulps`` units in the last place of its
    dtype (up for ulps > 0, down for ulps < 0)."""
    toward = torch.full_like(x, math.inf if ulps > 0 else -math.inf)
    for _ in range(abs(ulps)):
        x = torch.nextafter(x, toward)
    return x


def run_grid(name: str, n_runs: int = N_RUNS, n_cycles: int = N_CYCLES, sigmas=None,
             algorithms=None, use_kernels: bool = True, dtype=torch.float32, device=None,
             town=None, nudge_ulps: int = 0) -> list:
    """The rows of grid ``name`` (``GRIDS``), as the CLI's ``sweep`` runs
    it; ``sigmas`` / ``algorithms`` cut it to a subset, ``use_kernels=False``
    builds the costmaps on the oracle resample and propagation (the CLI's
    ``--no-kernels``).  ``town`` is the synthetic town prior (map,
    geometry), made here if not given.  ``nudge_ulps`` moves every draw of
    the noise block by that many units in the last place of ``dtype``.  In
    float64 K1 and K3 run their plain versions (``route.plain()``), and the
    costmap kernels, which take float32 only, must be left out
    (``use_kernels=False``) on the card."""
    device = resolve(device)
    if dtype == torch.float64 and use_kernels and device.type == "cuda":
        raise ValueError("a float64 grid on the card takes use_kernels=False: the costmap "
                         "kernels compute in float32")
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
    with route.plain() if dtype == torch.float64 else contextlib.nullcontext():
        return sweep.run_sigma_sweep(
            sigmas if sigmas is not None else g["sigmas"],
            algorithms=algorithms if algorithms is not None else g["algorithms"],
            scenario=scenario, p=p, global_map=gm, global_geom=gg, n_runs=n_runs,
            n_cycles=n_cycles, sigma_theta_ratio=g["ratio"], use_kernels=use_kernels,
            dtype=dtype, plan=plan,
            noise_draws=nudged(jax_noise(n_cycles, n_runs, dtype, device), nudge_ulps),
            device=device)


def compare(rows: list, reference: list, spread: int = SPREAD) -> list:
    """Per cell of ``rows``, its JAX row's collision runs and the worlds
    whose outcome differs: {"sigma_xy", "algorithm", "jax", "port",
    "worlds", "within"}; within: the counts at most ``spread`` apart."""
    ref = {(r["sigma_xy"], r["algorithm"]): r for r in reference}
    out = []
    for r in rows:
        j = ref[(r["sigma_xy"], r["algorithm"])]
        worlds = [i for i, (a, b) in enumerate(zip(r["collided_mask"], j["collided_mask"]))
                  if a != b]
        out.append(dict(sigma_xy=r["sigma_xy"], algorithm=r["algorithm"],
                        jax=j["collision_runs"], port=r["collision_runs"], worlds=worlds,
                        within=abs(r["collision_runs"] - j["collision_runs"]) <= spread))
    return out


def comparison_table(name: str, cells: list, spread: int = SPREAD) -> str:
    lines = [f"| grid | sigma_xy | algorithm | JAX collisions | port collisions | "
             f"differing worlds | within {spread} of 50 |", "|---|---|---|---|---|---|---|"]
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
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="float64 runs K1 and K3 on their plain versions and, on the card, "
                         "needs --no-kernels")
    ap.add_argument("--algorithms", help="a subset of each grid's algorithms, comma-separated")
    ap.add_argument("--sigmas", help="a subset of each grid's sigma_xy, comma-separated")
    ap.add_argument("--nudge-ulps", type=int, default=0,
                    help="move every noise draw by K units in the last place")
    ap.add_argument("--out", default=str(ROOT / "docs" / "sweep_torch_h100"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.grids.split(",")
    dtype = getattr(torch, args.dtype)
    subset = dict(algorithms=args.algorithms and tuple(args.algorithms.split(",")),
                  sigmas=args.sigmas and tuple(float(s) for s in args.sigmas.split(",")))
    town = None
    if any(not GRIDS[n]["free_prior"] for n in names):
        town = sweep.synthetic_town_prior(dtype, args.device)
    for name in names:
        rows = run_grid(name, use_kernels=not args.no_kernels, device=args.device, town=town,
                        dtype=dtype, nudge_ulps=args.nudge_ulps, **subset)
        out = pathlib.Path(args.out) / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "sweep.json").write_text(sweep.rows_to_json(rows))
        (out / "sweep.md").write_text(sweep.format_table(rows) + "\n")
        spread = GRIDS[name].get("spread", SPREAD)
        table = comparison_table(name, compare(rows, json.loads(
            (ROOT / GRIDS[name]["reference"]).read_text()), spread), spread)
        (out / "compare.md").write_text(table + "\n")
        print(f"## {name}\n\n{sweep.format_table(rows)}\n", flush=True)
        print(table + "\n", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
