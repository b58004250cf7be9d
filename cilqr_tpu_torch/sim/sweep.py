"""Sigma-sweep campaign: measure WHERE the uncertainty term changes outcomes.

Port of ``cilqr_tpu/sim/sweep.py``.  The reference's core experimental
claim is that uncertainty-aware CILQR beats the non-aware baseline under
localization noise (experiment design
``CILQR/src/ilqr/src/batch_dataprocess.py:459-475``, noise overrides
``ilqr/launch/Experiment.launch:7-12``).  This module reproduces that claim
measurably: a grid of noise levels x algorithms on the ``gauntlet`` scenario
(a chicane between SAT-only walls — ``sim.scenarios.make_gauntlet``), with
the costmap engine's propagation sigmas matched to the injected noise, as
the reference experiment sets both from the same launch values.

Each cell is one batched loop over the runs, run eagerly (the JAX package
compiles one program per algorithm with sigma traced; here nothing is
compiled, so there is no compile cache and no traced sigma), planned by
``runner.make_plan_step`` with the cell's noise:

  * map consumers (`cilqr`, `frenet_propagation`):
    ``plant.closed_loop_full_stack_batched`` with the cell's
    ``costmap_sigmas``: per cycle the resample kernel K5, the propagation
    kernel K4 over a band plan sized for the sweep's largest sigma
    (``uncertainty_cuda.make_band_plan_bounds`` over
    ``costmap.corridor_center_bounds``), and the planner (`cilqr`: the
    hybrid solve, K3);
  * blind cells: ``plant.closed_loop_batched`` with the planner as its hook
    (`cilqr_base`: K1; `ccnmpc`: the two-phase solve, K2).

At each sigma every algorithm gets the same pre-drawn (T, n_runs, 3)
standard-normal block from ``seed`` (the JAX package's ``per_run_keys``
gives it the same guarantee), so paired comparisons across algorithm rows
are exact.

Outputs per (sigma, algorithm): collision-run count, min wall clearance,
min obstacle distance, mean speed — the batch_dataprocess.py metric set
plus the wall-clearance column the walled scenario adds.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from math import comb
from typing import Optional, Sequence

import numpy as np
import torch

from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.ops import gridmap, uncertainty_cuda
from cilqr_tpu_torch.sim import plant, runner, scenarios
from cilqr_tpu_torch.utils import maps
from cilqr_tpu_torch.utils import metrics as metrics_mod
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import CostmapParams, NoiseParams, SolverParams

#: The complete reference comparison axis under noise: uncertainty-aware vs
#: blind CILQR, the Frenet propagation-vs-origin ablation, chance-constrained
#: NMPC and risk-bounded RRT (batch_dataprocess.py:458-463).
SWEEP_ALGORITHMS = (
    "cilqr", "cilqr_base", "frenet_origin", "frenet_propagation",
    "ccnmpc", "nrb_rrt",
)

#: Algorithms that consume the per-cycle uncertainty costmap.  The blind
#: ablations discard it BY DEFINITION (the CILQR_Base / Frenet-origin /
#: CCNMPC / NRB-RRT nodes never subscribe to the map topic), so skipping
#: the build for them is faithful; CCNMPC and NRB-RRT instead receive the
#: injected noise sigmas directly (their own uncertainty machinery).
MAP_CONSUMERS = ("cilqr", "frenet_propagation")


def matched_costmap_params(cp: CostmapParams, sigma_xy: float,
                           sigma_theta: float) -> CostmapParams:
    """Costmap propagation sigmas matched to the injected noise, with the
    fixed window radius sized to cover the worst-case 95% ellipse
    (``costmap.required_window_radius``)."""
    cp = dataclasses.replace(cp, sigma_x=sigma_xy, sigma_y=sigma_xy, sigma_theta=sigma_theta)
    r = costmap_mod.required_window_radius(cp, cp.rows, cp.cols)
    if r > cp.window_radius:
        cp = dataclasses.replace(cp, window_radius=r)
    return cp


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def wall_clearance(rec, scenario: scenarios.Scenario, ego_width: float,
                   ego_length: float = 4.79):
    """Min distance from the ego side to the nearest wall inner face over a
    recorded batch (runs, cycles, 4).

    Walls are arbitrary OBBs (``Scenario.walls_xyyaw`` carries per-wall yaw)
    — for each wall, the ego center's lateral offset along the wall normal
    minus half wall thickness minus half ego width, counted only while the
    ego is alongside the wall (longitudinal overlap with the wall span,
    grown by half the ego length).  Returns (runs,) or None without walls.
    """
    if scenario.n_walls == 0:
        return None
    sp = _np(rec["start_pos"]).astype(np.float64)  # (runs, T, 4)
    x, y = sp[..., 0], sp[..., 1]
    L, Wt = float(scenario.wall_size[0]), float(scenario.wall_size[1])
    clear = np.full(x.shape, np.inf)
    for wx, wy, wyaw in np.asarray(scenario.walls_xyyaw, np.float64):
        c, s = np.cos(wyaw), np.sin(wyaw)
        dx, dy = x - wx, y - wy
        lon = c * dx + s * dy
        lat = -s * dx + c * dy
        alongside = np.abs(lon) <= L / 2.0 + ego_length / 2.0
        cw = np.abs(lat) - Wt / 2.0 - ego_width / 2.0
        clear = np.minimum(clear, np.where(alongside, cw, np.inf))
    # runs that never pass a wall contribute nothing (all-inf row)
    return clear.min(axis=-1)


def load_prior(yaml_path: str, dtype=torch.float32, device=None):
    """(global map, geometry) of a map_server YAML (``maps.load_map``),
    unknown cells at 100, on ``device``."""
    occ, info = maps.load_map(yaml_path)
    arr, center = maps.to_gridmap_array(occ, info, unknown_value=100.0)
    device = resolve(device)
    return (torch.as_tensor(arr, dtype=dtype, device=device),
            gridmap.make_geom(center, info.resolution, arr.shape[0], arr.shape[1], dtype=dtype,
                              device=device))


def synthetic_town_prior(dtype=torch.float32, device=None):
    """``load_prior`` of the synthetic Town02-style map
    (``maps.make_synthetic_town``: 1506 x 1506 cells at 0.2 m), written to
    and read back from a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="cilqr_town_") as d:
        return load_prior(maps.make_synthetic_town(d), dtype, device)


def sweep_band_plan(cp: CostmapParams, plan: torch.Tensor, n) -> uncertainty_cuda.BandPlan:
    """Row bands for every corridor center the route can produce at ``cp``'s
    (the sweep's largest) sigmas."""
    xr, yr = costmap_mod.corridor_center_bounds(cp, plan, n)
    return uncertainty_cuda.make_band_plan_bounds(cp, cp.rows, cp.cols, xr, yr,
                                                  (cp.sigma_x, cp.sigma_y, cp.sigma_theta))


def run_cell(algorithm: str, p: SolverParams, cp: CostmapParams, scenario: scenarios.Scenario,
             plan: torch.Tensor, n, x0s: torch.Tensor, draws: torch.Tensor, s_xy: float,
             s_th: float, global_map, global_geom, use_kernels: bool, band_plan=None,
             nrb_params=None) -> dict:
    """One (sigma, algorithm) cell: ``draws`` (T, runs, 3) through the batched
    loop of the cell's kind.  ``cp`` must already be window-sized for the
    largest sigma the sweep feeds (``matched_costmap_params``), and
    ``band_plan`` (with ``use_kernels``) sized for it.  `nrb_rrt` samples in
    the scenario's corridor band (``runner.nrb_params_for_scenario``) unless
    ``nrb_params`` is given.  Returns the record as (runs, T, ...) tensors."""
    dtype, dev = x0s.dtype, x0s.device
    ob, obs_xyyaw, obs_size, obs_mask = runner.build_scenario_inputs(p, scenario, dtype, dev)
    noise = NoiseParams(s_xy, s_xy, s_th)
    obs_kw = dict(obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask)
    if algorithm == "nrb_rrt" and nrb_params is None:
        nrb_params = runner.nrb_params_for_scenario(p, scenario)
    plan_step = runner.make_plan_step(algorithm, p, noise, plan, n, obstacles=ob,
                                      nrb_params=nrb_params)
    if algorithm in MAP_CONSUMERS:
        sig3 = torch.tensor([s_xy, s_xy, s_th], dtype=dtype, device=dev)
        _, rec = plant.closed_loop_full_stack_batched(
            p, cp, noise, global_map, global_geom, plan, n, x0s, None, draws.shape[0],
            obstacles=ob, band_plan=band_plan if use_kernels else None, costmap_sigmas=sig3,
            use_kernels=use_kernels, plan_step_batched=plan_step, noise_draws=draws, **obs_kw)
    else:
        _, rec = plant.closed_loop_batched(p, noise, plan, n, x0s, None, draws.shape[0],
                                           obstacles=ob, noise_draws=draws,
                                           plan_step_batched=plan_step, **obs_kw)
    return runner.runs_first(rec)


def run_sigma_sweep(
    sigmas_xy: Sequence[float],
    algorithms: Sequence[str] = SWEEP_ALGORITHMS,
    scenario: Optional[scenarios.Scenario] = None,
    p: Optional[SolverParams] = None,
    cp: Optional[CostmapParams] = None,
    global_map=None,
    global_geom=None,
    n_runs: int = 10,
    n_cycles: int = 160,
    seed: int = 0,
    sigma_theta_ratio: float = 0.017 / 0.16,
    use_kernels: bool = True,
    dtype=torch.float32,
    plan=None,
    nrb_params=None,
    noise_draws=None,
    device=None,
) -> list[dict]:
    """Run the (sigma x algorithm) grid; returns one result row per cell.

    Every algorithm sees the identical noise block at each sigma (drawn once
    from ``seed``, or ``noise_draws`` (n_cycles, n_runs, 3));
    costmap-consuming algorithms get per-cycle propagated costmaps whose
    sigmas match the injected noise (the launch/rqt_reconfigure matching of
    the reference experiment).  The costmap window and band plan are sized
    once, for the largest sigma of the grid.  Without ``global_map`` the
    synthetic Town02-style prior is made (``synthetic_town_prior``).

    ``plan`` overrides the scenario's default global route (pass the
    rotated route when sweeping a rotated-corridor site).
    """
    device = resolve(device)
    sc = scenario if scenario is not None else scenarios.make_gauntlet()
    p = p if p is not None else SolverParams()
    cp = cp if cp is not None else CostmapParams()
    if global_map is None:
        global_map, global_geom = synthetic_town_prior(dtype, device)
    if plan is None:
        plan = scenarios.plan_for(sc.name if sc.name in scenarios._SCENARIOS else "compare")

    # window and bands sized once at the sweep maximum
    s_max = max(float(s) for s in sigmas_xy)
    cp_max = matched_costmap_params(cp, s_max, s_max * sigma_theta_ratio)
    plan_t, n = rp.pad_global_plan(p, np.asarray(plan), dtype=dtype, device=device)
    band_plan = None
    if use_kernels and any(a in MAP_CONSUMERS for a in algorithms):
        band_plan = sweep_band_plan(cp_max, plan_t, n)
    x0s = torch.as_tensor(np.asarray(sc.start, np.float64), dtype=dtype,
                          device=device).expand(n_runs, 4).contiguous()
    draws = runner.noise_block((n_cycles, n_runs, 3), None, noise_draws, seed, dtype, device)

    rows = []
    for algo in algorithms:
        for s_xy in sigmas_xy:
            s_th = s_xy * sigma_theta_ratio
            rec = run_cell(algo, p, cp_max, sc, plan_t, n, x0s, draws, float(s_xy), float(s_th),
                           global_map, global_geom, use_kernels, band_plan, nrb_params)
            rows.append(summarize_cell(rec, sc, p, algo, float(s_xy), float(s_th), n_runs))
    rows.sort(key=lambda r: (r["sigma_xy"], SWEEP_ALGORITHMS.index(r["algorithm"])
                             if r["algorithm"] in SWEEP_ALGORITHMS else 99))
    return rows


def summarize_cell(rec, sc: scenarios.Scenario, p: SolverParams, algo: str, s_xy: float,
                   s_th: float, n_runs: int) -> dict:
    """One result row from a (runs, cycles, ...) record."""
    collided = _np(rec["collided"])  # (runs, T)
    start_pos = rec["start_pos"]
    obs_xy = torch.as_tensor(sc.obstacles_xyyaw[:, :2], dtype=start_pos.dtype,
                             device=start_pos.device)
    per_run = metrics_mod.analyze_batch(start_pos, obs_xy, dt=p.timestep)
    wc = wall_clearance(rec, sc, p.width, ego_length=p.length)
    run_collided = collided.sum(axis=-1) > 0
    row = {
        "sigma_xy": float(s_xy),
        "sigma_theta": round(float(s_th), 4),
        "algorithm": algo,
        "collision_runs": int(run_collided.sum()),
        "n_runs": n_runs,
        # per-run bitmask: worlds are shared across algorithms at each
        # sigma (identical noise draws), so paired (McNemar-style)
        # comparisons across algorithm rows are exact
        "collided_mask": "".join("1" if c else "0" for c in run_collided),
        "velocity_mean": round(float(np.mean(per_run["velocity"].mean)), 3),
        "min_obstacle_distance": round(float(np.min(per_run["distance_to_obstacles"].min)), 3),
        "mean_jerk": round(float(np.mean(per_run["mean_jerk"])), 4),
    }
    if wc is not None:
        # runs never longitudinally alongside a wall (+inf) are dropped;
        # when every run is +inf the keys are still present, as float NaN,
        # which ``rows_to_json`` writes as a JSON null
        wcf = wc[np.isfinite(wc)]
        row["min_wall_clearance"] = round(float(wcf.min()), 3) if wcf.size else float("nan")
        row["mean_min_wall_clearance"] = (round(float(wcf.mean()), 3) if wcf.size
                                          else float("nan"))
    return row


def rows_to_json(rows: list[dict]) -> str:
    """Serialize sweep rows to STRICT JSON (indent=2): a NaN (the all-inf
    wall-clearance contract above) becomes null, never the non-standard
    ``NaN`` token."""
    def _clean(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        return v

    return json.dumps([{k: _clean(v) for k, v in r.items()} for r in rows], indent=2)


def paired_sign_test(row_a: dict, row_b: dict) -> dict:
    """Exact two-sided sign test on the paired per-run collision outcomes
    of two sweep rows that shared their noise worlds.

    Every algorithm column at a given sigma runs the IDENTICAL noise draws,
    so the two ``collided_mask`` strings are paired observations; the
    discordant counts (worlds that killed only A / only B) carry all the
    comparative information (McNemar).  Returns the counts and the exact
    binomial two-sided p-value.
    """
    a, b = row_a["collided_mask"], row_b["collided_mask"]
    if len(a) != len(b):
        raise ValueError("rows have different run counts")
    only_a = sum(1 for x, y in zip(a, b) if x == "1" and y == "0")
    only_b = sum(1 for x, y in zip(a, b) if x == "0" and y == "1")
    both = sum(1 for x, y in zip(a, b) if x == "1" and y == "1")
    n = only_a + only_b
    if n == 0:
        pv = 1.0
    else:
        tail = sum(comb(n, k) for k in range(0, min(only_a, only_b) + 1))
        pv = min(1.0, 2.0 * tail / 2.0**n)
    return {"only_a": only_a, "only_b": only_b, "both": both, "n_discordant": n, "p_value": pv}


def format_table(rows: list[dict]) -> str:
    """Markdown table of sweep rows."""
    cols = ["sigma_xy", "algorithm", "collision_runs", "min_wall_clearance",
            "mean_min_wall_clearance", "min_obstacle_distance",
            "velocity_mean", "mean_jerk"]
    have = [c for c in cols if any(c in r for r in rows)]
    out = ["| " + " | ".join(have) + " |",
           "|" + "|".join("---" for _ in have) + "|"]
    for r in rows:
        out.append("| " + " | ".join(
            "" if r.get(c) is None
            or (isinstance(r[c], float) and not np.isfinite(r[c]))
            else str(r[c]) for c in have) + " |")
    return "\n".join(out)
