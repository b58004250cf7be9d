"""Command-line experiment runner — the framework's `roslaunch` + `rosbag
record` + offline-analysis pipeline in one invocation, on the PyTorch port.

Port of ``cilqr_tpu/__main__.py``.  Replaces the reference bring-up
sequence (SURVEY.md §3.4: CARLA server -> carla-ros-bridge -> vehiclepub ->
map_server+local_costmap -> ilqr node -> rosbag record -> dataprocess.py)
with:

    python -m cilqr_tpu_torch run --scenario success1 --cycles 120 \
        --out /tmp/exp --sigma-x 0.16 --sigma-y 0.16 --sigma-theta 0.017

    python -m cilqr_tpu_torch analyze /tmp/exp/experiment.log --scenario success1

    python -m cilqr_tpu_torch compare --full-stack --algorithms cilqr,ccnmpc,nrb_rrt

    python -m cilqr_tpu_torch sweep --sigmas 0.0,0.25,0.5 --runs 10

    python -m cilqr_tpu_torch bench

Every subcommand runs on the card unless ``--device cpu`` says otherwise;
without a card the first allocation fails with PyTorch's own error.  The
flags are the JAX CLI's, but ``--no-pallas`` is ``--no-kernels`` (the
oracle propagation in the costmap build).  ``bench`` runs
``cilqr_tpu_torch.benchmark`` (one JSON line; its knobs are the BENCH_*
environment variables).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np


def _load_global_map(path_or_none, out_dir=None, device=None):
    """Global prior map for the per-cycle map_engine pipeline.

    ``path_or_none``: a map_server YAML (Town02.yaml / h301.yaml semantics —
    ``utils/maps.load_map`` parses image/resolution/origin/negate/thresholds);
    None synthesizes a Town02-style map (in ``out_dir``, or a temporary
    directory).  Returns (global_map, global_geom) on ``device``.
    """
    import torch

    from cilqr_tpu_torch.sim import sweep
    from cilqr_tpu_torch.utils import maps

    if path_or_none is None and out_dir is None:
        return sweep.synthetic_town_prior(torch.float32, device)
    if path_or_none is None:
        path_or_none = maps.make_synthetic_town(str(out_dir))
    return sweep.load_prior(path_or_none, torch.float32, device)


def _costmap_kwargs(args, out_dir) -> dict:
    """The per-cycle costmap pipeline's arguments for ``--map`` /
    ``--full-stack`` (kernels K5 and K4 on the card), else none."""
    if args.map is None and not args.full_stack:
        return {}
    from cilqr_tpu_torch.utils.params import CostmapParams

    gm, gg = _load_global_map(args.map, out_dir=out_dir / "town", device=args.device)
    return {"costmap_params": CostmapParams(), "global_map": gm, "global_geom": gg}


def _cmd_run(args) -> int:
    import torch

    from cilqr_tpu_torch.sim import runner, scenarios
    from cilqr_tpu_torch.utils import explog, metrics, viz
    from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

    p = dataclasses.replace(
        SolverParams(),
        horizon=args.horizon,
        desired_speed=args.desired_speed,
        w_uncertainty=args.w_uncertainty,
        # the long scenario's loop route has north/south legs — the global
        # y(x) parity fit cannot represent them (see reference_path.py)
        chord_frame_fit=(args.scenario == "long"),
    )
    noise = NoiseParams(args.sigma_x, args.sigma_y, args.sigma_theta)
    sc = scenarios.get_scenario(args.scenario)
    plan = scenarios.plan_for(args.scenario)
    x0 = np.array(sc.start) if args.x0 is None else np.array(
        [args.x0, args.y0, args.v0, args.yaw0])

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cm_kwargs = _costmap_kwargs(args, out_dir)
    with explog.ExperimentLog(out_dir / "experiment.log", "w") as log:
        rec = runner.run_experiment(
            p, noise, plan, x0, args.cycles, scenario=sc, seed=args.seed, log=log,
            algorithm=args.algorithm, device=args.device, **cm_kwargs)

    res = metrics.analyze_run(
        torch.as_tensor(rec["start_pos"]), torch.as_tensor(sc.obstacles_xyyaw[:, :2]),
        dt=p.timestep, planning_time=torch.as_tensor(rec["planning_time"]))
    metrics.export_csv([metrics.summary_row(args.scenario, res)], str(out_dir / "metrics.csv"))
    try:
        viz.plot_run(rec, sc.obstacles_xyyaw, path=str(out_dir / "run.png"))
    except ModuleNotFoundError as e:
        print(f"run.png not written: {e}", file=sys.stderr)

    pt = rec["planning_time"]
    summary = {
        "scenario": args.scenario,
        "cycles": int(args.cycles),
        "collisions": int(rec["collided"].sum()),
        "final_x": float(rec["start_pos"][-1, 0]),
        "planning_time_ms": {
            "p50": round(float(np.percentile(pt, 50)) * 1e3, 2),
            "p99": round(float(np.percentile(pt, 99)) * 1e3, 2),
        },
        "mean_iterations": round(float(rec["iterations"].mean()), 2),
        "out": str(out_dir),
    }
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_analyze(args) -> int:
    import torch

    from cilqr_tpu_torch.sim import scenarios
    from cilqr_tpu_torch.utils import explog, metrics

    data = explog.read_experiment_log(args.log)
    if data["start_pos"].shape[0] < 3:
        print("log has fewer than 3 records", file=sys.stderr)
        return 1
    sc = scenarios.get_scenario(args.scenario)
    window = scenarios.EVAL_WINDOWS[args.window] if args.window else None
    t = lambda a: torch.as_tensor(np.asarray(a), device=args.device)
    try:
        res = metrics.analyze_run(t(data["start_pos"]), t(sc.obstacles_xyyaw[:, :2]),
                                  planning_time=t(data["planning_time"]), window=window)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(metrics.summary_row(args.log, res), indent=2))
    return 0


def _cmd_bench(args) -> int:
    from cilqr_tpu_torch.benchmark import main as bench_main

    return bench_main(["--device", str(args.device)])


def _cmd_compare(args) -> int:
    """Algorithm-comparison campaign: the reference's multi-algorithm
    10-bag batches (batch_dataprocess.py:459-502) end to end."""
    from cilqr_tpu_torch.sim import runner, scenarios
    from cilqr_tpu_torch.utils import metrics
    from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

    noise = NoiseParams(args.sigma_x, args.sigma_y, args.sigma_theta)
    algos = tuple(args.algorithms.split(","))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # per-cycle uncertainty costmaps from the global prior — the complete
    # map_engine + planner pipeline; without it the uncertainty-consuming
    # variants degrade to their base algorithms (no costmap to consume)
    cm_kwargs = _costmap_kwargs(args, out_dir)

    all_rows, summary = [], {}
    for name in args.scenarios.split(","):
        sc = scenarios.get_scenario(name)
        p = dataclasses.replace(SolverParams(), horizon=args.horizon,
                                chord_frame_fit=(name == "long"))
        plan = scenarios.plan_for(name)
        x0 = np.array(sc.start) if args.x0 is None else np.array(
            [args.x0, args.y0, args.v0, 0.0])
        results, rows = runner.run_algorithm_comparison(
            p, noise, plan, x0, args.cycles, sc, algorithms=algos, n_runs=args.runs,
            seed=args.seed, device=args.device, **cm_kwargs)
        all_rows.extend(rows)
        for algo in algos:
            rs = results[algo][1]
            summary[f"{name}/{algo}"] = {
                "collision_runs": sum(1 for r in rs if r["collisions"] > 0),
                "velocity_mean": round(float(np.mean([r["velocity_mean"] for r in rs])), 3),
                "mean_jerk": round(float(np.mean([r["mean_jerk"] for r in rs])), 4),
                "min_obstacle_distance": round(
                    float(np.min([r["distance_to_obstacles_min"] for r in rs])), 3),
                "curvature_mean": round(float(np.mean([r["curvature_mean"] for r in rs])), 4),
            }

    metrics.export_csv(all_rows, str(out_dir / "comparison.csv"))
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_sweep(args) -> int:
    """Sigma-sweep campaign on the gauntlet scenario: the measured proof
    that the uncertainty term changes outcomes (sim/sweep.py)."""
    import torch

    from cilqr_tpu_torch.ops import gridmap
    from cilqr_tpu_torch.sim import scenarios, sweep as sweep_mod
    from cilqr_tpu_torch.utils.params import SolverParams

    p = dataclasses.replace(
        SolverParams(), horizon=args.horizon, w_uncertainty=args.w_uncertainty,
        # the global y(x) polyfit basis is rank-deficient for steep routes
        # (reference_path.py); rotated courses past ~40 degrees need the
        # chord-aligned fit
        chord_frame_fit=abs(args.rotate) > 40.0)
    gm = gg = None
    if args.map is not None:
        gm, gg = _load_global_map(args.map, device=args.device)
    scenario = plan = None
    if args.rotate:
        scenario, plan = scenarios.rotate_scenario(
            scenarios.make_gauntlet(), scenarios.plan_for("compare"),
            float(np.deg2rad(args.rotate)))
    if args.free_prior or (args.rotate and args.map is None):
        # A FREE global prior: the gauntlet's hazards enter through the bbox
        # rasterization channel (the ablation's information asymmetry), and
        # a rotated corridor would otherwise cut diagonally through the
        # synthetic town's buildings — phantom prior occupancy the SAT
        # ground truth knows nothing about.  Rotated and unrotated runs meant
        # for orientation comparison must BOTH use --free-prior.
        gm = torch.zeros((512, 512), dtype=torch.float32, device=args.device)
        gg = gridmap.make_geom([115.0, -285.0], 0.5, 512, 512, dtype=torch.float32,
                               device=args.device)
    rows = sweep_mod.run_sigma_sweep(
        [float(s) for s in args.sigmas.split(",")],
        algorithms=tuple(args.algorithms.split(",")),
        p=p, n_runs=args.runs, n_cycles=args.cycles, seed=args.seed,
        sigma_theta_ratio=args.sigma_theta_ratio, use_kernels=not args.no_kernels,
        global_map=gm, global_geom=gg, scenario=scenario, plan=plan, device=args.device)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "sweep.json").write_text(sweep_mod.rows_to_json(rows))
    (out_dir / "sweep.md").write_text(sweep_mod.format_table(rows) + "\n")
    print(sweep_mod.format_table(rows))
    return 0


def main(argv=None) -> int:
    from cilqr_tpu_torch.sim.runner import ALGORITHMS
    from cilqr_tpu_torch.sim.sweep import SWEEP_ALGORITHMS

    ap = argparse.ArgumentParser(prog="cilqr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def with_device(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device the run allocates on (default: cuda)")
        return parser

    r = with_device(sub.add_parser("run", help="closed-loop scenario experiment"))
    r.add_argument("--scenario", default="success1")
    r.add_argument("--algorithm", default="cilqr",
                   help="one of sim.runner.ALGORITHMS")
    r.add_argument("--cycles", type=int, default=60)
    r.add_argument("--horizon", type=int, default=40)
    r.add_argument("--out", default="/tmp/cilqr_exp")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--desired-speed", type=float, default=5.0)
    r.add_argument("--w-uncertainty", type=float, default=1.0)
    # Experiment.launch:7-12 noise defaults
    r.add_argument("--sigma-x", type=float, default=0.16)
    r.add_argument("--sigma-y", type=float, default=0.16)
    r.add_argument("--sigma-theta", type=float, default=0.017)
    r.add_argument("--x0", type=float, default=None,
                   help="override the scenario's default spawn x")
    r.add_argument("--y0", type=float, default=-306.74)
    r.add_argument("--v0", type=float, default=4.0)
    r.add_argument("--yaw0", type=float, default=0.0)
    r.add_argument("--map", default=None, metavar="YAML",
                   help="map_server YAML (Town02.yaml/h301.yaml semantics) — "
                        "enables the per-cycle map_engine costmap pipeline "
                        "on that map")
    r.add_argument("--full-stack", action="store_true",
                   help="per-cycle costmap pipeline on a synthetic "
                        "Town02-style prior (same as --map but synthesized)")
    r.set_defaults(fn=_cmd_run)

    a = with_device(sub.add_parser("analyze", help="offline metrics from an experiment log"))
    a.add_argument("log")
    a.add_argument("--scenario", default="success1")
    a.add_argument("--window", type=int, default=None, choices=[1, 2, 3, 4],
                   help="spatial evaluation window (dataprocess.py:311-322)")
    a.set_defaults(fn=_cmd_analyze)

    b = with_device(sub.add_parser("bench", help="run the benchmark (one JSON line)"))
    b.set_defaults(fn=_cmd_bench)

    c = with_device(sub.add_parser(
        "compare", help="multi-algorithm closed-loop comparison campaign"))
    c.add_argument("--scenarios", default="success1,success2,success3,compare")
    c.add_argument("--algorithms", default=",".join(ALGORITHMS),
                   help="comma-separated subset of sim.runner.ALGORITHMS")
    c.add_argument("--runs", type=int, default=10)
    c.add_argument("--cycles", type=int, default=120)
    c.add_argument("--horizon", type=int, default=40)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--out", default="/tmp/cilqr_cmp")
    c.add_argument("--sigma-x", type=float, default=0.16)
    c.add_argument("--sigma-y", type=float, default=0.16)
    c.add_argument("--sigma-theta", type=float, default=0.017)
    c.add_argument("--x0", type=float, default=None,
                   help="override every scenario's default spawn x")
    c.add_argument("--y0", type=float, default=-306.74)
    c.add_argument("--v0", type=float, default=4.0)
    c.add_argument("--full-stack", action="store_true",
                   help="rebuild the uncertainty costmap every cycle from a "
                        "synthetic Town02-style prior (map_engine pipeline)")
    c.add_argument("--map", default=None, metavar="YAML",
                   help="map_server YAML to use as the global prior "
                        "(implies --full-stack)")
    c.set_defaults(fn=_cmd_compare)

    s = with_device(sub.add_parser(
        "sweep",
        help="sigma-sweep campaign on the gauntlet scenario (uncertainty "
             "term ablation: cilqr vs cilqr_base, frenet ablations)"))
    s.add_argument("--sigmas", default="0.0,0.125,0.25,0.375,0.5",
                   help="comma-separated sigma_xy grid [m]")
    s.add_argument("--algorithms", default=",".join(SWEEP_ALGORITHMS),
                   help="comma-separated subset of sim.sweep.SWEEP_ALGORITHMS "
                        "(default: the full batch_dataprocess.py:458-463 axis)")
    s.add_argument("--runs", type=int, default=10)
    s.add_argument("--cycles", type=int, default=160)
    s.add_argument("--horizon", type=int, default=40)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--w-uncertainty", type=float, default=5.0,
                   help="w_uncertainty for the aware planner (the launch-"
                        "file rosparam knob, Experiment.launch:11)")
    s.add_argument("--sigma-theta-ratio", type=float, default=0.017 / 0.16,
                   help="sigma_theta = ratio * sigma_xy (default: the "
                        "Experiment.launch:7-12 design ratio 0.017/0.16; "
                        "larger ratios blow up the propagation window "
                        "radius via the lever-arm term)")
    s.add_argument("--no-kernels", action="store_true",
                   help="the oracle propagation and resample in the costmap build "
                        "(no K5 / K4)")
    s.add_argument("--map", default=None, metavar="YAML",
                   help="map_server YAML as the global prior (default: "
                        "synthetic Town02-style map)")
    s.add_argument("--rotate", type=float, default=0.0, metavar="DEG",
                   help="rotate the whole gauntlet + route by DEG degrees "
                        "(proves the separation is not axis-aligned); "
                        "implies --free-prior unless --map is given")
    s.add_argument("--free-prior", action="store_true",
                   help="all-free global prior (hazards enter via the bbox "
                        "channel only) — required for orientation-"
                        "comparison pairs")
    s.add_argument("--out", default="/tmp/cilqr_sweep")
    s.set_defaults(fn=_cmd_sweep)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
