"""Traffic ``fleet``: back-to-back batched planner solves on one shared world.

Each timed call is one ``solver_batched.run_steps_batched(impl="mega")`` of
``batch`` ego hypotheses: the configuration's start plus N(0, sigma) on x,
y and yaw (sigma from the configuration's ``noise``), drawn on the card from
the seed, call after call; every call starts from the cold controls of
iLQR.cpp:9-15.  The world is the configuration's route and obstacles and
one costmap that the benchmark makes at the nominal pose.

Of ``check_calls`` of the window's calls, drawn from the seed, the answers
of ``check_lanes`` lanes, drawn from the seed, are kept and solved again by
the reference in float64 after the window.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import torch

from benchmarks import check as check_mod
from benchmarks import sampling
from benchmarks import world as world_mod
from benchmarks.reference import cilqr as ref


class Kept(NamedTuple):
    """The sampled lanes of the checked calls."""

    egos: torch.Tensor  # (L, 4) float32
    X: torch.Tensor
    U: torch.Tensor
    J: torch.Tensor
    it: torch.Tensor


class Fleet(sampling.Traffic):
    """The program's side of the cell: its world, its call, the draws."""

    def __init__(self, run):
        from cilqr_tpu_torch.models import obstacles as obs_mod
        from cilqr_tpu_torch.models import reference_path as rp
        from cilqr_tpu_torch.models import solver, solver_batched
        from cilqr_tpu_torch.models import uncertainty as unc_mod
        from cilqr_tpu_torch.utils.params import SolverParams

        cfg, cell, dev = run.config, run.cell, run.device
        self.cfg, self.cell, self.dev, self.B = cfg, cell, dev, cell["batch"]
        self.p = dataclasses.replace(SolverParams(), **cfg["solver"])
        w = cfg["world"]
        start = w["start"]
        self.frame = world_mod.vehicle_frame(cfg, (start[0], start[1], start[3]))
        self.costmap = world_mod.world_costmap(cfg, self.frame, dev)
        self.plan = world_mod.route(w)
        self.obs = world_mod.obstacles(w)
        f32 = dict(dtype=torch.float32, device=dev)
        plan_xy, n = rp.pad_global_plan(self.p, self.plan, torch.float32, dev)
        ob = obs_mod.make_static_obstacles(self.p, self.obs[:, :2], self.obs[:, 3:5],
                                           self.obs[:, 2], dtype=torch.float32, device=dev)
        umap = unc_mod.make_uncertainty_map(self.costmap, self.frame.center, self.frame.res,
                                            self.frame.origin_xy, self.frame.origin_yaw,
                                            dtype=torch.float32, device=dev)
        U0 = solver.initial_controls(self.p, torch.float32, dev)
        self.U0 = U0.expand(self.B, *U0.shape).contiguous()
        noise = cfg["noise"]
        self.nominal = torch.tensor(start, **f32)
        self.sigma = torch.tensor([noise["sigma_x"], noise["sigma_y"], 0.0, noise["sigma_theta"]],
                                  **f32)
        self.solve = lambda egos: solver_batched.run_steps_batched(
            self.p, plan_xy, n, egos, self.U0, ob, umap, impl="mega")

    def draw(self) -> torch.Tensor:
        r = torch.randn((self.B, 4), generator=self.gen, dtype=torch.float32, device=self.dev)
        return self.nominal + self.sigma * r

    def call(self, k: int):
        egos = self.inputs(k)
        return egos, self.solve(egos)

    def keep(self, k: int, out, traced: bool = False) -> None:
        egos, res = out
        li = self.lanes
        self.kept.offer(k, lambda: (egos[li], res.X[li], res.U[li], res.J[li],
                                    res.iterations[li]))
        self.failed += sampling.failed(res.X, res.U)
        if traced:
            self.traced.append(res.iterations.sum())

    def reference(self, kept: Kept, dtype) -> ref.Result:
        p = ref.Params.from_config(self.cfg["solver"])
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.dev)
        world = ref.World(t(self.plan), t(self.obs), self.costmap.to(dtype), self.frame.center,
                          self.frame.res, self.frame.origin_xy, self.frame.origin_yaw)
        egos = kept.egos.to(dtype)
        return ref.solve(p, world, egos, ref.initial_controls(p, egos.shape[0], dtype, self.dev))


def setup(run) -> Fleet:
    fl = Fleet(run)
    sampling.warm_up(fl, run.seed, 2)
    return fl


def window(run, fl: Fleet) -> None:
    from benchmarks.run import back_to_back

    n = run.cell["trace_calls"]
    back_to_back(run, fl.call, lambda k, out: fl.keep(k, out, run.trace and k < n), n)
    run.items = run.calls * fl.B
    run.failed = int(fl.failed)
    if run.trace:
        run.counters["iterations_traced"] = float(torch.stack(fl.traced).sum())
        run.counters["batch"] = fl.B
        run.counters["horizon"] = fl.p.horizon
        run.counters["samples"] = fl.p.n_closest_samples
        run.counters["obstacles"] = fl.p.max_obstacles


def release(run, fl: Fleet):
    return fl, Kept(*fl.kept.joined())


def check(run, held) -> list:
    fl, kept = held
    r = fl.reference(kept, torch.float64)
    values = check_mod.numbers(check_mod.gaps(kept.X, kept.U, r), run.cell["lane_bar"])
    run.counters["record"] = check_mod.record(kept.X, kept.U, kept.J, kept.it, r)
    print("record " + repr(run.counters["record"]), file=sys.stderr)
    return check_mod.checks(values, run.cell["limits"])


def control(run, held, dtype=torch.bfloat16) -> dict:
    """The control: the reference in ``dtype`` in the program's place, held
    to the float64 reference by the same numbers."""
    fl, kept = held
    r64 = fl.reference(kept, torch.float64)
    low = fl.reference(kept, dtype)
    return check_mod.numbers(check_mod.gaps(low.X, low.U, r64), run.cell["lane_bar"])
