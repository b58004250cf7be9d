"""Traffic ``mc``: back-to-back Monte-Carlo planning cycles.

Each timed call is one ``parallel.monte_carlo.monte_carlo(impl="fast")`` of
``batch`` simulated vehicles: per vehicle a localization covariance, sigmas
uniform in [``sigma_lo``, ``sigma_hi``], and its ego, the configuration's
start plus N(0, that sigma) on x, y and yaw, handed over as an ``MCSample``
drawn on the card from the seed, call after call.  Every vehicle propagates
the shared prior (the Town02 prior's window at the start, the obstacles'
boxes over it) under its own covariance (kernel K4) and solves on its own
map from the cold controls (the hybrid LM loop, K3).

Of ``check_calls`` of the window's calls, drawn from the seed, the answers
of ``check_lanes`` lanes, drawn from the seed, are kept and worked out again
by the reference in float64 after the window: each lane's map propagated
from the prior and its solve on that map.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import torch

from benchmarks import check as check_mod
from benchmarks import roofline, sampling
from benchmarks import world as world_mod
from benchmarks.reference import cilqr as ref
from benchmarks.reference import costmap as ref_costmap


class Kept(NamedTuple):
    sigmas: torch.Tensor  # (L, 3) float32
    egos: torch.Tensor    # (L, 4) float32
    X: torch.Tensor
    U: torch.Tensor
    J: torch.Tensor
    it: torch.Tensor


class Campaign(sampling.Traffic):
    def __init__(self, run):
        from cilqr_tpu_torch.models import obstacles as obs_mod
        from cilqr_tpu_torch.models import reference_path as rp
        from cilqr_tpu_torch.ops import gridmap, uncertainty_cuda
        from cilqr_tpu_torch.parallel import monte_carlo as mc
        from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams

        cfg, cell, dev = run.config, run.cell, run.device
        self.cfg, self.cell, self.dev, self.B = cfg, cell, dev, cell["batch"]
        self.p = dataclasses.replace(SolverParams(), **cfg["solver"])
        cm = cfg["costmap"]
        cp = dataclasses.replace(CostmapParams(), **cm)
        w = cfg["world"]
        start = w["start"]
        self.frame = world_mod.vehicle_frame(cfg, (start[0], start[1], start[3]))
        self.plan = world_mod.route(w)
        self.obs = world_mod.obstacles(w)
        self.sigma_lo, self.sigma_hi = tuple(cell["sigma_lo"]), tuple(cell["sigma_hi"])
        center = self.frame.center
        f32 = dict(dtype=torch.float32, device=dev)
        cp = mc.ensure_window_covers(cp, cp.rows, cp.cols, center, self.sigma_hi)
        band_plan = uncertainty_cuda.make_band_plan(cp, cp.rows, cp.cols, center, self.sigma_hi)
        self.prior = torch.tensor(self.frame.vehicle_map, **f32)
        geom = gridmap.make_geom(center, self.frame.res, cp.rows, cp.cols, torch.float32,
                                 device=dev)
        plan_xy, n = rp.pad_global_plan(self.p, self.plan, torch.float32, dev)
        ob = obs_mod.make_static_obstacles(self.p, self.obs[:, :2], self.obs[:, 3:5],
                                           self.obs[:, 2], dtype=torch.float32, device=dev)
        origin_xy = torch.tensor(self.frame.origin_xy, **f32)
        origin_yaw = torch.tensor(self.frame.origin_yaw, **f32)
        self.nominal = torch.tensor(start, **f32)
        self.lo = torch.tensor(self.sigma_lo, **f32)
        self.hi = torch.tensor(self.sigma_hi, **f32)
        self.solve = lambda sigmas, egos: mc.monte_carlo(
            self.p, cp, self.prior, geom, origin_xy, origin_yaw, plan_xy, n,
            mc.MCSample(sigmas, egos), ob, sigma_hi=self.sigma_hi, impl="fast",
            band_plan=band_plan, center=center)

    def draw(self):
        u = torch.rand((self.B, 3), generator=self.gen, dtype=torch.float32, device=self.dev)
        r = torch.randn((self.B, 3), generator=self.gen, dtype=torch.float32, device=self.dev)
        sigmas = self.lo + u * (self.hi - self.lo)
        noise = torch.stack([sigmas[:, 0] * r[:, 0], sigmas[:, 1] * r[:, 1],
                             torch.zeros_like(r[:, 0]), sigmas[:, 2] * r[:, 2]], dim=-1)
        return sigmas, self.nominal + noise

    def call(self, k: int):
        sigmas, egos = self.inputs(k)
        return sigmas, egos, self.solve(sigmas, egos)

    def keep(self, k: int, out, traced: bool = False) -> None:
        sigmas, egos, res = out
        li = self.lanes
        self.kept.offer(k, lambda: (sigmas[li], egos[li], res.X[li], res.U[li], res.J[li],
                                    res.iterations[li]))
        self.failed += sampling.failed(res.X, res.U)
        if traced:
            it = res.iterations.float()
            self.traced.append((sigmas, it.mean() / it.max().clamp(min=1.0)))

    def reference(self, kept: Kept, dtype) -> ref.Result:
        cm = self.cfg["costmap"]
        f = self.frame
        rows, cols = f.vehicle_map.shape
        radius = ref_costmap.required_radius(f.center, f.res, rows, cols, cm["chisquare_val"],
                                             self.sigma_hi)
        kw = dict(dtype=dtype, device=self.dev)
        prior = torch.as_tensor(f.vehicle_map, **kw)[None]
        maps = torch.cat([ref_costmap.propagate(
            prior, torch.tensor([f.center], **kw).expand(len(s), 2), f.res,
            torch.full((len(s),), f.origin_yaw, **kw), s, cm["chisquare_val"], radius)
            for s in kept.sigmas.to(dtype).split(16)])
        p = ref.Params.from_config(self.cfg["solver"])
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.dev)
        world = ref.World(t(self.plan), t(self.obs), maps, f.center, f.res, f.origin_xy,
                          f.origin_yaw)
        egos = kept.egos.to(dtype)
        return ref.solve(p, world, egos, ref.initial_controls(p, egos.shape[0], dtype, self.dev))

    def k4_bound_s(self) -> float:
        """The least time of the traced calls' K4 launches, on their fields:
        one launch per call, the shared prior read once."""
        cm, f = self.cfg["costmap"], self.frame
        rows, cols = f.vehicle_map.shape
        total = 0.0
        for sigmas, _ in self.traced:
            ops, n_bytes = 0.0, float(rows * cols * 4)
            for s in sigmas.split(1024):
                kw = dict(dtype=torch.float64, device=self.dev)
                sx, sy, rho = ref_costmap.fields(
                    torch.tensor([f.center], **kw).expand(len(s), 2), f.res, rows, cols,
                    torch.full((len(s),), f.origin_yaw, **kw), s.double())
                o, b = roofline.k4_work(sx, sy, rho, f.res, cm["chisquare_val"])
                ops, n_bytes = ops + o, n_bytes + b
            total += roofline.bound_s(n_bytes, ops)
        return total


def setup(run) -> Campaign:
    cam = Campaign(run)
    sampling.warm_up(cam, run.seed, 2)
    return cam


def window(run, cam: Campaign) -> None:
    from benchmarks.run import back_to_back

    n = run.cell["trace_calls"]
    back_to_back(run, cam.call, lambda k, out: cam.keep(k, out, run.trace and k < n), n)
    run.items = run.calls * cam.B
    run.failed = int(cam.failed)
    if run.trace:
        use = torch.stack([u for _, u in cam.traced])
        run.counters["lm_lane_use_pct"] = float(100.0 * use.mean())
        run.counters["k4_bound_s"] = cam.k4_bound_s()


def release(run, cam: Campaign):
    return cam, Kept(*cam.kept.joined())


def check(run, held) -> list:
    cam, kept = held
    r = cam.reference(kept, torch.float64)
    values = check_mod.numbers(check_mod.gaps(kept.X, kept.U, r), run.cell["lane_bar"])
    run.counters["record"] = check_mod.record(kept.X, kept.U, kept.J, kept.it, r)
    print("record " + repr(run.counters["record"]), file=sys.stderr)
    return check_mod.checks(values, run.cell["limits"])


def control(run, held, dtype=torch.bfloat16) -> dict:
    cam, kept = held
    r64 = cam.reference(kept, torch.float64)
    low = cam.reference(kept, dtype)
    return check_mod.numbers(check_mod.gaps(low.X, low.U, r64), run.cell["lane_bar"])
