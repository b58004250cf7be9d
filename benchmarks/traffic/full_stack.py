"""Traffic ``full_stack``: back-to-back batched closed-loop episodes.

Each timed call is one ``sim.plant.closed_loop_full_stack_batched`` of
``batch`` simulated vehicles over ``cycles`` planning cycles: per cycle and
vehicle the costmap at the true pose (corridor, obstacle raster, the
prior's resample with the box override (kernel K5), the propagation (K4)),
the localization noise, the hybrid solve on the noisy pose (the K3 loop)
and the plant's step.  The starts lie along the configuration's route,
``start_spread_m`` metres of it from the configuration's start, with
N(0, sigma) on y and yaw; they and the noise blocks are drawn on the card
from the seed, call after call, and handed to the loop.

Of ``check_calls`` of the window's calls, drawn from the seed, ``check_lanes``
lanes, drawn from the seed, are kept: their starts, their noise blocks and
what the loop records of them.  After the window the reference runs the
same closed loop on them in float64, from the same starts and draws, cycle
after cycle: the costmap at its own true pose, the noise, the solve on the
noisy pose warm-started from its own last controls, the plant's step.
Every cycle's true pose, noisy pose and J, and the final pose, are held
against the program's.
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
    x0: torch.Tensor     # (L, 4) the start handed to the loop
    draws: torch.Tensor  # (L, T, 3)
    start: torch.Tensor  # (L, T, 4) each cycle's true pose
    noisy: torch.Tensor  # (L, T, 4)
    J: torch.Tensor      # (L, T)
    it: torch.Tensor     # (L, T)
    final: torch.Tensor  # (L, 4) the pose after the last cycle


class Loop(NamedTuple):
    """The reference's closed loop on the kept lanes."""

    start: torch.Tensor
    noisy: torch.Tensor
    J: torch.Tensor
    it: torch.Tensor
    final: torch.Tensor


class Campaign(sampling.Traffic):
    def __init__(self, run):
        from cilqr_tpu_torch.models import obstacles as obs_mod
        from cilqr_tpu_torch.models import reference_path as rp
        from cilqr_tpu_torch.ops import costmap, gridmap, uncertainty_cuda
        from cilqr_tpu_torch.sim import plant
        from cilqr_tpu_torch.utils.params import CostmapParams, NoiseParams, SolverParams

        cfg, cell, dev = run.config, run.cell, run.device
        self.cfg, self.cell, self.dev, self.B = cfg, cell, dev, cell["batch"]
        self.T = cell["cycles"]
        self.p = dataclasses.replace(SolverParams(), **cfg["solver"])
        cp = dataclasses.replace(CostmapParams(), **cfg["costmap"])
        noise = cfg["noise"]
        w = cfg["world"]
        f32 = dict(dtype=torch.float32, device=dev)
        self.prior = world_mod.town_prior(w["town"])
        H, W = self.prior.values.shape
        gmap = torch.tensor(self.prior.values, **f32)
        ggeom = gridmap.make_geom(self.prior.center, self.prior.res, H, W, torch.float32,
                                  device=dev)
        self.plan = world_mod.route(w)
        self.obs = world_mod.obstacles(w)
        plan_xy, n = rp.pad_global_plan(self.p, self.plan, torch.float32, dev)
        ob = obs_mod.make_static_obstacles(self.p, self.obs[:, :2], self.obs[:, 3:5],
                                           self.obs[:, 2], dtype=torch.float32, device=dev)
        obs_xyyaw = torch.tensor(self.obs[:, :3], **f32)
        obs_size = torch.tensor(self.obs[:, 3:5], **f32)
        obs_mask = torch.ones(len(self.obs), **f32)
        xr, yr = costmap.corridor_center_bounds(cp, plan_xy, n)
        band = uncertainty_cuda.make_band_plan_bounds(cp, cp.rows, cp.cols, xr, yr,
                                                      (cp.sigma_x, cp.sigma_y, cp.sigma_theta))
        self.start = torch.tensor(w["start"], **f32)
        self.sigma = torch.tensor([noise["sigma_x"], noise["sigma_y"], noise["sigma_theta"]], **f32)
        self.solve = lambda draws, x0s: plant.closed_loop_full_stack_batched(
            self.p, cp, NoiseParams(**noise), gmap, ggeom, plan_xy, n, x0s, None, self.T,
            obstacles=ob, obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
            band_plan=band, noise_draws=draws)

    def draw(self):
        kw = dict(generator=self.gen, dtype=torch.float32, device=self.dev)
        u = torch.rand(self.B, **kw)
        r = torch.randn((self.B, 2), **kw)
        zero = torch.zeros_like(u)
        x0s = self.start + torch.stack([self.cell["start_spread_m"] * u, self.sigma[1] * r[:, 0],
                                        zero, self.sigma[2] * r[:, 1]], dim=-1)
        return x0s, torch.randn((self.T, self.B, 3), **kw)

    def call(self, k: int):
        x0s, draws = self.inputs(k)
        return x0s, draws, self.solve(draws, x0s)

    def keep(self, k: int, out, traced: bool = False) -> None:
        x0s, draws, (final, rec) = out
        li = self.lanes
        lane = lambda t: t[:, li].transpose(0, 1)
        self.kept.offer(k, lambda: (x0s[li], lane(draws), lane(rec["start_pos"]),
                                    lane(rec["noisy_pos"]), lane(rec["J"]),
                                    lane(rec["iterations"]), final[li]))
        self.failed += sampling.failed(final)
        if traced:
            self.traced.append((rec["start_pos"], rec["iterations"]))

    def traced_counters(self) -> dict:
        """What the traced calls' per-layer metrics read: their cycles, K5's
        bytes, K4's least time on the cycles' fields, the LM loop's lane use."""
        cm, f = self.cfg["costmap"], self.prior
        rows, cols, res = cm["rows"], cm["cols"], cm["resolution"]
        kw = dict(dtype=torch.float64, device=self.dev)
        plan, sig = torch.tensor(self.plan, **kw), torch.tensor(
            [[cm["sigma_x"], cm["sigma_y"], cm["sigma_theta"]]], **kw)
        cycles = len(self.traced) * self.T
        k4 = 0.0
        for start, _ in self.traced:
            for states in start.double():
                ops, n_bytes = 0.0, float(self.B * rows * cols * 4)  # the priors in
                for s in states.split(1024):
                    pose = s[:, [0, 1, 3]]
                    center = ref_costmap.corridor_center(plan, pose, cm["look_ahead_waypoints"],
                                                         cm["corridor_left"], cm["corridor_right"])
                    sx, sy, rho = ref_costmap.fields(center, res, rows, cols, pose[:, 2],
                                                     sig.expand(len(s), 3))
                    o, b = roofline.k4_work(sx, sy, rho, res, cm["chisquare_val"])
                    ops, n_bytes = ops + o, n_bytes + b
                k4 += roofline.bound_s(n_bytes, ops)
        use = [(it.float().mean(1) / it.float().amax(1).clamp(min=1.0)).mean()
               for _, it in self.traced]
        return {"cycles_traced": cycles, "k4_bound_s": k4,
                "k5_bytes": cycles * (2 * self.B * rows * cols * 4 + f.values.size * 4),
                "lm_lane_use_pct": float(100.0 * torch.stack(use).mean())}

    def reference(self, kept: Kept, dtype) -> Loop:
        """The closed loop of the kept lanes, cycle after cycle, from their
        starts and draws, in ``dtype``."""
        kw = dict(dtype=dtype, device=self.dev)
        t = lambda a: torch.as_tensor(a, **kw)
        cm = self.cfg["costmap"]
        L, T = kept.J.shape
        plan, obs, prior = t(self.plan), t(self.obs), t(self.prior.values)
        p = ref.Params.from_config(self.cfg["solver"])
        sig = self.sigma.to(dtype)
        x, U = kept.x0.to(dtype), ref.initial_controls(p, L, dtype, self.dev)
        out = []
        for c in range(T):
            d = kept.draws[:, c].to(dtype)
            noisy = x + torch.stack([sig[0] * d[:, 0], sig[1] * d[:, 1], torch.zeros_like(d[:, 0]),
                                     sig[2] * d[:, 2]], dim=-1)
            maps, centers = ref_costmap.tick(cm, plan, obs, prior, self.prior.center,
                                             self.prior.res, x[:, [0, 1, 3]])
            world = ref.World(plan, obs, maps, centers, cm["resolution"], x[:, :2], x[:, 3])
            res = ref.solve(p, world, noisy, U)
            out.append((x, noisy, res.J, res.iterations))
            U = res.U
            x = ref.step(p, x, U[:, 0])
        return Loop(*(torch.stack(parts, 1) for parts in zip(*out)), x)


def numbers(kept: Kept, r: Loop, cell) -> dict:
    """A lane's gap: the widest over its cycles of the true pose's and the
    noisy pose's gap and of J's gap relative to the reference's, and the
    final pose's gap."""
    d = lambda a, b: torch.nan_to_num((a.double() - b.double()).abs().flatten(1).amax(1),
                                      nan=float("inf"))
    dj = torch.nan_to_num(((kept.J.double() - r.J.double()).abs()
                           / r.J.double().abs().clamp(min=1.0)).amax(1), nan=float("inf"))
    g = torch.stack([d(kept.start, r.start), d(kept.noisy, r.noisy), dj,
                     d(kept.final, r.final)]).amax(0)
    return check_mod.numbers(g, cell["lane_bar"])


def setup(run) -> Campaign:
    cam = Campaign(run)
    sampling.warm_up(cam, run.seed, 2)
    return cam


def window(run, cam: Campaign) -> None:
    from benchmarks.run import back_to_back

    n = run.cell["trace_calls"]
    back_to_back(run, cam.call, lambda k, out: cam.keep(k, out, run.trace and k < n), n)
    run.items = run.calls * cam.B * cam.T
    run.failed = int(cam.failed)
    if run.trace:
        run.counters.update(cam.traced_counters())


def release(run, cam: Campaign):
    return cam, Kept(*cam.kept.joined())


def check(run, held) -> list:
    cam, kept = held
    r = cam.reference(kept, torch.float64)
    rel = (kept.J.double() - r.J.double()).abs() / r.J.double().abs().clamp(min=1.0)
    rec = {"J_rel_max": float(rel.max()), "J_rel_median": float(rel.median()),
           "iterations_differ_pct": float(100.0 * (kept.it.cpu().long() != r.it.cpu().long())
                                          .double().mean()),
           "lanes": int(kept.J.shape[0]), "cycles": int(kept.J.shape[1])}
    run.counters["record"] = rec
    print("record " + repr(rec), file=sys.stderr)
    return check_mod.checks(numbers(kept, r, run.cell), run.cell["limits"])


def control(run, held, dtype=torch.bfloat16) -> dict:
    """The reference's closed loop in ``dtype`` in the program's place, held
    to the float64 one."""
    cam, kept = held
    r64 = cam.reference(kept, torch.float64)
    low = cam.reference(kept, dtype)
    as_program = kept._replace(start=low.start, noisy=low.noisy, J=low.J, final=low.final)
    return numbers(as_program, r64, run.cell)
