"""Traffic ``frenet``: back-to-back closed loops of the Frenet lattice baseline
in its UncertaintyPropagation mode on the full stack.

Each timed call is one ``sim.plant.closed_loop_full_stack_batched`` of
``batch`` simulated vehicles over ``cycles`` planning cycles with the plan
step ``sim.runner.make_plan_step("frenet_propagation", ...)``: per cycle and
vehicle the costmap at the true pose (corridor, obstacle raster, the
prior's resample with the box override (kernel K5), the propagation (K4)),
the localization noise, then the lattice on the noisy pose: every one of
the configuration's K candidates over the whole horizon, held to the
feasibility rules, both ego circles against every obstacle slot and the
vehicle's own map (cells at or over the threshold block, the mean
occupancy costs), the first of least cost taken; then the plant's step on
its first control.  No cycle reads anything from the card.  The starts lie
along the configuration's route, ``start_spread_m`` metres of it from the
configuration's start, with N(0, sigma) on y and yaw; they and the noise
blocks are drawn on the card from the seed, call after call.

The check does not follow a lane through its cycles: the lattice's choice
is discrete, and float32 rounding near a tie carries a lane onto another
path.  Of ``check_calls`` of the window's calls, ``check_lanes`` lanes and
``check_cycles`` cycles (cycle 0 among them), all drawn from the seed, each
(call, lane, cycle) keeps that cycle's true state, noise draw, noisy pose,
the plan (X, U, the chosen candidate's index and cost, whether any
candidate was feasible) and the next true state.  After the window the reference
(``benchmarks/reference/frenet.py``) builds that cycle's map at the true
state in float64 (``reference/costmap.tick``) and plans once from the noisy
pose it works out from the same draw.  Like is held to like: the row's gap
is the widest difference of the noisy pose, of the program's X and U
against the reference's X of the candidate the program chose and its
controls (the reference's brake where the program braked), of the next
state against the plant's step of the program's first control, and of the
program's cost of its candidate against the reference's (relative, to at
least 1; the least cost of all candidates where the program braked).  The
cost holds the map's term (``w_unc`` times the mean occupancy along the
candidate), which the trajectory does not show where the map moves no
choice.  A row is off, whatever its gap, where the reference finds the
program's candidate broken by more than ``slack_margin`` (relative to the
rule's bound), rates it worse than its own best clearly feasible candidate
by more than ``rank_rel`` (relative), or finds a clearly feasible candidate
where the program braked.
"""

from __future__ import annotations

import dataclasses
import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from benchmarks import check as check_mod
from benchmarks import sampling
from benchmarks import world as world_mod
from benchmarks.reference import cilqr as ref
from benchmarks.reference import costmap as ref_costmap
from benchmarks.reference import frenet as ref_fr
from benchmarks.traffic import full_stack


class Kept(NamedTuple):
    """One row per kept (call, lane, cycle)."""

    state: torch.Tensor  # (R, 4) the true state at the cycle's start
    draw: torch.Tensor   # (R, 3) the cycle's standard-normal noise draw
    noisy: torch.Tensor  # (R, 4) the pose the planner saw
    X: torch.Tensor      # (R, N+1, 4) the plan
    U: torch.Tensor      # (R, N, 2)
    pick: torch.Tensor   # (R,) the chosen candidate's index
    J: torch.Tensor      # (R,) its cost (the least of all where none was feasible)
    ok: torch.Tensor     # (R,) whether any candidate was feasible (else the brake)
    next: torch.Tensor   # (R, 4) the true state after the cycle


class Answer(NamedTuple):
    """A cycle's answer as ``numbers`` compares it: the program's, or the
    control's."""

    noisy: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    pick: torch.Tensor
    J: torch.Tensor
    ok: torch.Tensor
    next: torch.Tensor


class Campaign(sampling.Traffic):
    def __init__(self, run):
        from cilqr_tpu_torch.models import frenet
        from cilqr_tpu_torch.models import obstacles as obs_mod
        from cilqr_tpu_torch.models import reference_path as rp
        from cilqr_tpu_torch.ops import costmap, gridmap, uncertainty_cuda
        from cilqr_tpu_torch.sim import plant, runner
        from cilqr_tpu_torch.utils.params import CostmapParams, NoiseParams, SolverParams

        cfg, cell, dev = run.config, run.cell, run.device
        self.cfg, self.cell, self.dev, self.B = cfg, cell, dev, cell["batch"]
        self.T = cell["cycles"]
        self.p = dataclasses.replace(SolverParams(), **cfg["solver"])
        cp = dataclasses.replace(CostmapParams(), **cfg["costmap"])
        noise = NoiseParams(**cfg["noise"])
        w = cfg["world"]
        f32 = dict(dtype=torch.float32, device=dev)
        self.prior = world_mod.town_prior(w["town"])
        H, W = self.prior.values.shape
        gmap = torch.tensor(self.prior.values, **f32)
        ggeom = gridmap.make_geom(self.prior.center, self.prior.res, H, W, torch.float32,
                                  device=dev)
        self.route = world_mod.route(w)
        self.obs = world_mod.obstacles(w)
        plan_xy, n = rp.pad_global_plan(self.p, self.route, torch.float32, dev)
        ob = obs_mod.make_static_obstacles(self.p, self.obs[:, :2], self.obs[:, 3:5],
                                           self.obs[:, 2], dtype=torch.float32, device=dev)
        sat = (torch.tensor(self.obs[:, :3], **f32), torch.tensor(self.obs[:, 3:5], **f32),
               torch.ones(len(self.obs), **f32))
        xr, yr = costmap.corridor_center_bounds(cp, plan_xy, n)
        band = uncertainty_cuda.make_band_plan_bounds(cp, cp.rows, cp.cols, xr, yr,
                                                      (cp.sigma_x, cp.sigma_y, cp.sigma_theta))
        self.start = torch.tensor(w["start"], **f32)
        self.sigma = torch.tensor([noise.sigma_x, noise.sigma_y, noise.sigma_theta], **f32)
        self.fp = frenet.FrenetParams(**cfg["frenet"])
        # made once: the step's curvature bound is a copy from the host
        self.step = runner.make_plan_step("frenet_propagation", self.p, noise, plan_xy, n, ob,
                                          frenet_params=self.fp)
        self.loop = lambda draws, x0s, step: plant.closed_loop_full_stack_batched(
            self.p, cp, noise, gmap, ggeom, plan_xy, n, x0s, None, self.T, obstacles=ob,
            obs_xyyaw=sat[0], obs_size=sat[1], obs_mask=sat[2], band_plan=band,
            noise_draws=draws, plan_step_batched=step)

    def reseed(self, seed: int) -> None:
        """The base draws, and the kept cycles: 0 and ``check_cycles`` - 1
        others drawn from the seed."""
        rng = np.random.default_rng([seed, 2])
        rest = rng.choice(np.arange(1, self.T), min(self.cell["check_cycles"], self.T) - 1,
                          replace=False)
        self.at = [0] + sorted(int(c) for c in rest)
        self.at_dev = torch.tensor(self.at, device=self.dev)
        super().reseed(seed)

    def draw(self):
        kw = dict(generator=self.gen, dtype=torch.float32, device=self.dev)
        u = torch.rand(self.B, **kw)
        r = torch.randn((self.B, 2), **kw)
        zero = torch.zeros_like(u)
        x0s = self.start + torch.stack([self.cell["start_spread_m"] * u, self.sigma[1] * r[:, 0],
                                        zero, self.sigma[2] * r[:, 1]], dim=-1)
        return x0s, torch.randn((self.T, self.B, 3), **kw)

    def solve(self, draws, x0s):
        """One closed loop; the record also holds, for the kept cycles and
        lanes, the plan, the candidate chosen, its cost and whether any was
        feasible (``kept_X``, ``kept_U``, ``kept_pick``, ``kept_J``,
        ``kept_ok``: (cycles, lanes, ...)), gathered on the card."""
        li, kept, cycle = self.lanes, [], [0]

        def step(noisy, U_warm, umaps):
            res = self.step(noisy, U_warm, umaps)
            if cycle[0] in self.at:
                kept.append((res.X[li], res.U[li], res.iterations[li], res.J[li],
                             res.lamb[li] > 0))
            cycle[0] += 1
            return res

        final, rec = self.loop(draws, x0s, step)
        for k, v in zip(("kept_X", "kept_U", "kept_pick", "kept_J", "kept_ok"), zip(*kept)):
            rec[k] = torch.stack(v)
        return final, rec

    def call(self, k: int):
        x0s, draws = self.inputs(k)
        return x0s, draws, self.solve(draws, x0s)

    def keep(self, k: int, out, traced: bool = False) -> None:
        x0s, draws, (final, rec) = out
        li, at = self.lanes, self.at_dev
        rows = lambda t: t[at][:, li].flatten(0, 1)
        nxt = torch.cat([rec["start_pos"][1:], final[None]])
        self.kept.offer(k, lambda: (
            rows(rec["start_pos"]), rows(draws), rows(rec["noisy_pos"]),
            rec["kept_X"].flatten(0, 1), rec["kept_U"].flatten(0, 1),
            rec["kept_pick"].flatten(0, 1), rec["kept_J"].flatten(0, 1),
            rec["kept_ok"].flatten(0, 1), rows(nxt)))
        self.failed += sampling.failed(final)
        if traced:
            self.traced.append(rec["start_pos"])

    def traced_counters(self) -> dict:
        """What the traced calls' per-layer metrics read: their cycles, and
        K5's bytes and K4's least time on the cycles' start states, counted
        as the FS cell counts them (the same world stage)."""
        view = SimpleNamespace(cfg=self.cfg, prior=self.prior, plan=self.route, dev=self.dev,
                               B=self.B, T=self.T,
                               traced=[(start, torch.ones(1, 1)) for start in self.traced])
        c = full_stack.Campaign.traced_counters(view)
        return {k: c[k] for k in ("cycles_traced", "k4_bound_s", "k5_bytes")}

    def reference(self, kept: Kept, dtype, mode: str = "propagation") -> tuple:
        """The kept rows' cycles worked out again in ``dtype``: (the noisy
        pose, the reference's ``ref_fr.Cycle``)."""
        kw = dict(dtype=dtype, device=self.dev)
        t = lambda a: torch.as_tensor(a, **kw)
        cm = self.cfg["costmap"]
        p = ref.Params.from_config(self.cfg["solver"])
        lat = ref_fr.Lattice.from_config(dict(self.cfg["frenet"], mode=mode))
        state, d = kept.state.to(dtype), kept.draw.to(dtype)
        sig = self.sigma.to(dtype)
        noisy = state + torch.stack([sig[0] * d[:, 0], sig[1] * d[:, 1], torch.zeros_like(d[:, 0]),
                                     sig[2] * d[:, 2]], dim=-1)
        route = t(self.route)
        maps, centers = ref_costmap.tick(cm, route, t(self.obs), t(self.prior.values),
                                         self.prior.center, self.prior.res, state[:, [0, 1, 3]])
        lane_maps = ref_fr.Maps(maps, centers, cm["resolution"], state[:, :2], state[:, 3])
        return noisy, ref_fr.cycle(p, lat, route, t(self.obs), noisy, lane_maps)


def numbers(p: ref.Params, kept: Kept, got: Answer, noisy, r: ref_fr.Cycle, cell) -> dict:
    """A row's gap: the widest absolute difference of the noisy pose, of X
    and U against the reference's X of the candidate ``got`` chose (its
    brake where ``got`` braked) and that plan's controls, of the next state
    against the plant's step of ``got``'s own first control, and the
    relative difference of ``got``'s cost against the reference's cost of
    that candidate (its least cost where ``got`` braked), in float64;
    infinite where the choice is off (see the module)."""
    R = kept.state.shape[0]
    rows = torch.arange(R, device=r.J.device)
    ok = got.ok.to(r.J.device).bool()
    k = got.pick.to(r.J.device).long().clamp(0, r.J.shape[1] - 1)
    X = torch.where(ok[:, None, None], r.X_all[rows, k], ref_fr.brake(p, noisy))
    d = lambda a, b: torch.nan_to_num((a.double() - b.double()).abs().flatten(1).amax(1),
                                      nan=float("inf"))
    plant = ref.step(p, kept.state.double(), got.U[:, 0].double())
    cost = torch.where(ok, r.J[rows, k], r.J.amin(-1))
    g = torch.stack([d(got.noisy, noisy), d(got.X, X), d(got.U, ref_fr.controls(p, X)),
                     d(got.next, plant),
                     d(got.J[:, None], cost[:, None]) / cost.abs().clamp(min=1.0)]).amax(0)
    margin, rank = cell["slack_margin"], cell["rank_rel"]
    clear = r.slack <= -margin
    best = torch.where(clear, r.J, torch.full_like(r.J, float("inf"))).amin(-1)
    J = r.J[rows, k]
    off = torch.where(ok, (r.slack[rows, k] > margin) | (J > best + rank * best.abs()),
                      clear.any(-1))
    g = torch.where(off.to(g.device), torch.full_like(g, float("inf")), g)
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
    noisy, r = cam.reference(kept, torch.float64)
    _, origin = cam.reference(kept, torch.float64, mode="origin")
    p = ref.Params.from_config(cam.cfg["solver"])
    got = Answer(kept.noisy, kept.X, kept.U, kept.pick, kept.J, kept.ok, kept.next)
    ok = kept.ok.bool().cpu()
    pick = kept.pick.long().cpu()
    centre = cam.fp.n_lat // 2
    per_d = cam.fp.n_T * cam.fp.n_v
    rec = {"rows": int(ok.numel()),
           "pick_differs_pct": float(100.0 * (torch.where(ok, pick, -1) != r.best.cpu())
                                     .double().mean()),
           "brake_pct": float(100.0 * (~ok).double().mean()),
           "lateral_offset_pct": float(100.0 * (ok & (pick // per_d != centre)).double().mean()),
           "map_moves_pick_pct": float(100.0 * (r.best != origin.best).double().mean())}
    run.counters["record"] = rec
    print("record " + repr(rec), file=sys.stderr)
    return check_mod.checks(numbers(p, kept, got, noisy, r, run.cell), run.cell["limits"])


def control(run, held, dtype=torch.bfloat16) -> dict:
    """The reference's cycle in ``dtype`` in the program's place, held to
    the float64 one."""
    cam, kept = held
    noisy, r64 = cam.reference(kept, torch.float64)
    low_noisy, low = cam.reference(kept, dtype)
    p = ref.Params.from_config(cam.cfg["solver"])
    nxt = ref.step(p, kept.state.to(dtype), low.U[:, 0])
    pick, ok = low.best.clamp(min=0), low.best >= 0
    J = torch.where(ok, low.J[torch.arange(len(pick), device=pick.device), pick],
                    low.J.amin(-1))
    as_program = Answer(low_noisy, low.X, low.U, pick, J, ok, nxt)
    return numbers(p, kept, as_program, noisy, r64, run.cell)
