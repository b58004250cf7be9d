"""Traffic ``nrb``: back-to-back closed loops of the risk-bounded kinodynamic
RRT baseline (NRB-RRT).

Each timed call is one ``sim.plant.closed_loop_batched`` of ``batch``
simulated vehicles over ``cycles`` planning cycles with the plan step
``sim.runner.make_plan_step("nrb_rrt", ...)``: per cycle and vehicle the
localization noise, then a tree of the configuration's ``n_iters`` growth
iterations from the noisy pose (the nearest node, every steering primitive
integrated over its steps, each state held to the distributionally robust
risk bound against every obstacle with both ego discs, the admissible
primitive nearest the target), the chosen node's control tape and its
rollout (or the brake), then the plant's step on its first control.  The
starts lie along the configuration's lane, x uniform over
``start_spread_m`` metres from its start; they and the noise blocks are
drawn on the card from the seed, call after call.  The planner keeps no
state between cycles: its draws come from the pose it plans from.

The check does not follow a lane through its cycles: the tree's choices are
discrete, and float32 rounding near a tie carries a lane onto another tree.
Of ``check_calls`` of the window's calls, ``check_lanes`` lanes and
``check_cycles`` cycles (cycle 0 among them), all drawn from the seed, each
(call, lane, cycle) keeps that cycle's true state, noise draw, noisy pose,
the plan (X, U, J, whether a plan was found, the nodes grown) and the next
true state.  After the window the reference (``benchmarks/reference/
nrb_rrt.py``) plans that cycle again in float64 from the program's noisy
pose, its draws keyed by that pose's float32 bits as the program's are.  A
row's gap is the widest absolute difference of the noisy pose (against the
true state plus sigma times the draw), of X and U (against the
reference's), and of the next state (against the plant's step of the
program's first control).  A row is off, whatever its gap, where ``found``
or the nodes grown disagree with the reference (every iteration is held,
not only those on the chosen chain); where a found plan's chain (the
states its tape reaches before the braking tail) breaks the reference's
risk bound, each half-axis eased by ``risk_ease_m``; where a found plan's
X is not the float64 rollout of its U from the noisy pose within
``rollout_tol``; or where a lane without a plan does not brake (X off the
reference's brake by more than ``rollout_tol``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from benchmarks import check as check_mod
from benchmarks import sampling
from benchmarks import world as world_mod
from benchmarks.reference import cilqr as ref
from benchmarks.reference import frenet as ref_fr
from benchmarks.reference import nrb_rrt as ref_nrb


class Kept(NamedTuple):
    """One row per kept (call, lane, cycle)."""

    cycle: torch.Tensor  # (R,) the cycle's index
    state: torch.Tensor  # (R, 4) the true state at the cycle's start
    draw: torch.Tensor   # (R, 3) the cycle's standard-normal noise draw
    noisy: torch.Tensor  # (R, 4) the pose the planner saw
    X: torch.Tensor      # (R, N+1, 4) the plan
    U: torch.Tensor      # (R, N, 2)
    J: torch.Tensor      # (R,) the chosen node's score (1e6 where none was found)
    found: torch.Tensor  # (R,) 1.0 where a plan was found (else the brake)
    grown: torch.Tensor  # (R,) the nodes grown (the root left out)
    next: torch.Tensor   # (R, 4) the true state after the cycle


class Answer(NamedTuple):
    """A cycle's answer as ``numbers`` compares it: the program's, or the
    control's."""

    noisy: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    found: torch.Tensor
    grown: torch.Tensor
    next: torch.Tensor


class Campaign(sampling.Traffic):
    def __init__(self, run):
        from cilqr_tpu_torch.models import nrb_rrt
        from cilqr_tpu_torch.models import obstacles as obs_mod
        from cilqr_tpu_torch.models import reference_path as rp
        from cilqr_tpu_torch.sim import plant, runner
        from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

        cfg, cell, dev = run.config, run.cell, run.device
        self.cfg, self.cell, self.dev, self.B = cfg, cell, dev, cell["batch"]
        self.T = cell["cycles"]
        self.p = dataclasses.replace(SolverParams(), **cfg["solver"])
        noise = NoiseParams(**cfg["noise"])
        self.np_ = nrb_rrt.NRBParams(**cfg["nrb"])
        w = cfg["world"]
        f32 = dict(dtype=torch.float32, device=dev)
        self.route = world_mod.route(w)
        self.obs = world_mod.obstacles(w)
        plan_xy, n = rp.pad_global_plan(self.p, self.route, torch.float32, dev)
        ob = obs_mod.make_static_obstacles(self.p, self.obs[:, :2], self.obs[:, 3:5],
                                           self.obs[:, 2], dtype=torch.float32, device=dev)
        sat = (torch.tensor(self.obs[:, :3], **f32), torch.tensor(self.obs[:, 3:5], **f32),
               torch.ones(len(self.obs), **f32))
        self.start = torch.tensor(w["start"], **f32)
        self.spread = w["start_spread_m"]
        self.sigma = (noise.sigma_x, noise.sigma_y, noise.sigma_theta)
        # made once: the step's constants are copies from the host
        self.step = runner.make_plan_step("nrb_rrt", self.p, noise, plan_xy, n, ob,
                                          nrb_params=self.np_)
        self.loop = lambda draws, x0s, step: plant.closed_loop_batched(
            self.p, noise, plan_xy, n, x0s, None, self.T, obs_xyyaw=sat[0], obs_size=sat[1],
            obs_mask=sat[2], noise_draws=draws, plan_step_batched=step)

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
        zero = torch.zeros_like(u)
        x0s = self.start + torch.stack([self.spread * u, zero, zero, zero], dim=-1)
        return torch.randn((self.T, self.B, 3), **kw), x0s

    def solve(self, draws, x0s):
        """One closed loop of the NRB-RRT plan step; the record also holds,
        for the kept cycles and lanes, the plan and whether it was found
        (``kept_X``, ``kept_U``, ``kept_found``: (cycles, lanes, ...))."""
        li, kept, cycle = self.lanes, [], [0]

        def step(noisy, U_warm, umaps=None):
            res = self.step(noisy, U_warm)
            if cycle[0] in self.at:
                kept.append((res.X[li], res.U[li], res.lamb[li]))
            cycle[0] += 1
            return res

        final, rec = self.loop(draws, x0s, step)
        rec["kept_X"], rec["kept_U"], rec["kept_found"] = (torch.stack(v) for v in zip(*kept))
        return final, rec

    def call(self, k: int):
        draws, x0s = self.inputs(k)
        return draws, x0s, self.solve(draws, x0s)

    def keep(self, k: int, out, traced: bool = False) -> None:
        draws, x0s, (final, rec) = out
        li, at = self.lanes, self.at_dev
        rows = lambda t: t[at][:, li].flatten(0, 1)
        nxt = torch.cat([rec["start_pos"][1:], final[None]])
        self.kept.offer(k, lambda: (
            at.repeat_interleave(len(li)), rows(rec["start_pos"]), rows(draws),
            rows(rec["noisy_pos"]), rec["kept_X"].flatten(0, 1), rec["kept_U"].flatten(0, 1),
            rows(rec["J"]), rec["kept_found"].flatten(0, 1), rows(rec["iterations"]) - 1,
            rows(nxt)))
        self.failed += sampling.failed(final)
        if traced:
            self.traced.append(rec["iterations"])

    def traced_counters(self) -> dict:
        """The traced calls' cycles, and the share of their lane-cycles that
        found a plan (from the records: the nodes grown)."""
        grown = torch.stack(self.traced) - 1
        return {"cycles_traced": len(self.traced) * self.T,
                "found_pct": float(100.0 * (grown > 0).double().mean())}

    def reference(self, kept: Kept, dtype) -> tuple:
        """The kept rows' cycles worked out again in ``dtype``: (the noisy
        pose from the true state and the draw, the reference's
        ``ref_nrb.Cycle`` planned from the program's noisy pose)."""
        kw = dict(dtype=dtype, device=self.dev)
        p = ref.Params.from_config(self.cfg["solver"])
        sig = torch.tensor(self.sigma, **kw)
        state, d = kept.state.to(dtype), kept.draw.to(dtype)
        noisy = state + torch.stack([sig[0] * d[:, 0], sig[1] * d[:, 1], torch.zeros_like(d[:, 0]),
                                     sig[2] * d[:, 2]], dim=-1)
        tree = ref_nrb.Tree.from_config(self.cfg["nrb"])
        r = ref_nrb.cycle(p, tree, torch.as_tensor(self.route, **kw),
                          torch.as_tensor(self.obs, **kw), kept.noisy.to(dtype), sig,
                          drawn_at=kept.noisy)
        return noisy, r


def numbers(p: ref.Params, cfg: dict, kept: Kept, got: Answer, noisy, r: ref_nrb.Cycle,
            cell) -> dict:
    """The rows' gaps (``numbers`` of ``check``): the widest absolute
    difference of the noisy pose, X, U and the next state; infinite where
    the row is off by a rule of the module's docstring."""
    d = lambda a, b: torch.nan_to_num((a.double() - b.double()).abs().flatten(1).amax(1),
                                      nan=float("inf"))
    pose = kept.noisy.double()
    plant = ref.step(p, kept.state.double(), got.U[:, 0].double())
    g = torch.stack([d(got.noisy, noisy), d(got.X, r.X), d(got.U, r.U),
                     d(got.next, plant)]).amax(0)
    found = got.found.to(g.device) > 0
    off = (found != r.found.to(g.device)) | (got.grown.to(g.device).long() != r.grown)
    X, U = got.X.double(), got.U.double()
    tol = cell["rollout_tol"]
    off |= found & (d(X, ref.rollout(p, pose, U)) > tol)
    off |= ~found & (d(X, ref_fr.brake(p, pose)) > tol)
    tree = ref_nrb.Tree.from_config(cfg["nrb"])
    steps = torch.arange(p.horizon + 1, device=X.device).expand(X.shape[0], -1)
    sig = torch.tensor(cfg["noise"]["sigma_x"] ** 2 + cfg["noise"]["sigma_y"] ** 2,
                       dtype=torch.float64, device=X.device).sqrt()
    safe = ref_nrb.risk_ok(p, tree, torch.as_tensor(world_mod.obstacles(cfg["world"]),
                                                    dtype=torch.float64, device=X.device),
                           X, steps, sig, ease=cell["risk_ease_m"])
    off |= found & (ref_nrb.chain_mask(p, U) & ~safe).any(1)
    g = torch.where(off, torch.full_like(g, float("inf")), g)
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
    p = ref.Params.from_config(cam.cfg["solver"])
    got = Answer(kept.noisy, kept.X, kept.U, kept.found, kept.grown, kept.next)
    found = kept.found.to(r.found.device) > 0
    both = found & r.found
    dj = (kept.J.double() - r.J.double()).abs() / r.J.double().abs().clamp(min=1.0)
    rec = {"gap_max": float(check_mod.gaps(kept.X, kept.U, r).max()),
           "J_rel_median": float(dj[both].median()) if bool(both.any()) else None,
           "found_pct": float(100.0 * found.double().mean()),
           "found_differs": int((found != r.found).sum()),
           "grown_differs_pct": float(100.0 * (kept.grown.long().to(r.grown.device)
                                               != r.grown).double().mean()),
           "rows": int(kept.cycle.numel())}
    run.counters["record"] = rec
    print("record " + repr(rec), file=sys.stderr)
    return check_mod.checks(numbers(p, cam.cfg, kept, got, noisy, r, run.cell),
                            run.cell["limits"])


def control(run, held, dtype=torch.bfloat16) -> dict:
    """The reference's cycle in ``dtype`` in the program's place, held to
    the float64 one: the noisy pose, the plan and the next state all worked
    out in ``dtype``, the draws keyed by the pose as the program saw it."""
    cam, kept = held
    noisy64, r64 = cam.reference(kept, torch.float64)
    noisy, low = cam.reference(kept, dtype)
    p = ref.Params.from_config(cam.cfg["solver"])
    nxt = ref.step(p, kept.state.to(dtype), low.U[:, 0])
    answer = Answer(noisy, low.X, low.U, low.found.to(dtype), low.grown, nxt)
    # the widest X, U difference before the rules mark rows off: what the
    # gap_median limit is set against
    raw = check_mod.gaps(low.X, low.U, r64).double()
    rec = {"gap_median_before_rules": float(raw.median()),
           "found_differs": int((low.found != r64.found).sum())}
    run.counters["control_record"] = rec
    print("control record " + repr(rec), file=sys.stderr)
    return numbers(p, cam.cfg, kept, answer, noisy64, r64, run.cell)
