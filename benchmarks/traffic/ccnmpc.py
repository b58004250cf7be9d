"""Traffic ``ccnmpc``: back-to-back closed loops of the chance-constrained
NMPC baseline.

Each timed call is one ``sim.plant.closed_loop_batched`` of ``batch``
simulated vehicles over ``cycles`` planning cycles with the CCNMPC plan step
of ``sim.runner.make_plan_step``: per cycle and vehicle the localization
noise, then ``chance.n_sqp`` rounds of the rollout, the covariance along it,
the obstacles tightened by kappa sigma and the two-phase LM solve on them
(kernel K2 once per LM iteration), then the plant's step.  The starts lie
along the configuration's lane, x uniform over ``start_spread_m`` metres
from its start; they and the noise blocks are drawn on the card from the
seed, call after call.  Cycle 0 starts from the cold controls, every later
cycle from the last cycle's plan.

The check does not follow a lane through its 20 cycles: float32 chaos would
compound there, and CCNMPC's LM stops are knife-edges in every cycle.  Of
``check_calls`` of the window's calls, ``check_lanes`` lanes and
``check_cycles`` cycles (cycle 0 among them), all drawn from the seed, each
(call, lane, cycle) keeps that cycle's own inputs (the true state, the
noise draw, the warm start) and outputs (the noisy pose, the second round's
X and U, the next true state), and the plan that the lane's last cycle
handed on.  After the window the reference (``benchmarks/reference/
ccnmpc.py``) runs that one cycle in float64 from the same inputs, with its
own cold controls at cycle 0.  The warm start itself is held too: it must
equal the last cycle's plan (at cycle 0, the reference's cold controls), or
the row is off, so a fault in the hand-off between cycles, which the
reference fed the same warm start would not see, is caught.
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
from benchmarks.reference import ccnmpc as ref_cc
from benchmarks.reference import cilqr as ref


class Kept(NamedTuple):
    """One row per kept (call, lane, cycle)."""

    cycle: torch.Tensor  # (K,) the cycle's index
    state: torch.Tensor  # (K, 4) the true state at the cycle's start
    draw: torch.Tensor   # (K, 3) the cycle's standard-normal noise draw
    noisy: torch.Tensor  # (K, 4) the pose the planner saw
    warm: torch.Tensor   # (K, N, 2) the controls handed to the planner
    handed: torch.Tensor  # (K, N, 2) the last cycle's plan (at cycle 0: NaN)
    X: torch.Tensor      # (K, N+1, 4) the second round's plan
    U: torch.Tensor      # (K, N, 2)
    next: torch.Tensor   # (K, 4) the true state after the cycle
    it: torch.Tensor     # (K,) the second round's LM iterations


class Cycle(NamedTuple):
    """A cycle worked out for the kept rows: what ``numbers`` compares."""

    noisy: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    next: torch.Tensor


class Campaign(sampling.Traffic):
    def __init__(self, run):
        from cilqr_tpu_torch.models import ccnmpc
        from cilqr_tpu_torch.models import obstacles as obs_mod
        from cilqr_tpu_torch.models import reference_path as rp
        from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

        cfg, cell, dev = run.config, run.cell, run.device
        self.cfg, self.cell, self.dev, self.B = cfg, cell, dev, cell["batch"]
        self.T = cell["cycles"]
        self.p = dataclasses.replace(SolverParams(), **cfg["solver"])
        self.noise = NoiseParams(**cfg["noise"])
        self.cc = ccnmpc.CCParams(**cfg["chance"])
        w = cfg["world"]
        f32 = dict(dtype=torch.float32, device=dev)
        self.route = world_mod.route(w)
        self.obs = world_mod.obstacles(w)
        self.plan_xy, self.n = rp.pad_global_plan(self.p, self.route, torch.float32, dev)
        self.ob = obs_mod.make_static_obstacles(self.p, self.obs[:, :2], self.obs[:, 3:5],
                                                self.obs[:, 2], dtype=torch.float32, device=dev)
        self.sat = (torch.tensor(self.obs[:, :3], **f32), torch.tensor(self.obs[:, 3:5], **f32),
                    torch.ones(len(self.obs), **f32))
        self.start = torch.tensor(w["start"], **f32)
        self.spread = w["start_spread_m"]
        self.sigma = (self.noise.sigma_x, self.noise.sigma_y, self.noise.sigma_theta)
        self.solve = self.loop

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

    def loop(self, draws, x0s):
        """One closed loop of the CCNMPC plan step; the record also holds,
        for the kept cycles and lanes, the warm start, the plan and the
        last cycle's plan (``kept_warm``, ``kept_X``, ``kept_U``,
        ``kept_handed``: (cycles, lanes, ...); at cycle 0 NaN)."""
        from cilqr_tpu_torch.sim import plant, runner

        inner = runner.make_plan_step("ccnmpc", self.p, self.noise, self.plan_xy, self.n, self.ob,
                                      cc_params=self.cc)
        li, kept, handed, cycle = self.lanes, [], [], [0]

        def step(noisy, U_warm, umaps=None):
            res = inner(noisy, U_warm)
            if cycle[0] in self.at:
                kept.append((U_warm[li], res.X[li], res.U[li]))
            if cycle[0] + 1 in self.at:
                handed.append(res.U[li])
            cycle[0] += 1
            return res

        final, rec = plant.closed_loop_batched(
            self.p, self.noise, self.plan_xy, self.n, x0s, None, self.T, obs_xyyaw=self.sat[0],
            obs_size=self.sat[1], obs_mask=self.sat[2], noise_draws=draws, plan_step_batched=step)
        rec["kept_warm"], rec["kept_X"], rec["kept_U"] = (torch.stack(v) for v in zip(*kept))
        rec["kept_handed"] = torch.stack([torch.full_like(kept[0][0], float("nan"))] + handed)
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
            rows(rec["noisy_pos"]), rec["kept_warm"].flatten(0, 1),
            rec["kept_handed"].flatten(0, 1), rec["kept_X"].flatten(0, 1),
            rec["kept_U"].flatten(0, 1), rows(nxt), rows(rec["iterations"])))
        self.failed += sampling.failed(final)
        if traced:
            self.traced.append(rec["iterations"])

    def traced_counters(self) -> dict:
        """The traced calls' cycles, and the LM loop's lane use over their
        planner solves (each cycle's second round, the record's)."""
        use = [(it.float().mean(1) / it.float().amax(1).clamp(min=1.0)).mean()
               for it in self.traced]
        return {"cycles_traced": len(self.traced) * self.T,
                "lm_lane_use_pct": float(100.0 * torch.stack(use).mean())}

    def reference(self, kept: Kept, dtype) -> tuple:
        """The kept rows' cycles worked out again in ``dtype``: (``Cycle``,
        the rounds' ``ref.Result``)."""
        kw = dict(dtype=dtype, device=self.dev)
        p = ref.Params.from_config(self.cfg["solver"])
        sig = torch.tensor(self.sigma, **kw)
        state, d = kept.state.to(dtype), kept.draw.to(dtype)
        noisy = state + torch.stack([sig[0] * d[:, 0], sig[1] * d[:, 1], torch.zeros_like(d[:, 0]),
                                     sig[2] * d[:, 2]], dim=-1)
        cold = ref.initial_controls(p, state.shape[0], dtype, self.dev)
        warm = torch.where((kept.cycle == 0)[:, None, None], cold, kept.warm.to(dtype))
        chance = ref_cc.Chance(**self.cfg["chance"])
        rounds = ref_cc.cycle(p, chance, torch.as_tensor(self.route, **kw),
                              torch.as_tensor(self.obs, **kw), noisy, warm,
                              ref_cc.process_noise(self.sigma, dtype, self.dev))
        last = rounds[-1]
        return Cycle(noisy, last.X, last.U, ref.step(p, state, last.U[:, 0])), rounds


def handed_on(p: ref.Params, kept: Kept) -> torch.Tensor:
    """(K,) whether each row's warm start equals what the lane's last
    cycle handed on: its plan's controls, at cycle 0 the reference's cold
    controls (both in the warm start's float32, where equal values are
    equal bits)."""
    cold = ref.initial_controls(p, kept.warm.shape[0], kept.warm.dtype, kept.warm.device)
    want = torch.where((kept.cycle == 0)[:, None, None], cold, kept.handed)
    return (kept.warm == want).flatten(1).all(1)


def numbers(p: ref.Params, kept: Kept, got: Cycle, r: Cycle, cell) -> dict:
    """A row's gap: the widest absolute difference over the noisy pose and
    the second round's X and U, each against the reference's ``r``, and
    over the next true state, against the plant's step of ``got``'s own
    first control, worked out in float64; infinite where the warm start is
    not the one handed on (``handed_on``)."""
    d = lambda a, b: torch.nan_to_num((a.double() - b.double()).abs().flatten(1).amax(1),
                                      nan=float("inf"))
    plant = ref.step(p, kept.state.double(), got.U[:, 0].double())
    g = torch.stack([d(got.noisy, r.noisy), d(got.X, r.X), d(got.U, r.U),
                     d(got.next, plant)]).amax(0)
    g = torch.where(handed_on(p, kept).to(g.device), g, torch.full_like(g, float("inf")))
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
    r, rounds = cam.reference(kept, torch.float64)
    p = ref.Params.from_config(cam.cfg["solver"])
    got = Cycle(kept.noisy, kept.X, kept.U, kept.next)
    g = check_mod.gaps(kept.X, kept.U, r)
    rec = {"gap_max": float(g.max()), "cold_rows": int((kept.cycle == 0).sum()),
           "warm_not_handed_on": int((~handed_on(p, kept)).sum()),
           "iterations_differ_pct": float(100.0 * (kept.it.cpu().long()
                                                   != rounds[-1].iterations.cpu().long())
                                          .double().mean()),
           "rows": int(kept.cycle.numel())}
    run.counters["record"] = rec
    print("record " + repr(rec), file=sys.stderr)
    return check_mod.checks(numbers(p, kept, got, r, run.cell), run.cell["limits"])


def control(run, held, dtype=torch.bfloat16) -> dict:
    """The reference's cycle in ``dtype`` in the program's place, held to
    the float64 one."""
    cam, kept = held
    r64, _ = cam.reference(kept, torch.float64)
    low, _ = cam.reference(kept, dtype)
    p = ref.Params.from_config(cam.cfg["solver"])
    return numbers(p, kept, low, r64, run.cell)
