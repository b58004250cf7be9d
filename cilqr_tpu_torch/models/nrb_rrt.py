"""NRB-RRT baseline — risk-bounded kinodynamic RRT.

Port of ``cilqr_tpu/models/nrb_rrt.py``, batched over a leading B axis of
ego states.  The reference's batch comparison has an "NRB-RRT" column
(``CILQR/src/ilqr/src/batch_dataprocess.py:458``) pointing at the
*Risk Bounded Nonlinear Robot Motion Planning* repository; this planner
keeps from NRB-RRT* (Safaoui et al.):

  * kinodynamic tree growth with the plant's bicycle model
    (control-sampled steering primitives, not straight-line edges);
  * the distributionally-robust risk bound: an edge is admissible only if
    every state on it keeps each obstacle's ellipse at a margin
    kappa(alpha) * sigma_pos(t), kappa = sqrt((1 - alpha) / alpha), with
    sigma_pos grown along the plan horizon;
  * goal-directed sampling along the reference line.

RRT*'s rewiring is omitted, as in the JAX package.  Randomness is derived
from the ego state (``fold_in`` of its float32 bits into a fixed key), so a
closed loop needs no key plumbing and the same state gives the same plan;
``utils.prng`` reproduces JAX's threefry draws bit for bit, and all of a
call's draws, (B, n_iters) of them, are made before the tree grows.

The tree lives in (B, max_nodes, ...) tensors; each growth iteration is a
masked argmin for the nearest node, all primitives integrated together, the
risk check, and a scatter of the new node; then a parent-pointer walk
extracts the control tape.  Plain PyTorch: no TPU kernel stands behind
this module.  A call is ~24,000 small kernels at the CLI's batch sizes, so
on the card everything after the local plan runs as a CUDA graph, captured
once per batch shape and parameters and replayed with the call's inputs
(the same kernels on the same inputs: the same bits as the eager run).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from cilqr_tpu_torch.models import dynamics, frenet
from cilqr_tpu_torch.models import obstacles as obs_mod
from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.utils import graphs, prng
from cilqr_tpu_torch.utils.params import SolverParams

#: run the planner as a CUDA graph on the card (False: eagerly, as on the CPU)
GRAPHS = True
#: the captures by parameters, dtype, device and shapes (``graphs.GraphCache``)
CAPTURED = graphs.GraphCache(kept=8)


@dataclasses.dataclass(frozen=True)
class NRBParams:
    """Tree size, steering primitives, and the risk bound.

    ``lat_lo`` / ``lat_hi``: a corridor-feasible lateral sampling band
    relative to the reference line (``sim.runner.nrb_params_for_scenario``
    derives it from a scenario's walls); unset, targets sample within
    +-``lat_max``."""

    n_iters: int = 96            # growth iterations (max_nodes = n_iters + 1)
    steer_steps: int = 4         # dynamics steps per edge (0.4 s at dt=0.1)
    n_yawrate: int = 5           # steering primitive grid
    n_acc: int = 3
    goal_bias: float = 0.3       # probability of sampling the plan end
    lat_max: float = 3.0         # lateral sampling band around the ref line
    lat_lo: float = None
    lat_hi: float = None
    risk_alpha: float = 0.05     # per-constraint admissible collision risk
    sigma_growth: float = 0.5    # sigma_pos(t) = sigma0 * sqrt(1 + growth*t*dt)
    collision_margin: float = 0.3
    w_speed: float = 0.3         # nearest-metric weights
    w_yaw: float = 1.0
    goal_weight: float = 2.0     # goal-distance weight in best-node selection
    seed: int = 0

    @property
    def max_nodes(self) -> int:
        return self.n_iters + 1

    @property
    def n_primitives(self) -> int:
        return self.n_yawrate * self.n_acc

    @property
    def kappa(self) -> float:
        """Cantelli/DR tightening sqrt((1-alpha)/alpha)."""
        a = self.risk_alpha
        return float(((1.0 - a) / a) ** 0.5)


class NRBResult(NamedTuple):
    """Field-compatible with ``SolveResult`` (like FrenetResult)."""

    X: torch.Tensor           # (B, N+1, 4)
    U: torch.Tensor           # (B, N, 2)
    ref_x: torch.Tensor
    ref_y: torch.Tensor
    iterations: torch.Tensor  # (B,) int32 number of nodes grown
    J: torch.Tensor           # (B,) best path cost
    lamb: torch.Tensor        # (B,) 1.0 if a risk-admissible path was found


class _Consts(NamedTuple):
    """A call's constants, made before a graph is captured (a tensor built
    from host values is a copy from the host, which a capture may not hold)."""

    key: torch.Tensor     # (2,) key(seed)
    lo: torch.Tensor      # (3,) the uniforms' bounds: goal flag, lateral offset, speed
    hi: torch.Tensor
    sign: torch.Tensor    # (2,) the front / rear ego disc
    reach: torch.Tensor
    brake: torch.Tensor   # (2,) the brake primitive [acc_min, 0]
    prims: torch.Tensor   # (C, 2) the steering primitives [acceleration, yaw-rate scale]


def _consts(p: SolverParams, np_: NRBParams, dtype, dev) -> _Consts:
    f = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    lat_lo = -np_.lat_max if np_.lat_lo is None else np_.lat_lo
    lat_hi = np_.lat_max if np_.lat_hi is None else np_.lat_hi
    yr = frenet._linspace(-1.0, 1.0, np_.n_yawrate, dtype, dev)
    ac = frenet._linspace(p.acc_min / 2.0, p.acc_max, np_.n_acc, dtype, dev)
    YR, AC = torch.meshgrid(yr, ac, indexing="ij")
    return _Consts(prng.key(np_.seed, dev), f([0.0, lat_lo, 0.0]),
                   f([1.0, lat_hi, p.desired_speed * 1.2]), f([1.0, -1.0]),
                   f([p.ego_front, p.ego_rear]), f([p.acc_min, 0.0]),
                   torch.stack([AC.reshape(-1), YR.reshape(-1)], dim=-1))


def _risk_ok(p: SolverParams, np_: NRBParams, c: _Consts, states: torch.Tensor,
             t_idx: torch.Tensor, obstacles, sigma0: torch.Tensor) -> torch.Tensor:
    """DR chance-constraint check of states (..., 4) at horizon steps t_idx
    (...): each obstacle ellipse (half-axes dims/2 + ego disc + margin) is
    inflated by kappa * sigma_pos(t); both ego discs (front/rear,
    Obstacle.cpp:39-112 geometry) must clear every live obstacle at its
    time-indexed pose.  Returns bool (...)."""
    if obstacles is None:
        return torch.ones(states.shape[:-1], dtype=torch.bool, device=states.device)
    dtype = states.dtype
    ti = t_idx.clamp(max=obstacles.pos.shape[1] - 1)
    opos = obstacles.pos[:, ti]                 # (M, ..., 4)
    odim = obstacles.dims[:, ti]                # (M, ..., 2)
    sig_t = sigma0 * torch.sqrt(1.0 + np_.sigma_growth * ti.to(dtype) * p.timestep)
    infl = np_.kappa * sig_t                    # (...,) DR margin

    # both discs at once on a leading axis: (2, M, ...)
    a = odim[..., 0] / 2.0 + p.ego_rad + np_.collision_margin + infl
    b = odim[..., 1] / 2.0 + p.ego_rad + np_.collision_margin + infl
    co, so = torch.cos(opos[..., 3]), torch.sin(opos[..., 3])
    yaw = states[..., 3]
    shape = (2,) + (1,) * yaw.ndim
    sign, reach = c.sign.reshape(shape), c.reach.reshape(shape)
    ex = states[..., 0] + sign * torch.cos(yaw) * reach          # (2, ...)
    ey = states[..., 1] + sign * torch.sin(yaw) * reach
    dx = ex[:, None] - opos[..., 0]                               # (2, M, ...)
    dy = ey[:, None] - opos[..., 1]
    du = co * dx + so * dy
    dv = -so * dx + co * dy
    q = (du / a) ** 2 + (dv / b) ** 2
    live = (obstacles.mask > 0).reshape((1, -1) + (1,) * yaw.ndim)
    return ~((q < 1.0) & live).flatten(0, 1).any(dim=0)


def _draws(p: SolverParams, np_: NRBParams, c: _Consts, egos: torch.Tensor, W: int):
    """Every growth iteration's draws for every lane, as JAX's plan_step
    makes them: the key fold_in(fold_in(key(seed), b0 ^ b2), b1 ^ b3) of
    the ego's float32 bit patterns b, then per iteration i fold_in(key, i)
    split into (k_goal, k_s, k_lat, k_v).  Returns (waypoint index j,
    lateral offset, goal flag, target speed), each (B, n_iters); randint's
    integers are 32-bit for float32 states, 64-bit for float64 (JAX's
    default integer width with x64 off and on)."""
    dtype = egos.dtype
    bits = egos.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    key = prng.fold_in(prng.fold_in(c.key, bits[:, 0] ^ bits[:, 2]),
                       bits[:, 1] ^ bits[:, 3])                    # (B, 2)
    its = torch.arange(np_.n_iters, device=egos.device)
    sub = prng.split(prng.fold_in(key[:, None], its), 4)          # (B, n_iters, 4, 2)
    j = prng.randint(sub[..., 1, :], 0, W, bits=64 if dtype == torch.float64 else 32)
    # the three uniforms at once (slices, not a list index: a list would
    # be copied from the host, which a graph capture may not hold)
    u = prng.uniform(torch.stack([sub[..., 0, :], sub[..., 2, :], sub[..., 3, :]], dim=-2),
                     dtype, c.lo, c.hi)                            # (B, n_iters, 3)
    return j, u[..., 1], u[..., 0] < np_.goal_bias, u[..., 2]


def _steer(p: SolverParams, x: torch.Tensor, u_scale: torch.Tensor) -> torch.Tensor:
    """One plant step under a primitive: the acceleration, and a yaw rate
    that scales the state-dependent bound (Model.cpp:20), so every
    primitive stays actuation-feasible at any speed."""
    u = torch.stack([u_scale[..., 0].expand_as(x[..., 2]),
                     u_scale[..., 1] * x[..., 2] * p.yawrate_gain], dim=-1)
    return dynamics.step(p, x, u), u


def plan_steps(p: SolverParams, np_: NRBParams, plan_xy: torch.Tensor, plan_n,
               egos: torch.Tensor, obstacles=None, unc_map=None,
               sigmas: Optional[torch.Tensor] = None) -> NRBResult:
    """One risk-bounded RRT planning cycle per lane at egos (B, 4):
    ``plan_step`` of the JAX package, vmapped.  ``unc_map`` is unused (the
    DR bound is NRB-RRT's own uncertainty machinery); ``sigmas`` (3,) feeds
    sigma_pos = sqrt(sx^2 + sy^2), 0 without it (a geometric RRT)."""
    dtype, dev = egos.dtype, egos.device
    plan = rp.get_local_plan(p, plan_xy, plan_n, egos)
    if sigmas is None:
        sigmas = torch.zeros(3, dtype=dtype, device=dev)
    args = [egos, plan.x_wpts, plan.y_fit, sigmas] + ([] if obstacles is None else list(obstacles))
    c = _consts(p, np_, dtype, dev)

    def tree(egos, wx, wy, sigmas, *ob):
        return _tree(p, np_, c, egos, wx, wy, sigmas, obs_mod.Obstacles(*ob) if ob else None)

    if egos.is_cuda and GRAPHS:
        key = (p, np_, dtype, dev) + tuple((a.shape, a.dtype) for a in args)
        X, U, it, J, lamb = _replay(key, tree, args)
    else:
        X, U, it, J, lamb = tree(*args)
    return NRBResult(X, U, plan.x_wpts, plan.y_fit, it, J, lamb)


def _replay(key, fn, args: list) -> tuple:
    """fn(*args) as a CUDA graph: captured at the first call of ``key``
    (after one warm-up run on a side stream), then replayed on each call's
    inputs copied into the captured ones.  Returns copies of the outputs
    (the graph overwrites its own on the next replay)."""
    def make(inputs):
        dev = inputs[0].device
        with graphs.side_stream(dev):
            fn(*inputs)
        out = []
        graph = graphs.capture(lambda: out.extend(fn(*inputs)), dev)
        return (graph,), out, fn

    g = CAPTURED.load(key, args, make)
    g.graphs[0].replay()
    return tuple(o.clone() for o in g.out)


def _tree(p: SolverParams, np_: NRBParams, c: _Consts, egos: torch.Tensor, wx: torch.Tensor,
          wy: torch.Tensor, sigmas: torch.Tensor, obstacles) -> tuple:
    """Everything after the local plan (waypoints wx, wy (B, W)): the
    draws, the tree, the tape and the brake fallback.  Returns (X, U,
    iterations, J, lamb)."""
    dtype, dev = egos.dtype, egos.device
    B, N = egos.shape[0], p.horizon
    m, Nn = np_.steer_steps, np_.max_nodes
    lanes = torch.arange(B, device=dev)
    prims = c.prims

    W = wx.shape[-1]
    tx, ty = frenet._gradient(wx), frenet._gradient(wy)
    # get_local_plan repeats the last waypoint near the route's end, where
    # the gradient is exactly 0: the guard makes those slots sample on the line
    tn = torch.clamp(torch.sqrt(tx * tx + ty * ty), min=1e-6)
    nx, ny = -ty / tn, tx / tn                                     # unit normals
    goal = torch.stack([wx[:, -1], wy[:, -1]], dim=-1)             # (B, 2)
    sigma0 = torch.sqrt(sigmas[0] ** 2 + sigmas[1] ** 2).to(dtype)

    # every iteration's target (goal-biased, in the band along the line)
    j, lat, use_goal, v_t = _draws(p, np_, c, egos, W)
    at = lambda a: a.gather(1, j)
    samp = torch.stack([at(wx) + lat * at(nx), at(wy) + lat * at(ny)], dim=-1)
    targets = torch.where(use_goal[..., None], goal[:, None], samp)  # (B, n_iters, 2)

    states = torch.zeros((B, Nn, 4), dtype=dtype, device=dev)
    states[:, 0] = egos
    parent = torch.zeros((B, Nn), dtype=torch.int64, device=dev)
    ctrl = torch.zeros((B, Nn, 2), dtype=dtype, device=dev)   # control that reached the node
    cost = torch.zeros((B, Nn), dtype=dtype, device=dev)
    time = torch.zeros((B, Nn), dtype=torch.int64, device=dev)  # horizon step of the node
    valid = torch.zeros((B, Nn), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    inf = torch.full((B, Nn), math.inf, dtype=dtype, device=dev)
    steps = torch.arange(1, m + 1, device=dev)

    for i in range(np_.n_iters):
        target, v = targets[:, i], v_t[:, i]
        # nearest valid node (masked weighted metric)
        d2 = (((states[..., :2] - target[:, None]) ** 2).sum(dim=-1)
              + np_.w_speed * (states[..., 2] - v[:, None]) ** 2)
        near = torch.argmin(torch.where(valid, d2, inf), dim=-1)   # (B,)
        x_near, t_near = states[lanes, near], time[lanes, near]

        # steer: every primitive m steps from the nearest node
        x = x_near[:, None].expand(B, prims.shape[0], 4)
        path = []
        for _ in range(m):
            x, _ = _steer(p, x, prims)
            path.append(x)
        paths = torch.stack(path, dim=2)                           # (B, C, m, 4)
        ends = paths[:, :, -1]

        # the DR risk check along every primitive edge
        t_edge = (t_near[:, None] + steps)[:, None].expand(B, prims.shape[0], m)
        ok = _risk_ok(p, np_, c, paths, t_edge, obstacles, sigma0).all(dim=-1)
        ok &= (t_near + m <= 4 * N)[:, None]                       # (B, C)

        # the admissible primitive closest to the target
        d_end = (((ends[..., :2] - target[:, None]) ** 2).sum(dim=-1)
                 + np_.w_speed * (ends[..., 2] - v[:, None]) ** 2)
        any_ok = ok.any(dim=-1)
        best = torch.argmin(torch.where(ok, d_end, inf[:, :1]), dim=-1)
        end = ends[lanes, best]
        seg = torch.sqrt(((end[:, :2] - x_near[:, :2]) ** 2).sum(dim=-1))

        slot = i + 1
        states[:, slot] = torch.where(any_ok[:, None], end, torch.zeros_like(end))
        parent[:, slot] = near
        ctrl[:, slot] = prims[best]
        cost[:, slot] = cost[lanes, near] + seg
        time[:, slot] = t_near + m
        valid[:, slot] = any_ok

    # best node: cost-to-come + weighted goal distance.  The root is left
    # out (its plan would be an unchecked coast); with no grown node,
    # ``found`` is False and the brake fallback below takes over.
    d_goal = torch.sqrt(((states[..., :2] - goal[:, None]) ** 2).sum(dim=-1))
    score = cost + np_.goal_weight * d_goal
    grown = valid.clone()
    grown[:, 0] = False
    best = torch.argmin(torch.where(grown, score, inf), dim=-1)
    found = grown.any(dim=-1)

    # the control tape root -> best by the parent pointers: node v > 0 was
    # reached by holding ctrl[v] over horizon steps [time[v] - m, time[v]).
    # Slots past the chain's depth keep the brake primitive (full
    # deceleration, zero yaw rate).  A valid node's time is its depth * m
    # <= 4N, so max_edges steps reach the root from any node a found plan
    # selects (the JAX package walks max_nodes steps; the extra ones stay
    # at the root and write nothing).
    max_edges = 4 * N // m + 1
    edges = c.brake.expand(B, max_edges, 2).clone()
    node = best
    for _ in range(min(Nn, max_edges)):
        s = (time[lanes, node] // m - 1).clamp(min=0)
        edges[lanes, s] = torch.where((node > 0)[:, None], ctrl[lanes, node], edges[lanes, s])
        node = parent[lanes, node]
    # each edge's scales held over its m steps: (B, N, 2)
    u_tape = edges[:, :, None].expand(B, max_edges, m, 2).reshape(B, max_edges * m, 2)[:, :N]

    # roll the tape out from the ego (exact plant dynamics)
    x, xs, us = egos, [egos], []
    for k in range(N):
        x, u = _steer(p, x, u_tape[:, k])
        xs.append(x)
        us.append(u)
    X = torch.stack(xs, dim=1)
    U = torch.stack(us, dim=1)

    # the emergency brake when no admissible edge exists (never execute an
    # inadmissible maneuver)
    X = torch.where(found[:, None, None], X, frenet.brake_trajectory(p, egos))
    U = torch.where(found[:, None, None], U, frenet.brake_controls(p, X))
    return (X, U, valid.sum(dim=-1).to(torch.int32),
            # a finite sentinel on failure: J feeds metric sums downstream
            torch.where(found, score[lanes, best], torch.full_like(score[:, 0], 1e6)),
            found.to(dtype))
