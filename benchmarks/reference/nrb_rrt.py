"""Plain PyTorch reference of one NRB-RRT planning cycle.

Written from the description of the comparison's risk-bounded kinodynamic
RRT (the reference's comparison column "NRB-RRT",
``batch_dataprocess.py:458-463``, after NRB-RRT* of Safaoui et al.: *Risk
Bounded Nonlinear Robot Motion Planning*), batched over lanes and computed
in the dtype it is given: float64 to judge the program, bfloat16 for the
benchmark's control.  It imports nothing of the program and takes none of
its derived data.

One cycle per lane, from the pose the planner sees:

* The reference line: the window of ``reference/cilqr.local_plan`` (the
  waypoints from the nearest one on, the last repeated at the route's end)
  and its degree-5 fit at the window's x; the unit normals from the
  centred differences of the fitted waypoints (one-sided at the ends).
* The draws, made as a float32 lane makes them, whatever the dtype: the key
  ``fold_in(fold_in(key(seed), b0 ^ b2), b1 ^ b3)`` of the pose's float32
  bit patterns b, per growth iteration i ``split(fold_in(key, i), 4)`` into
  (goal, waypoint, lateral, speed) keys; the waypoint a 32-bit ``randint``
  over the window, the rest float32 uniforms (the goal flag below
  ``goal_bias``, the lateral offset in the band, the target speed in [0,
  1.2 v_des]).  JAX's threefry2x32 (``jax.random`` with its default
  implementation), written out below.  A target is the window's last
  waypoint where the goal flag is set, else the waypoint moved along its
  normal by the offset.
* The tree, root the pose, ``n_iters`` growth iterations: the nearest node
  (squared distance plus ``w_speed`` times the squared speed gap; the first
  of least value), every steering primitive (an acceleration of
  ``n_acc`` in [acc_min / 2, acc_max] and a yaw-rate scale of ``n_yawrate``
  in [-1, 1] of v tan(steer_max) / wheelbase, acceleration minor) held over
  ``steer_steps`` plant steps, each state of each edge held to the risk
  bound, then of the admissible primitives the one whose end is nearest the
  target (the first of least value).  A node's horizon step is its depth
  times ``steer_steps``; an edge that would end past 4 N is not admissible.
  The new node's cost is its parent's plus the straight distance between
  their positions.
* The risk bound (distributionally robust, Cantelli): both ego discs
  (``ego_front`` ahead, ``ego_rear`` behind) outside every live obstacle's
  ellipse, half-axes half its size plus ``ego_rad`` plus
  ``collision_margin`` plus kappa sigma(t), kappa = sqrt((1 - alpha) /
  alpha), sigma(t) = sqrt(sigma_x^2 + sigma_y^2) sqrt(1 + sigma_growth t
  dt), t the horizon step, held at N - 1 (the obstacles' last pose).
* The chosen node: of the grown nodes (the root left out) the least cost
  plus ``goal_weight`` times its distance to the goal (the first of least
  value).  Its chain's controls from the root, each held over its edge's
  steps, then full braking with no yaw rate, are the tape; X its rollout
  from the pose.  A lane with no grown node brakes: full deceleration along
  the pose's heading, the controls its finite differences
  (``reference/frenet.brake`` and ``controls``).

Where it departs from the program's computation (the same semantics):

* Only the live obstacles are tested (the rows it is given); obstacles are
  static.
* The tape is built forward along the chain, not by the program's walk of
  parent pointers from the chosen node.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cilqr as ref
from . import frenet as ref_fr

MASK32 = 0xFFFFFFFF


class Tree(NamedTuple):
    """The tree's size, primitives, sampling and risk bound, from a
    configuration's ``nrb`` group (missing keys are an error, not a
    default)."""

    n_iters: int
    steer_steps: int
    n_yawrate: int
    n_acc: int
    goal_bias: float
    lat_max: float
    lat_lo: float | None
    lat_hi: float | None
    risk_alpha: float
    sigma_growth: float
    collision_margin: float
    w_speed: float
    goal_weight: float
    seed: int

    @classmethod
    def from_config(cls, nrb: dict) -> "Tree":
        return cls(**{k: nrb[k] for k in cls._fields})

    @property
    def kappa(self) -> float:
        return math.sqrt((1.0 - self.risk_alpha) / self.risk_alpha)


class Cycle(NamedTuple):
    X: torch.Tensor      # (L, N+1, 4)
    U: torch.Tensor      # (L, N, 2)
    found: torch.Tensor  # (L,) bool: a grown node was chosen (else the brake)
    grown: torch.Tensor  # (L,) int64: growth iterations that added a node
    J: torch.Tensor      # (L,) the chosen node's score (found lanes)


# ------------------------------------------------------- threefry2x32
def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of counter (x0, x1) under key (k0, k1): int64
    words in [0, 2^32)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(k, data):
    """k (..., 2) with the 32-bit words of data (broadcast)."""
    data = data & MASK32
    a, b = threefry(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def split(k, num: int):
    """k (..., 2) -> (..., num, 2)."""
    c = torch.arange(num, dtype=torch.int64, device=k.device)
    a, b = threefry(k[..., 0, None], k[..., 1, None], torch.zeros_like(c), c)
    return torch.stack([a, b], dim=-1)


def bits32(k):
    """32 random bits per key (..., 2): the XOR of the hash of (0, 0)."""
    z = torch.zeros_like(k[..., 0])
    a, b = threefry(k[..., 0], k[..., 1], z, z)
    return a ^ b


def uniform32(k, lo: float, hi: float):
    """A float32 uniform in [lo, hi) per key: 23 random bits as the
    mantissa of a number in [1, 2), minus 1, times (hi - lo) plus lo rounded
    once, at least lo."""
    f = ((bits32(k) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo32 = torch.tensor(lo, dtype=torch.float32, device=k.device)
    span = torch.tensor(hi, dtype=torch.float32, device=k.device) - lo32
    return torch.maximum(lo32, (f.double() * span.double() + lo32.double()).float())


def randint32(k, n: int):
    """An integer in [0, n) per key, from two 32-bit draws (JAX's int32
    ``randint``)."""
    halves = split(k, 2)
    r = bits32(halves) % n
    m = (1 << 16) % n
    return (r[..., 0] * (m * m % n) + r[..., 1]) % n


def draws(t: Tree, pose: torch.Tensor, W: int, lat: tuple, v_max: float):
    """Every growth iteration's draws from poses (L, 4) as float32 lanes:
    (waypoint index (L, n_iters) int64, lateral offset, goal flag, target
    speed), the uniforms float32."""
    b = pose.float().contiguous().view(torch.int32).to(torch.int64)
    k = fold_in(fold_in(key(t.seed, pose.device), b[:, 0] ^ b[:, 2]), b[:, 1] ^ b[:, 3])
    its = torch.arange(t.n_iters, dtype=torch.int64, device=pose.device)
    sub = split(fold_in(k[:, None], its), 4)                       # (L, n_iters, 4, 2)
    goal = uniform32(sub[..., 0, :], 0.0, 1.0) < t.goal_bias
    return (randint32(sub[..., 1, :], W), uniform32(sub[..., 2, :], *lat), goal,
            uniform32(sub[..., 3, :], 0.0, v_max))


# ---------------------------------------------------------- the risk bound
def risk_ok(p: ref.Params, t: Tree, obstacles, states, steps, sigma0, ease: float = 0.0):
    """Whether states (..., 4) at horizon steps ``steps`` (...) keep both ego
    discs outside every obstacle's (M, 6) ellipse grown by the risk margin,
    each half-axis eased by ``ease`` metres."""
    ok = torch.ones(states.shape[:-1], dtype=torch.bool, device=states.device)
    tt = steps.clamp(max=p.horizon - 1).to(states.dtype)
    infl = t.kappa * (sigma0 * torch.sqrt(1.0 + t.sigma_growth * tt * p.timestep))
    x, y, yaw = states[..., 0], states[..., 1], states[..., 3]
    c, s = torch.cos(yaw), torch.sin(yaw)
    discs = ((x + c * p.ego_front, y + s * p.ego_front), (x - c * p.ego_rear, y - s * p.ego_rear))
    for o in obstacles:
        a = o[3] / 2.0 + p.ego_rad + t.collision_margin + infl - ease
        b = o[4] / 2.0 + p.ego_rad + t.collision_margin + infl - ease
        co, so = torch.cos(o[2]), torch.sin(o[2])
        for ex, ey in discs:
            dx, dy = ex - o[0], ey - o[1]
            du = co * dx + so * dy
            dv = -so * dx + co * dy
            ok = ok & ~((du / a) ** 2 + (dv / b) ** 2 < 1.0)
    return ok


def _gradient(a):
    return torch.cat([a[:, 1:2] - a[:, :1], (a[:, 2:] - a[:, :-2]) * 0.5, a[:, -1:] - a[:, -2:-1]],
                     dim=-1)


def _steer(p: ref.Params, x, prim):
    """One plant step under primitives prim (..., 2) [acceleration,
    yaw-rate scale]: (the next state, the control)."""
    u = torch.stack([prim[..., 0].expand_as(x[..., 2]),
                     prim[..., 1] * x[..., 2] * (math.tan(p.steer_angle_max) / p.wheelbase)],
                    dim=-1)
    return ref.step(p, x, u), u


def _linspace(a: float, b: float, n: int, dtype, device):
    s = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    return torch.cat([a * (1 - s) + b * s, torch.full((1,), b, dtype=dtype, device=device)])


def cycle(p: ref.Params, t: Tree, route, obstacles, pose, sigmas, drawn_at=None) -> Cycle:
    """One planning cycle per lane from poses (L, 4), in their dtype, on the
    route (n, 2), the live obstacles (M, 6) [x, y, yaw, length, width,
    speed] and the localization sigmas (3,), each in that dtype.  The draws
    are keyed by ``drawn_at`` (L, 4), the poses as float32 lanes saw them
    (default: ``pose``)."""
    dtype, dev = pose.dtype, pose.device
    L, N, m, n_it = pose.shape[0], p.horizon, t.steer_steps, t.n_iters
    lanes = torch.arange(L, device=dev)

    # the window and its fit at the window's x
    plan = ref.local_plan(p, route, pose)
    start = torch.argmin(((route[None] - pose[:, None, :2]) ** 2).sum(-1), dim=-1)
    idx = (start[:, None] + torch.arange(p.num_of_local_wpts, device=dev)).clamp(
        max=route.shape[0] - 1)
    wx = route[idx][..., 0]
    wy = ref._poly(plan.coeffs, plan.mid, plan.scale, wx)
    gx, gy = _gradient(wx), _gradient(wy)
    gn = torch.sqrt(gx * gx + gy * gy).clamp(min=1e-6)
    nx, ny = -gy / gn, gx / gn
    goal = torch.stack([wx[:, -1], wy[:, -1]], dim=-1)

    lat = (-t.lat_max if t.lat_lo is None else t.lat_lo,
           t.lat_max if t.lat_hi is None else t.lat_hi)
    j, off, use_goal, v_t = draws(t, pose if drawn_at is None else drawn_at, wx.shape[1], lat,
                                  p.desired_speed * 1.2)
    off, v_t = off.to(dtype), v_t.to(dtype)
    at = lambda a: a.gather(1, j)
    targets = torch.where(use_goal[..., None], goal[:, None],
                          torch.stack([at(wx) + off * at(nx), at(wy) + off * at(ny)], dim=-1))

    yr = _linspace(-1.0, 1.0, t.n_yawrate, dtype, dev)
    ac = _linspace(p.acc_min / 2.0, p.acc_max, t.n_acc, dtype, dev)
    prims = torch.stack([ac.repeat(t.n_yawrate), yr.repeat_interleave(t.n_acc)], dim=-1)
    C = prims.shape[0]
    sigma0 = torch.sqrt(sigmas[0] ** 2 + sigmas[1] ** 2)

    # the tree: node 0 the root, node i + 1 grown at iteration i (or not)
    states, parents, ctrls, costs, steps, alive = [pose], [], [], [torch.zeros_like(pose[:, 0])], \
        [torch.zeros(L, dtype=torch.int64, device=dev)], [torch.ones(L, dtype=torch.bool,
                                                                     device=dev)]
    inf = torch.tensor(math.inf, dtype=dtype, device=dev)
    for i in range(n_it):
        S = torch.stack(states, dim=1)                                      # (L, i + 1, 4)
        tgt, v = targets[:, i], v_t[:, i]
        d2 = ((S[..., 0] - tgt[:, None, 0]) ** 2 + (S[..., 1] - tgt[:, None, 1]) ** 2
              + t.w_speed * (S[..., 2] - v[:, None]) ** 2)
        near = torch.argmin(torch.where(torch.stack(alive, dim=1), d2, inf), dim=-1)
        x0, t0 = S[lanes, near], torch.stack(steps, dim=1)[lanes, near]
        x, path = x0[:, None].expand(L, C, 4), []
        for _ in range(m):
            x, _ = _steer(p, x, prims)
            path.append(x)
        path = torch.stack(path, dim=2)                                     # (L, C, m, 4)
        k = t0[:, None, None] + torch.arange(1, m + 1, device=dev)
        ok = risk_ok(p, t, obstacles, path, k.expand(L, C, m), sigma0).all(-1)
        ok = ok & (t0 + m <= 4 * N)[:, None]
        end = path[:, :, -1]
        d_end = ((end[..., 0] - tgt[:, None, 0]) ** 2 + (end[..., 1] - tgt[:, None, 1]) ** 2
                 + t.w_speed * (end[..., 2] - v[:, None]) ** 2)
        best = torch.argmin(torch.where(ok, d_end, inf), dim=-1)
        grew = ok.any(-1)
        e = end[lanes, best]
        states.append(torch.where(grew[:, None], e, torch.zeros_like(e)))
        parents.append(near)
        ctrls.append(prims[best])
        costs.append(torch.stack(costs, dim=1)[lanes, near]
                     + torch.sqrt(((e[:, :2] - x0[:, :2]) ** 2).sum(-1)))
        steps.append(t0 + m)
        alive.append(grew)

    S, cost = torch.stack(states, dim=1), torch.stack(costs, dim=1)
    grown = torch.stack(alive[1:], dim=1)
    score = cost[:, 1:] + t.goal_weight * torch.sqrt(((S[:, 1:, :2] - goal[:, None]) ** 2).sum(-1))
    pick = torch.argmin(torch.where(grown, score, inf), dim=-1) + 1
    found = grown.any(-1)

    # the chain root -> chosen node, forward, as controls held over each edge
    par = torch.stack([torch.zeros_like(near)] + parents, dim=1)           # (L, n_it + 1)
    ctl = torch.stack([torch.zeros_like(ctrls[0])] + ctrls, dim=1)
    tape = torch.tensor([p.acc_min, 0.0], dtype=dtype, device=dev).repeat(L, N, 1)
    node = pick
    for _ in range(4 * N // m):
        d = torch.stack(steps, dim=1)[lanes, node] // m                     # node's depth
        for s in range(m):
            k = (d - 1) * m + s
            put = (node > 0) & (k < N)
            kk = k.clamp(0, N - 1)
            tape[lanes, kk] = torch.where(put[:, None], ctl[lanes, node], tape[lanes, kk])
        node = torch.where(node > 0, par[lanes, node], node)
    x, xs, us = pose, [pose], []
    for k in range(N):
        x, u = _steer(p, x, tape[:, k])
        xs.append(x)
        us.append(u)
    X, U = torch.stack(xs, dim=1), torch.stack(us, dim=1)
    Xb = ref_fr.brake(p, pose)
    X = torch.where(found[:, None, None], X, Xb)
    U = torch.where(found[:, None, None], U, ref_fr.controls(p, Xb))
    return Cycle(X, U, found, grown.sum(-1), score.gather(1, (pick - 1)[:, None])[:, 0])


def chain_mask(p: ref.Params, U) -> torch.Tensor:
    """(L, N+1) bool: the states X[k] that a plan's tape U (L, N, 2) reaches
    along its chain (k >= 1 and every control before it a primitive's, not
    the tail's full braking)."""
    prim = U[..., 0] != p.acc_min
    return torch.cat([torch.zeros_like(prim[:, :1]), torch.cumprod(prim.long(), dim=1).bool()],
                     dim=1)
