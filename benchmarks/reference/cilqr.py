"""Plain PyTorch reference of one uncertainty-aware CILQR planning cycle.

Written from the reference planner's C++ semantics (``iLQR.cpp``,
``Constraints.cpp``, ``Obstacle.cpp``, ``Model.cpp``, ``LocalPlanner.cpp``),
batched over lanes and computed in the dtype it is given: float64 to judge
the program, bfloat16 for the benchmark's control.  It imports nothing of
the program and takes none of its derived data: the plan fit, the
closest-point table, the obstacle ellipses and the map samples are worked
out here again from the benchmark's inputs.

The semantics kept, as the program states them:

* Jacobians at the successor states; V seeded from the running cost of
  step N-1; the acceptance cost J on the pre-update trajectory without any
  barrier; the 2x2 eigenvalue clamp of Q_uu shifted by lambda.
* The local plan: ``num_of_local_wpts`` waypoints from the nearest one
  (the last repeated at the end of the route), a degree-5 least-squares fit
  of y(x) in a centred and scaled basis, and ``num_of_local_wpts * 10``
  closest-point samples (first minimum wins).
* Lambda is multiplied by 1/lamb_factor rounded to the working dtype; a
  lane stops when an accepted step changes J by less than the tolerance or
  lambda passes lamb_max.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Params(NamedTuple):
    """The solver settings the reference reads, from a configuration's
    ``solver`` group (missing keys are an error, not a default)."""

    num_of_local_wpts: int
    poly_order: int
    desired_speed: float
    timestep: float
    horizon: int
    tolerance: float
    max_iterations: int
    w_acc: float
    w_yawrate: float
    w_pos: float
    w_vel: float
    w_obstacle: float
    w_uncertainty: float
    q1_acc: float
    q2_acc: float
    q1_yawrate: float
    q2_yawrate: float
    q1_front: float
    q2_front: float
    q1_rear: float
    q2_rear: float
    q1_uncertainty: float
    q2_uncertainty: float
    acc_max: float
    acc_min: float
    steer_angle_min: float
    steer_angle_max: float
    wheelbase: float
    speed_max: float
    t_safe: float
    s_safe_a: float
    s_safe_b: float
    ego_rad: float
    ego_front: float
    ego_rear: float
    lamb_factor: float
    lamb_max: float
    lamb_init: float
    closest_point_samples_per_wpt: int

    @classmethod
    def from_config(cls, solver: dict) -> "Params":
        if solver.get("chord_frame_fit") or solver.get("exact_end_shrink"):
            raise ValueError("the reference fits y(x) on the plain window only")
        return cls(**{k: solver[k] for k in cls._fields})


class World(NamedTuple):
    """What a solve sees besides its ego and warm start.

    plan: (n, 2) route; obstacles: (M, 6) rows [x, y, yaw, length, width,
    speed], constant over the horizon; maps: None, (H, W) shared or (L, H,
    W) one per lane, occupancy in [0, 100] with the vehicle-frame grid
    centred at ``map_center`` at ``map_res`` and its frame at
    (``origin_xy``, ``origin_yaw``): each shared, or one per lane ((L, 2),
    (L, 2), (L,))."""

    plan: torch.Tensor
    obstacles: torch.Tensor
    maps: torch.Tensor | None
    map_center: object
    map_res: float
    origin_xy: object
    origin_yaw: object


class Result(NamedTuple):
    X: torch.Tensor           # (L, N+1, 4)
    U: torch.Tensor           # (L, N, 2)
    iterations: torch.Tensor  # (L,)
    J: torch.Tensor           # (L,)


# ---------------------------------------------------------------- dynamics
def _yaw_rate_bounds(p: Params, v):
    return (v * math.tan(p.steer_angle_min) / p.wheelbase,
            v * math.tan(p.steer_angle_max) / p.wheelbase)


def step(p: Params, x, u):
    """Model.cpp:17-30: clamp the controls, one Euler step, clamp the speed."""
    acc = u[..., 0].clamp(p.acc_min, p.acc_max)
    lo, hi = _yaw_rate_bounds(p, x[..., 2])
    yr = torch.minimum(torch.maximum(u[..., 1], lo), hi)
    dt = p.timestep
    ds = x[..., 2] * dt + 0.5 * acc * dt * dt
    return torch.stack([x[..., 0] + torch.cos(x[..., 3]) * ds,
                        x[..., 1] + torch.sin(x[..., 3]) * ds,
                        (x[..., 2] + acc * dt).clamp(0.0, p.speed_max),
                        x[..., 3] + yr * dt], dim=-1)


def rollout(p: Params, x0, U):
    xs = [x0]
    for j in range(U.shape[-2]):
        xs.append(step(p, xs[-1], U[:, j]))
    return torch.stack(xs, dim=1)


# ------------------------------------------------------------ local plan
class Plan(NamedTuple):
    coeffs: torch.Tensor  # (L, order+1) ascending in t = (x - mid) / scale
    mid: torch.Tensor
    scale: torch.Tensor
    sx: torch.Tensor      # (L, S) closest-point samples
    sy: torch.Tensor


def _poly(coeffs, mid, scale, x):
    t = (x - mid[:, None]) / scale[:, None]
    r = torch.zeros_like(t)
    for i in reversed(range(coeffs.shape[-1])):
        r = r * t + coeffs[:, i, None]
    return r


def _cholesky_solve(G, b):
    """G x = b for small symmetric positive definite G (L, m, m), written out
    so that it runs in any floating dtype."""
    m = G.shape[-1]
    Lo = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = G[:, i, j]
            for k in range(j):
                s = s - Lo[i][k] * Lo[j][k]
            Lo[i][j] = torch.sqrt(s) if i == j else s / Lo[j][j]
    z = []
    for i in range(m):
        s = b[:, i]
        for k in range(i):
            s = s - Lo[i][k] * z[k]
        z.append(s / Lo[i][i])
    x = [None] * m
    for i in reversed(range(m)):
        s = z[i]
        for k in range(i + 1, m):
            s = s - Lo[k][i] * x[k]
        x[i] = s / Lo[i][i]
    return torch.stack(x, dim=-1)


def local_plan(p: Params, plan, ego) -> Plan:
    """LocalPlanner.cpp:25-117 and the sample table of Constraints.cpp:24-42."""
    n = plan.shape[0]
    d = ((plan[None, :, :] - ego[:, None, :2]) ** 2).sum(-1)
    start = torch.argmin(d, dim=-1)
    idx = (start[:, None] + torch.arange(p.num_of_local_wpts, device=plan.device)).clamp(max=n - 1)
    w = plan[idx]
    x, y = w[..., 0], w[..., 1]
    mid = 0.5 * (x.amax(-1) + x.amin(-1))
    scale = (0.5 * (x.amax(-1) - x.amin(-1))).clamp(min=1e-6)
    t = (x - mid[:, None]) / scale[:, None]
    V = torch.stack([t ** k for k in range(p.poly_order + 1)], dim=-1)  # (L, W, m)
    y_mid = y.mean(-1)
    G = (V[:, :, :, None] * V[:, :, None, :]).sum(1)
    b = (V * (y - y_mid[:, None])[..., None]).sum(1)
    coeffs = _cholesky_solve(G, b)
    coeffs = torch.cat([coeffs[:, :1] + y_mid[:, None], coeffs[:, 1:]], dim=-1)
    S = p.num_of_local_wpts * p.closest_point_samples_per_wpt
    dx = (x[:, -1] - x[:, 0]) / S
    sx = x[:, :1] + dx[:, None] * torch.arange(S, dtype=x.dtype, device=x.device)
    return Plan(coeffs, mid, scale, sx, _poly(coeffs, mid, scale, sx))


def closest_points(plan: Plan, X):
    """Constraints.cpp:24-59 for X (L, N, >=2) -> (L, N, 2)."""
    d = (plan.sx[:, None, :] - X[..., 0:1]) ** 2 + (plan.sy[:, None, :] - X[..., 1:2]) ** 2
    j = torch.argmin(d, dim=-1)
    return torch.stack([torch.gather(plan.sx, 1, j), torch.gather(plan.sy, 1, j)], dim=-1)


# ------------------------------------------------------------------- costs
def _outer(g):
    return g[..., :, None] * g[..., None, :]


def _obstacle_terms(p: Params, obstacles, X):
    """Obstacle.cpp:39-112 summed over obstacles: (L, N, 2), (L, N, 2, 2)."""
    vx = torch.zeros(X.shape[:-1] + (2,), dtype=X.dtype, device=X.device)
    mx = torch.zeros(X.shape[:-1] + (2, 2), dtype=X.dtype, device=X.device)
    for ox, oy, oth, length, width, speed in obstacles.tolist():
        a = length / 2.0 + abs(speed * math.cos(oth)) * p.t_safe + p.s_safe_a + p.ego_rad
        b = width / 2.0 + abs(speed * math.sin(oth)) * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
        co, so = math.cos(oth), math.sin(oth)
        for sign, reach, q1, q2 in ((1.0, p.ego_front, p.q1_front, p.q2_front),
                                    (-1.0, p.ego_rear, p.q1_rear, p.q2_rear)):
            ex = X[..., 0] + sign * torch.cos(X[..., 3]) * reach - ox
            ey = X[..., 1] + sign * torch.sin(X[..., 3]) * reach - oy
            dx = co * ex + so * ey
            dy = -so * ex + co * ey
            c = 1.0 - (dx * dx / (a * a) + dy * dy / (b * b))
            g = torch.stack([-2.0 * (co * dx / (a * a) - so * dy / (b * b)),
                             -2.0 * (so * dx / (a * a) + co * dy / (b * b))], dim=-1)
            e = q1 * torch.exp(q2 * c)
            vx = vx + (q2 * e)[..., None] * g
            mx = mx + (q2 * q2 * e)[..., None, None] * _outer(g)
    return vx, mx


def _per_lane(value, shape: tuple, like) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device).expand(shape)


def _map_terms(p: Params, world: World, X):
    """The uncertainty barrier: the map sampled bilinearly (border cells
    clamp) in its own frame, zero outside it.  (L, N, 2), (L, N, 2, 2)."""
    maps = world.maps
    L, N = X.shape[:2]
    if maps.ndim == 2:
        maps = maps.expand(L, *maps.shape)
    H, W = maps.shape[1:]
    res = world.map_res
    center = _per_lane(world.map_center, (L, 2), X)
    origin = _per_lane(world.origin_xy, (L, 2), X)
    yaw = _per_lane(world.origin_yaw, (L,), X)
    cy, sy = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    d0 = X[..., 0] - origin[:, 0, None]
    d1 = X[..., 1] - origin[:, 1, None]
    lx, ly = cy * d0 + sy * d1, -sy * d0 + cy * d1
    half_x, half_y = 0.5 * H * res, 0.5 * W * res
    c0, c1 = center[:, 0, None], center[:, 1, None]
    inside = ((lx >= c0 - half_x) & (lx <= c0 + half_x) & (ly >= c1 - half_y)
              & (ly <= c1 + half_y))
    fi = ((c0 + half_x - 0.5 * res - lx) / res).clamp(0.0, H - 1.0)
    fj = ((c1 + half_y - 0.5 * res - ly) / res).clamp(0.0, W - 1.0)
    i0 = torch.floor(fi).long().clamp(0, H - 2)
    j0 = torch.floor(fj).long().clamp(0, W - 2)
    ti, tj = fi - i0, fj - j0
    lane = torch.arange(L, device=X.device)[:, None]
    v00, v01 = maps[lane, i0, j0], maps[lane, i0, j0 + 1]
    v10, v11 = maps[lane, i0 + 1, j0], maps[lane, i0 + 1, j0 + 1]
    v0 = v00 * (1 - tj) + v01 * tj
    v1 = v10 * (1 - tj) + v11 * tj
    u = v0 * (1 - ti) + v1 * ti
    gi = -(v1 - v0) / res / 100.0
    gj = -((v01 - v00) * (1 - ti) + (v11 - v10) * ti) / res / 100.0
    g = torch.stack([cy * gi - sy * gj, sy * gi + cy * gj], dim=-1)
    e = torch.where(inside, p.q1_uncertainty * torch.exp(p.q2_uncertainty * u / 100.0),
                    torch.zeros_like(u))
    return (p.q2_uncertainty * e)[..., None] * g, (p.q2_uncertainty ** 2 * e)[..., None, None] * _outer(g)


def _barrier(q1, q2, c):
    e = q1 * torch.exp(q2 * c)
    return q2 * e, q2 * q2 * e


def derivatives_and_J(p: Params, plan: Plan, world: World, X, U):
    """Constraints.cpp:86-227 and :534-561 at (X, U)."""
    N = p.horizon
    Xh = X[:, :N]
    cp = closest_points(plan, Xh)
    ex, ey, ev = Xh[..., 0] - cp[..., 0], Xh[..., 1] - cp[..., 1], Xh[..., 2] - p.desired_speed
    zero = torch.zeros_like(ex)
    l_x = torch.stack([2 * p.w_pos * ex, 2 * p.w_pos * ey, 2 * p.w_vel * ev, zero], dim=-1)
    l_xx = torch.zeros(Xh.shape + (4,), dtype=X.dtype, device=X.device)
    l_xx[..., 0, 0] = 2 * p.w_pos
    l_xx[..., 1, 1] = 2 * p.w_pos
    l_xx[..., 2, 2] = 2 * p.w_vel
    terms = []
    if world.obstacles.shape[0]:
        terms.append((p.w_obstacle, _obstacle_terms(p, world.obstacles, Xh)))
    if world.maps is not None:
        terms.append((p.w_uncertainty, _map_terms(p, world, Xh)))
    for w, (vx, mx) in terms:
        l_x = torch.cat([l_x[..., :2] + w * vx, l_x[..., 2:]], dim=-1)
        l_xx[..., :2, :2] += w * mx

    acc, yr = U[..., 0], U[..., 1]
    lo, hi = _yaw_rate_bounds(p, Xh[..., 2])
    g1, h1 = _barrier(p.q1_acc, p.q2_acc, acc - p.acc_max)
    g2, h2 = _barrier(p.q1_acc, p.q2_acc, p.acc_min - acc)
    g3, h3 = _barrier(p.q1_yawrate, p.q2_yawrate, yr - hi)
    g4, h4 = _barrier(p.q1_yawrate, p.q2_yawrate, lo - yr)
    l_u = torch.stack([g1 - g2 + 2 * p.w_acc * acc, g3 - g4 + 2 * p.w_yawrate * yr], dim=-1)
    l_uu = torch.zeros(U.shape + (2,), dtype=X.dtype, device=X.device)
    l_uu[..., 0, 0] = h1 + h2 + 2 * p.w_acc
    l_uu[..., 1, 1] = h3 + h4 + 2 * p.w_yawrate

    J = (p.w_pos * (ex * ex + ey * ey) + p.w_vel * ev * ev).sum(-1) \
        + (p.w_acc * acc * acc + p.w_yawrate * yr * yr).sum(-1)
    return l_x, l_xx, l_u, l_uu, J


# ------------------------------------------------------------------ solver
def _clamped_inverse(Q, lamb):
    """iLQR.cpp:155-175 for symmetric 2x2 Q (L, 2, 2): the eigenvalues
    clamped at 0, shifted by lamb (L,), inverted and recomposed."""
    a, b, c = Q[:, 0, 0], Q[:, 0, 1], Q[:, 1, 1]
    mean, half = 0.5 * (a + c), 0.5 * (a - c)
    r = torch.sqrt(half * half + b * b)
    w_lo, w_hi = mean - r, mean + r
    # unit eigenvector of w_hi: (b, w_hi - a), or an axis when b is nought
    flat = b.abs() <= torch.finfo(Q.dtype).eps * (a.abs() + c.abs())
    vx = torch.where(flat, (a >= c).to(Q.dtype), b)
    vy = torch.where(flat, (a < c).to(Q.dtype), w_hi - a)
    n = torch.sqrt(vx * vx + vy * vy)
    vx, vy = vx / n, vy / n
    i_lo = 1.0 / (w_lo.clamp(min=0.0) + lamb)
    i_hi = 1.0 / (w_hi.clamp(min=0.0) + lamb)
    # V diag(i_lo, i_hi) V^T with V = [[-vy, vx], [vx, vy]]
    m00 = vy * vy * i_lo + vx * vx * i_hi
    m01 = -vy * vx * i_lo + vx * vy * i_hi
    m11 = vx * vx * i_lo + vy * vy * i_hi
    return torch.stack([torch.stack([m00, m01], -1), torch.stack([m01, m11], -1)], -2)


def _jacobians(p: Params, v, th, acc):
    """Model.cpp:100-155 at the successor states: fx (L, 4, 4), fu (L, 4, 2)."""
    L = v.shape[0]
    dt = p.timestep
    c, s = torch.cos(th), torch.sin(th)
    ds = v * dt + 0.5 * acc * dt * dt
    fx = torch.eye(4, dtype=v.dtype, device=v.device).repeat(L, 1, 1)
    fx[:, 0, 2] = dt * c
    fx[:, 0, 3] = -s * ds
    fx[:, 1, 2] = dt * s
    fx[:, 1, 3] = c * ds
    fu = torch.zeros((L, 4, 2), dtype=v.dtype, device=v.device)
    fu[:, 0, 0] = 0.5 * dt * dt * c
    fu[:, 1, 0] = 0.5 * dt * dt * s
    fu[:, 2, 0] = dt
    fu[:, 3, 1] = dt
    return fx, fu


def _mm(a, b):
    """Batched product written as a broadcast sum, so that no matrix unit of
    the device (and none of its reduced-precision modes) takes part."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _T(a):
    return a.transpose(-1, -2)


def iteration(p: Params, plan: Plan, world: World, X, U, lamb):
    """One LM iteration: derivatives and J at (X, U), the backward pass
    (iLQR.cpp:91-195) and the closed-loop rollout (iLQR.cpp:68-86)."""
    N = p.horizon
    l_x, l_xx, l_u, l_uu, J = derivatives_and_J(p, plan, world, X, U)
    V_x = l_x[:, N - 1, :, None]
    V_xx = l_xx[:, N - 1]
    ks, Ks = [None] * N, [None] * N
    for j in reversed(range(N)):
        fx, fu = _jacobians(p, X[:, j + 1, 2], X[:, j + 1, 3], U[:, j, 0])
        Q_x = l_x[:, j, :, None] + _mm(_T(fx), V_x)
        Q_u = l_u[:, j, :, None] + _mm(_T(fu), V_x)
        Q_xx = l_xx[:, j] + _mm(_mm(_T(fx), V_xx), fx)
        Q_ux = _mm(_mm(_T(fu), V_xx), fx)
        Q_uu = l_uu[:, j] + _mm(_mm(_T(fu), V_xx), fu)
        inv = _clamped_inverse(Q_uu, lamb)
        k = -_mm(inv, Q_u)
        K = -_mm(inv, Q_ux)
        V_x = Q_x - _mm(_T(K), _mm(Q_uu, k))
        V_xx = Q_xx - _mm(_T(K), _mm(Q_uu, K))
        ks[j], Ks[j] = k[..., 0], K
    x = X[:, 0]
    xs, us = [x], []
    for j in range(N):
        u = U[:, j] + ks[j] + _mm(Ks[j], (x - X[:, j])[..., None])[..., 0]
        x = step(p, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, 1), torch.stack(us, 1), J


def solve(p: Params, world: World, ego, U_init) -> Result:
    """iLQR.cpp:201-255 on every lane: ego (L, 4), U_init (L, N, 2)."""
    dtype, dev = ego.dtype, ego.device
    plan = local_plan(p, world.plan, ego)
    X = rollout(p, ego, U_init)
    U = U_init.clone()
    L = ego.shape[0]
    lamb = torch.full((L,), p.lamb_init, dtype=dtype, device=dev)
    J_old = torch.full((L,), torch.finfo(dtype).max, dtype=dtype, device=dev)
    it = torch.zeros(L, dtype=torch.int64, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    shrink = torch.tensor(p.lamb_factor, dtype=dtype, device=dev).reciprocal()
    for _ in range(p.max_iterations):
        if bool(done.all()):
            break
        X_new, U_new, J_new = iteration(p, plan, world, X, U, lamb)
        accept = J_new < J_old
        take = (accept & ~done)[:, None, None]
        X = torch.where(take, X_new, X)
        U = torch.where(take, U_new, U)
        lamb_n = torch.where(accept, lamb * shrink, lamb * p.lamb_factor)
        stop = torch.where(accept, (J_new - J_old).abs() < p.tolerance, lamb_n > p.lamb_max)
        J_old = torch.where(done, J_old, J_new)
        lamb = torch.where(done, lamb, lamb_n)
        it = torch.where(done, it, it + 1)
        done = done | stop
    return Result(X, U, it, J_old)


def initial_controls(p: Params, L: int, dtype, device):
    """The cold start of iLQR.cpp:9-15: acceleration 0.5, yaw rate 0 for the
    first N/2 steps, then 0.1."""
    U = torch.zeros((L, p.horizon, 2), dtype=dtype, device=device)
    U[..., 0] = 0.5
    U[:, p.horizon // 2:, 1] = 0.1
    return U
