"""Plain PyTorch reference of one Frenet-frame lattice planning cycle.

Written from the description of the reference's Frenet baseline
(``Frenet/readme.md:1-55``: the optimal-Frenet lattice of Werling et al.,
ICRA 2010, with three ways of handling the localization uncertainty),
batched over lanes and computed in the dtype it is given: float64 to judge
the program, bfloat16 for the benchmark's control.  It imports nothing of
the program and takes none of its derived data.

One cycle per lane, from the pose the planner sees:

* The reference line is the local plan of ``reference/cilqr.local_plan``
  (the CILQR planner's window, degree-5 fit and densified sample table),
  with its arclength and unit tangents.  The pose is projected on it: the
  nearest sample (first minimum), corrected along the tangent.
* The lattice: every end offset D of ``n_lat`` in [-d_max, d_max], every
  manoeuvre time T of ``n_T`` in [T_min, T_max], every end speed V of
  ``n_v`` in [v_frac_min, v_frac_max] x the desired speed (D major, then
  T, then V).  Laterally a quintic from (d0, d'0, 0) to (D, 0, 0) over T,
  held at D after T; along the line a quartic from (s0, s'0, 0) to the
  speed V with no acceleration at T, at constant speed V after T.
* The cost of a candidate: k_lat (k_j int jerk^2 + k_t T + k_d D^2) + k_lon
  (k_j int jerk_s^2 + k_t T + k_v (V - v_des)^2), the jerk integrated over
  [0, T]; in propagation mode also w_unc times the mean over the horizon of
  the map's occupancy / 100.
* A candidate is feasible when over the whole horizon its longitudinal
  acceleration lies in [acc_min, acc_max], its speed under speed_max, it
  does not reverse, the curvature of its path (heading change over
  arclength, the arclength step at least 1 mm) stays within 1.5
  tan(steer_angle_max) / wheelbase, neither ego circle (at ego_front ahead,
  ego_rear behind, radius ego_rad) enters a live obstacle's ellipse grown
  by the collision margin (and, in expansion mode, by chi max(sigma_x,
  sigma_y)), and, in propagation mode, every point's occupancy is under
  ``unc_threshold``.  Each rule's bounds carry the program's 1e-6.
* The first candidate of least cost among the feasible ones wins; with
  none feasible, the emergency brake: full deceleration along the pose's
  heading.  The controls are the trajectory's finite differences, clamped
  to the plant's bounds.

Where it departs from the program's computation (the same semantics):

* Each rule gives a signed slack (positive where it is broken, relative to
  its bound), and a candidate is feasible where the largest is not
  positive: so a check can tell a candidate broken by a hair from one
  broken by far.  The ellipse test's slack is 1 - sqrt(q), the
  ellipse's own radial scale.
* Only the live obstacles are tested (the rows it is given), not the
  program's padded slots; obstacles are static.
* The polynomials are evaluated in the time basis from the textbook closed
  forms, not in the program's tau = t / T basis.
* Interpolation along the line and the map's bilinear sample are its own
  code: the segment of a point found by counting the knots at or below it.
* The map sample clamps its corner cells as the program does, and reads 0
  outside the grid (its edges included in the grid).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cilqr as ref


class Lattice(NamedTuple):
    """The lattice's geometry, weights and mode, from a configuration's
    ``frenet`` group (missing keys are an error, not a default)."""

    mode: str
    n_lat: int
    d_max: float
    n_T: int
    T_min: float
    T_max: float
    n_v: int
    v_frac_min: float
    v_frac_max: float
    k_j: float
    k_t: float
    k_d: float
    k_v: float
    k_lat: float
    k_lon: float
    collision_margin: float
    expansion_chi: float
    unc_threshold: float
    w_unc: float

    @classmethod
    def from_config(cls, frenet: dict) -> "Lattice":
        return cls(**{k: frenet[k] for k in cls._fields})


class Maps(NamedTuple):
    """Per-lane vehicle-frame maps: values (L, H, W) in [0, 100], grid centre
    (L, 2) in the frame, resolution, frame origin (L, 2) and yaw (L,)."""

    values: torch.Tensor
    center: torch.Tensor
    res: float
    origin_xy: torch.Tensor
    origin_yaw: torch.Tensor


class Cycle(NamedTuple):
    X_all: torch.Tensor  # (L, K, N+1, 4) every candidate [x, y, v, yaw]
    J: torch.Tensor      # (L, K) cost
    slack: torch.Tensor  # (L, K) largest relative slack of the rules (> 0: broken)
    best: torch.Tensor   # (L,) the winner's index (-1: none feasible)
    X: torch.Tensor      # (L, N+1, 4) the plan: the winner, else the brake
    U: torch.Tensor      # (L, N, 2)


def _grid(values: list, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def lattice_grid(lat: Lattice, v_des: float, dtype, device):
    """(D, T, V) of the K candidates, D major, then T, then V."""
    lin = lambda a, b, n: [a + (b - a) * i / (n - 1) for i in range(n)] if n > 1 else [a]
    d = _grid(lin(-lat.d_max, lat.d_max, lat.n_lat), dtype, device)
    T = _grid(lin(lat.T_min, lat.T_max, lat.n_T), dtype, device)
    V = _grid(lin(lat.v_frac_min * v_des, lat.v_frac_max * v_des, lat.n_v), dtype, device)
    D = d[:, None, None].expand(lat.n_lat, lat.n_T, lat.n_v).reshape(-1)
    T = T[None, :, None].expand(lat.n_lat, lat.n_T, lat.n_v).reshape(-1)
    V = V[None, None, :].expand(lat.n_lat, lat.n_T, lat.n_v).reshape(-1)
    return D, T, V


def interp(x, knots, values):
    """Piecewise-linear values (L, ...) at x (L, ...) on increasing knots
    (L, S), held at the end values outside them."""
    L, S = knots.shape
    xf = x.reshape(L, -1)
    below = (knots[:, None, :] <= xf[..., None]).sum(-1)  # knots at or below each point
    i = (below - 1).clamp(0, S - 2)
    k0, k1 = knots.gather(1, i), knots.gather(1, i + 1)
    v0, v1 = values.gather(1, i), values.gather(1, i + 1)
    w = (xf - k0) / torch.where(k1 > k0, k1 - k0, torch.ones_like(k0))
    w = torch.where(k1 > k0, w, torch.zeros_like(w)).clamp(0.0, 1.0)
    out = v0 + w * (v1 - v0)
    out = torch.where(xf <= knots[:, :1], values[:, :1], out)
    out = torch.where(xf >= knots[:, -1:], values[:, -1:], out)
    return out.reshape(x.shape)


def unwrap(a):
    """Angles along the last axis with jumps over pi taken out (2 pi each)."""
    d = torch.diff(a, dim=-1)
    m = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    m = torch.where((m == -math.pi) & (d > 0), torch.full_like(m, math.pi), m)
    fix = torch.where(d.abs() < math.pi, torch.zeros_like(d), m - d)
    return torch.cat([a[..., :1], a[..., 1:] + torch.cumsum(fix, dim=-1)], dim=-1)


def sample_map(maps: Maps, pts):
    """Bilinear occupancy of each lane's own map at global points (L, P, 2),
    0 outside the grid."""
    L = pts.shape[0]
    H, W = maps.values.shape[1:]
    res = maps.res
    c, s = torch.cos(maps.origin_yaw)[:, None], torch.sin(maps.origin_yaw)[:, None]
    dx = pts[..., 0] - maps.origin_xy[:, 0, None]
    dy = pts[..., 1] - maps.origin_xy[:, 1, None]
    lx, ly = c * dx + s * dy, -s * dx + c * dy
    c0, c1 = maps.center[:, 0, None], maps.center[:, 1, None]
    hx, hy = 0.5 * H * res, 0.5 * W * res
    inside = (lx >= c0 - hx) & (lx <= c0 + hx) & (ly >= c1 - hy) & (ly <= c1 + hy)
    fi = ((c0 + hx - 0.5 * res - lx) / res).clamp(0.0, H - 1.0)
    fj = ((c1 + hy - 0.5 * res - ly) / res).clamp(0.0, W - 1.0)
    i0 = torch.floor(fi).long().clamp(0, H - 2)
    j0 = torch.floor(fj).long().clamp(0, W - 2)
    ti, tj = fi - i0, fj - j0
    lane = torch.arange(L, device=pts.device)[:, None]
    v = maps.values
    top = v[lane, i0, j0] * (1 - tj) + v[lane, i0, j0 + 1] * tj
    bottom = v[lane, i0 + 1, j0] * (1 - tj) + v[lane, i0 + 1, j0 + 1] * tj
    u = top * (1 - ti) + bottom * ti
    return torch.where(inside, u, torch.zeros_like(u))


def brake(p: ref.Params, ego):
    """The emergency brake (L, N+1, 4) from poses (L, 4)."""
    t = torch.arange(p.horizon + 1, dtype=ego.dtype, device=ego.device) * p.timestep
    v = (ego[:, 2:3] + p.acc_min * t).clamp(min=0.0)
    s = torch.cat([torch.zeros_like(v[:, :1]), torch.cumsum(v[:, :-1] * p.timestep, dim=-1)], -1)
    yaw = ego[:, 3:4].expand_as(v)
    return torch.stack([ego[:, :1] + s * torch.cos(yaw), ego[:, 1:2] + s * torch.sin(yaw), v, yaw],
                       dim=-1)


def controls(p: ref.Params, X):
    """The finite-difference controls of trajectories X (L, N+1, 4), clamped
    to the plant's bounds at each step's speed."""
    acc = (torch.diff(X[..., 2], dim=-1) / p.timestep).clamp(p.acc_min, p.acc_max)
    yr = torch.diff(unwrap(X[..., 3]), dim=-1) / p.timestep
    v = X[:, :-1, 2]
    lo = v * math.tan(p.steer_angle_min) / p.wheelbase
    hi = v * math.tan(p.steer_angle_max) / p.wheelbase
    return torch.stack([acc, torch.minimum(torch.maximum(yr, lo), hi)], dim=-1)


def _quintic(T, p0, v0, p1):
    """Coefficients (c3, c4, c5) of t^3..t^5 from (p0, v0, 0) to (p1, 0, 0)
    over T."""
    dp = p1 - p0
    return ((20 * dp - 12 * v0 * T) / (2 * T ** 3), (-30 * dp + 16 * v0 * T) / (2 * T ** 4),
            (12 * dp - 6 * v0 * T) / (2 * T ** 5))


def _quartic(T, v0, v1):
    """Coefficients (c3, c4) of t^3, t^4 from speed v0 (no acceleration) to
    v1 with no acceleration at T."""
    dv = v1 - v0
    return dv / T ** 2, -dv / (2 * T ** 3)


def _jerk_cost(T, c3, c4, c5):
    """int_0^T (6 c3 + 24 c4 t + 60 c5 t^2)^2 dt."""
    a, b, c = 6 * c3, 24 * c4, 60 * c5
    return (a * a * T + a * b * T ** 2 + (b * b + 2 * a * c) * T ** 3 / 3 + b * c * T ** 4 / 2
            + c * c * T ** 5 / 5)


def cycle(p: ref.Params, lat: Lattice, route, obstacles, ego, maps: Maps | None = None,
          sigmas=None) -> Cycle:
    """One planning cycle per lane at the poses ego (L, 4) [x, y, v, yaw]:
    ``route`` (n, 2), ``obstacles`` (M, 6) rows [x, y, yaw, length, width,
    speed] (all live), ``maps`` read in propagation mode, ``sigmas`` (3,)
    in expansion mode."""
    dtype, dev = ego.dtype, ego.device
    L, N = ego.shape[0], p.horizon
    plan = ref.local_plan(p, route, ego)
    lx, ly = plan.sx, plan.sy                                    # (L, S)
    seg = torch.sqrt(torch.diff(lx, dim=-1) ** 2 + torch.diff(ly, dim=-1) ** 2)
    arc = torch.cat([torch.zeros_like(lx[:, :1]), torch.cumsum(seg, dim=-1)], dim=-1)
    grad = lambda a: torch.cat([a[:, 1:2] - a[:, :1], (a[:, 2:] - a[:, :-2]) / 2,
                                a[:, -1:] - a[:, -2:-1]], dim=-1)
    gx_, gy_ = grad(lx), grad(ly)
    norm = torch.sqrt(gx_ * gx_ + gy_ * gy_).clamp(min=1e-9)
    tx, ty = gx_ / norm, gy_ / norm

    # the pose in the line's frame
    i = torch.argmin((lx - ego[:, :1]) ** 2 + (ly - ego[:, 1:2]) ** 2, dim=-1, keepdim=True)
    at = lambda a: a.gather(1, i)[:, 0]
    ex, ey = ego[:, 0] - at(lx), ego[:, 1] - at(ly)
    tx0, ty0 = at(tx), at(ty)
    s0 = at(arc) + tx0 * ex + ty0 * ey
    d0 = -ty0 * ex + tx0 * ey
    rel = ego[:, 3] - torch.atan2(ty0, tx0)
    sd0, dd0 = ego[:, 2] * torch.cos(rel), ego[:, 2] * torch.sin(rel)

    D, T, V = lattice_grid(lat, p.desired_speed, dtype, dev)       # (K,)
    t = torch.arange(N + 1, dtype=dtype, device=dev) * p.timestep   # (N+1,)
    col = lambda a: a[None, :, None]                                # (1, K, 1)
    row = lambda a: a[:, None, None]                                # (L, 1, 1)
    Tk = col(T)
    tc = torch.minimum(t, Tk)                                       # (1, K, N+1)
    c3, c4, c5 = _quintic(Tk, row(d0), row(dd0), col(D))
    d = row(d0) + row(dd0) * tc + c3 * tc ** 3 + c4 * tc ** 4 + c5 * tc ** 5
    dd = row(dd0) + 3 * c3 * tc ** 2 + 4 * c4 * tc ** 3 + 5 * c5 * tc ** 4
    q3, q4 = _quartic(Tk, row(sd0), col(V))
    s = row(s0) + row(sd0) * tc + q3 * tc ** 3 + q4 * tc ** 4 + col(V) * (t - tc)
    sd = torch.where(t > Tk, col(V).expand_as(s), row(sd0) + 3 * q3 * tc ** 2 + 4 * q4 * tc ** 3)
    sdd = torch.where(t > Tk, torch.zeros_like(s), 6 * q3 * tc + 12 * q4 * tc ** 2)

    xr, yr = interp(s, arc, lx), interp(s, arc, ly)
    txr, tyr = interp(s, arc, tx), interp(s, arc, ty)
    tn = torch.sqrt(txr * txr + tyr * tyr).clamp(min=1e-9)
    txr, tyr = txr / tn, tyr / tn
    gx, gy = xr - d * tyr, yr + d * txr
    gv = torch.sqrt(sd * sd + dd * dd)
    yaw = torch.atan2(tyr, txr) + torch.atan2(dd, sd.clamp(min=1e-3))
    X_all = torch.stack([gx, gy, gv, yaw], dim=-1)

    J_lat = (lat.k_j * _jerk_cost(T, c3[..., 0], c4[..., 0], c5[..., 0]) + lat.k_t * T
             + lat.k_d * D * D)
    J_lon = (lat.k_j * _jerk_cost(T, q3[..., 0], q4[..., 0], torch.zeros_like(q4[..., 0]))
             + lat.k_t * T + lat.k_v * (V - p.desired_speed) ** 2)
    J = lat.k_lat * J_lat + lat.k_lon * J_lon

    # signed slack of each rule, relative to its bound, largest over the horizon
    rules = [(sdd - (p.acc_max + 1e-6)) / max(abs(p.acc_max), 1.0),
             ((p.acc_min - 1e-6) - sdd) / max(abs(p.acc_min), 1.0),
             (gv - (p.speed_max + 1e-6)) / p.speed_max,
             -sd - 1e-6]
    slack = torch.stack([r.amax(-1) for r in rules]).amax(0)
    kappa = 1.5 * math.tan(p.steer_angle_max) / p.wheelbase
    curv = (torch.diff(unwrap(yaw), dim=-1) / torch.diff(s, dim=-1).clamp(min=1e-3)).abs()
    slack = torch.maximum(slack, ((curv - kappa) / kappa).amax(-1))
    if obstacles.shape[0]:
        grow = 0.0
        if lat.mode == "expansion":
            grow = lat.expansion_chi * max(float(sigmas[0]), float(sigmas[1]))
        cy, sy_ = torch.cos(yaw), torch.sin(yaw)
        for ox, oy, oyaw, length, width, _ in obstacles.tolist():
            a = length / 2 + lat.collision_margin + p.ego_rad + grow
            b = width / 2 + lat.collision_margin + p.ego_rad + grow
            co, so = math.cos(oyaw), math.sin(oyaw)
            for reach in (p.ego_front, -p.ego_rear):
                dx, dy = gx + reach * cy - ox, gy + reach * sy_ - oy
                q = ((co * dx + so * dy) / a) ** 2 + ((-so * dx + co * dy) / b) ** 2
                slack = torch.maximum(slack, (1.0 - torch.sqrt(q)).amax(-1))
    if lat.mode == "propagation" and maps is not None:
        u = sample_map(maps, X_all[..., :2].reshape(L, -1, 2)).reshape(gx.shape)
        slack = torch.maximum(slack, ((u - lat.unc_threshold) / lat.unc_threshold).amax(-1))
        J = J + lat.w_unc * (u / 100.0).mean(-1)

    feasible = slack <= 0
    masked = torch.where(feasible, J, torch.full_like(J, math.inf))
    best = torch.argmin(masked, dim=-1)
    any_ok = feasible.any(-1)
    X = torch.where(any_ok[:, None, None], X_all[torch.arange(L, device=dev), best], brake(p, ego))
    best = torch.where(any_ok, best, torch.full_like(best, -1))
    return Cycle(X_all, J, slack, best, X, controls(p, X))
