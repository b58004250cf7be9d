"""Frenet-frame lattice planner — the reference's `Frenet/` baseline.

Port of ``cilqr_tpu/models/frenet.py``, batched over a leading B axis of
ego states.  The standard optimal-Frenet lattice (Werling et al., ICRA
2010) with the reference's three uncertainty-handling modes
(`Frenet/readme.md:1-55`):

  * ``origin``      — localization uncertainty ignored;
  * ``expansion``   — obstacle footprints inflated by the chi * sigma
    confidence bound;
  * ``propagation`` — the propagated uncertainty costmap consumed as the
    CILQR planner consumes it (cells above a threshold block, the mean
    occupancy along a candidate costs).

Every lane evaluates the same static lattice of K = n_lat * n_T * n_v
candidates over the whole horizon as (B, K, N+1) tensors; infeasible
candidates are masked (+inf cost) and the first candidate of least cost
wins (``torch.argmin`` takes the first index on ties, as ``jnp.argmin``
does), fetched by an index gather.  The reference line is the CILQR local
plan (global-plan window + degree-5 polyfit + densified sample table), so
both planners track the identical path.  No TPU kernel stands behind
this module (the JAX package's lattice is plain XLA); on the card the
candidates' evaluation and the selection are one CUDA kernel
(``ops/frenet_cuda.lattice`` → op ``cilqr_torch::frenet_lattice`` →
``csrc/frenet.cu``), whose plain version is ``lattice_plain``: a block per
lane and a thread per candidate, so no (B, K, N+1) tensor is formed there.
The reference line, the lane's start terms, the grid, the obstacle slots'
terms, the brake and the controls stay in PyTorch.

The closed loops call ``run_steps``: one cycle as a stage of
``solver.run``, on the card one CUDA graph per parameters, mode and shapes,
replayed (elsewhere, and inside ``route.plain()``, the same call eagerly).
So ``plan_steps`` reads nothing from the host and makes no tensor from
host data: it is given the curvature bound (``curvature_bound``, made once
outside the step).  Span (``utils.profiling``): each ``run_steps`` call,
``frenet.plan``, holding the stage's ``run.*`` spans.  Counters (entered in
``profiling.HOST_COUNTERS``, read by ``profiling.counters()``): ``PLANS``,
the ``run_steps`` calls, ``CANDIDATES``, the (lane, candidate) pairs they
evaluated, on the host; ``FEASIBLE``, the pairs that were feasible, summed
on the card from the lattice's per-lane counts and read while tracing
(``profiling.DeviceCounter``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from cilqr_tpu_torch.models import dynamics, solver
from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.ops import frenet_cuda, gridmap
from cilqr_tpu_torch.utils import profiling
from cilqr_tpu_torch.utils.params import SolverParams

MODES = ("origin", "expansion", "propagation")

PLANS = 0       # ``run_steps`` calls (host counter)
CANDIDATES = 0  # (lane, candidate) pairs those calls evaluated (host counter)
profiling.HOST_COUNTERS.extend((sys.modules[__name__], n) for n in ("PLANS", "CANDIDATES"))
#: feasible (lane, candidate) pairs of the traced calls: ``plan_steps`` adds
#: the lattice's per-lane feasible counts on the card (``_FEASIBLE``; inside
#: the graph), read while tracing (``profiling.device_counters``)
FEASIBLE = 0
_FEASIBLE = profiling.DeviceCounter(sys.modules[__name__], "FEASIBLE")


@dataclasses.dataclass(frozen=True)
class FrenetParams:
    """Lattice geometry, cost weights and uncertainty mode (the Werling
    weights: jerk k_j, time k_t, terminal lateral offset k_d, terminal
    speed error k_v, and the lat/lon combination weights).  T_min=1.0 keeps
    late swerves representable; v_frac_min=0.0 includes full braking, so a
    blocked corridor degrades to a stop."""

    mode: str = "origin"

    n_lat: int = 9           # lateral end-offset candidates in [-d_max, d_max]
    d_max: float = 3.0
    n_T: int = 4             # maneuver durations in [T_min, T_max]
    T_min: float = 1.0
    T_max: float = 4.0
    n_v: int = 5             # target speeds in [v_frac_min, v_frac_max]*v_des
    v_frac_min: float = 0.0
    v_frac_max: float = 1.2

    k_j: float = 0.1
    k_t: float = 0.1
    k_d: float = 1.0
    k_v: float = 1.0
    k_lat: float = 1.0
    k_lon: float = 1.0

    collision_margin: float = 0.5

    expansion_chi: float = 2.4477  # 95% confidence (chisquare_val, ARBIT.cuh)
    unc_threshold: float = 80.0    # propagation mode: cells above block
    w_unc: float = 2.0             # propagation mode: integrated-occupancy weight

    @property
    def n_candidates(self) -> int:
        return self.n_lat * self.n_T * self.n_v

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")


class FrenetResult(NamedTuple):
    """Best-candidate trajectories, field-compatible with ``SolveResult``."""

    X: torch.Tensor           # (B, N+1, 4) [x, y, v, theta]
    U: torch.Tensor           # (B, N, 2) finite-difference [accel, yaw-rate]
    ref_x: torch.Tensor       # (B, num_of_local_wpts)
    ref_y: torch.Tensor
    iterations: torch.Tensor  # (B,) int32 selected candidate index
    J: torch.Tensor           # (B,) winning candidate cost
    lamb: torch.Tensor        # (B,) 1.0 if any candidate feasible else 0.0


def _ipow(x, n: int):
    """x ** n by JAX's ``integer_pow`` (binary exponentiation), so the
    products round as the JAX package's do."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _quintic(T, p0, v0, a0, p1, v1, a1):
    """Quintic boundary solve in the tau = t/T basis: the closed form of
    the constant 3x3 system [[1,1,1],[3,4,5],[6,12,20]] (det 2)."""
    h = p1 - p0 - v0 * T - 0.5 * a0 * T * T
    g = (v1 - v0 - a0 * T) * T
    f = (a1 - a0) * T * T
    b3 = 0.5 * (20.0 * h - 8.0 * g + f)
    b4 = 0.5 * (-30.0 * h + 14.0 * g - 2.0 * f)
    b5 = 0.5 * (12.0 * h - 6.0 * g + f)
    return b3, b4, b5


def _quartic(T, p0, v0, a0, v1, a1):
    """Quartic (free end position): velocity/accel matched at tau=1."""
    g = (v1 - v0 - a0 * T) * T
    f = (a1 - a0) * T * T
    b3 = g - f / 3.0
    b4 = -0.5 * g + 0.25 * f
    return b3, b4


def _jerk_integral(T, a0, b3, b4, b5):
    """Closed-form integral of squared jerk over [0, T] in the tau basis
    (a0 enters only tau^2 and lower, so it does not appear)."""
    c = 6.0 * b3
    d = 24.0 * b4
    e = 60.0 * b5
    integ = (c * c + c * d + (d * d + 2.0 * c * e) / 3.0
             + d * e / 2.0 + e * e / 5.0)
    return integ / _ipow(torch.clamp(T, min=1e-6), 5)


class _RefLine(NamedTuple):
    s: torch.Tensor      # (B, S) cumulative arclength of the densified table
    x: torch.Tensor      # (B, S)
    y: torch.Tensor      # (B, S)
    tx: torch.Tensor     # (B, S) unit tangent
    ty: torch.Tensor


def _gradient(a: torch.Tensor) -> torch.Tensor:
    """``jnp.gradient`` along the last axis at unit spacing: one-sided
    differences at the ends, central ones (times 0.5) inside."""
    return torch.cat([a[..., 1:2] - a[..., :1], (a[..., 2:] - a[..., :-2]) * 0.5,
                      a[..., -1:] - a[..., -2:-1]], dim=-1)


def _ref_line(plan: rp.LocalPlan) -> _RefLine:
    x, y = plan.sample_x, plan.sample_y
    dx, dy = _gradient(x), _gradient(y)
    norm = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=1e-9)
    seg = torch.sqrt(torch.diff(x, dim=-1) ** 2 + torch.diff(y, dim=-1) ** 2)
    s = torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(seg, dim=-1)], dim=-1)
    return _RefLine(s, x, y, dx / norm, dy / norm)


def _project(ref: _RefLine, pos_xy: torch.Tensor):
    """(s, d, heading of the line) of global points (..., 2) on the
    densified reference lines (..., S)."""
    d2 = (ref.x - pos_xy[..., 0, None]) ** 2 + (ref.y - pos_xy[..., 1, None]) ** 2
    i = torch.argmin(d2, dim=-1, keepdim=True)
    at = lambda a: a.gather(-1, i)[..., 0]
    sx, sy, tx, ty, s0 = at(ref.x), at(ref.y), at(ref.tx), at(ref.ty), at(ref.s)
    ex, ey = pos_xy[..., 0] - sx, pos_xy[..., 1] - sy
    s0 = s0 + tx * ex + ty * ey           # tangential correction
    d0 = -ty * ex + tx * ey               # signed offset (left positive)
    return s0, d0, torch.atan2(ty, tx)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` per lane (numpy's semantics): x (B, ...) on the knots
    xp (B, S) with values fp (B, S); the end values are held outside the
    knots, and a point on a knot takes the knot's value exactly."""
    B, S = xp.shape
    xf = x.reshape(B, -1)
    i = torch.searchsorted(xp.contiguous(), xf.contiguous(), right=True).clamp(1, S - 1)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    dx = x1 - x0
    dx0 = dx.abs() <= float(np.spacing(torch.finfo(xp.dtype).eps))
    f = torch.where(dx0, f0, f0 + ((xf - x0) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (f1 - f0))
    f = torch.where(xf < xp[:, :1], fp[:, :1], f)
    f = torch.where(xf > xp[:, -1:], fp[:, -1:], f)
    return f.reshape(x.shape)


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """``numpy.unwrap`` along the last axis: period 2*pi, discontinuity pi."""
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), torch.full_like(ddmod, math.pi), ddmod)
    correct = torch.where(dd.abs() < math.pi, torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(correct, dim=-1)], dim=-1)


def _linspace(a: float, b: float, n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(a, b, n, dtype=dtype)``: a * (1 - s) + b * s with
    s = i / (n - 1), the end point exactly b."""
    if n == 1:
        return torch.full((1,), a, dtype=dtype, device=device)
    s = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    return torch.cat([a * (1 - s) + b * s, torch.full((1,), b, dtype=dtype, device=device)])


def brake_trajectory(p: SolverParams, egos: torch.Tensor) -> torch.Tensor:
    """The emergency brake (B, N+1, 4): full deceleration along the current
    heading from egos (B, 4) to a stop."""
    t = torch.arange(p.horizon + 1, dtype=egos.dtype, device=egos.device) * p.timestep
    vb = torch.clamp(egos[:, 2:3] + p.acc_min * t, min=0.0)
    sb = torch.cat([torch.zeros_like(vb[:, :1]), torch.cumsum(vb[:, :-1] * p.timestep, dim=-1)],
                   dim=-1)
    yaw0 = egos[:, 3:4]
    return torch.stack([egos[:, :1] + sb * torch.cos(yaw0), egos[:, 1:2] + sb * torch.sin(yaw0),
                        vb, yaw0.expand_as(vb)], dim=-1)


def brake_controls(p: SolverParams, X: torch.Tensor) -> torch.Tensor:
    """Finite-difference controls of trajectories X (B, N+1, 4), clamped to
    the plant's actuation bounds (Model.cpp:19-20 semantics)."""
    dv = torch.diff(X[..., 2], dim=-1) / p.timestep
    dyaw = torch.diff(unwrap(X[..., 3]), dim=-1) / p.timestep
    return dynamics.clamp_control(p, X[:, :-1], torch.stack([dv, dyaw], dim=-1))


def _lane_maps(unc_map, B: int):
    """(values (B, H, W), per-lane GridGeom, origin_xy (B, 2), origin_yaw
    (B,)) of one map per lane or one shared map."""
    values, geom, oxy, oyaw = unc_map
    if values.ndim == 2:
        values = values.expand(B, *values.shape)
        geom = gridmap.GridGeom(geom.center.expand(B, 2), geom.resolution.expand(B),
                                geom.length.expand(B, 2))
        oxy, oyaw = oxy.expand(B, 2), oyaw.expand(B)
    return values, geom, oxy, oyaw


def curvature_bound(p: SolverParams, dtype, device) -> torch.Tensor:
    """The lattice's curvature bound tan(steer_angle_max) / wheelbase, the
    angle rounded to ``dtype`` first: a tensor made from host data, so made
    outside a captured step."""
    return torch.tan(torch.tensor(p.steer_angle_max, dtype=dtype, device=device)) / p.wheelbase


def obstacle_terms(p: SolverParams, fp: FrenetParams, obstacles, sigmas: Optional[torch.Tensor],
                   dtype, dev) -> list:
    """The obstacle slots' terms the lattice's tests read, each (M, N+1)
    over the horizon: the half-axes a and b (inflated by mode), the
    heading's cosine and sine, the centre x and y; then the slots' live
    flags (M,) bool.  Tracks shorter than the horizon hold their last pose."""
    N = p.horizon
    if fp.mode == "expansion":
        if sigmas is None:
            raise ValueError("expansion mode needs sigmas=(sx, sy, stheta)")
        infl = fp.expansion_chi * torch.maximum(sigmas[0], sigmas[1]).to(dtype)
    else:
        infl = torch.zeros((), dtype=dtype, device=dev)
    opos = obstacles.pos[:, :N + 1]                    # (M, N', 4)
    odim = obstacles.dims[:, :N + 1]
    # tracks are per solver horizon: hold the last pose past their end
    Nt = opos.shape[1]
    if Nt < N + 1:
        opos = torch.cat([opos, opos[:, -1:].expand(-1, N + 1 - Nt, 4)], dim=1)
        odim = torch.cat([odim, odim[:, -1:].expand(-1, N + 1 - Nt, 2)], dim=1)
    a = odim[..., 0] / 2.0 + fp.collision_margin + p.ego_rad + infl
    b = odim[..., 1] / 2.0 + fp.collision_margin + p.ego_rad + infl
    return [a, b, torch.cos(opos[..., 3]), torch.sin(opos[..., 3]), opos[..., 0], opos[..., 1],
            obstacles.mask > 0]


def lattice_plain(p: SolverParams, fp: FrenetParams, start: torch.Tensor, ref, axes,
                  kappa_max: torch.Tensor, obstacles, unc_map):
    """The plain version of the lattice kernel (``ops/frenet_cuda``): every
    candidate of the lattice over the horizon as (B, K, N+1) tensors,
    infeasible ones masked (+inf cost), the first of least cost taken
    (``torch.argmin`` takes the first index on ties, as ``jnp.argmin``
    does), fetched by an index gather; where none is feasible, the first of
    least cost of all.

    start (B, 4): [s0, d0, s_dot0, d_dot0]; ref: the reference line's (s, x,
    y, tx, ty), each (B, S); axes: the lattice's end offsets (n_lat,),
    durations (n_T,) and end speeds (n_v,), K = n_lat * n_T * n_v candidates
    d major, then T, then v; kappa_max: the curvature bound (0-dim); obstacles:
    ``obstacle_terms``' list, or empty; unc_map: [values, centre,
    resolution, length, origin xy, origin yaw] of one map per lane or one
    shared, read in propagation mode only, or empty.  Returns (X (B, N+1,
    4) of each lane's chosen candidate, its index (B,) int32, its cost (B,),
    whether any candidate was feasible (B,) bool, the feasible count (B,)
    int32)."""
    dtype, dev = start.dtype, start.device
    B, N = start.shape[0], p.horizon
    ref = _RefLine(*ref)
    s0, d0, s_dot0, d_dot0 = (c[:, None, None] for c in start.unbind(-1))
    # the candidate lattice (K,), d major, then T, then v
    D, T, V = (g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij"))
    Tc, Vc = T[:, None], V[:, None]                        # (K, 1)

    # lateral quintic (d0, d_dot0, 0) -> (D, 0, 0) over T; longitudinal
    # quartic (s_dot0, 0) -> (V, 0) over T (free end position); (B, K, 1)
    lb3, lb4, lb5 = _quintic(Tc, d0, d_dot0, 0.0, D[:, None], 0.0, 0.0)
    sb3, sb4 = _quartic(Tc, s0, s_dot0, 0.0, Vc, 0.0)

    t = torch.arange(N + 1, dtype=dtype, device=dev) * p.timestep   # (N+1,)
    tau = torch.minimum(t, Tc) / Tc                                 # (K, N+1)
    tau2, tau3, tau4, tau5 = _ipow(tau, 2), _ipow(tau, 3), _ipow(tau, 4), _ipow(tau, 5)

    # past T the lateral maneuver holds at (D, 0): tau clamped at 1 gives it
    d_t = d0 + d_dot0 * Tc * tau + lb3 * tau3 + lb4 * tau4 + lb5 * tau5
    d_dot_t = (d_dot0 * Tc + 3 * lb3 * tau2 + 4 * lb4 * tau3 + 5 * lb5 * tau4) / Tc
    s_t = s0 + s_dot0 * Tc * tau + sb3 * tau3 + sb4 * tau4
    s_dot_t = (s_dot0 * Tc + 3 * sb3 * tau2 + 4 * sb4 * tau3) / Tc
    s_ddot_t = (6 * sb3 * tau + 12 * sb4 * tau2) / _ipow(Tc, 2)
    # past T: constant speed V
    past = t > Tc
    s_t = torch.where(past, s_t + Vc * (t - Tc), s_t)
    s_dot_t = torch.where(past, Vc.expand_as(s_dot_t), s_dot_t)
    s_ddot_t = torch.where(past, torch.zeros_like(s_ddot_t), s_ddot_t)

    # Frenet -> global (tangent components interpolate without angle wraps)
    xr = _interp(s_t, ref.s, ref.x)
    yr = _interp(s_t, ref.s, ref.y)
    txr = _interp(s_t, ref.s, ref.tx)
    tyr = _interp(s_t, ref.s, ref.ty)
    tn = torch.clamp(torch.sqrt(txr * txr + tyr * tyr), min=1e-9)
    txr, tyr = txr / tn, tyr / tn

    gx = xr - d_t * tyr
    gy = yr + d_t * txr
    gv = torch.sqrt(s_dot_t ** 2 + d_dot_t ** 2)
    gyaw = torch.atan2(tyr, txr) + torch.atan2(d_dot_t, torch.clamp(s_dot_t, min=1e-3))
    X = torch.stack([gx, gy, gv, gyaw], dim=-1)            # (B, K, N+1, 4)

    # cost (B, K)
    J_lat = (fp.k_j * _jerk_integral(T, 0.0, lb3[..., 0], lb4[..., 0], lb5[..., 0])
             + fp.k_t * T + fp.k_d * D * D)
    J_lon = (fp.k_j * _jerk_integral(T, 0.0, sb3[..., 0], sb4[..., 0],
                                     torch.zeros_like(sb3[..., 0]))
             + fp.k_t * T + fp.k_v * (V - p.desired_speed) ** 2)
    J = fp.k_lat * J_lat + fp.k_lon * J_lon

    # feasibility (B, K)
    feasible = (s_ddot_t <= p.acc_max + 1e-6).all(dim=-1)
    feasible &= (s_ddot_t >= p.acc_min - 1e-6).all(dim=-1)
    feasible &= (gv <= p.speed_max + 1e-6).all(dim=-1)
    feasible &= (s_dot_t >= -1e-6).all(dim=-1)   # no reversing
    # curvature from yaw finite differences over arclength
    dyaw = torch.diff(unwrap(gyaw), dim=-1)
    darc = torch.clamp(torch.diff(s_t, dim=-1), min=1e-3)
    feasible &= ((dyaw / darc).abs() <= kappa_max * 1.5).all(dim=-1)

    # obstacles, inflated by mode (``obstacle_terms``)
    if obstacles:
        a, b, co, so, ox, oy = (o[:, None] for o in obstacles[:6])  # (M, 1, N+1)
        live = obstacles[6][:, None, None]
        cyaw, syaw = torch.cos(gyaw), torch.sin(gyaw)

        def hit_for(sign: float, reach: float):
            ex = gx + sign * cyaw * reach                  # (B, K, N+1)
            ey = gy + sign * syaw * reach
            dxg = ex[:, None] - ox                         # (B, M, K, N+1)
            dyg = ey[:, None] - oy
            dxo = co * dxg + so * dyg
            dyo = -so * dxg + co * dyg
            q = (dxo / a) ** 2 + (dyo / b) ** 2
            return (q < 1.0) & live

        hits = hit_for(+1.0, p.ego_front) | hit_for(-1.0, p.ego_rear)
        feasible &= ~hits.any(dim=-1).any(dim=1)

    # the uncertainty costmap (propagation mode)
    if unc_map:
        values, center, res, length, oxy, oyaw = unc_map
        values, geom, oxy, oyaw = _lane_maps(
            (values, gridmap.GridGeom(center, res, length), oxy, oyaw), B)
        dxy = X[..., :2] - oxy[:, None, None, :]
        cy = torch.cos(oyaw)[:, None, None]
        sy = torch.sin(oyaw)[:, None, None]
        local = torch.stack([cy * dxy[..., 0] + sy * dxy[..., 1],
                             -sy * dxy[..., 0] + cy * dxy[..., 1]], dim=-1).reshape(B, -1, 2)
        u, _ = gridmap.sample_bilinear_with_grad_batched(values, geom, local)
        inside = gridmap.in_bounds(gridmap.GridGeom(geom.center[:, None], geom.resolution,
                                                    geom.length[:, None]), local)
        u = torch.where(inside, u, torch.zeros_like(u)).reshape(gx.shape)
        feasible &= (u < fp.unc_threshold).all(dim=-1)
        J = J + fp.w_unc * (u / 100.0).mean(dim=-1)

    # select
    any_ok = feasible.any(dim=-1)                          # (B,)
    J_masked = torch.where(feasible, J, torch.full_like(J, math.inf))
    best = torch.argmin(torch.where(any_ok[:, None], J_masked, J), dim=-1)
    Xb = X[torch.arange(B, device=dev), best]              # (B, N+1, 4)
    # the winner's cost is the min (a one-hot dot would give 0 * inf)
    J_best = torch.where(any_ok, J_masked.amin(dim=-1), J.amin(dim=-1))
    return Xb, best.to(torch.int32), J_best, any_ok, feasible.sum(dim=-1, dtype=torch.int32)


def lattice_inputs(p: SolverParams, fp: FrenetParams, plan: rp.LocalPlan, egos: torch.Tensor,
                   obstacles=None, unc_map=None, sigmas: Optional[torch.Tensor] = None, *,
                   kappa_max: torch.Tensor) -> tuple:
    """The lattice's arguments after (p, fp) (``lattice_plain``,
    ``frenet_cuda.lattice``) for egos (B, 4) on their local plans: the
    lanes' start terms (B, 4), the reference line's five (B, S) tensors,
    the lattice's axes (end offsets, durations, end speeds), the curvature
    bound, the obstacle slots' terms (or none) and, in propagation mode,
    the map's tensors (or none)."""
    dtype, dev = egos.dtype, egos.device
    ref = _ref_line(plan)
    s0, d0, th_ref0 = _project(ref, egos[:, :2])          # (B,)
    v0 = egos[:, 2]
    dth = egos[:, 3] - th_ref0
    start = torch.stack([s0, d0, v0 * torch.cos(dth), v0 * torch.sin(dth)], dim=-1)

    # the lattice's axes: K = n_lat * n_T * n_v candidates, d major, then T, then v
    d_f = _linspace(-fp.d_max, fp.d_max, fp.n_lat, dtype, dev)
    T_f = _linspace(fp.T_min, fp.T_max, fp.n_T, dtype, dev)
    v_f = _linspace(fp.v_frac_min * p.desired_speed, fp.v_frac_max * p.desired_speed, fp.n_v,
                    dtype, dev)
    obs = [] if obstacles is None else obstacle_terms(p, fp, obstacles, sigmas, dtype, dev)
    umap = []
    if fp.mode == "propagation" and unc_map is not None:
        values, geom, oxy, oyaw = unc_map
        umap = [values, geom.center, geom.resolution, geom.length, oxy, oyaw]
    return start, list(ref), [d_f, T_f, v_f], kappa_max, obs, umap


def plan_steps(p: SolverParams, fp: FrenetParams, plan_xy: torch.Tensor, plan_n,
               egos: torch.Tensor, obstacles=None, unc_map=None,
               sigmas: Optional[torch.Tensor] = None, *,
               kappa_max: torch.Tensor) -> FrenetResult:
    """One Frenet lattice planning cycle per lane at egos (B, 4) [x, y, v,
    theta]: ``plan_step`` of the JAX package, vmapped.

    obstacles: shared ``models.obstacles.Obstacles`` (padded; mask-aware).
    unc_map: ``models.uncertainty.UncertaintyMap``, one per lane (values
    (B, H, W)) or shared (values (H, W)); read in propagation mode only.
    sigmas: (3,) [sigma_x, sigma_y, sigma_theta] localization noise, which
    expansion mode needs when there are obstacles.
    kappa_max: ``curvature_bound`` in egos' dtype.  The candidates are
    evaluated and chosen by ``frenet_cuda.lattice`` (on the card the kernel,
    float32 only; elsewhere and inside ``route.plain()`` ``lattice_plain``).
    The feasible (lane, candidate) pairs are added to ``FEASIBLE``'s total
    on egos' device.
    """
    plan = rp.get_local_plan(p, plan_xy, plan_n, egos)
    X, best, J, any_ok, count = frenet_cuda.lattice(
        p, fp, *lattice_inputs(p, fp, plan, egos, obstacles, unc_map, sigmas,
                               kappa_max=kappa_max))
    _FEASIBLE.add(count)

    # Emergency-brake fallback: when NO candidate is collision-free the
    # planner brakes at the actuation limit along the current heading (the
    # result still carries lamb == 0)
    Xb = torch.where(any_ok[:, None, None], X, brake_trajectory(p, egos))
    # the recorded controls never claim infeasible actuation
    U = brake_controls(p, Xb)
    return FrenetResult(X=Xb, U=U, ref_x=plan.x_wpts, ref_y=plan.y_fit, iterations=best, J=J,
                        lamb=any_ok.to(egos.dtype))


def _stage(p: SolverParams, egos: torch.Tensor, fp: FrenetParams, plan_xy: torch.Tensor, plan_n,
           obstacles, unc_map, sigmas, kappa_max) -> FrenetResult:
    """``plan_steps`` as a ``solver.run`` stage: the per-lane egos first."""
    return plan_steps(p, fp, plan_xy, plan_n, egos, obstacles, unc_map, sigmas,
                      kappa_max=kappa_max)


def stage(p: SolverParams, fp: FrenetParams, plan_xy: torch.Tensor, plan_n, egos: torch.Tensor,
          obstacles, unc_map, sigmas: Optional[torch.Tensor],
          kappa_max: torch.Tensor) -> solver.Stage:
    """The ``solver.run`` stage of ``plan_steps`` (same arguments, the
    curvature bound given): its tensors are copied into a capture, ``fp``
    (the mode with it) keys it."""
    return solver.Stage(_stage, (egos, fp, plan_xy, plan_n, obstacles, unc_map, sigmas, kappa_max))


def run_steps(p: SolverParams, fp: FrenetParams, plan_xy: torch.Tensor, plan_n,
              egos: torch.Tensor, obstacles, unc_map, sigmas: Optional[torch.Tensor],
              kappa_max: torch.Tensor) -> FrenetResult:
    """``plan_steps`` (same arguments, the curvature bound given: no copy
    from the host) as one stage of ``solver.run``: on the card one CUDA
    graph, captured once per parameters, ``fp`` (the mode with it) and the
    tensors' shapes, and replayed; the eager call's bits.  Span
    ``frenet.plan``; counts ``PLANS`` and ``CANDIDATES``."""
    global PLANS, CANDIDATES
    PLANS += 1
    CANDIDATES += egos.shape[0] * fp.n_candidates
    with profiling.span("frenet.plan"):
        return solver.run(p, stage(p, fp, plan_xy, plan_n, egos, obstacles, unc_map, sigmas,
                                   kappa_max))
