"""Cost stack: tracking + exponential barriers, with analytic 1st/2nd derivs.

Reference semantics: ``Constraints.cpp``; the port of
``cilqr_tpu/models/costs.py``.  Everything is evaluated for the whole
horizon (and any leading batch) at once.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from cilqr_tpu_torch.utils.params import SolverParams
from cilqr_tpu_torch.models import obstacles as obstacles_mod
from cilqr_tpu_torch.models import uncertainty as uncertainty_mod
from cilqr_tpu_torch.models.reference_path import LocalPlan, find_closest_points


class CostDerivs(NamedTuple):
    l_x: torch.Tensor   # (..., N, 4)
    l_xx: torch.Tensor  # (..., N, 4, 4)
    l_u: torch.Tensor   # (..., N, 2)
    l_uu: torch.Tensor  # (..., N, 2, 2)
    l_ux: torch.Tensor  # (..., N, 2, 4) — identically zero (Constraints.cpp:501-506)


class Consts(NamedTuple):
    """The cost stack's constant tensors of one (params, dtype, device)."""

    e1: torch.Tensor  # (2,) [1, 0]: d acc / d u
    e2: torch.Tensor  # (2,) [0, 1]: d yaw-rate / d u
    R: torch.Tensor   # (2, 2) diag(w_acc, w_yawrate)
    Q: torch.Tensor   # (4, 4) diag(w_pos, w_pos, w_vel, 0)
    q: torch.Tensor   # (4,) the diagonal of Q
    r: torch.Tensor   # (2,) the diagonal of R


@functools.lru_cache(maxsize=64)
def consts(p: SolverParams, dtype, device) -> Consts:
    """The constants, built once per (p, dtype, device): a tensor made from
    host values is a copy from the host, which a CUDA graph capture may not
    hold (``solver.optimize`` replays the iteration as one).  Every caller
    shares the same tensors, so none may write to them."""
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    q = f([p.w_pos, p.w_pos, p.w_vel, 0.0])
    return Consts(f([1.0, 0.0]), f([0.0, 1.0]), f([[p.w_acc, 0.0], [0.0, p.w_yawrate]]),
                  torch.diag(q), q, f([p.w_acc, p.w_yawrate]))


def barrier(q1: float, q2: float, c: torch.Tensor, c_dot: torch.Tensor):
    """Exponential barrier b = q1*exp(q2*c) with gradient and Gauss-Newton
    Hessian (Constraints.cpp:67-78).  c: (...,); c_dot: (..., D)."""
    b = q1 * torch.exp(q2 * c)
    vx = (q2 * b)[..., None] * c_dot
    mx = (q2 * q2 * b)[..., None, None] * (c_dot[..., :, None] * c_dot[..., None, :])
    return b, vx, mx


def control_cost_derivs(p: SolverParams, X: torch.Tensor, U: torch.Tensor):
    """l_u (..., N, 2), l_uu (..., N, 2, 2) — quadratic effort + 4 control
    barriers (Constraints.cpp:86-137), the yaw-rate bounds at the concurrent
    state X[i] (Constraints.cpp:119-121)."""
    N = U.shape[-2]
    c = consts(p, U.dtype, U.device)
    v = X[..., :N, 2]
    acc = U[..., 0]
    yr = U[..., 1]
    e1 = c.e1.expand(U.shape)
    e2 = c.e2.expand(U.shape)

    _, v1, m1 = barrier(p.q1_acc, p.q2_acc, acc - p.acc_max, e1)
    _, v2, m2 = barrier(p.q1_acc, p.q2_acc, p.acc_min - acc, -e1)
    yr_hi = v * math.tan(p.steer_angle_max) / p.wheelbase
    yr_lo = v * math.tan(p.steer_angle_min) / p.wheelbase
    _, v3, m3 = barrier(p.q1_yawrate, p.q2_yawrate, yr - yr_hi, e2)
    _, v4, m4 = barrier(p.q1_yawrate, p.q2_yawrate, yr_lo - yr, -e2)

    l_u = v1 + v2 + v3 + v4 + 2.0 * (U @ c.R)
    l_uu = m1 + m2 + m3 + m4 + 2.0 * c.R
    return l_u, l_uu


def tracking_cost_derivs(p: SolverParams, plan: LocalPlan, X: torch.Tensor, cp=None):
    """Quadratic tracking l_x/l_xx (Constraints.cpp:161-175).  Yaw is
    untracked (Constraints.cpp:9-13,168).  ``cp`` takes precomputed closest
    points so callers share one lookup."""
    if cp is None:
        cp = find_closest_points(plan, X)
    err = torch.stack(
        [
            X[..., 0] - cp[..., 0],
            X[..., 1] - cp[..., 1],
            X[..., 2] - p.desired_speed,
            torch.zeros_like(X[..., 0]),
        ],
        dim=-1,
    )
    Q = consts(p, X.dtype, X.device).Q
    l_x = 2.0 * (err @ Q)
    l_xx = (2.0 * Q).expand(X.shape[:-1] + (4, 4))
    return l_x, l_xx


def state_cost_derivs(
    p: SolverParams,
    plan: LocalPlan,
    X: torch.Tensor,
    obstacles: Optional[obstacles_mod.Obstacles] = None,
    unc_map: Optional[uncertainty_mod.UncertaintyMap] = None,
    cp=None,
    unc_planes=None,
):
    """Full l_x (..., N, 4), l_xx (..., N, 4, 4): tracking + obstacle
    barriers + uncertainty-map barrier (Constraints.cpp:145-227).  ``X`` is
    the first N states of the trajectory (Constraints.cpp:161).

    Obstacles and the map are shared, or carry a leading scenario axis
    (obstacles.pos (B, M, N, 4), map values (B, H, W)) for X (B, N, 4).
    ``unc_planes`` (..., N, 3) replaces the map's sample (the hybrid path
    samples the per-scenario maps outside the kernel)."""
    l_x, l_xx = tracking_cost_derivs(p, plan, X, cp=cp)
    if obstacles is not None:
        ovx, omx = obstacles_mod.obstacle_cost_derivs(p, obstacles, X)
        l_x = l_x + p.w_obstacle * ovx
        l_xx = l_xx + p.w_obstacle * omx
    if unc_map is not None or unc_planes is not None:
        _, uvx, umx = uncertainty_mod.uncertainty_cost(p, unc_map, X, unc_planes)
        l_x = l_x + p.w_uncertainty * uvx
        l_xx = l_xx + p.w_uncertainty * umx
    return l_x, l_xx


def total_cost_J(p: SolverParams, plan: LocalPlan, X: torch.Tensor, U: torch.Tensor,
                 cp=None) -> torch.Tensor:
    """Acceptance cost J (Constraints.cpp:534-561), (...,).

    Parity quirk: J counts only the quadratic tracking and control terms;
    every barrier and the uncertainty term are excluded.
    """
    N = U.shape[-2]
    Xh = X[..., :N, :]
    if cp is None:
        cp = find_closest_points(plan, Xh)
    err = torch.stack(
        [Xh[..., 0] - cp[..., 0], Xh[..., 1] - cp[..., 1], Xh[..., 2] - p.desired_speed,
         Xh[..., 3]],
        dim=-1,
    )
    c = consts(p, X.dtype, X.device)
    x_cost = (err * err * c.q).sum(dim=(-2, -1))
    u_cost = (U * U * c.r).sum(dim=(-2, -1))
    return x_cost + u_cost


def all_cost_derivs(p: SolverParams, plan: LocalPlan, X, U, obstacles=None,
                    unc_map=None) -> CostDerivs:
    """Everything the backward pass needs, in one evaluation."""
    derivs, _ = all_cost_derivs_and_J(p, plan, X, U, obstacles, unc_map)
    return derivs


def all_cost_derivs_and_J(p: SolverParams, plan: LocalPlan, X, U, obstacles=None,
                          unc_map=None, unc_planes=None):
    """(CostDerivs, J): one closest-point pass serves both the tracking
    derivatives and the acceptance cost, since both evaluate at X[0..N-1].
    World arguments as in ``state_cost_derivs``."""
    N = U.shape[-2]
    Xh = X[..., :N, :]
    cp = find_closest_points(plan, Xh)
    l_x, l_xx = state_cost_derivs(p, plan, Xh, obstacles, unc_map, cp=cp,
                                  unc_planes=unc_planes)
    l_u, l_uu = control_cost_derivs(p, X, U)
    l_ux = torch.zeros(U.shape[:-1] + (2, 4), dtype=X.dtype, device=X.device)
    J = total_cost_J(p, plan, X, U, cp=cp)
    return CostDerivs(l_x, l_xx, l_u, l_uu, l_ux), J
