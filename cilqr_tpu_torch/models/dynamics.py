"""Kinematic bicycle dynamics (reference: ``Model.cpp``).

State   x = [px, py, v, theta]     (shape (..., 4))
Control u = [acc, yaw_rate]        (shape (..., 2))

Every function takes any number of leading batch dimensions; the horizon
axis sits just before the component axis ((..., N, 4) / (..., N, 2)).
"""

from __future__ import annotations

import math

import torch

from cilqr_tpu_torch.utils.params import SolverParams


def clamp_control(p: SolverParams, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Input clamping applied before integration (Model.cpp:19-20).

    acc is clamped to [acc_min, acc_max]; yaw-rate to the state-dependent
    bound  v * tan(steer_angle) / wheelbase  at the current speed.
    """
    acc = u[..., 0].clamp(p.acc_min, p.acc_max)
    v = x[..., 2]
    yr_hi = v * math.tan(p.steer_angle_max) / p.wheelbase
    yr_lo = v * math.tan(p.steer_angle_min) / p.wheelbase
    yawrate = torch.minimum(torch.maximum(u[..., 1], yr_lo), yr_hi)
    return torch.stack([acc, yawrate], dim=-1)


def step(p: SolverParams, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One Euler step with input clamping (Model.cpp:17-30).

    Positions integrate the clamped acceleration through the unclamped
    current speed; the speed is clamped to [0, speed_max] after integration.
    """
    uc = clamp_control(p, x, u)
    dt = p.timestep
    px, py, v, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    acc, yawrate = uc[..., 0], uc[..., 1]

    ds = v * dt + 0.5 * acc * dt * dt
    nx = px + torch.cos(th) * ds
    ny = py + torch.sin(th) * ds
    nv = (v + acc * dt).clamp(0.0, p.speed_max)
    nth = th + yawrate * dt
    return torch.stack([nx, ny, nv, nth], dim=-1)


def rollout(p: SolverParams, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Nominal trajectory from x0 (..., 4) under U (..., N, 2) (iLQR.cpp:51-62).

    Returns X (..., N+1, 4) including x0.
    """
    xs = [x0]
    for j in range(U.shape[-2]):
        xs.append(step(p, xs[-1], U[..., j, :]))
    return torch.stack(xs, dim=-2)


def jacobians(p: SolverParams, v: torch.Tensor, theta: torch.Tensor, acc: torch.Tensor):
    """Analytic discrete-dynamics Jacobians fx (..., 4, 4), fu (..., 4, 2).

    Mirrors ``Model::get_A_matrix``/``get_B_matrix`` (Model.cpp:100-155) in
    the standard orientation fx = d f / d x.  Parity quirk: callers pass v,
    theta of the successor states X[1:] and acc of U (iLQR.cpp:102-106).
    """
    dt = p.timestep
    c, s = torch.cos(theta), torch.sin(theta)
    ds = v * dt + 0.5 * acc * dt * dt
    z = torch.zeros_like(v)
    o = torch.ones_like(v)

    fx = torch.stack(
        [
            torch.stack([o, z, dt * c, -s * ds], dim=-1),
            torch.stack([z, o, dt * s, c * ds], dim=-1),
            torch.stack([z, z, o, z], dim=-1),
            torch.stack([z, z, z, o], dim=-1),
        ],
        dim=-2,
    )
    fu = torch.stack(
        [
            torch.stack([0.5 * dt * dt * c, z], dim=-1),
            torch.stack([0.5 * dt * dt * s, z], dim=-1),
            torch.stack([dt * o, z], dim=-1),
            torch.stack([z, dt * o], dim=-1),
        ],
        dim=-2,
    )
    return fx, fu
