"""Rotated-ellipse obstacle safety sets with exponential barriers.

Reference semantics: ``Obstacle.cpp``; the port of
``cilqr_tpu/models/obstacles.py``.  All obstacles live in one padded
NamedTuple and are evaluated for every (obstacle, timestep) pair at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cilqr_tpu.utils.params import SolverParams


class Obstacles(NamedTuple):
    """Padded per-timestep obstacle predictions.

    dims:  (M, N, 2)  [length, width] per timestep
    pos:   (M, N, 4)  [x, y, v, theta] per timestep
    mask:  (M,)       1.0 for real obstacles, 0.0 for padding
    """

    dims: torch.Tensor
    pos: torch.Tensor
    mask: torch.Tensor


def make_static_obstacles(p: SolverParams, centers, sizes, yaws, speeds=None,
                          dtype=torch.float32, device=None) -> Obstacles:
    """Padded ``Obstacles`` with a constant pose over the horizon
    (ilqr_uncertainty_node.cpp:151-190).  Padding obstacles sit at x=1e6 so
    their masked barrier also underflows to 0."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    centers = t(centers).reshape(-1, 2)
    sizes = t(sizes).reshape(-1, 2)
    yaws = t(yaws).reshape(-1)
    m = centers.shape[0]
    speeds = torch.zeros(m, dtype=dtype, device=device) if speeds is None else t(speeds).reshape(-1)
    M, N = p.max_obstacles, p.horizon
    if m > M:
        raise ValueError(f"{m} obstacles > max_obstacles={M}")

    dims = torch.zeros((M, N, 2), dtype=dtype, device=device)
    pos = torch.zeros((M, N, 4), dtype=dtype, device=device)
    pos[:, :, 0] = 1e6
    mask = torch.zeros((M,), dtype=dtype, device=device)
    dims[:m] = sizes[:, None, :]
    pos[:m] = torch.stack([centers[:, 0], centers[:, 1], speeds, yaws], dim=-1)[:, None, :]
    mask[:m] = 1.0
    return Obstacles(dims, pos, mask)


def obstacle_cost_derivs(p: SolverParams, obs: Obstacles, X: torch.Tensor):
    """Summed obstacle barrier gradient/Hessian (Constraints.cpp:180-187).

    X: (..., N, 4) states for timesteps 0..N-1; the obstacles are shared or
    carry the same leading batch (pos (B, M, N, 4) for X (B, N, 4)).
    Returns (vx (..., N, 4), mx (..., N, 4, 4)).  Per (obstacle j, step i),
    ``Obstacle.cpp:39-112``:
        a = len/2 + |v_o cos(th_o)| t_safe + s_safe_a + ego_rad
        b = wid/2 + |v_o sin(th_o)| t_safe + s_safe_b + ego_rad + 1
    c = 1 - d^T P d with d the ego front/rear disc center in the obstacle
    frame; barrier q1*exp(q2*c); the gradient fills only the x/y slots.
    """
    N = X.shape[-2]
    dims = obs.dims[..., :N, :]  # (..., M, N, 2)
    pos = obs.pos[..., :N, :]    # (..., M, N, 4)

    ov = pos[..., 2]
    oth = pos[..., 3]
    a = dims[..., 0] / 2.0 + (ov * torch.cos(oth)).abs() * p.t_safe + p.s_safe_a + p.ego_rad
    b = dims[..., 1] / 2.0 + (ov * torch.sin(oth)).abs() * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
    inv_a2 = 1.0 / (a * a)
    inv_b2 = 1.0 / (b * b)
    co, so = torch.cos(oth), torch.sin(oth)

    vth = X[..., 3]
    cth, sth = torch.cos(vth), torch.sin(vth)

    def disc(offset_sign: float, reach: float, q1: float, q2: float):
        ex = X[..., 0] + offset_sign * cth * reach  # (..., N)
        ey = X[..., 1] + offset_sign * sth * reach
        dxg = ex[..., None, :] - pos[..., 0]  # (..., M, N)
        dyg = ey[..., None, :] - pos[..., 1]
        dx = co * dxg + so * dyg
        dy = -so * dxg + co * dyg
        c_val = 1.0 - (dx * dx * inv_a2 + dy * dy * inv_b2)
        gx_o = dx * inv_a2
        gy_o = dy * inv_b2
        gx = -2.0 * (co * gx_o - so * gy_o)
        gy = -2.0 * (so * gx_o + co * gy_o)
        e = q1 * torch.exp(q2 * c_val)
        g2 = torch.stack([gx, gy], dim=-1)  # (..., M, N, 2)
        vx2 = g2 * (q2 * e)[..., None]
        mx2 = (q2 * q2 * e)[..., None, None] * (g2[..., :, None] * g2[..., None, :])
        return vx2, mx2

    fvx, fmx = disc(+1.0, p.ego_front, p.q1_front, p.q2_front)
    rvx, rmx = disc(-1.0, p.ego_rear, p.q1_rear, p.q2_rear)

    m = obs.mask[..., None, None]  # (..., M, 1, 1)
    vx2 = ((fvx + rvx) * m).sum(dim=-3)            # (..., N, 2)
    mx2 = ((fmx + rmx) * m[..., None]).sum(dim=-4)  # (..., N, 2, 2)

    vx = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    mx = torch.zeros(X.shape[:-1] + (4, 4), dtype=X.dtype, device=X.device)
    vx[..., :2] = vx2
    mx[..., :2, :2] = mx2
    return vx, mx
