"""Uncertainty-costmap barrier term (the reconstructed ``Uncertainty.h``).

Port of ``cilqr_tpu/models/uncertainty.py``, which derives the semantics:
transform the ego position into the map frame, bilinearly sample the
propagated occupancy in [0, 100], normalize c = u/100 and apply the barrier
``q1_uncertainty * exp(q2_uncertainty * c)`` with the map gradient and the
Gauss-Newton outer product.  Outside the map the cost is zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.ops import gridmap


class UncertaintyMap(NamedTuple):
    """Propagated uncertainty costmap + frame metadata.

    values:     (rows, cols) occupancy in [0, 100]
    geom:       grid geometry in the map frame (vehicle frame at build time)
    origin_xy:  (2,) global position of the map frame origin
    origin_yaw: () global yaw of the map frame
    """

    values: torch.Tensor
    geom: gridmap.GridGeom
    origin_xy: torch.Tensor
    origin_yaw: torch.Tensor


def make_uncertainty_map(values, center_xy, resolution, origin_xy, origin_yaw,
                         dtype=torch.float32, device=None) -> UncertaintyMap:
    values = torch.as_tensor(values, dtype=dtype, device=device)
    geom = gridmap.make_geom(center_xy, float(resolution), values.shape[0],
                             values.shape[1], dtype=dtype, device=device)
    return UncertaintyMap(
        values,
        geom,
        torch.as_tensor(origin_xy, dtype=dtype, device=device),
        torch.as_tensor(origin_yaw, dtype=dtype, device=device),
    )


def _to_map_frame(m: UncertaintyMap, Xs: torch.Tensor, cy, sy):
    d0 = Xs[..., 0] - m.origin_xy[..., 0, None]
    d1 = Xs[..., 1] - m.origin_xy[..., 1, None]
    return torch.stack([cy * d0 + sy * d1, -sy * d0 + cy * d1], dim=-1)


def _barrier_sample(p: SolverParams, u, grad_local, inside, cy, sy):
    c = u / 100.0
    grad_c = grad_local / 100.0
    # chain rule back to the global frame: grad_g = R(yaw) grad_l
    gx = cy * grad_c[..., 0] - sy * grad_c[..., 1]
    gy = sy * grad_c[..., 0] + cy * grad_c[..., 1]
    e = p.q1_uncertainty * torch.exp(p.q2_uncertainty * c)
    e = torch.where(inside, e, torch.zeros_like(e))
    return e, gx, gy


def uncertainty_sample(p: SolverParams, m: UncertaintyMap, Xs: torch.Tensor):
    """Raw barrier sample at (..., >=2) query states on one shared map:
    (e, gx, gy), each (...,).  e is masked to 0 outside the map; the
    gradient is not masked (every consumer multiplies it by e)."""
    cy, sy = torch.cos(m.origin_yaw), torch.sin(m.origin_yaw)
    local = _to_map_frame(m, Xs, cy, sy)
    u, grad_local = gridmap.sample_bilinear_with_grad(m.values, m.geom, local)
    inside = gridmap.in_bounds(m.geom, local)
    return _barrier_sample(p, u, grad_local, inside, cy, sy)


def uncertainty_sample_batched(p: SolverParams, m: UncertaintyMap, Xs: torch.Tensor):
    """One map per scenario: m with leading B leaves (values (B, H, W)),
    Xs (B, N, >=2).  Returns (e, gx, gy), each (B, N)."""
    B = Xs.shape[0]
    cy = torch.cos(m.origin_yaw).reshape(B, 1)
    sy = torch.sin(m.origin_yaw).reshape(B, 1)
    local = _to_map_frame(m, Xs, cy, sy)
    u, grad_local = gridmap.sample_bilinear_with_grad_batched(m.values, m.geom, local)
    lo = m.geom.center - 0.5 * m.geom.length  # (B, 2)
    hi = m.geom.center + 0.5 * m.geom.length
    inside = ((local >= lo[:, None, :]) & (local <= hi[:, None, :])).all(dim=-1)
    return _barrier_sample(p, u, grad_local, inside, cy, sy)


def uncertainty_cost(p: SolverParams, m: UncertaintyMap | None, X: torch.Tensor,
                     planes: torch.Tensor | None = None):
    """Barrier (e, vx, mx) at states X (..., 4): (...,), (..., 4), (..., 4, 4).

    The raw sample comes from the map (one shared map, or one per scenario
    when m.values is (B, H, W) and X is (B, N, 4)) or, given ``planes``
    (..., 3) = [e, gx, gy], from samples taken outside.  Unweighted: the
    caller applies w_uncertainty (Constraints.cpp:199-200).
    """
    if planes is not None:
        e, gx, gy = planes.unbind(-1)
    elif m.values.ndim == 3:
        e, gx, gy = uncertainty_sample_batched(p, m, X)
    else:
        e, gx, gy = uncertainty_sample(p, m, X)
    g = torch.stack([gx, gy], dim=-1)
    vx2 = (p.q2_uncertainty * e)[..., None] * g
    mx2 = (p.q2_uncertainty ** 2 * e)[..., None, None] * (g[..., :, None] * g[..., None, :])
    vx = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    mx = torch.zeros(X.shape[:-1] + (4, 4), dtype=X.dtype, device=X.device)
    vx[..., :2] = vx2
    mx[..., :2, :2] = mx2
    return e, vx, mx
