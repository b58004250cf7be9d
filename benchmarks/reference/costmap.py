"""Plain PyTorch reference of the map engine's local costmap
(``local_costmap.cpp``, ``arbitrary_transformation.cu`` / ``ARBIT.cuh``).

One costmap tick at a pose (x, y, yaw): the vehicle-frame grid is centred
on the lane corridor's bounding box (``getVehicleMapScale``), the obstacles'
boxes are filled at 100 (``bondingBoxHandle``), the global prior's nearest
cell is read under every other cell, and the result is propagated.

For every cell i the propagated occupancy is ``u_i = sum_j f_ij p_j /
sum_j f_ij`` over the cells j inside the 95% ellipse of cell i's covariance
(``d^T cov_i^-1 d <= chi^2``) and inside the map, with f the correlated 2D
Gaussian; cells whose covariance is not positive definite or whose ellipse
holds no cell keep their value, the rest are clipped to [0, 100].  Cell i's
covariance is the pose covariance carried to the cell by the lever of the
heading: sx^2 = sigma_x'^2 + sigma_theta^2 Cy^2, sy^2 = sigma_y'^2 +
sigma_theta^2 Cx^2, rho sx sy = dxy - sigma_theta^2 Cx Cy, the translational
part rotated into the map frame by the yaw.

Every function takes L lanes, each with its own grid centre (L, 2), yaw (L,)
and sigmas (L, 3), and computes in the dtype it is given.  It imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch


def cell_positions(center, res: float, rows: int, cols: int):
    """Cell-centre coordinates of grids centred at ``center`` (L, 2), index 0
    at the +x / +y edge: xs (L, rows), ys (L, cols)."""
    ar = lambda n: torch.arange(n, dtype=center.dtype, device=center.device)
    xs = center[:, 0, None] + (rows * res / 2 - res / 2) - res * ar(rows)
    ys = center[:, 1, None] + (cols * res / 2 - res / 2) - res * ar(cols)
    return xs, ys


def fields(center, res: float, rows: int, cols: int, yaw, sigmas):
    """Per-cell (sx, sy, rho), each (L, rows, cols)."""
    xs, ys = cell_positions(center, res, rows, cols)
    Cx, Cy = xs[:, :, None], ys[:, None, :]
    s_x, s_y, s_t = (sigmas[:, k, None, None] for k in range(3))
    s, c = torch.sin(yaw)[:, None, None], torch.cos(yaw)[:, None, None]
    d = s_x * s_x - s_y * s_y
    st2 = s_t * s_t
    sx = torch.sqrt(s_x * s_x - d * s * s + st2 * Cy * Cy)
    sy = torch.sqrt(s_y * s_y + d * s * s + st2 * Cx * Cx)
    rho = (-d * s * c - st2 * Cx * Cy) / (sx * sy)
    shape = rho.shape
    return sx.expand(shape), sy.expand(shape), rho


def required_radius(center, res: float, rows: int, cols: int, chi: float, sigma_hi) -> int:
    """Half-window in cells that holds the 95% ellipse of every cell for
    sigmas up to ``sigma_hi``: chi sqrt(lambda_max) <= chi sqrt(sx^2 + sy^2)
    at the map corner farthest from the frame's origin; ``center`` (x, y)."""
    corner = math.hypot(rows * res / 2 + abs(center[0]), cols * res / 2 + abs(center[1]))
    s_x, s_y, s_t = sigma_hi
    return max(1, math.ceil(chi * math.sqrt(s_x ** 2 + s_y ** 2 + s_t ** 2 * corner ** 2) / res))


def propagate(prior, center, res: float, yaw, sigmas, chi: float, radius: int):
    """prior (L or 1, rows, cols) -> (L, rows, cols) in prior's dtype."""
    rows, cols = prior.shape[-2:]
    sx, sy, rho = fields(center, res, rows, cols, yaw, sigmas)
    prior = prior.expand_as(sx)
    psd = rho.abs() < 1.0
    rho = torch.where(psd, rho, torch.zeros_like(rho))
    omr = 1.0 - rho * rho
    R = radius
    pad = torch.nn.functional.pad(prior, (R, R, R, R))
    inside_map = torch.nn.functional.pad(torch.ones_like(prior), (R, R, R, R))
    num = torch.zeros_like(sx)
    den = torch.zeros_like(sx)
    for di in range(-R, R + 1):
        for dj in range(-R, R + 1):
            # neighbour (i + di, j + dj) lies at (-di res, -dj res) from cell i
            zx = (-di * res) / sx
            zy = (-dj * res) / sy
            q = zx * zx - 2.0 * rho * zx * zy + zy * zy
            p_j = pad[:, R + di:R + di + rows, R + dj:R + dj + cols]
            v_j = inside_map[:, R + di:R + di + rows, R + dj:R + dj + cols]
            w = torch.where((q <= chi * chi * omr) & (v_j > 0), torch.exp(-q / (2.0 * omr)),
                            torch.zeros_like(q))
            num = num + w * p_j
            den = den + w
    out = torch.where(den > 0, num / den, prior).clamp(0.0, 100.0)
    return torch.where(psd & (den > 0), out, prior)


def to_frame(points, pose):
    """Global points (L, K, 2) into the frames of poses (L, 3) [x, y, yaw]."""
    c, s = torch.cos(pose[:, 2, None]), torch.sin(pose[:, 2, None])
    dx, dy = points[..., 0] - pose[:, 0, None], points[..., 1] - pose[:, 1, None]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)


def corridor_center(plan, pose, look_ahead: int, left: float, right: float):
    """The grid centre of local_costmap.cpp:712-805 and :213 for poses (L, 3):
    ``look_ahead`` waypoints from the nearest, offset ``left`` and ``right``
    across the path's heading (the last valid tangent carried over the
    route's end, the ego's yaw where there is none), bounded in the vehicle
    frame; the centre sits at (x_len / 2 - 5, (y_min + y_max) / 2)."""
    n = plan.shape[0]
    d = ((plan[None] - pose[:, None, :2]) ** 2).sum(-1)
    start = torch.argmin(d, dim=-1)
    ar = torch.arange(look_ahead, device=plan.device)
    idx = (start[:, None] + ar).clamp(max=n - 1)
    wp = plan[idx]
    tangent = plan[(idx + 1).clamp(max=n - 1)] - wp
    yaw_w = torch.atan2(tangent[..., 1], tangent[..., 0])
    ok = (tangent * tangent).sum(-1) > 1e-12
    last = torch.cummax(torch.where(ok, ar.expand_as(idx), torch.full_like(idx, -1)), dim=-1).values
    yaw_w = torch.where(last >= 0, torch.gather(yaw_w, 1, last.clamp(min=0)), pose[:, 2, None])
    heading = yaw_w - math.pi / 2.0
    heading = torch.where(heading < 0, heading + 2 * math.pi, heading)
    side = torch.stack([torch.cos(heading), torch.sin(heading)], dim=-1)
    local = to_frame(torch.cat([wp - left * side, wp + right * side], dim=1), pose)
    lo, hi = local.amin(1), local.amax(1)
    return torch.stack([(hi[:, 0] - lo[:, 0]) / 2.0 - 5.0, (hi[:, 1] + lo[:, 1]) / 2.0], dim=-1)


def _global_cells(center, res, rows, cols, pose):
    xs, ys = cell_positions(center, res, rows, cols)
    c, s = torch.cos(pose[:, 2])[:, None, None], torch.sin(pose[:, 2])[:, None, None]
    gx = xs[:, :, None] * c - ys[:, None, :] * s + pose[:, 0, None, None]
    gy = xs[:, :, None] * s + ys[:, None, :] * c + pose[:, 1, None, None]
    return gx, gy


def box_layer(obstacles, inflation: float, gate: float, center, res, rows, cols, pose):
    """100 on the cells whose centre lies in an obstacle's box grown by
    ``inflation`` (a same-side test against the box's four edges in the
    vehicle frame), for the obstacles within ``gate`` m of the ego; obstacles
    (M, 6) rows [x, y, yaw, length, width, speed]."""
    xs, ys = cell_positions(center, res, rows, cols)
    px, py = xs[:, :, None], ys[:, None, :]
    out = torch.zeros((pose.shape[0], rows, cols), dtype=pose.dtype, device=pose.device)
    signs = ((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0))
    for x, y, yaw, length, width, _ in obstacles.tolist():
        hx, hy = (length + inflation) / 2, (width + inflation) / 2
        co, so = math.cos(yaw), math.sin(yaw)
        corners = torch.tensor([[co * a * hx - so * b * hy + x, so * a * hx + co * b * hy + y]
                                for a, b in signs], dtype=pose.dtype, device=pose.device)
        v = to_frame(corners.expand(pose.shape[0], 4, 2), pose)  # (L, 4, 2)
        ge = le = None
        for k in range(4):
            a, b = v[:, k, None, None, :], v[:, (k + 1) % 4, None, None, :]
            cross = (b[..., 0] - a[..., 0]) * (py - a[..., 1]) - (b[..., 1] - a[..., 1]) * (px - a[..., 0])
            ge = cross >= 0 if ge is None else ge & (cross >= 0)
            le = cross <= 0 if le is None else le & (cross <= 0)
        near = ((pose[:, 0] - x) ** 2 + (pose[:, 1] - y) ** 2).sqrt() <= gate
        out = torch.maximum(out, 100.0 * ((ge | le) & near[:, None, None]).to(out.dtype))
    return out


def prior_layer(prior, prior_center, prior_res: float, center, res, rows, cols, pose):
    """The global prior's nearest cell under every cell, clamped to its edge."""
    H, W = prior.shape
    gx, gy = _global_cells(center, res, rows, cols, pose)
    top_x = prior_center[0] + H * prior_res / 2.0
    top_y = prior_center[1] + W * prior_res / 2.0
    # clamped as integers: a non-finite pose (a diverged control) reads the edge
    i = torch.floor((top_x - gx) / prior_res).long().clamp(0, H - 1)
    j = torch.floor((top_y - gy) / prior_res).long().clamp(0, W - 1)
    return prior[i, j]


def tick(cm: dict, plan, obstacles, prior, prior_center, prior_res: float, pose):
    """One costmap tick per pose (L, 3): (uncertainty map (L, rows, cols),
    grid centre (L, 2)), with the configuration's map-engine settings ``cm``."""
    rows, cols, res = cm["rows"], cm["cols"], cm["resolution"]
    center = corridor_center(plan, pose, cm["look_ahead_waypoints"], cm["corridor_left"],
                             cm["corridor_right"])
    boxes = box_layer(obstacles, cm["bbox_inflation"], cm["obstacle_raster_radius"], center, res,
                      rows, cols, pose)
    vehicle = torch.where(boxes > 90.0, boxes,
                          prior_layer(prior, prior_center, prior_res, center, res, rows, cols, pose))
    sig = torch.tensor([[cm["sigma_x"], cm["sigma_y"], cm["sigma_theta"]]], dtype=pose.dtype,
                       device=pose.device).expand(pose.shape[0], 3)
    return propagate(vehicle, center, res, pose[:, 2], sig, cm["chisquare_val"],
                     cm["window_radius"]), center
