"""Local uncertainty-costmap engine: the ``map_engine`` node
(``local_costmap.cpp`` + ``arbitrary_transformation.cu`` / ``ARBIT.cuh``).

Port of ``cilqr_tpu/ops/costmap.py``.  Per planning tick
(odomCallback, local_costmap.cpp:172-310):
  1. corridor-derived map geometry        (``corridor_geometry``)
  2. obstacle OBB rasterization           (``rasterize_obstacles``; with the
     corridor mask one kernel on the card, ``ops/costmap_cuda.py``)
  3. prior-map resampling, a rotated nearest gather (``sample_prior``;
     batched on the card: kernel K5, ``ops/sample_cuda.py``)
  4. uncertainty propagation (``propagate_uncertainty_reference``; on the
     card: kernel K4, ``ops/uncertainty_cuda.py``)
  5. planner map assembly                 (``build_local_costmap(_batched)``)

The grid is a fixed (rows, cols) patch whose center follows the corridor
bounding box, as in the JAX package.  Functions that the JAX package
``vmap``s over scenarios take leading scenario dims here.

For every cell i the propagated occupancy is
``u_i = sum_j f_ij p_j / sum_j f_ij`` over the cells j inside the 95%
ellipse of cell i's covariance and inside the map, with f the correlated 2D
Gaussian (``ARBIT.cuh:103-107``); the data-dependent EllipseIterator becomes
a fixed (2R+1)^2 offset scan with the analytic inside test
``d^T cov^-1 d <= chi^2``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cilqr_tpu_torch.models.reference_path import closest_point_index
from cilqr_tpu_torch.ops import costmap_cuda, gridmap
from cilqr_tpu_torch.utils.device import constant
from cilqr_tpu_torch.utils.params import CostmapParams


class LocalCostmap(NamedTuple):
    """Multi-layer vehicle-frame costmap (layers of local_costmap.cpp:125-132);
    in the batched build every leaf carries a leading B axis.
    ``semantic_lidar_map`` (the KF-tracked perception box, :328-394) and
    ``ellipse_map`` (the ego's 95% ellipse, for display) are filled on
    demand and None otherwise."""

    vehicle_map: torch.Tensor       # (rows, cols) prior + obstacle occupancy
    bounding_box_map: torch.Tensor  # (rows, cols) rasterized obstacle OBBs
    uncertainty_map: torch.Tensor   # (rows, cols) propagated occupancy
    corridor_mask: torch.Tensor     # (rows, cols) 1 inside the dynamic corridor
    geom: gridmap.GridGeom          # vehicle-frame geometry
    origin_xy: torch.Tensor         # (2,) ego global position (map origin)
    origin_yaw: torch.Tensor        # () ego global yaw
    semantic_lidar_map: Optional[torch.Tensor] = None
    ellipse_map: Optional[torch.Tensor] = None


def _last_index(n_valid, device):
    """n_valid - 1, a number or a tensor on ``device``."""
    return (n_valid.to(device) if isinstance(n_valid, torch.Tensor) else n_valid) - 1


def _path_headings(waypoints: torch.Tensor, idx: torch.Tensor, n_valid, fallback_yaw):
    """Path-tangent headings at waypoint indices ``idx`` (..., L).

    Degenerate tail (repeated last waypoint): the last valid heading is
    carried forward; ``fallback_yaw`` (...,) only where no index up to there
    has a valid tangent."""
    wp = waypoints[idx]
    nxt = waypoints[torch.clamp(idx + 1, max=_last_index(n_valid, idx.device))]
    tangent = nxt - wp
    yaw_w = torch.atan2(tangent[..., 1], tangent[..., 0])
    ok = (tangent * tangent).sum(dim=-1) > 1e-12
    L = idx.shape[-1]
    ar = torch.arange(L, device=idx.device).expand(idx.shape)
    last_valid = torch.cummax(torch.where(ok, ar, torch.full_like(ar, -1)), dim=-1).values
    yaw_filled = torch.gather(yaw_w, -1, last_valid.clamp(min=0))
    fallback = torch.as_tensor(fallback_yaw, dtype=yaw_w.dtype, device=yaw_w.device)
    return torch.where(last_valid >= 0, yaw_filled, fallback[..., None])


def corridor_geometry(cp: CostmapParams, waypoints: torch.Tensor, n_valid,
                      ego_xy: torch.Tensor, ego_yaw: torch.Tensor):
    """Vehicle-map center from the lane-corridor bounding box
    (``getVehicleMapScale``, local_costmap.cpp:712-805): ``look_ahead_waypoints``
    waypoints from the nearest one, offset 8 m left / 4 m right along
    heading - pi/2, transformed to the vehicle frame and bounded.

    ego_xy (..., 2), ego_yaw (...).  Returns (center (..., 2), (x_len, y_len),
    (x_min, x_max, y_min, y_max)), each (...,); the -5 m x shift of
    local_costmap.cpp:213 is included in the center."""
    start = closest_point_index(waypoints, n_valid, ego_xy)
    ar = torch.arange(cp.look_ahead_waypoints, device=start.device)
    idx = torch.clamp(start[..., None] + ar, max=_last_index(n_valid, start.device))
    wp = waypoints[idx]  # (..., L, 2)
    yaw_w = _path_headings(waypoints, idx, n_valid, ego_yaw)

    heading = yaw_w - math.pi / 2.0
    heading = torch.where(heading < 0, heading + 2 * math.pi, heading)
    side = torch.stack([torch.cos(heading), torch.sin(heading)], dim=-1)
    left = wp - cp.corridor_left * side
    right = wp + cp.corridor_right * side
    corridor = torch.cat([left, right], dim=-2)  # (..., 2L, 2)

    cy, sy = torch.cos(ego_yaw)[..., None], torch.sin(ego_yaw)[..., None]
    dxy = corridor - ego_xy[..., None, :]
    lx = cy * dxy[..., 0] + sy * dxy[..., 1]
    ly = -sy * dxy[..., 0] + cy * dxy[..., 1]
    x_min, x_max = lx.amin(dim=-1), lx.amax(dim=-1)
    y_min, y_max = ly.amin(dim=-1), ly.amax(dim=-1)
    x_len = x_max - x_min
    y_len = y_max - y_min
    center = torch.stack([x_len / 2.0 - 5.0, (y_max + y_min) / 2.0], dim=-1)
    return center, (x_len, y_len), (x_min, x_max, y_min, y_max)


def corridor_center_bounds(cp: CostmapParams, waypoints, n_valid, lateral_offsets=(-3.0, 0.0, 3.0),
                           max_yaw_dev: float = 1.2, n_yaw: int = 9, x_margin: float = 5.0,
                           y_margin: float = 5.0):
    """Bounds on the corridor-derived map center over a route: ``corridor_geometry``
    at ego poses swept along the plan (each valid waypoint at the path-tangent
    yaw) x lateral and yaw perturbations, padded with margins.  Feed the
    result to ``uncertainty_cuda.make_band_plan_bounds``.  Runs on the CPU in
    the waypoints' dtype, outside any loop; ``max_yaw_dev`` must bound the
    worst |ego_yaw - path_yaw| of the run (the center is a rotation of
    global offsets by -ego_yaw, so its extrema over the yaw range are
    interior: ``n_yaw`` points sample the whole interval).

    Returns ((x_lo, x_hi), (y_lo, y_hi)) Python floats."""
    nv = int(n_valid)
    if nv < 1:
        raise ValueError("corridor_center_bounds needs at least one waypoint")
    wpt = torch.as_tensor(waypoints).detach().cpu()
    dtype = wpt.dtype
    wp = wpt.numpy().astype(np.float64)[:nv]
    yaw = _path_headings(wpt, torch.arange(nv), nv, torch.zeros((), dtype=dtype)).numpy().astype(
        np.float64)
    centers = []
    for lat in lateral_offsets:
        exs = wp[:, 0] + lat * np.cos(yaw - np.pi / 2.0)
        eys = wp[:, 1] + lat * np.sin(yaw - np.pi / 2.0)
        for dy in np.linspace(-max_yaw_dev, max_yaw_dev, n_yaw):
            c, _, _ = corridor_geometry(cp, wpt, nv, torch.tensor(np.stack([exs, eys], -1), dtype=dtype),
                                        torch.tensor(yaw + dy, dtype=dtype))
            centers.append(c.numpy())
    cat = np.concatenate(centers, axis=0)
    return ((float(cat[:, 0].min() - x_margin), float(cat[:, 0].max() + x_margin)),
            (float(cat[:, 1].min() - y_margin), float(cat[:, 1].max() + y_margin)))


def obstacle_corners(cp: CostmapParams, obs_xy: torch.Tensor, obs_size: torch.Tensor,
                     obs_yaw: torch.Tensor, obs_mask: torch.Tensor, ego_xy: torch.Tensor,
                     ego_yaw: torch.Tensor, dtype: torch.dtype):
    """The per-scenario terms of the bounding-box layer (``bondingBoxHandle``,
    local_costmap.cpp:860-922): +0.2 m inflation, corners rotated by the
    obstacle yaw and transformed to the vehicle frame, the 100 m range gate.

    obs_xy, obs_size (M, 2), obs_yaw, obs_mask (M,) are shared; ego_xy
    (..., 2), ego_yaw (...) may carry leading scenario dims; ``dtype`` is the
    grid's.  Returns (corners (..., M, 4, 2), active (..., M))."""
    dist = torch.sqrt(((obs_xy - ego_xy[..., None, :]) ** 2).sum(dim=-1))  # (..., M)
    active = (obs_mask != 0) & (dist <= cp.obstacle_raster_radius)

    half = 0.5 * (obs_size + cp.bbox_inflation)  # (M, 2)
    sx = constant((1.0, 1.0, -1.0, -1.0), dtype, obs_xy.device)
    sy = constant((1.0, -1.0, -1.0, 1.0), dtype, obs_xy.device)
    cx_l = half[:, 0:1] * sx  # (M, 4) corners in the obstacle frame
    cy_l = half[:, 1:2] * sy
    co, so = torch.cos(obs_yaw)[:, None], torch.sin(obs_yaw)[:, None]
    gx = co * cx_l - so * cy_l + obs_xy[:, 0:1]
    gy = so * cx_l + co * cy_l + obs_xy[:, 1:2]
    cy, sy_e = torch.cos(ego_yaw)[..., None, None], torch.sin(ego_yaw)[..., None, None]
    ex, ey = ego_xy[..., 0, None, None], ego_xy[..., 1, None, None]
    lx = cy * (gx - ex) + sy_e * (gy - ey)  # (..., M, 4)
    ly = -sy_e * (gx - ex) + cy * (gy - ey)
    return torch.stack([lx, ly], dim=-1), active


def rasterize_obstacles(cp: CostmapParams, geom: gridmap.GridGeom, rows: int, cols: int,
                        obs_xy: torch.Tensor, obs_size: torch.Tensor, obs_yaw: torch.Tensor,
                        obs_mask: torch.Tensor, ego_xy: torch.Tensor,
                        ego_yaw: torch.Tensor) -> torch.Tensor:
    """Bounding-box layer (``bondingBoxHandle``, local_costmap.cpp:860-922):
    the ``obstacle_corners`` filled at 100 by the polygon mask
    (``costmap_cuda.obstacle_layer_plain``).

    obs_xy, obs_size (M, 2), obs_yaw, obs_mask (M,) are shared; ego_xy
    (..., 2), ego_yaw (...) and geom may carry leading scenario dims."""
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    verts, active = obstacle_corners(cp, obs_xy, obs_size, obs_yaw, obs_mask, ego_xy, ego_yaw,
                                     geom.center.dtype)
    return costmap_cuda.obstacle_layer_plain(xs, ys, verts, active)


def rasterize_tracked_bbox(geom: gridmap.GridGeom, rows: int, cols: int, box: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """``semantic_lidar_map`` layer: the KF-smoothed perception box filled as
    ``bboxCallback`` does (local_costmap.cpp:358-371).  ``box`` (..., 4) is
    the tracker's [cx, cy, w, h] in cell units of the camera convention: the
    start index is (150 - cy - h/2, 50 + cx - w/2), the extent (h, w), both
    truncated to integers.  Invalid measurements clear the layer."""
    cx, cy, w, h = box.unbind(-1)
    start = torch.stack([150.0 - cy - 0.5 * h, 50.0 + cx - 0.5 * w], dim=-1).to(torch.int32)
    size = torch.stack([h, w], dim=-1).to(torch.int32)
    m = gridmap.submap_mask(rows, cols, start, size, dtype=geom.center.dtype)
    return torch.where(valid[..., None, None], 100.0 * m, torch.zeros_like(m))


def sample_prior(geom: gridmap.GridGeom, rows: int, cols: int, global_map: torch.Tensor,
                 global_geom: gridmap.GridGeom, ego_xy: torch.Tensor,
                 ego_yaw: torch.Tensor) -> torch.Tensor:
    """Prior-map layer: nearest-cell lookup of the global map at every
    vehicle-frame cell rotated into the global frame
    (local_costmap.cpp:242-253).  geom, ego_xy (..., 2) and ego_yaw (...)
    may carry leading scenario dims: (..., rows, cols).  Batched, this is
    the plain version of kernel K5 (``ops/sample_cuda.py``), which repeats
    every operation below in this order."""
    H, W = global_map.shape
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    cx = xs[..., :, None]
    cyy = ys[..., None, :]
    cyaw = torch.cos(ego_yaw)[..., None, None]
    syaw = torch.sin(ego_yaw)[..., None, None]
    gx = cx * cyaw - cyy * syaw + ego_xy[..., 0, None, None]
    gy = cx * syaw + cyy * cyaw + ego_xy[..., 1, None, None]
    top = global_geom.center + 0.5 * global_geom.length
    i = gridmap.nearest_index(top[0], global_geom.resolution, gx, H)
    j = gridmap.nearest_index(top[1], global_geom.resolution, gy, W)
    return global_map[i, j]


def sigma_rho_terms(cp: CostmapParams, ego_yaw, faithful: bool = False, sigmas=None):
    """The part of ``cell_sigma_rho`` that does not depend on the cell:
    (s, c, sc, ssmcc, a, b, dxy, st2) with s, c = sin, cos of the yaw,
    sc = s c and ssmcc = s s - c c (the faithful lever's cross term; None
    in the default mode), a = sigma_x^2 + dxx, b = sigma_y^2 + dyy, dxy,
    st2 = sigma_theta^2.  Each is a tensor of the yaw's / sigmas' shape or,
    where only configured sigmas enter, a Python float, which PyTorch
    rounds to the tensor dtype where it meets a tensor."""
    s, c = torch.sin(ego_yaw), torch.cos(ego_yaw)
    if sigmas is None:
        s_x, s_y, s_t = cp.sigma_x, cp.sigma_y, cp.sigma_theta
    else:
        s_x, s_y, s_t = sigmas
    if faithful:
        sc, ssmcc = s * c, s * s - c * c
        dxx = dyy = dxy = 0.0  # reference form: unrotated diag
    else:
        sc = ssmcc = None
        d = s_x**2 - s_y**2
        dxx = -d * s * s
        dyy = d * s * s
        dxy = -d * s * c
    return s, c, sc, ssmcc, s_x**2 + dxx, s_y**2 + dyy, dxy, s_t**2


def sigma_rho_cells(Cx: torch.Tensor, Cy: torch.Tensor, terms, faithful: bool = False):
    """The per-cell arithmetic of ``cell_sigma_rho`` on cell coordinates Cx
    (..., rows, 1), Cy (..., 1, cols) and the ``sigma_rho_terms`` (tensors
    among them broadcast against (..., rows, cols)).  The propagation kernel
    repeats these operations in this order (``cell_fields`` in
    csrc/uncertainty.cu)."""
    s, c, sc, ssmcc, a, b, dxy, st2 = terms
    if faithful:
        g1 = -s * Cx - c * Cy
        g2 = c * Cx - s * Cy
        t = sc * (Cx * Cx - Cy * Cy) + Cx * Cy * ssmcc
    else:
        g1 = -Cy + 0.0 * Cx  # broadcast to (..., rows, cols)
        g2 = Cx + 0.0 * Cy
        t = g1 * g2
    u = g1 * g1
    v = g2 * g2
    sx = torch.sqrt(a + st2 * u)
    sy = torch.sqrt(b + st2 * v)
    rho = (dxy + st2 * t) / (sx * sy)
    return sx, sy, rho


def cell_sigma_rho(cp: CostmapParams, xs: torch.Tensor, ys: torch.Tensor, ego_yaw,
                   faithful: bool = False, sigmas=None):
    """Per-cell propagated covariance terms (sigma_x_i, sigma_y_i, rho),
    (..., rows, cols) (``uncertainty_error_functor``, ARBIT.cuh:51-69).

    xs (..., rows) and ys (..., cols) are the cell-center coordinates
    (``gridmap.cell_positions``).  ``ego_yaw`` and each of ``sigmas``
    (sigma_x, sigma_y, sigma_theta; default: the configured ones) are
    numbers or tensors that broadcast against (..., rows, cols), e.g.
    (B, 1, 1) for one map per scenario.

    Default (map frame): the lever of the pose's theta uncertainty is
    R(-yaw) g_g = (-Cy, Cx), yaw-free, and the translational diagonal is
    rotated into the map frame in the delta form d = sx^2 - sy^2 (exact for
    anisotropic sigmas, bit-identical to the isotropic form when d == 0).
    ``faithful=True`` reproduces the reference formula: the global-frame
    lever and its cross-term sign defect, which makes |rho| exceed 1 at some
    yaws; callers keep the prior on such cells.  See the JAX docstring for
    the derivation.  Split into the per-scenario ``sigma_rho_terms`` and the
    per-cell ``sigma_rho_cells``.
    """
    Cx = xs[..., :, None]
    Cy = ys[..., None, :]
    yaw = torch.as_tensor(ego_yaw, dtype=Cx.dtype, device=Cx.device)
    return sigma_rho_cells(Cx, Cy, sigma_rho_terms(cp, yaw, faithful, sigmas), faithful)


def required_window_radius(cp: CostmapParams, rows: int, cols: int, center=(None, None),
                           sigmas=None) -> int:
    """Smallest half-window (cells) covering the worst-case 95% ellipse:
    half_major = chi sqrt(lambda_max(cov)) <= chi sqrt(sigma_x^2 + sigma_y^2
    + sigma_theta^2 |corner|^2).  ``center`` defaults to the configured
    (x_position - 5, y_position); ``sigmas`` to the configured sigmas (pass
    the sampling upper bound for Monte-Carlo)."""
    cx = center[0] if center[0] is not None else cp.x_position - 5.0
    cy = center[1] if center[1] is not None else cp.y_position
    s_x, s_y, s_t = sigmas if sigmas is not None else (cp.sigma_x, cp.sigma_y, cp.sigma_theta)
    res = cp.resolution
    corner = math.hypot(rows * res / 2 + abs(cx), cols * res / 2 + abs(cy))
    a_plus_c = s_x**2 + s_y**2 + s_t**2 * corner**2
    half_major = cp.chisquare_val * math.sqrt(a_plus_c)
    return max(1, math.ceil(half_major / res))


def offset_distance(offset: int, res: float, dtype: torch.dtype) -> float:
    """-offset * res rounded as the JAX code rounds it in ``dtype``: the
    offset and the resolution are each cast to ``dtype`` and multiplied
    there (float32 arithmetic for a float32 map)."""
    npt = np.float32 if dtype == torch.float32 else np.float64
    return float(npt(-offset) * npt(res))


def propagate_uncertainty_reference(cp: CostmapParams, prior: torch.Tensor,
                                    geom: gridmap.GridGeom, ego_yaw,
                                    faithful_rho: bool = False, sigmas=None) -> torch.Tensor:
    """Plain PyTorch uncertainty propagation: the semantics oracle of the
    propagation kernel (division ``dx / sx``, row-major offset loop, full
    (2R+1)^2 window of ``cp.window_radius``).

    prior (rows, cols); ``sigmas`` as in ``cell_sigma_rho``: shaped
    (B, 1, 1) they give one map per draw, (B, rows, cols).  Cells whose
    covariance is not PSD (reachable with ``faithful_rho=True``) or whose
    weights are all zero keep the prior; the rest are clipped to [0, 100].
    """
    rows, cols = prior.shape[-2:]
    dtype = prior.dtype
    R = cp.window_radius
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    sx, sy, rho = cell_sigma_rho(cp, xs, ys, ego_yaw, faithful=faithful_rho, sigmas=sigmas)
    sx, sy, rho = sx.to(dtype), sy.to(dtype), rho.to(dtype)

    psd = rho.abs() < 1.0
    rho = torch.where(psd, rho, torch.zeros_like(rho))
    one_m_rho2 = 1.0 - rho * rho
    inv_det2 = 1.0 / (2.0 * one_m_rho2)
    # the Gaussian normalizer depends only on the output cell: it cancels
    chi2 = cp.chisquare_val**2
    thresh = chi2 * one_m_rho2
    two_rho = rho + rho

    # neighbour j at index offset (di, dj) sits at position offset
    # (-di*res, -dj*res) (indices grow against position)
    prior_pad = F.pad(prior, (R, R, R, R))
    valid_pad = F.pad(torch.ones_like(prior), (R, R, R, R))
    kw = dict(dtype=dtype, device=prior.device)
    num = torch.zeros(torch.broadcast_shapes(sx.shape, prior.shape), **kw)
    den = torch.zeros_like(num)
    W = 2 * R + 1
    for k in range(W * W):
        di = k // W - R
        dj = k % W - R
        dx = torch.tensor(offset_distance(di, cp.resolution, dtype), **kw)
        dy = torch.tensor(offset_distance(dj, cp.resolution, dtype), **kw)
        p_j = prior_pad[..., di + R: di + R + rows, dj + R: dj + R + cols]
        v_j = valid_pad[..., di + R: di + R + rows, dj + R: dj + R + cols]
        zx = dx / sx
        zy = dy / sy
        q = (zx - two_rho * zy) * zx + zy * zy
        f = torch.exp(-q * inv_det2)
        w = torch.where((q <= thresh) & (v_j > 0), f, torch.zeros_like(f))
        num = num + w * p_j
        den = den + w
    return torch.where(psd & (den > 0), (num / den).clamp(0.0, 100.0), prior)


def vehicle_geom(cp: CostmapParams, center: torch.Tensor) -> gridmap.GridGeom:
    """The static-extent vehicle-frame grid at ``center`` (..., 2); the
    resolution and length leaves are broadcast to its leading dims (views)."""
    lead = tuple(center.shape[:-1])
    res = constant(cp.resolution, center.dtype, center.device)
    length = constant((cp.rows * cp.resolution, cp.cols * cp.resolution), center.dtype,
                      center.device)
    return gridmap.GridGeom(center, res.expand(lead), length.expand(lead + (2,)))


def _costmap_pre(cp: CostmapParams, global_map, global_geom, waypoints, n_wpts, ego_state,
                 obs_xy, obs_size, obs_yaw, obs_mask, use_kernels: bool = False,
                 skip_prior: bool = False):
    """Everything before the propagation: corridor geometry and mask, the
    obstacle layer, the prior with the bbox override.  ego_state (..., 4).
    ``use_kernels`` forms the corridor mask and the obstacle layer with
    ``costmap_cuda.costmap_layers`` (one kernel for float32 tensors on the
    card, its plain version on the CPU), else with the plain version on any
    device and dtype.  ``skip_prior=True`` leaves the prior out
    (vehicle_map = bbox): the batched build fills it with kernel K5."""
    rows, cols = cp.rows, cp.cols
    ego_xy, ego_yaw = ego_state[..., :2], ego_state[..., 3]
    center, _, bounds = corridor_geometry(cp, waypoints, n_wpts, ego_xy, ego_yaw)
    geom = vehicle_geom(cp, center.to(global_map.dtype))
    # cells inside the reference's dynamic corridor bbox, and the obstacle boxes
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    verts, active = obstacle_corners(cp, obs_xy, obs_size, obs_yaw, obs_mask, ego_xy, ego_yaw,
                                     geom.center.dtype)
    layers = costmap_cuda.costmap_layers if use_kernels else costmap_cuda.costmap_layers_plain
    corridor, bbox = layers(xs, ys, torch.stack(bounds, dim=-1), verts, active)
    if skip_prior:
        return bbox, bbox, corridor, geom
    prior = sample_prior(geom, rows, cols, global_map, global_geom, ego_xy, ego_yaw)
    # bbox overrides prior where > 90 (local_costmap.cpp:260-263)
    return torch.where(bbox > 90.0, bbox, prior), bbox, corridor, geom


def build_local_costmap(cp: CostmapParams, global_map, global_geom, waypoints, n_wpts, ego_state,
                        obs_xy, obs_size, obs_yaw, obs_mask, use_kernels: bool = False,
                        tracked_box=None, tracked_valid=None, with_ellipse_layer: bool = False,
                        sigmas=None) -> LocalCostmap:
    """One costmap tick (odomCallback, local_costmap.cpp:172-310) for one
    ego_state (4,).

    ``use_kernels`` (the JAX package's ``use_pallas``): False propagates
    with the oracle ``propagate_uncertainty_reference``; True with
    ``uncertainty_cuda.propagate_uncertainty`` (kernel K4 for a float32 map
    on the card, its plain version on the CPU), and forms the corridor mask
    and the obstacle layer with ``costmap_cuda.costmap_layers`` (one
    kernel on the card).  ``tracked_box`` /
    ``tracked_valid``: the KF-smoothed perception box (``models.tracker.step``),
    rasterized into ``semantic_lidar_map`` and overriding the vehicle map
    where > 90.  ``with_ellipse_layer`` fills ``ellipse_map`` with the ego
    pose's 95% ellipse.  ``sigmas`` (3,) overrides the configured
    propagation sigmas; size ``cp.window_radius`` for the largest one
    (``required_window_radius``)."""
    ego_xy, ego_yaw = ego_state[:2], ego_state[3]
    vehicle_map, bbox, corridor, geom = _costmap_pre(
        cp, global_map, global_geom, waypoints, n_wpts, ego_state, obs_xy, obs_size, obs_yaw,
        obs_mask, use_kernels=use_kernels)

    semantic = None
    if tracked_box is not None:
        semantic = rasterize_tracked_bbox(geom, cp.rows, cp.cols, tracked_box, tracked_valid)
        vehicle_map = torch.where(semantic > 90.0, semantic, vehicle_map)

    ellipse = None
    if with_ellipse_layer:
        kw = dict(dtype=vehicle_map.dtype, device=vehicle_map.device)
        # the ego sits at vehicle-frame (0, 0): no lever arm, cov = diag(sx^2, sy^2)
        cov = torch.diag(torch.tensor([cp.sigma_x * cp.sigma_x, cp.sigma_y * cp.sigma_y], **kw))
        hm, hmin, ang = gridmap.confidence_ellipse(cov, cp.chisquare_val)
        axes = torch.stack([hm.clamp(min=cp.resolution), hmin.clamp(min=cp.resolution)])
        ellipse = 100.0 * gridmap.ellipse_mask(geom, cp.rows, cp.cols, torch.zeros(2, **kw),
                                               axes, ang).to(vehicle_map.dtype)

    if use_kernels:
        from cilqr_tpu_torch.ops import uncertainty_cuda

        unc = uncertainty_cuda.propagate_uncertainty(cp, vehicle_map, geom, ego_yaw, sigmas=sigmas)
    else:
        unc = propagate_uncertainty_reference(cp, vehicle_map, geom, ego_yaw, sigmas=sigmas)
    return LocalCostmap(vehicle_map, bbox, unc, corridor, geom, ego_xy, ego_yaw,
                        semantic_lidar_map=semantic, ellipse_map=ellipse)


def build_local_costmap_batched(cp: CostmapParams, global_map, global_geom, waypoints, n_wpts,
                                ego_states, obs_xy, obs_size, obs_yaw, obs_mask,
                                use_kernels: bool = True, band_plan=None,
                                global_res: Optional[float] = None, tracked_boxes=None,
                                tracked_valid=None, sigmas=None) -> LocalCostmap:
    """Per-scenario costmap ticks for ego_states (B, 4) over one shared
    world; every leaf of the result carries a leading B axis.

    ``use_kernels`` (the JAX package's ``use_pallas``): True takes the
    kernel wrappers: the corridor mask and the obstacle layer
    ``costmap_cuda.costmap_layers`` (one kernel), the prior resample with
    the bbox / semantic overrides ``sample_cuda.vehicle_map_batched`` (K5),
    then the banded propagation
    ``uncertainty_cuda.propagate_uncertainty_banded`` (K4) with per-scenario
    priors, frames and yaws.  For float32 tensors on the card they launch
    their kernels; for CPU tensors of any float dtype they take their plain
    versions; for float64 on the card they raise.  False takes
    ``sample_prior`` and the oracle ``propagate_uncertainty_reference`` on
    any device and dtype, and the plain version of the layers.

    ``band_plan`` (``uncertainty_cuda.make_band_plan_bounds`` over
    ``corridor_center_bounds``) cuts the propagation exactly; None is one
    full window of ``cp.window_radius``.  ``sigmas`` (B, 3) or (3,)
    overrides the configured propagation sigmas; the plan / window must be
    sized for the largest the caller feeds.  ``tracked_boxes`` (B, 4) /
    ``tracked_valid`` (B,) as in ``build_local_costmap``.  ``global_res``
    is accepted for the JAX signature and not used: the JAX package needs
    the resolution as a Python float to size its kernel's window, K5 reads
    it from ``global_geom``."""
    del global_res
    B = ego_states.shape[0]
    vehicle_map, bbox, corridor, geom = _costmap_pre(
        cp, global_map, global_geom, waypoints, n_wpts, ego_states, obs_xy, obs_size, obs_yaw,
        obs_mask, use_kernels=use_kernels, skip_prior=use_kernels)
    xys, yaws = ego_states[:, :2], ego_states[:, 3]

    semantic = None
    if tracked_boxes is not None:
        semantic = rasterize_tracked_bbox(geom, cp.rows, cp.cols, tracked_boxes, tracked_valid)
    if use_kernels:
        from cilqr_tpu_torch.ops import sample_cuda

        vehicle_map = sample_cuda.vehicle_map_batched(geom, cp.rows, cp.cols, global_map,
                                                      global_geom, xys, yaws, bbox, semantic)
    elif semantic is not None:
        vehicle_map = torch.where(semantic > 90.0, semantic, vehicle_map)

    sig_b = None
    if sigmas is not None:
        sig_b = torch.as_tensor(sigmas, dtype=vehicle_map.dtype,
                                device=vehicle_map.device).expand(B, 3)
    if use_kernels:
        from cilqr_tpu_torch.ops import uncertainty_cuda

        if band_plan is None:
            band_plan = uncertainty_cuda.full_window_plan(cp, cp.rows)
        elif band_plan.sigma_hi is not None and sigmas is None:
            # a plan built for smaller sigmas would silently truncate the
            # 95% ellipses; with ``sigmas`` given the caller owns the bound
            sh = band_plan.sigma_hi
            if cp.sigma_x > sh[0] or cp.sigma_y > sh[1] or cp.sigma_theta > sh[2]:
                raise ValueError(
                    f"band plan sized for sigma_hi={sh} but the costmap uses "
                    f"({cp.sigma_x}, {cp.sigma_y}, {cp.sigma_theta}): rebuild it with "
                    "make_band_plan_bounds")
        unc = uncertainty_cuda.propagate_uncertainty_banded(cp, vehicle_map, geom, yaws, sig_b,
                                                            band_plan)
    else:
        sig = None if sig_b is None else tuple(s[:, None, None] for s in sig_b.unbind(-1))
        unc = propagate_uncertainty_reference(cp, vehicle_map, geom, yaws[:, None, None],
                                              sigmas=sig)
    return LocalCostmap(vehicle_map, bbox, unc, corridor, geom, xys, yaws,
                        semantic_lidar_map=semantic)
