"""Simulated perception bbox camera: the sensor feeding the KF tracker.

Port of ``cilqr_tpu/sim/perception.py``.  The reference's perception
channel publishes pixel bounding boxes consumed by
``LocalCostmap::bboxCallback`` (``local_costmap.cpp:328-394``): gated for
sanity (:331-336), converted to [cx, cy, w, h] (:343-349), smoothed by the
constant-velocity Kalman filter (``models/tracker.py``) and rasterized into
``semantic_lidar_map`` (``ops.costmap.rasterize_tracked_bbox``).  This
module closes the loop without a simulator: it projects a (moving)
obstacle's ground-truth OBB into the vehicle-frame grid and emits the
[cx, cy, w, h] cell-unit measurement in the reference's camera convention,
the exact inverse of ``rasterize_tracked_bbox``'s start-index mapping.
Gaussian noise models the detector.  As in the JAX package, the painted box
is the KF posterior, not the previous raw measurement the reference paints.

The detector noise is taken as standard-normal draws from the caller (JAX's
PRNG stream cannot be reproduced), scaled by ``sigma`` here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cilqr_tpu_torch.ops import gridmap
from cilqr_tpu_torch.utils.device import constant
from cilqr_tpu_torch.utils.params import CostmapParams


class PerceptionSim(NamedTuple):
    """The simulated camera channel of the full-stack loops.

    ``obs_index``: which obstacle row the camera sees.  That obstacle is
    removed from the bounding-box rasterization: its only way into the
    costmap is camera -> KF -> ``semantic_lidar_map``, while the SAT
    collision ground truth still sees its true pose."""

    obs_index: int
    vel: torch.Tensor   # (2,) constant global-frame velocity [m/s]
    bbox_sigma: float   # detector noise, cells (std dev on cx/cy/w/h)


def bbox_measurement(cp: CostmapParams, geom: gridmap.GridGeom, ego_xy: torch.Tensor,
                     ego_yaw: torch.Tensor, obs_xy: torch.Tensor, obs_size: torch.Tensor,
                     obs_yaw: torch.Tensor, draws: torch.Tensor | None = None,
                     sigma: float = 0.0):
    """Project one obstacle OBB to a noisy [cx, cy, w, h] cell measurement:
    (z (..., 4), valid (...)).  geom, ego_xy (..., 2) and ego_yaw (...) may
    carry leading scenario dims; the obstacle (obs_xy (2,), obs_size (2,),
    obs_yaw ()) is shared.  ``draws`` (..., 4) standard-normal numbers add
    ``sigma * draws`` to z when sigma > 0.

    z follows the camera convention (local_costmap.cpp:343-349):
    ``cy = 150 - r0 - h/2`` and ``cx = c0 - 50 + w/2`` with (r0, c0) the
    top-left continuous index of the obstacle's axis-aligned cell box, so
    ``rasterize_tracked_bbox`` paints the obstacle's cells.  ``valid`` is
    the out-of-plane gate (``measurement_valid``)."""
    dtype = geom.center.dtype
    half = 0.5 * obs_size
    signs = constant(((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)), dtype, half.device)
    corners = signs * half  # (4, 2) obstacle frame
    co, so = torch.cos(obs_yaw), torch.sin(obs_yaw)
    gx = co * corners[:, 0] - so * corners[:, 1] + obs_xy[0]
    gy = so * corners[:, 0] + co * corners[:, 1] + obs_xy[1]
    ce, se = torch.cos(ego_yaw)[..., None], torch.sin(ego_yaw)[..., None]
    ex, ey = ego_xy[..., 0, None], ego_xy[..., 1, None]
    lx = ce * (gx - ex) + se * (gy - ey)  # (..., 4)
    ly = -se * (gx - ex) + ce * (gy - ey)
    first = gridmap.first_position(geom)[..., None, :]  # (..., 1, 2)
    res = geom.resolution[..., None, None]
    ci = (first - torch.stack([lx, ly], dim=-1)) / res  # (..., 4, 2) continuous index
    r0, r1 = ci[..., 0].amin(dim=-1), ci[..., 0].amax(dim=-1)
    c0, c1 = ci[..., 1].amin(dim=-1), ci[..., 1].amax(dim=-1)
    h = r1 - r0
    w = c1 - c0
    z = torch.stack([c0 - 50.0 + 0.5 * w, 150.0 - r0 - 0.5 * h, w, h], dim=-1)
    if draws is not None and sigma > 0.0:
        z = z + sigma * draws.to(z.dtype)
    return z, measurement_valid(cp, z)


def measurement_valid(cp: CostmapParams, z: torch.Tensor) -> torch.Tensor:
    """The bbox sanity gate on [cx, cy, w, h] (..., 4): the implied cell box
    must lie inside the (rows, cols) grid with positive extent
    (local_costmap.cpp:331-336)."""
    r0 = 150.0 - z[..., 1] - 0.5 * z[..., 3]
    c0 = 50.0 + z[..., 0] - 0.5 * z[..., 2]
    return ((z[..., 2] > 0.0) & (z[..., 3] > 0.0)
            & (r0 >= 0.0) & (r0 + z[..., 3] <= cp.rows)
            & (c0 >= 0.0) & (c0 + z[..., 2] <= cp.cols))
