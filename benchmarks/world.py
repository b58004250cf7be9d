"""The inputs the benchmark makes itself, from a configuration's ``world``
group: the route, the obstacles, the Town02-class global prior, its
vehicle-frame window at a pose, and the world's propagated costmap.  Both
sides, the program and the reference, get these same values.

The prior is a rectangular road loop at 0.2 m per cell: free lanes (0),
occupied elsewhere (100), laid out as the map server's image read back and
turned into grid order (index 0 at the +x / +y corner).  It does not depend
on the seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmarks.reference import costmap as ref_costmap


def _cells(center, res: float, rows: int, cols: int):
    xs = center[0] + rows * res / 2 - res / 2 - res * np.arange(rows)
    ys = center[1] + cols * res / 2 - res / 2 - res * np.arange(cols)
    return xs, ys


class Prior(NamedTuple):
    values: np.ndarray  # (H, W) occupancy in {0, 100}, grid order
    center: tuple       # map-frame centre of the grid
    res: float


def route(world: dict) -> np.ndarray:
    """(n, 2) waypoints of the straight lane ``world["plan"]``."""
    x0, y, length, spacing = (world["plan"][k] for k in ("x0", "y", "length", "spacing"))
    n = int(length / spacing) + 1
    return np.stack([x0 + spacing * np.arange(n), np.full(n, y)], axis=1)


def obstacles(world: dict) -> np.ndarray:
    """(M, 6) rows [x, y, yaw, length, width, speed]."""
    length, width = world["obstacle_size"]
    return np.array([[x, y, yaw, length, width, 0.0] for x, y, yaw in world["obstacles"]],
                    dtype=np.float64)


def town_prior(town: dict) -> Prior:
    res = town["resolution"]
    n = int(round(town["size_m"] / res))
    ox, oy = town["origin"]
    half = town["lane_width"] / 2.0
    free = np.zeros((n, n), dtype=bool)  # image rows top-down, columns west-east
    for x0, y0, x1, y1 in town["lanes"]:
        c0 = (min(x0, x1) - half - ox) / res
        r0 = n - 1 - (max(y0, y1) + half - oy) / res
        c1 = (max(x0, x1) + half - ox) / res
        r1 = n - 1 - (min(y0, y1) - half - oy) / res
        free[max(0, int(r0)):min(n, int(r1) + 1), max(0, int(c0)):min(n, int(c1) + 1)] = True
    occ = np.where(free, 0.0, 100.0)
    grid = np.ascontiguousarray(occ.T[::-1, :])
    return Prior(grid, (ox + n * res / 2.0, oy + n * res / 2.0), res)


def prior_window(prior: Prior, pose, center, res: float, rows: int, cols: int) -> np.ndarray:
    """The prior's nearest cell under every cell of a vehicle-frame grid at
    ``pose`` (x, y, yaw), clamped to the prior's edge: (rows, cols)."""
    xs, ys = _cells(center, res, rows, cols)
    c, s = math.cos(pose[2]), math.sin(pose[2])
    gx = xs[:, None] * c - ys[None, :] * s + pose[0]
    gy = xs[:, None] * s + ys[None, :] * c + pose[1]
    H, W = prior.values.shape
    top_x = prior.center[0] + H * prior.res / 2.0
    top_y = prior.center[1] + W * prior.res / 2.0
    i = np.clip(np.floor((top_x - gx) / prior.res), 0, H - 1).astype(np.int64)
    j = np.clip(np.floor((top_y - gy) / prior.res), 0, W - 1).astype(np.int64)
    return prior.values[i, j]


def obstacle_layer(obs: np.ndarray, inflation: float, pose, center, res: float, rows: int,
                   cols: int) -> np.ndarray:
    """100 on the cells whose centre lies in an obstacle's box grown by
    ``inflation``, else 0: (rows, cols)."""
    xs, ys = _cells(center, res, rows, cols)
    c, s = math.cos(pose[2]), math.sin(pose[2])
    gx = xs[:, None] * c - ys[None, :] * s + pose[0]
    gy = xs[:, None] * s + ys[None, :] * c + pose[1]
    out = np.zeros((rows, cols))
    for x, y, yaw, length, width, _ in obs:
        co, so = math.cos(yaw), math.sin(yaw)
        lx = co * (gx - x) + so * (gy - y)
        ly = -so * (gx - x) + co * (gy - y)
        inside = (np.abs(lx) <= (length + inflation) / 2) & (np.abs(ly) <= (width + inflation) / 2)
        out[inside] = 100.0
    return out


class Frame(NamedTuple):
    """A vehicle-frame grid at a pose: its occupancy before propagation."""

    vehicle_map: np.ndarray  # (rows, cols)
    center: tuple
    res: float
    origin_xy: tuple
    origin_yaw: float


def vehicle_frame(config: dict, pose) -> Frame:
    """The prior window with the obstacles' boxes over it, at ``pose``."""
    w, cm = config["world"], config["costmap"]
    center = tuple(w["map_center"])
    rows, cols, res = cm["rows"], cm["cols"], cm["resolution"]
    prior = prior_window(town_prior(w["town"]), pose, center, res, rows, cols)
    boxes = obstacle_layer(obstacles(w), cm["bbox_inflation"], pose, center, res, rows, cols)
    return Frame(np.maximum(prior, boxes), center, res, (pose[0], pose[1]), pose[2])


def world_costmap(config: dict, frame: Frame, device) -> torch.Tensor:
    """The frame propagated at the configured map-engine sigmas, in float64
    on ``device`` and rounded to float32: the shared costmap of a world."""
    cm = config["costmap"]
    sig = (cm["sigma_x"], cm["sigma_y"], cm["sigma_theta"])
    f64 = dict(dtype=torch.float64, device=device)
    out = ref_costmap.propagate(torch.tensor(frame.vehicle_map, **f64)[None],
                                torch.tensor([frame.center], **f64), frame.res,
                                torch.tensor([frame.origin_yaw], **f64),
                                torch.tensor([sig], **f64), cm["chisquare_val"],
                                cm["window_radius"])
    return out[0].float()
