"""Separating-axis-theorem OBB collision: the ground-truth checker.

Reference semantics: ``CILQR/src/ilqr/include/ilqr/Experiment.cpp:2-69``;
the port of ``cilqr_tpu/sim/collision.py``.  A vehicle is (x, y, yaw,
length, width); every component may carry leading dims, and the two
vehicles of a test broadcast against each other.
"""

from __future__ import annotations

import torch

_SIGNS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


def obb_corners(x, y, yaw, length, width) -> torch.Tensor:
    """(..., 4, 2) rectangle corners (Experiment.cpp:13-28 ordering)."""
    x, y, yaw, length, width = torch.broadcast_tensors(
        *(torch.as_tensor(v) for v in (x, y, yaw, length, width)))
    hl, hw = length / 2.0, width / 2.0
    c, s = torch.cos(yaw), torch.sin(yaw)
    corners = []
    for sx, sy in _SIGNS:
        lx, ly = sx * hl, sy * hw
        corners.append(torch.stack([lx * c - ly * s + x, lx * s + ly * c + y], dim=-1))
    return torch.stack(corners, dim=-2)


def is_collision(v1, v2) -> torch.Tensor:
    """SAT test between two (x, y, yaw, length, width) tuples -> bool (...).

    Mirrors ``isCollision`` (Experiment.cpp:30-68): 4 candidate axes from
    the two rectangles' edges; overlap on every axis is a collision."""
    c1 = obb_corners(*v1)
    c2 = obb_corners(*v2)
    lead = torch.broadcast_shapes(c1.shape[:-2], c2.shape[:-2])
    c1 = c1.expand(lead + (4, 2))
    c2 = c2.expand(lead + (4, 2))

    def edge_axis(c, i, j):
        return torch.atan2(c[..., j, 1] - c[..., i, 1], c[..., j, 0] - c[..., i, 0])

    axes = torch.stack([edge_axis(c1, 0, 1), edge_axis(c1, 0, 3),
                        edge_axis(c2, 0, 1), edge_axis(c2, 0, 3)], dim=-1)  # (..., 4)
    ca, sa = torch.cos(axes)[..., :, None], torch.sin(axes)[..., :, None]
    p1 = c1[..., None, :, 0] * ca + c1[..., None, :, 1] * sa  # (..., axis, corner)
    p2 = c2[..., None, :, 0] * ca + c2[..., None, :, 1] * sa
    sep = (p1.amax(dim=-1) < p2.amin(dim=-1)) | (p2.amax(dim=-1) < p1.amin(dim=-1))
    return ~sep.any(dim=-1)
