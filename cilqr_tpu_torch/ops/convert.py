"""Occupancy-grid <-> grid-layer conversions.

Port of ``cilqr_tpu/ops/convert.py``: functional equivalents of the
load-bearing ``GridMapRosConverter`` slice
(``grid_map_ros/src/GridMapRosConverter.cpp``: ``toOccupancyGrid`` :271,
``fromOccupancyGrid`` :225, ``toMessage`` :82); the transport message is a
NamedTuple of tensors, the value scaling / NaN semantics are kept.
Functions of tensors: they follow their tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cilqr_tpu_torch.ops import gridmap


class OccupancyGrid(NamedTuple):
    """nav_msgs/OccupancyGrid payload: int8 data in [-1, 100] (-1 = unknown),
    plus map_server-style geometry (origin = lower-left)."""

    data: torch.Tensor       # (rows, cols) int8 in our grid orientation
    resolution: torch.Tensor
    origin_xy: torch.Tensor  # (2,) position of the lower-left corner
    origin_yaw: torch.Tensor


def to_occupancy_grid(layer: torch.Tensor, geom: gridmap.GridGeom, data_min: float,
                      data_max: float, origin_yaw=None) -> OccupancyGrid:
    """GridMapRosConverter::toOccupancyGrid semantics: linearly map
    [data_min, data_max] -> [0, 100], NaN -> -1 (unknown)."""
    span = data_max - data_min
    scaled = (layer - data_min) / span * 100.0
    occ = torch.clamp(torch.round(scaled), 0.0, 100.0)
    occ = torch.where(torch.isnan(layer), torch.full_like(occ, -1.0), occ).to(torch.int8)
    origin = geom.center - 0.5 * geom.length
    yaw = (torch.zeros((), dtype=geom.center.dtype, device=geom.center.device)
           if origin_yaw is None else origin_yaw)
    return OccupancyGrid(occ, geom.resolution, origin, yaw)


def from_occupancy_grid(msg: OccupancyGrid, data_min: float = 0.0, data_max: float = 100.0):
    """Inverse conversion: -1 (unknown) -> NaN, [0, 100] -> [min, max], in
    float32 as the JAX function computes it.  Returns (layer, GridGeom)."""
    rows, cols = msg.data.shape
    vals = msg.data.to(torch.float32)
    layer = data_min + vals / 100.0 * (data_max - data_min)
    layer = torch.where(msg.data < 0, torch.full_like(layer, float("nan")), layer)
    # the length in the layer's float32, promoted by its product with the
    # resolution as JAX promotes it (PyTorch would not promote by a 0-d tensor)
    res = torch.as_tensor(msg.resolution, device=layer.device)
    dtype = torch.promote_types(layer.dtype, res.dtype)
    length = torch.tensor([rows, cols], dtype=dtype, device=layer.device) * res
    center = msg.origin_xy + 0.5 * length
    return layer, gridmap.GridGeom(center, msg.resolution, length)


class GridMapMessage(NamedTuple):
    """grid_map_msgs/GridMap payload (toMessage, GridMapRosConverter.cpp:82):
    named layers + shared geometry."""

    layers: tuple            # tuple of layer names
    data: torch.Tensor       # (L, rows, cols)
    geom: gridmap.GridGeom
    frame_origin_xy: torch.Tensor
    frame_origin_yaw: torch.Tensor


def to_gridmap_message(layer_dict: dict, geom: gridmap.GridGeom, origin_xy,
                       origin_yaw) -> GridMapMessage:
    names = tuple(sorted(layer_dict))
    data = torch.stack([layer_dict[n] for n in names])
    return GridMapMessage(names, data, geom, origin_xy, origin_yaw)


def layer(msg: GridMapMessage, name: str) -> torch.Tensor:
    return msg.data[msg.layers.index(name)]
