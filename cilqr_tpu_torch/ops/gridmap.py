"""Grid-map geometry and bilinear sampling (the slice the solver uses).

Port of the geometry/sampling part of ``cilqr_tpu/ops/gridmap.py``
(grid_map's ``GridMapMath.cpp:114-145`` semantics).  Cell (0, 0) is the
top-left corner at the (+x, +y) extreme; positions decrease as indices grow:

    pos(i, j) = center + (length/2 - res/2) - res * (i, j)

Axis 0 (rows) spans x, axis 1 (cols) spans y.  The corner fetch is a
direct index gather: the one-hot matmul of the JAX package was a TPU
workaround for slow gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GridGeom(NamedTuple):
    """Geometry of a fixed-size grid."""

    center: torch.Tensor      # (2,) map-frame position of the grid center
    resolution: torch.Tensor  # ()
    length: torch.Tensor      # (2,) physical extent [len_x, len_y]


def make_geom(center_xy, resolution: float, rows: int, cols: int,
              dtype=torch.float32, device=None) -> GridGeom:
    center = torch.as_tensor(center_xy, dtype=dtype, device=device)
    res = torch.as_tensor(resolution, dtype=dtype, device=device)
    length = torch.tensor([rows * resolution, cols * resolution], dtype=dtype,
                          device=device)
    return GridGeom(center, res, length)


def _first(geom: GridGeom) -> torch.Tensor:
    return geom.center + 0.5 * geom.length - 0.5 * geom.resolution[..., None]


def cell_positions(geom: GridGeom, rows: int, cols: int):
    """(..., rows), (..., cols) cell-center coordinates along x and y; the
    leading dims are those of a geometry with one grid per scenario."""
    first = _first(geom)
    res = geom.resolution[..., None]
    ar = lambda n: torch.arange(n, dtype=geom.center.dtype, device=geom.center.device)
    xs = first[..., 0, None] - res * ar(rows)
    ys = first[..., 1, None] - res * ar(cols)
    return xs, ys


def position_from_index(geom: GridGeom, idx: torch.Tensor) -> torch.Tensor:
    """Cell-center position of integer index (..., 2)."""
    return _first(geom) - geom.resolution * idx.to(geom.center.dtype)


def index_from_position(geom: GridGeom, pos: torch.Tensor) -> torch.Tensor:
    """Integer cell index containing position (..., 2)."""
    top = geom.center + 0.5 * geom.length
    return torch.floor((top - pos) / geom.resolution).to(torch.int32)


def continuous_index(geom: GridGeom, pos: torch.Tensor) -> torch.Tensor:
    """Real-valued index such that integer values land on cell centers."""
    return (_first(geom) - pos) / geom.resolution


def in_bounds(geom: GridGeom, pos: torch.Tensor) -> torch.Tensor:
    """Boolean mask: position inside the map rectangle."""
    lo = geom.center - 0.5 * geom.length
    hi = geom.center + 0.5 * geom.length
    return ((pos >= lo) & (pos <= hi)).all(dim=-1)


def _corner_index(fi, fj, H: int, W: int):
    """Clamped float indices -> the top-left corner (i0, j0) and fractions.

    i0 <= H-2 and j0 <= W-2, so the four corners never leave the map."""
    fi = fi.clamp(0.0, H - 1.0)
    fj = fj.clamp(0.0, W - 1.0)
    i0 = torch.floor(fi).long().clamp(0, H - 2)
    j0 = torch.floor(fj).long().clamp(0, W - 2)
    return i0, j0, fi - i0, fj - j0


def _bilinear_tail(v00, v01, v10, v11, ti, tj, inv):
    """Interpolation + gradient; ``inv`` = d index / d pos = -1/resolution."""
    v0 = v00 * (1 - tj) + v01 * tj
    v1 = v10 * (1 - tj) + v11 * tj
    val = v0 * (1 - ti) + v1 * ti
    dv_di = v1 - v0
    dv_dj = (v01 - v00) * (1 - ti) + (v11 - v10) * ti
    grad = torch.stack([dv_di * inv, dv_dj * inv], dim=-1)
    return val, grad


def sample_bilinear_with_grad(data: torch.Tensor, geom: GridGeom, pos: torch.Tensor):
    """Bilinear interpolation + spatial gradient in map-frame coordinates.

    data: (H, W); pos: (..., 2).  Returns (value (...,), grad (..., 2)) with
    grad = d value / d pos.  Border cells clamp (the gradient follows the
    clamped interpolant).
    """
    H, W = data.shape
    ci = continuous_index(geom, pos)
    i0, j0, ti, tj = _corner_index(ci[..., 0], ci[..., 1], H, W)
    v00 = data[i0, j0]
    v01 = data[i0, j0 + 1]
    v10 = data[i0 + 1, j0]
    v11 = data[i0 + 1, j0 + 1]
    return _bilinear_tail(v00, v01, v10, v11, ti, tj, -1.0 / geom.resolution)


def sample_bilinear_with_grad_batched(data: torch.Tensor, geom: GridGeom,
                                      pos: torch.Tensor):
    """One map per batch row: data (B, H, W), geom with leading B leaves,
    pos (B, N, 2).  Same semantics as ``sample_bilinear_with_grad`` per row.
    """
    B, H, W = data.shape
    res = geom.resolution.reshape(B, 1)
    first = geom.center + 0.5 * geom.length - 0.5 * res  # (B, 2)
    ci = (first[:, None, :] - pos) / res[:, :, None]     # (B, N, 2)
    i0, j0, ti, tj = _corner_index(ci[..., 0], ci[..., 1], H, W)
    b = torch.arange(B, device=data.device)[:, None]
    v00 = data[b, i0, j0]
    v01 = data[b, i0, j0 + 1]
    v10 = data[b, i0 + 1, j0]
    v11 = data[b, i0 + 1, j0 + 1]
    return _bilinear_tail(v00, v01, v10, v11, ti, tj, -1.0 / res)
