"""Grid-map geometry, sampling and rasterization.

Port of ``cilqr_tpu/ops/gridmap.py`` (grid_map's ``GridMapMath.cpp:114-145``
semantics, its Polygon/Submap/Ellipse iterators as masks).  Where the JAX
code is ``vmap``ped over scenarios, the functions here take a geometry and
arguments with leading scenario dims.  Cell (0, 0) is the
top-left corner at the (+x, +y) extreme; positions decrease as indices grow:

    pos(i, j) = center + (length/2 - res/2) - res * (i, j)

Axis 0 (rows) spans x, axis 1 (cols) spans y.  The corner fetch is a
direct index gather: the one-hot matmul of the JAX package was a TPU
workaround for slow gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from cilqr_tpu_torch.ops.eig2x2 import eigh2x2
from cilqr_tpu_torch.utils.device import resolve


class GridGeom(NamedTuple):
    """Geometry of a fixed-size grid."""

    center: torch.Tensor      # (2,) map-frame position of the grid center
    resolution: torch.Tensor  # ()
    length: torch.Tensor      # (2,) physical extent [len_x, len_y]


def make_geom(center_xy, resolution: float, rows: int, cols: int,
              dtype=torch.float32, device=None) -> GridGeom:
    device = resolve(device)
    center = torch.as_tensor(center_xy, dtype=dtype, device=device)
    res = torch.as_tensor(resolution, dtype=dtype, device=device)
    length = torch.tensor([rows * resolution, cols * resolution], dtype=dtype,
                          device=device)
    return GridGeom(center, res, length)


def first_position(geom: GridGeom) -> torch.Tensor:
    """(..., 2) position of the center of cell (0, 0)."""
    return geom.center + 0.5 * geom.length - 0.5 * geom.resolution[..., None]


def cell_positions(geom: GridGeom, rows: int, cols: int):
    """(..., rows), (..., cols) cell-center coordinates along x and y; the
    leading dims are those of a geometry with one grid per scenario."""
    first = first_position(geom)
    res = geom.resolution[..., None]
    ar = lambda n: torch.arange(n, dtype=geom.center.dtype, device=geom.center.device)
    xs = first[..., 0, None] - res * ar(rows)
    ys = first[..., 1, None] - res * ar(cols)
    return xs, ys


def position_from_index(geom: GridGeom, idx: torch.Tensor) -> torch.Tensor:
    """Cell-center position of integer index (..., 2)."""
    return first_position(geom) - geom.resolution * idx.to(geom.center.dtype)


def index_from_position(geom: GridGeom, pos: torch.Tensor) -> torch.Tensor:
    """Integer cell index containing position (..., 2)."""
    top = geom.center + 0.5 * geom.length
    return torch.floor((top - pos) / geom.resolution).to(torch.int32)


def continuous_index(geom: GridGeom, pos: torch.Tensor) -> torch.Tensor:
    """Real-valued index such that integer values land on cell centers."""
    return (first_position(geom) - pos) / geom.resolution


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


def nearest_index(top, resolution, coord: torch.Tensor, n: int) -> torch.Tensor:
    """Cell index along one axis of the position coordinate ``coord``:
    floor((top - coord) / resolution), clamped to [0, n - 1] as a float and
    then cast, so coordinates far outside the map give the edge cell
    whatever the integer conversion does out of range."""
    return torch.floor((top - coord) / resolution).clamp(0.0, n - 1.0).long()


def sample_nearest(data: torch.Tensor, geom: GridGeom, pos: torch.Tensor) -> torch.Tensor:
    """atPosition-style nearest-cell lookup (GridMap.hpp:166), clamped at the
    border: data (H, W), pos (..., 2) -> values (...,)."""
    H, W = data.shape
    top = geom.center + 0.5 * geom.length
    i = nearest_index(top[0], geom.resolution, pos[..., 0], H)
    j = nearest_index(top[1], geom.resolution, pos[..., 1], W)
    return data[i, j]


def rasterize_polygon(geom: GridGeom, rows: int, cols: int, vertices: torch.Tensor) -> torch.Tensor:
    """(..., rows, cols) float mask of cells whose centers lie inside the
    convex polygon ``vertices`` (..., K, 2), CCW or CW (grid_map's
    ``PolygonIterator`` as an all-same-side half-plane test).  ``geom`` is
    shared or has the leading dims of ``vertices``."""
    xs, ys = cell_positions(geom, rows, cols)
    return polygon_mask(xs, ys, vertices, geom.center.dtype)


def polygon_mask(xs: torch.Tensor, ys: torch.Tensor, vertices: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``rasterize_polygon`` on the cell-center coordinates xs (..., rows)
    and ys (..., cols) of ``cell_positions``, as a ``dtype`` mask.

    The same-side test is accumulated edge by edge, so the temporaries stay
    (..., rows, cols) whatever K is."""
    px = xs[..., :, None]
    py = ys[..., None, :]
    K = vertices.shape[-2]
    all_ge = all_le = None
    for k in range(K):
        v = vertices[..., k, :]
        vn = vertices[..., (k + 1) % K, :]
        ex = (vn[..., 0] - v[..., 0])[..., None, None]
        ey = (vn[..., 1] - v[..., 1])[..., None, None]
        rx = px - v[..., 0, None, None]
        ry = py - v[..., 1, None, None]
        cross = ex * ry - ey * rx
        ge, le = cross >= 0, cross <= 0
        all_ge = ge if all_ge is None else all_ge & ge
        all_le = le if all_le is None else all_le & le
    return (all_ge | all_le).to(dtype)


def submap_mask(rows: int, cols: int, start: torch.Tensor, size: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """(..., rows, cols) mask of the rectangular submap [start, start+size)
    for integer start, size (..., 2): the ``SubmapIterator`` of the
    tracked-bbox rasterization (local_costmap.cpp:358-371)."""
    i = torch.arange(rows, device=start.device)[:, None]
    j = torch.arange(cols, device=start.device)[None, :]
    s0, s1 = start[..., 0, None, None], start[..., 1, None, None]
    n0, n1 = size[..., 0, None, None], size[..., 1, None, None]
    return ((i >= s0) & (i < s0 + n0) & (j >= s1) & (j < s1 + n1)).to(dtype)


def confidence_ellipse(cov: torch.Tensor, chisquare_val: float = 2.4477):
    """2x2 covariance (..., 2, 2) -> (half_major, half_minor, angle): half
    axes chi*sqrt(eigenvalue), angle of the major eigenvector wrapped to
    [0, 2pi) (``getConfidenceEllipse``, local_costmap.cpp:410-454)."""
    w, V = eigh2x2(cov)
    v_hi = V[..., :, 1]
    angle = torch.atan2(v_hi[..., 1], v_hi[..., 0])
    angle = torch.where(angle < 0, angle + 2 * math.pi, angle)
    half_major = chisquare_val * torch.sqrt(w[..., 1].clamp(min=0.0))
    half_minor = chisquare_val * torch.sqrt(w[..., 0].clamp(min=0.0))
    return half_major, half_minor, angle


def ellipse_mask(geom: GridGeom, rows: int, cols: int, center: torch.Tensor,
                 half_axes: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """(..., rows, cols) bool mask of cells inside a rotated ellipse, with
    grid_map's ``EllipseIterator::isInside`` form (EllipseIterator.cpp:84-90):
    the transform [[cos, sin], [sin, -cos]], tested <= 1 against the squared
    half axes.  center, half_axes (..., 2); rotation (...)."""
    xs, ys = cell_positions(geom, rows, cols)
    dx = xs[..., :, None] - center[..., 0, None, None]
    dy = ys[..., None, :] - center[..., 1, None, None]
    c = torch.cos(rotation)[..., None, None]
    s = torch.sin(rotation)[..., None, None]
    u = c * dx + s * dy
    w = s * dx - c * dy
    q = (u / half_axes[..., 0, None, None]) ** 2 + (w / half_axes[..., 1, None, None]) ** 2
    return q <= 1.0
