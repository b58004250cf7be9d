"""The costmap build's corridor mask and obstacle layer: one CUDA pass.

``costmap._costmap_pre`` forms two per-cell layers of every vehicle frame:
the corridor mask (cells inside the dynamic corridor's bounding box) and
the bounding-box layer (100 where an active obstacle's box holds the cell
centre).  In plain PyTorch (``costmap_layers_plain``) each obstacle edge
writes a full (B, rows, cols) cross product and two compare maps, and the
ands, the running maximum and the x100 each write another; the JAX
reference leaves the fusion to XLA.  One CUDA kernel (``csrc/costmap.cu``)
computes both layers from the per-scenario terms, which stay in PyTorch
and are a few hundred bytes per scenario: the cell centres xs (..., rows)
and ys (..., cols) (``gridmap.cell_positions``), the corridor bounds
(..., 4) = (x_min, x_max, y_min, y_max) (``costmap.corridor_geometry``), the
obstacles' vehicle-frame corners (..., M, 4, 2) and their active flags
(..., M) (``costmap.obstacle_corners``).

``costmap_layers`` launches the kernel for CUDA tensors (float32) and takes
the plain version for CPU tensors (any float dtype), both through the op
``cilqr_torch::costmap_layers`` (its CPU implementation is the plain
version), so a stream planner and a CUDA graph see the launch as one op.
The layers are exact 0 / 1 and 0 / 100 masks: kernel and plain version
agree on every cell.
"""

from __future__ import annotations

import math
import sys

import torch

from cilqr_tpu_torch.ops import gridmap, route
from cilqr_tpu_torch.utils import graphs

LAUNCHES = 0  # kernel launches made by this module's wrappers
MAX_OBSTACLES = 512  # the kernel stages every obstacle's edges in shared memory
graphs.COUNTERS.append((sys.modules[__name__], "LAUNCHES"))


def obstacle_layer_plain(xs: torch.Tensor, ys: torch.Tensor, verts: torch.Tensor,
                         active: torch.Tensor) -> torch.Tensor:
    """(..., rows, cols) bounding-box layer: 100 where an active obstacle's
    polygon ``verts`` (..., M, 4, 2) holds the cell centre
    (``gridmap.polygon_mask``), 0 elsewhere.  The obstacles are filled one
    after the other into a running maximum, so the temporaries stay
    (..., rows, cols)."""
    rows, cols = xs.shape[-1], ys.shape[-1]
    out = torch.zeros(tuple(active.shape[:-1]) + (rows, cols), dtype=xs.dtype, device=xs.device)
    for m in range(verts.shape[-3]):
        mask = gridmap.polygon_mask(xs, ys, verts[..., m, :, :], xs.dtype)
        out = torch.maximum(out, torch.where(active[..., m, None, None], mask,
                                             torch.zeros_like(mask)))
    return 100.0 * out


def costmap_layers_plain(xs: torch.Tensor, ys: torch.Tensor, bounds: torch.Tensor,
                         verts: torch.Tensor, active: torch.Tensor):
    """Plain version of the kernel: (corridor mask, bounding-box layer),
    each (..., rows, cols) in the dtype of xs.  The corridor mask is 1 where
    the cell centre lies inside ``bounds`` (..., 4) = (x_min, x_max, y_min,
    y_max), bounds included."""
    x_min, x_max, y_min, y_max = (b[..., None, None] for b in bounds.unbind(-1))
    corridor = ((xs[..., :, None] >= x_min) & (xs[..., :, None] <= x_max)
                & (ys[..., None, :] >= y_min) & (ys[..., None, :] <= y_max)).to(xs.dtype)
    return corridor, obstacle_layer_plain(xs, ys, verts, active)


@torch.library.custom_op(
    "cilqr_torch::costmap_layers", mutates_args=(), device_types="cpu",
    schema="(Tensor xs, Tensor ys, Tensor bounds, Tensor verts, Tensor active) "
           "-> (Tensor, Tensor)")
def _layers(xs, ys, bounds, verts, active):
    """The kernel as an op: on the CPU the plain version; on the card the
    kernel (``_layers_kernel``)."""
    return costmap_layers_plain(xs, ys, bounds, verts, active)


@_layers.register_fake
def _layers_fake(xs, ys, bounds, verts, active):
    shape = tuple(xs.shape[:-1]) + (xs.shape[-1], ys.shape[-1])
    return xs.new_empty(shape), xs.new_empty(shape)


@_layers.register_kernel("cuda")
def _layers_kernel(xs, ys, bounds, verts, active):
    """The op on the card: one launch of ``costmap_layers_kernel<vec>`` on the
    current stream, its 16-byte form where the width is a multiple of 4 (both
    maps are new allocations, aligned far beyond 16 bytes)."""
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    lead, rows, cols, M = tuple(xs.shape[:-1]), xs.shape[-1], ys.shape[-1], verts.shape[-3]
    xs, ys, bounds, verts, active = (t.contiguous() for t in (xs, ys, bounds, verts, active))
    corridor = torch.empty(lead + (rows, cols), dtype=torch.float32, device=xs.device)
    bbox = torch.empty_like(corridor)
    vec = cols % 4 == 0
    lib = build.load_library()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_costmap_layers(
            math.prod(lead), rows, cols, M, int(vec), xs.data_ptr(), ys.data_ptr(),
            bounds.data_ptr(), verts.data_ptr(), active.data_ptr(), corridor.data_ptr(),
            bbox.data_ptr(), stream)
    build.check(lib, rc, "costmap layers kernel launch")
    LAUNCHES += 1
    return corridor, bbox


def _op(xs, ys, bounds, verts, active):
    return torch.ops.cilqr_torch.costmap_layers(xs, ys, bounds, verts, active)


def _launch(xs, ys, bounds, verts, active):
    """The kernel on CUDA tensors, checked, then through its op (inside
    ``route.plain()`` its plain version)."""
    if route.plain_on_card():
        return costmap_layers_plain(xs, ys, bounds, verts, active)
    from cilqr_tpu_torch.ops import riccati_cuda

    lead, rows, cols, M = tuple(xs.shape[:-1]), xs.shape[-1], ys.shape[-1], verts.shape[-3]
    if math.prod(lead) < 1:
        raise ValueError("empty batch")
    if M > MAX_OBSTACLES:
        raise ValueError(f"{M} obstacles: the kernel takes at most {MAX_OBSTACLES}")
    riccati_cuda.check_cuda_f32("cell centres xs", xs, lead + (rows,))
    riccati_cuda.check_cuda_f32("cell centres ys", ys, lead + (cols,))
    riccati_cuda.check_cuda_f32("corridor bounds", bounds, lead + (4,))
    riccati_cuda.check_cuda_f32("obstacle corners", verts, lead + (M, 4, 2))
    if active.dtype != torch.bool or tuple(active.shape) != lead + (M,):
        raise ValueError(f"active: expected a bool tensor of shape {lead + (M,)}, got "
                         f"{active.dtype} {tuple(active.shape)}")
    return _op(xs, ys, bounds, verts, active)


def costmap_layers(xs: torch.Tensor, ys: torch.Tensor, bounds: torch.Tensor,
                   verts: torch.Tensor, active: torch.Tensor):
    """(corridor mask, bounding-box layer), each (..., rows, cols), of cell
    centres xs (..., rows) and ys (..., cols), corridor bounds (..., 4),
    obstacle corners verts (..., M, 4, 2) and their flags active (..., M),
    all with the same leading dims.  The kernel for CUDA tensors (at most
    ``MAX_OBSTACLES`` obstacles), the plain version for CPU tensors."""
    if xs.device.type == "cpu":
        return _op(xs, ys, bounds, verts, active)
    return _launch(xs, ys, bounds, verts, active)
