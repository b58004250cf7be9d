"""Batched prior-map resample: CUDA kernel K5.

Port of ``cilqr_tpu/ops/sample_pallas.py``.  Its two TPU kernels (the shear
decomposition ``_kernel_shear`` and the per-tile window gather ``_kernel`` /
``_kernel_fused``) compute one function, the batched ``costmap.sample_prior``:
a nearest-cell lookup of one shared global map at every cell of B rotated
vehicle frames.  Here one CUDA kernel (``csrc/sample.cu``) computes it, one
thread per output cell; the shear/window split, the eligibility gates
(``supports``, ``supports_shear``) and the static resolutions they need have
no counterpart.

``sample_prior_batched`` launches the kernel for CUDA tensors (float32) and
takes the plain version (``sample_prior_batched_plain`` = the batched
``costmap.sample_prior``, any float dtype) for CPU tensors.  The result is
a pure gather: kernel and plain version agree on every cell.
"""

from __future__ import annotations

import torch

from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.ops import gridmap, riccati_cuda

LAUNCHES = 0  # kernel launches made by this module's wrapper


def sample_prior_batched_plain(geoms: gridmap.GridGeom, rows: int, cols: int,
                               global_map: torch.Tensor, global_geom: gridmap.GridGeom,
                               ego_xys: torch.Tensor, ego_yaws: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``costmap.sample_prior`` over the leading
    scenario axis of geoms, ego_xys (B, 2) and ego_yaws (B,)."""
    return costmap_mod.sample_prior(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws)


def _launch(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws):
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    B = ego_xys.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    H, W = global_map.shape
    riccati_cuda.check_cuda_f32("global map", global_map, (H, W))
    riccati_cuda.check_cuda_f32("ego_xys", ego_xys, (B, 2))
    riccati_cuda.check_cuda_f32("ego_yaws", ego_yaws, (B,))
    riccati_cuda.check_cuda_f32("geometry centers", geoms.center, (B, 2))
    # first, top, cos and sin come from PyTorch, with the operations of
    # gridmap.cell_positions / costmap.sample_prior, so the kernel starts
    # from the plain version's own values
    first = gridmap.first_position(geoms)
    res = geoms.resolution.expand(B)
    zero = torch.zeros_like(ego_yaws)
    scl = torch.stack([first[:, 0], first[:, 1], res, ego_xys[:, 0], ego_xys[:, 1],
                       torch.cos(ego_yaws), torch.sin(ego_yaws), zero], dim=1).contiguous()
    top = global_geom.center + 0.5 * global_geom.length
    gscl = torch.stack([top[0], top[1], global_geom.resolution.reshape(()),
                        torch.zeros_like(top[0])]).contiguous()
    riccati_cuda.check_cuda_f32("scenario scalars", scl, (B, 8))
    riccati_cuda.check_cuda_f32("global geometry", gscl, (4,))
    global_map = global_map.contiguous()
    out = torch.empty((B, rows, cols), dtype=torch.float32, device=global_map.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(global_map.device).cuda_stream
    rc = lib.cilqr_sample_prior(B, rows, cols, H, W, global_map.data_ptr(), gscl.data_ptr(),
                                scl.data_ptr(), out.data_ptr(), stream)
    build.check(lib, rc, "prior resample kernel launch")
    LAUNCHES += 1
    return out


def sample_prior_batched(geoms: gridmap.GridGeom, rows: int, cols: int, global_map: torch.Tensor,
                         global_geom: gridmap.GridGeom, ego_xys: torch.Tensor,
                         ego_yaws: torch.Tensor) -> torch.Tensor:
    """(B, rows, cols) nearest-cell resample of one shared global map (H, W)
    at B vehicle frames (``sample_pallas.sample_prior_batched_tpu``).

    ``geoms`` carries leading-B leaves (center (B, 2); resolution (B,) or
    shared); ego_xys (B, 2), ego_yaws (B,).  Frames that leave the global
    map read its edge cells.  The kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if global_map.device.type == "cpu":
        return sample_prior_batched_plain(geoms, rows, cols, global_map, global_geom, ego_xys,
                                          ego_yaws)
    return _launch(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws)
