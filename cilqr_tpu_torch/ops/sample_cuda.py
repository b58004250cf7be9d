"""Batched prior-map resample: CUDA kernel K5.

Port of ``cilqr_tpu/ops/sample_pallas.py``.  Its two TPU kernels (the shear
decomposition ``_kernel_shear`` and the per-tile window gather ``_kernel`` /
``_kernel_fused``) compute one function, the batched ``costmap.sample_prior``:
a nearest-cell lookup of one shared global map at every cell of B rotated
vehicle frames.  Here one CUDA kernel (``csrc/sample.cu``) computes it, a
block per frame and a run of four cells of a row per thread; the
shear/window split, the eligibility gates (``supports``,
``supports_shear``) and the static resolutions they need have no
counterpart.  The same kernel also applies the costmap build's overrides
(``vehicle_map_batched``), so the build never holds the prior frame.

``sample_prior_batched`` and ``vehicle_map_batched`` launch the kernel for
CUDA tensors (float32) and take their plain versions
(``sample_prior_batched_plain`` = the batched ``costmap.sample_prior``;
``vehicle_map_batched_plain``, any float dtype) for CPU tensors, both
through the op ``cilqr_torch::sample`` (``_sample``: tensors in, a new
tensor out; its CPU implementation is the plain version), so a stream
planner and a CUDA graph see the launch as one op.  The result is a pure
gather and selects: kernel and plain version agree on every cell.
"""

from __future__ import annotations

import sys

import torch

from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.ops import gridmap, riccati_cuda, route
from cilqr_tpu_torch.utils import graphs

LAUNCHES = 0  # kernel launches made by this module's wrappers
graphs.COUNTERS.append((sys.modules[__name__], "LAUNCHES"))


def sample_prior_batched_plain(geoms: gridmap.GridGeom, rows: int, cols: int,
                               global_map: torch.Tensor, global_geom: gridmap.GridGeom,
                               ego_xys: torch.Tensor, ego_yaws: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``costmap.sample_prior`` over the leading
    scenario axis of geoms, ego_xys (B, 2) and ego_yaws (B,)."""
    return costmap_mod.sample_prior(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws)


def vehicle_map_batched_plain(geoms: gridmap.GridGeom, rows: int, cols: int,
                              global_map: torch.Tensor, global_geom: gridmap.GridGeom,
                              ego_xys: torch.Tensor, ego_yaws: torch.Tensor, bbox: torch.Tensor,
                              semantic: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel with the overrides: the prior, then bbox
    where bbox > 90 (local_costmap.cpp:260-263), then the semantic layer
    where it is > 90, as ``costmap.build_local_costmap_batched`` applies
    them.  bbox and semantic (B, rows, cols)."""
    prior = sample_prior_batched_plain(geoms, rows, cols, global_map, global_geom, ego_xys,
                                       ego_yaws)
    vehicle_map = torch.where(bbox > 90.0, bbox, prior.to(bbox.dtype))
    if semantic is not None:
        vehicle_map = torch.where(semantic > 90.0, semantic, vehicle_map)
    return vehicle_map


@torch.library.custom_op(
    "cilqr_torch::sample", mutates_args=(), device_types="cpu",
    schema="(Tensor[] geoms, int rows, int cols, Tensor global_map, Tensor[] global_geom, "
           "Tensor ego_xys, Tensor ego_yaws, Tensor? bbox, Tensor? semantic) -> Tensor")
def _sample(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox, semantic):
    """K5 as an op: the resample, with the overrides where ``bbox`` is
    given; ``geoms`` and ``global_geom`` are the fields of the geometries.
    On the CPU the plain version; on the card the kernel
    (``_sample_kernel``)."""
    geoms, global_geom = gridmap.GridGeom(*geoms), gridmap.GridGeom(*global_geom)
    if bbox is None:
        return sample_prior_batched_plain(geoms, rows, cols, global_map, global_geom, ego_xys,
                                          ego_yaws)
    return vehicle_map_batched_plain(geoms, rows, cols, global_map, global_geom, ego_xys,
                                     ego_yaws, bbox, semantic)


@_sample.register_fake
def _sample_fake(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox, semantic):
    dtype = global_map.dtype if bbox is None else bbox.dtype
    return global_map.new_empty((ego_xys.shape[0], rows, cols), dtype=dtype)


@_sample.register_kernel("cuda")
def _sample_kernel(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox,
                   semantic):
    """The op on the card: one launch of ``sample_kernel<vec>`` on the
    current stream, its 16-byte form where the width is a multiple of 4
    and the output and override frames are 16-byte aligned (in a CUDA
    graph: as they lie in the capture)."""
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    geoms, global_geom = gridmap.GridGeom(*geoms), gridmap.GridGeom(*global_geom)
    B = ego_xys.shape[0]
    H, W = global_map.shape
    frames = {name: t.contiguous() for name, t in (("bbox", bbox), ("semantic", semantic))
              if t is not None}
    # first, cos and sin come from PyTorch, with the operations of
    # gridmap.cell_positions / costmap.sample_prior, so the kernel starts
    # from the plain version's own values; the rest is read as it lies
    first = gridmap.first_position(geoms).contiguous()
    res = geoms.resolution.expand(B)
    if ego_xys.stride(1) != 1:
        ego_xys = ego_xys.contiguous()
    cs, sn = torch.cos(ego_yaws), torch.sin(ego_yaws)
    global_map = global_map.contiguous()
    gcenter, glength = global_geom.center.contiguous(), global_geom.length.contiguous()
    out = torch.empty((B, rows, cols), dtype=torch.float32, device=global_map.device)
    bbox_t, sem_t = frames.get("bbox"), frames.get("semantic")
    vec = cols % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (out, *frames.values()))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = build.load_library()
    stream = torch.cuda.current_stream(global_map.device).cuda_stream
    with torch.cuda.device(global_map.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_sample_prior(
            B, rows, cols, H, W, int(vec), global_map.data_ptr(), gcenter.data_ptr(),
            glength.data_ptr(), global_geom.resolution.data_ptr(), first.data_ptr(), res.data_ptr(),
            res.stride(0), ego_xys.data_ptr(), ego_xys.stride(0), cs.data_ptr(), sn.data_ptr(),
            ptr(bbox_t), ptr(sem_t), out.data_ptr(), stream)
    build.check(lib, rc, "prior resample kernel launch")
    LAUNCHES += 1
    return out


def _op(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox, semantic):
    return torch.ops.cilqr_torch.sample(list(geoms), rows, cols, global_map, list(global_geom),
                                        ego_xys, ego_yaws, bbox, semantic)


def _kernel_call(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox, semantic):
    """K5 on CUDA tensors, checked, then through its op."""
    B = ego_xys.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    H, W = global_map.shape
    riccati_cuda.check_cuda_f32("global map", global_map, (H, W))
    riccati_cuda.check_cuda_f32("ego_xys", ego_xys, (B, 2))
    riccati_cuda.check_cuda_f32("ego_yaws", ego_yaws, (B,))
    riccati_cuda.check_cuda_f32("geometry centers", geoms.center, (B, 2))
    for name, t in (("global center", global_geom.center), ("global length", global_geom.length)):
        riccati_cuda.check_cuda_f32(name, t, (2,))
    riccati_cuda.check_cuda_f32("global resolution", global_geom.resolution.reshape(()), ())
    riccati_cuda.check_cuda_f32("frame resolution", geoms.resolution.expand(B), (B,))
    for name, t in (("bbox", bbox), ("semantic", semantic)):
        if t is not None:
            riccati_cuda.check_cuda_f32(name, t, (B, rows, cols))
    return _op(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox, semantic)


def _launch(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws):
    """K5's resample (inside ``route.plain()`` its plain version)."""
    if route.plain_on_card():
        return sample_prior_batched_plain(geoms, rows, cols, global_map, global_geom, ego_xys,
                                          ego_yaws)
    return _kernel_call(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, None, None)


def _launch_vehicle_map(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox,
                        semantic=None):
    """K5 with the overrides (inside ``route.plain()`` its plain version)."""
    if route.plain_on_card():
        return vehicle_map_batched_plain(geoms, rows, cols, global_map, global_geom, ego_xys,
                                         ego_yaws, bbox, semantic)
    return _kernel_call(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox,
                        semantic)


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
        return _op(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, None, None)
    return _launch(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws)


def vehicle_map_batched(geoms: gridmap.GridGeom, rows: int, cols: int, global_map: torch.Tensor,
                        global_geom: gridmap.GridGeom, ego_xys: torch.Tensor,
                        ego_yaws: torch.Tensor, bbox: torch.Tensor,
                        semantic: torch.Tensor | None = None) -> torch.Tensor:
    """(B, rows, cols) vehicle maps of the batched costmap build: the
    resample of ``sample_prior_batched``, overridden by ``bbox`` where it is
    > 90 and then by ``semantic`` (optional) where it is > 90, in one pass
    (a NaN keeps the value below it).  The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if global_map.device.type == "cpu":
        return _op(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws, bbox, semantic)
    return _launch_vehicle_map(geoms, rows, cols, global_map, global_geom, ego_xys, ego_yaws,
                               bbox, semantic)
