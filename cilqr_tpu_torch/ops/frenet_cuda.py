"""The Frenet lattice's candidate evaluation and selection: one CUDA kernel.

``models/frenet.plan_steps`` evaluates, per lane, every candidate of a
static lattice (K = n_lat * n_T * n_v) over the horizon's N+1 points: the
quintic and quartic, the reference line's interpolations, the feasibility
rules, the obstacle tests and, in propagation mode, the lane's own map;
then it takes the first feasible candidate of least cost.  In plain PyTorch
(``frenet.lattice_plain``) that is ~100 passes over (B, K, N+1) tensors.
The kernel (``csrc/frenet.cu`` ``frenet_lattice_kernel``) gives each lane a
block, walks the lattice's longitudinal profiles (one per duration and end
speed, shared by the end offsets) into shared memory and gives each
candidate a thread, which walks its points in registers; only the winner's
trajectory (B, N+1, 4), its index, its cost, whether any
candidate was feasible and the feasible count per lane leave it.

Its inputs, all (B, S) or smaller, stay in PyTorch (``plan_steps``): the
lane's start terms (B, 4) = [s0, d0, s_dot0, d_dot0], the reference line
(s, x, y, tx, ty), the lattice's axes (end offsets, durations, end
speeds; K = n_lat * n_T * n_v candidates, d major), the curvature bound (a
0-dim tensor), the obstacle slots' terms of ``frenet.obstacle_terms`` (or none)
and the uncertainty map (values, centre, resolution, length, origin xy,
origin yaw; one per lane or one shared; or none).

``lattice`` launches the kernel on float32 CUDA tensors through the op
``cilqr_torch::frenet_lattice``, so a stream planner and a CUDA graph see the
launch as one op; on CPU tensors the op's CPU implementation, the plain
version; inside ``route.plain()`` the plain version on the card.  The kernel
follows the plain version's roundings operation by operation; only the
map's mean over the points and unwrap's cumulative sum are summed in
another order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import sys

import numpy as np
import torch

from cilqr_tpu_torch.ops import riccati_cuda, route
from cilqr_tpu_torch.utils import graphs

LAUNCHES = 0  # kernel launches made by this module's wrappers
graphs.COUNTERS.append((sys.modules[__name__], "LAUNCHES"))

MAX_THREADS = 256  # csrc/frenet.cu kMaxThreads: a block's candidates at once
MAX_OBSTACLES = 64  # kMaxObstacles: the live slots' tracks are staged in shared memory
MAP_NONE, MAP_SHARED, MAP_LANE = 0, 1, 2


class _FrenetConfig(ctypes.Structure):
    """Mirror of ``FrenetConfig`` in csrc/frenet.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "N", "S", "M", "H", "W", "n_lat", "n_T", "n_v",
                                            "map", "threads")] + [
        (n, ctypes.c_float) for n in (
            "dt", "acc_hi", "acc_lo", "v_hi", "sd_lo", "tiny_dx", "efront", "erear",
            "k_j", "k_t", "k_d", "k_v", "k_lat", "k_lon", "vdes", "unc_threshold", "w_unc",
            "mean_factor")]


def threads_per_block(K: int) -> int:
    """K rounded up to whole warps, at most ``MAX_THREADS``."""
    return min(MAX_THREADS, -(-K // 32) * 32)


def frenet_arg(fp) -> str:
    """``FrenetParams`` as the op's ``frenet`` argument (JSON)."""
    return json.dumps(dataclasses.asdict(fp), sort_keys=True)


@functools.lru_cache(maxsize=64)
def frenet_of(arg: str):
    """The ``FrenetParams`` of an op's ``frenet`` argument."""
    from cilqr_tpu_torch.models import frenet

    return frenet.FrenetParams(**json.loads(arg))


def _config(p, fp, B: int, axes: tuple, S: int, M: int, map_shape,
            map_mode: int) -> _FrenetConfig:
    """Kernel constants: each rule's bound and each Python-float constant
    as the plain version's comparisons and products round them (formed in
    double, rounded once to float).  axes: (n_lat, n_T, n_v)."""
    N, K = p.horizon, math.prod(axes)
    H, W = map_shape
    f32 = np.float32
    return _FrenetConfig(
        B=B, N=N, S=S, M=M, H=H, W=W, n_lat=axes[0], n_T=axes[1], n_v=axes[2], map=map_mode,
        threads=threads_per_block(K),
        dt=p.timestep, acc_hi=p.acc_max + 1e-6, acc_lo=p.acc_min - 1e-6, v_hi=p.speed_max + 1e-6,
        sd_lo=-1e-6, tiny_dx=float(np.spacing(torch.finfo(torch.float32).eps)),
        efront=p.ego_front, erear=p.ego_rear, k_j=fp.k_j, k_t=fp.k_t, k_d=fp.k_d, k_v=fp.k_v,
        k_lat=fp.k_lat, k_lon=fp.k_lon, vdes=p.desired_speed, unc_threshold=fp.unc_threshold,
        w_unc=fp.w_unc,
        # PyTorch's mean on the card: the sum times float(B * K) / float(B * K * (N + 1))
        mean_factor=float(f32(B * K) / f32(B * K * (N + 1))))


def _load(build):
    lib = build.load_library()
    if lib.cilqr_frenet_config_size() != ctypes.sizeof(_FrenetConfig):
        raise RuntimeError("FrenetConfig layout differs between Python and CUDA")
    return lib


def kernel_resources(axes: tuple, S: int, N: int, M: int) -> dict:
    """What the compiler and the current card give the kernel with one map
    per lane on the lattice's axes (n_lat, n_T, n_v), S reference samples,
    horizon N and M obstacle slots: threads, registers and local-memory
    bytes per thread, shared memory per block, resident blocks per SM."""
    from cilqr_tpu_torch.utils import build

    lib = _load(build)
    threads = threads_per_block(math.prod(axes))
    out = (ctypes.c_int * 4)()
    build.check(lib, lib.cilqr_frenet_resources(MAP_LANE, threads, S, N, M, axes[1] * axes[2],
                                                out), "Frenet kernel resources")
    return dict(threads=threads, registers=out[0], local_bytes=out[1], shared_bytes=out[2],
                blocks_per_sm=out[3])


@torch.library.custom_op(
    "cilqr_torch::frenet_lattice", mutates_args=(), device_types="cpu",
    schema="(str params, str frenet, Tensor start, Tensor[] ref, Tensor[] axes, "
           "Tensor kappa_max, Tensor[] obstacles, Tensor[] unc_map) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _lattice(params, frenet, start, ref, axes, kappa_max, obstacles, unc_map):
    """The kernel as an op -> (X (B, N+1, 4) of the winner, its index
    (B,) int32, its cost (B,), any feasible (B,) bool, the feasible count
    (B,) int32).  On the CPU the plain version; on the card the kernel
    (``_lattice_kernel``)."""
    from cilqr_tpu_torch.models import frenet as frenet_mod

    return frenet_mod.lattice_plain(riccati_cuda.params_of(params), frenet_of(frenet), start, ref,
                                    axes, kappa_max, obstacles, unc_map)


@_lattice.register_fake
def _lattice_fake(params, frenet, start, ref, axes, kappa_max, obstacles, unc_map):
    B, N = start.shape[0], riccati_cuda.params_of(params).horizon
    return (start.new_empty((B, N + 1, 4)), start.new_empty((B,), dtype=torch.int32),
            start.new_empty((B,)), start.new_empty((B,), dtype=torch.bool),
            start.new_empty((B,), dtype=torch.int32))


def _lane_geometry(unc_map) -> torch.Tensor:
    """(L, 16) geometry rows of the map list [values, centre, resolution,
    length, origin xy, origin yaw], L = 1 for one shared map ((H, W)
    values), else one per lane: ``lm_cuda.prep_lane_maps``' rows, so the
    kernel's sampler starts from the plain sampler's bits."""
    from cilqr_tpu_torch.models.uncertainty import UncertaintyMap
    from cilqr_tpu_torch.ops import lm_cuda
    from cilqr_tpu_torch.ops.gridmap import GridGeom

    values, center, res, length, oxy, oyaw = unc_map
    if values.ndim == 2:
        values, center, res = values[None], center.reshape(1, 2), res.reshape(1)
        length, oxy, oyaw = length.reshape(1, 2), oxy.reshape(1, 2), oyaw.reshape(1)
    return lm_cuda.prep_lane_maps(UncertaintyMap(values, GridGeom(center, res, length), oxy,
                                                 oyaw))


@_lattice.register_kernel("cuda")
def _lattice_kernel(params, frenet, start, ref, axes, kappa_max, obstacles, unc_map):
    """The op on the card: one launch of ``frenet_lattice_kernel`` on the
    current stream, one block per lane."""
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    p, fp = riccati_cuda.params_of(params), frenet_of(frenet)
    B, N, S = start.shape[0], p.horizon, ref[0].shape[1]
    lib = _load(build)
    start, *ref = (t.contiguous() for t in (start, *ref))
    axes = [a.contiguous() for a in axes]
    M, obs, live = 0, None, None
    if obstacles:
        obs = torch.stack(obstacles[:6], dim=1).contiguous()  # (M, 6, N+1)
        live, M = obstacles[6].contiguous(), obs.shape[0]
    values = geo = None
    map_mode, map_shape = MAP_NONE, (0, 0)
    if unc_map:
        values = unc_map[0].contiguous()
        geo = _lane_geometry(unc_map)
        map_mode = MAP_SHARED if values.ndim == 2 else MAP_LANE
        map_shape = tuple(values.shape[-2:])
    dev = start.device
    X = torch.empty((B, N + 1, 4), dtype=torch.float32, device=dev)
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    J = torch.empty((B,), dtype=torch.float32, device=dev)
    any_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    cfg = _config(p, fp, B, tuple(a.shape[0] for a in axes), S, M, map_shape, map_mode)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the card of the tensors, whichever is current
        rc = lib.cilqr_frenet_lattice(
            ctypes.byref(cfg), start.data_ptr(), *(t.data_ptr() for t in ref),
            *(a.data_ptr() for a in axes), kappa_max.data_ptr(), ptr(obs), ptr(live),
            ptr(values), ptr(geo), X.data_ptr(), best.data_ptr(), J.data_ptr(),
            any_ok.data_ptr(), count.data_ptr(), stream)
    build.check(lib, rc, "Frenet lattice kernel launch")
    LAUNCHES += 1
    return X, best, J, any_ok, count


def _launch(p, fp, start, ref, axes, kappa_max, obstacles, unc_map):
    """The kernel on CUDA tensors, checked, then through its op (inside
    ``route.plain()`` its plain version)."""
    from cilqr_tpu_torch.models import frenet

    if route.plain_on_card():
        return frenet.lattice_plain(p, fp, start, ref, axes, kappa_max, obstacles, unc_map)
    B, N = start.shape[0], p.horizon
    if B < 1:
        raise ValueError("empty batch")
    riccati_cuda.check_cuda_f32("lane start terms", start, (B, 4))
    S = ref[0].shape[-1]
    for name, t in zip(("s", "x", "y", "tx", "ty"), ref):
        riccati_cuda.check_cuda_f32(f"reference line {name}", t, (B, S))
    for name, t in zip(("end offsets", "durations", "end speeds"), axes):
        riccati_cuda.check_cuda_f32(f"lattice axis of {name}", t, (t.numel(),))
    riccati_cuda.check_cuda_f32("curvature bound", kappa_max, ())
    if obstacles:
        M = obstacles[0].shape[0]
        if M > MAX_OBSTACLES:
            raise ValueError(f"{M} obstacle slots: the kernel takes at most {MAX_OBSTACLES}")
        for name, t in zip(("a", "b", "cos", "sin", "x", "y"), obstacles[:6]):
            riccati_cuda.check_cuda_f32(f"obstacle {name}", t, (M, N + 1))
        if obstacles[6].dtype != torch.bool or tuple(obstacles[6].shape) != (M,):
            raise ValueError(f"obstacle live flags: expected a bool tensor of shape {(M,)}, got "
                             f"{obstacles[6].dtype} {tuple(obstacles[6].shape)}")
    if unc_map:
        values, center, res, length, oxy, oyaw = unc_map
        L = 1 if values.ndim == 2 else B
        lead = () if values.ndim == 2 else (B,)
        riccati_cuda.check_cuda_f32("map values", values, lead + tuple(values.shape[-2:]))
        for name, t in (("map centre", center), ("map length", length), ("map origin", oxy)):
            riccati_cuda.check_cuda_f32(name, t, lead + (2,))
        for name, t in (("map resolution", res), ("map origin yaw", oyaw)):
            riccati_cuda.check_cuda_f32(name, t, tuple(t.shape))
            if t.numel() != L:
                raise ValueError(f"{name}: expected {L} values, got {tuple(t.shape)}")
    return _op(p, fp, start, ref, axes, kappa_max, obstacles, unc_map)


def _op(p, fp, start, ref, axes, kappa_max, obstacles, unc_map):
    return torch.ops.cilqr_torch.frenet_lattice(riccati_cuda.params_arg(p), frenet_arg(fp), start,
                                                list(ref), list(axes), kappa_max,
                                                list(obstacles), list(unc_map))


def lattice(p, fp, start: torch.Tensor, ref, axes, kappa_max: torch.Tensor, obstacles, unc_map):
    """(X (B, N+1, 4) of each lane's winner, its index (B,) int32, its cost
    (B,), whether any candidate was feasible (B,) bool, the feasible count
    (B,) int32) of ``frenet.lattice_plain`` (same arguments).  The kernel
    for CUDA tensors (float32, at most ``MAX_OBSTACLES`` slots), the plain
    version for CPU tensors."""
    if start.device.type == "cpu":
        return _op(p, fp, start, ref, axes, kappa_max, obstacles, unc_map)
    return _launch(p, fp, start, ref, axes, kappa_max, obstacles, unc_map)
