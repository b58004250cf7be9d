"""The two-phase LM step's cost derivatives and J: one CUDA kernel.

``solver_batched``'s two-phase iteration needs, at each LM step, l_x, l_xx,
l_u, l_uu and the acceptance cost J of ``costs.all_cost_derivs_and_J`` at
the trajectory (X, U), before the Riccati kernel K2 runs the backward pass
and the rollout on them.  In plain PyTorch that is ~250 kernels per step at
CCNMPC's shapes (the closest-point search writes a (B, N, S) distance
tensor, the obstacle barriers (B, M, N, 2, 2) outer products).  The kernel
(``csrc/cost.cu`` ``cost_derivs_kernel``) computes them in one pass, one
thread per (lane, step), and writes them batch-major, as K2 reads them; l_ux
is identically zero and is not formed.

It reads the plans as K3 does, through ``lm_cuda.prep_iteration`` (the
scenario-minor sample table and the fit payload, which the caller prepares
once per solve), and the obstacles shared ((M, N, .)) or per lane
((B, M, N, .)), each through its strides: a stride-0 broadcast is read at
its shared shape.  The uncertainty term comes from external planes (B, N, 3)
= [e, gx, gy], sampled outside the kernel, as K3 takes them.

``cost_derivs`` launches the kernel on float32 CUDA tensors through the op
``cilqr_torch::cost_derivs``, so a stream planner and a CUDA graph see the
launch as one op; the op's CPU implementation is the plain version,
``costs.all_cost_derivs_and_J``.  The caller (``solver_batched._two_phase``)
chooses between the two.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from cilqr_tpu_torch.models import costs
from cilqr_tpu_torch.models.costs import CostDerivs
from cilqr_tpu_torch.models.obstacles import Obstacles
from cilqr_tpu_torch.models.reference_path import LocalPlan
from cilqr_tpu_torch.ops import riccati_cuda, route
from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import SolverParams

LAUNCHES = 0  # kernel launches made by this module's wrappers
graphs.COUNTERS.append((sys.modules[__name__], "LAUNCHES"))

LANES = 8          # lanes per block (csrc/cost.cu kMaxLanes): a lane's table serves its steps
MAX_THREADS = 512  # lanes x steps per block (kMaxThreads)


class _CostConfig(ctypes.Structure):
    """Mirror of ``CostConfig`` in csrc/cost.cu."""

    _fields_ = [("dims_stride", ctypes.c_longlong * 4), ("pos_stride", ctypes.c_longlong * 4),
                ("mask_stride", ctypes.c_longlong * 2)] + [
        (n, ctypes.c_int) for n in ("B", "N", "S", "M", "ncoef", "has_obs", "has_ext", "lanes")
    ] + [(n, ctypes.c_float) for n in (
        "dt", "acc_min", "acc_max", "tan_lo", "tan_hi", "speed_max",
        "two_wpos", "two_wvel", "wpos", "wvel", "wacc", "wyr", "two_wacc", "two_wyr", "vdes",
        "q1a", "q2a", "q2a_sq", "q1y", "q2y", "q2y_sq",
        "t_safe", "s_safe_a", "s_safe_b", "ego_rad", "efront", "erear", "w_obs",
        "q1f", "q2f", "q2f_sq", "q1r", "q2r", "q2r_sq",
        "s1u", "s2u",
    )]


def lanes_per_block(N: int) -> int:
    """Lanes of a block at horizon N: up to ``LANES``, at most
    ``MAX_THREADS`` threads.  Raises if one lane's steps do not fit."""
    if N > MAX_THREADS:
        raise ValueError(f"horizon {N}: the kernel takes at most {MAX_THREADS} steps")
    return min(LANES, MAX_THREADS // N)


def _config(p: SolverParams, B: int, S: int, strides: tuple, M: int, has_obs: bool,
            has_ext: bool) -> _CostConfig:
    """Kernel constants; products of parameters are formed in double and
    rounded once, as the plain version's Python-float constants are."""
    dims_s, pos_s, mask_s = strides
    return _CostConfig(
        (ctypes.c_longlong * 4)(*dims_s), (ctypes.c_longlong * 4)(*pos_s),
        (ctypes.c_longlong * 2)(*mask_s),
        B=B, N=p.horizon, S=S, M=M, ncoef=p.poly_order + 1, has_obs=int(has_obs),
        has_ext=int(has_ext), lanes=lanes_per_block(p.horizon),
        **riccati_cuda.dyn_constants(p),
        two_wpos=2.0 * p.w_pos, two_wvel=2.0 * p.w_vel, wpos=p.w_pos, wvel=p.w_vel,
        wacc=p.w_acc, wyr=p.w_yawrate, two_wacc=2.0 * p.w_acc, two_wyr=2.0 * p.w_yawrate,
        vdes=p.desired_speed,
        q1a=p.q1_acc, q2a=p.q2_acc, q2a_sq=p.q2_acc * p.q2_acc,
        q1y=p.q1_yawrate, q2y=p.q2_yawrate, q2y_sq=p.q2_yawrate * p.q2_yawrate,
        t_safe=p.t_safe, s_safe_a=p.s_safe_a, s_safe_b=p.s_safe_b, ego_rad=p.ego_rad,
        efront=p.ego_front, erear=p.ego_rear, w_obs=p.w_obstacle,
        q1f=p.q1_front, q2f=p.q2_front, q2f_sq=p.q2_front * p.q2_front,
        q1r=p.q1_rear, q2r=p.q2_rear, q2r_sq=p.q2_rear * p.q2_rear,
        s1u=p.w_uncertainty * p.q2_uncertainty,
        s2u=p.w_uncertainty * p.q2_uncertainty * p.q2_uncertainty,
    )


def _load(build):
    lib = build.load_library()
    if lib.cilqr_cost_config_size() != ctypes.sizeof(_CostConfig):
        raise RuntimeError("CostConfig layout differs between Python and CUDA")
    return lib


def kernel_resources(N: int, S: int) -> dict:
    """What the compiler and the current card give the kernel at horizon N
    with S table samples: registers and local-memory bytes per thread,
    shared memory per block, resident blocks per SM."""
    return _resources(lanes_per_block(N), N, S, torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _resources(lanes: int, N: int, S: int, device_index: int) -> dict:
    from cilqr_tpu_torch.utils import build

    lib = _load(build)
    out = (ctypes.c_int * 4)()
    build.check(lib, lib.cilqr_cost_resources(lanes, N, S, out), "cost kernel resources")
    return dict(lanes=lanes, registers=out[0], local_bytes=out[1], shared_bytes=out[2],
                blocks_per_sm=out[3])


@torch.library.custom_op(
    "cilqr_torch::cost_derivs", mutates_args=(), device_types="cpu",
    schema="(str params, Tensor X, Tensor U, Tensor fit, Tensor table, Tensor[] plans, "
           "Tensor[] obstacles, Tensor? planes) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _cost_derivs(params, X, U, fit, table, plans, obstacles, planes):
    """The kernel as an op -> (l_x, l_xx, l_u, l_uu, J).  On the CPU the
    plain version, ``costs.all_cost_derivs_and_J`` with the uncertainty
    sample from ``planes``, which reads the plans and obstacles (their fields
    in order; no obstacles: empty) where the kernel reads the plans' payload
    (``fit``, ``table``); on the card the kernel (``_cost_derivs_kernel``)."""
    d, J = costs.all_cost_derivs_and_J(riccati_cuda.params_of(params), LocalPlan(*plans), X, U,
                                       Obstacles(*obstacles) if obstacles else None, None,
                                       unc_planes=planes)
    # the tracking Hessian is a broadcast of one (4, 4) matrix without a
    # world term: an op returns storage of its own per output
    return d.l_x, d.l_xx.contiguous(), d.l_u, d.l_uu, J


@_cost_derivs.register_fake
def _cost_derivs_fake(params, X, U, fit, table, plans, obstacles, planes):
    B, N = U.shape[0], U.shape[1]
    return (X.new_empty((B, N, 4)), X.new_empty((B, N, 4, 4)), X.new_empty((B, N, 2)),
            X.new_empty((B, N, 2, 2)), X.new_empty((B,)))


def _per_lane(t: torch.Tensor, B: int, shared_ndim: int) -> torch.Tensor:
    """An obstacle tensor with the leading B axis, a stride-0 broadcast of
    it when it is shared (no copy)."""
    return t.expand((B,) + tuple(t.shape)) if t.ndim == shared_ndim else t


@_cost_derivs.register_kernel("cuda")
def _cost_derivs_kernel(params, X, U, fit, table, plans, obstacles, planes):
    """The op on the card: one launch of ``cost_derivs_kernel`` on the
    current stream; the obstacles read through their strides as given."""
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    p = riccati_cuda.params_of(params)
    N = p.horizon
    B, S = X.shape[0], table.shape[0]
    lib = _load(build)
    X, U, fit, table = (t.contiguous() for t in (X, U, fit, table))
    has_obs = bool(obstacles) and obstacles[0].shape[-3] > 0
    if has_obs:
        dims, pos, mask = (_per_lane(t, B, n) for t, n in zip(obstacles, (3, 3, 1)))
        strides = (dims.stride(), pos.stride(), mask.stride())
        M = dims.shape[1]
    else:
        dims = pos = mask = None
        strides, M = ((0,) * 4, (0,) * 4, (0,) * 2), 0
    ext = None if planes is None else planes.contiguous()
    f32 = dict(dtype=torch.float32, device=X.device)
    outs = [torch.empty((B, N, 4), **f32), torch.empty((B, N, 4, 4), **f32),
            torch.empty((B, N, 2), **f32), torch.empty((B, N, 2, 2), **f32),
            torch.empty((B,), **f32)]
    cfg = _config(p, B, S, strides, M, has_obs, ext is not None)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_cost_derivs(ctypes.byref(cfg), X.data_ptr(), U.data_ptr(), fit.data_ptr(),
                                   table.data_ptr(), ptr(dims), ptr(pos), ptr(mask), ptr(ext),
                                   *(t.data_ptr() for t in outs), stream)
    build.check(lib, rc, "cost derivatives kernel launch")
    LAUNCHES += 1
    return tuple(outs)


def _launch(p: SolverParams, plans, X, U, obstacles, planes, prepared):
    """The kernel on CUDA tensors, checked, then through its op (inside
    ``route.plain()`` its plain version)."""
    if route.plain_on_card():
        return costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, None, unc_planes=planes)
    N, S = p.horizon, p.n_closest_samples
    B = X.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    lanes_per_block(N)
    table, fit = prepared
    for name, t, shape_ in (("X", X, (B, N + 1, 4)), ("U", U, (B, N, 2)),
                            ("sample table", table, (S, 2, B)),
                            ("fit payload", fit, (p.poly_order + 11, B))):
        riccati_cuda.check_cuda_f32(name, t, shape_)
    if planes is not None:
        riccati_cuda.check_cuda_f32("uncertainty planes", planes, (B, N, 3))
    if obstacles is not None:
        M = obstacles.dims.shape[-3]
        for name, t, tail in (("obstacle dims", obstacles.dims, 2),
                              ("obstacle poses", obstacles.pos, 4)):
            lead = tuple(t.shape[:-3])
            if lead not in ((), (B,)) or t.shape[-3] != M or t.shape[-2] < N or t.shape[-1] != tail:
                raise ValueError(f"{name}: expected (M, >={N}, {tail}) or (B, M, >={N}, {tail}), "
                                 f"got {tuple(t.shape)}")
            riccati_cuda.check_cuda_f32(name, t, tuple(t.shape))
        riccati_cuda.check_cuda_f32("obstacle mask", obstacles.mask,
                                    (M,) if obstacles.mask.ndim == 1 else (B, M))
    l_x, l_xx, l_u, l_uu, J = torch.ops.cilqr_torch.cost_derivs(
        riccati_cuda.params_arg(p), X, U, fit, table, list(plans),
        [] if obstacles is None else list(obstacles), planes)
    return CostDerivs(l_x, l_xx, l_u, l_uu, None), J


def cost_derivs(p: SolverParams, plans, X: torch.Tensor, U: torch.Tensor, obstacles, planes,
                prepared):
    """(CostDerivs, J) of ``costs.all_cost_derivs_and_J`` at X (B, N+1, 4),
    U (B, N, 2) on batched ``plans``, the obstacles shared or per lane (or
    None) and the uncertainty sample from ``planes`` (B, N, 3) = [e, gx, gy]
    (or None), by the kernel: float32 CUDA tensors.  ``prepared``: (table,
    fit) of ``lm_cuda.prep_iteration(plans)``.  The derivatives' l_ux is
    None (identically zero; K2 does not read it)."""
    return _launch(p, plans, X, U, obstacles, planes, prepared)
