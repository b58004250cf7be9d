"""Batched backward Riccati recursion + closed-loop rollout: CUDA kernel K2.

Port of ``cilqr_tpu/ops/riccati_pallas.py`` (``_kernel`` + ``_fwd_kernel``).
The kernel (``csrc/riccati.cu``) runs one lane per scenario over the whole
horizon and reads and writes the tensors as PyTorch holds them (batch-major),
so a call is one kernel and no layout copy; ``backward_forward_batched``
chains the rollout after the recursion, ``backward_batched`` stops after it.

For a tensor on the CPU both take the plain PyTorch version
(``backward_forward_plain`` / ``backward_plain``: the port's
``solver.backward_seq`` + ``forward_pass`` on a leading batch dimension, in
any float dtype; sequential whatever ``p.backward_impl`` says, as the
kernel is).  For a CUDA tensor they launch the kernel
(float32 only) or raise.

The kernel is launched only by the op ``cilqr_torch::riccati`` (``_op``:
tensors in, new tensors out; its CPU implementation is the plain version),
which ``_launch`` calls: a stream planner (``utils/graphs.StreamPlanner``)
sees the launch as one op reading its inputs and writing its outputs, and a
CUDA graph of the two-phase LM loop holds it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import sys

import torch

from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import SolverParams
from cilqr_tpu_torch.models import solver
from cilqr_tpu_torch.models.costs import CostDerivs

LAUNCHES = 0  # kernel launches made by this module's wrappers
graphs.COUNTERS.append((sys.modules[__name__], "LAUNCHES"))


class _RiccatiConfig(ctypes.Structure):
    """Mirror of ``RiccatiConfig`` in csrc/riccati.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "N", "do_forward")] + [
        (n, ctypes.c_float)
        for n in ("dt", "acc_min", "acc_max", "tan_lo", "tan_hi", "speed_max")
    ]


def backward_plain(p: SolverParams, d: CostDerivs, X, U, lamb):
    """Plain version of the backward-only kernel -> (k (B,N,2), K (B,N,2,4))."""
    return solver.backward_seq(p, d, X, U, lamb)


def backward_forward_plain(p: SolverParams, d: CostDerivs, X, U, lamb):
    """Plain version of the backward + rollout kernel -> (X_new, U_new)."""
    k, K = solver.backward_seq(p, d, X, U, lamb)
    return solver.forward_pass(p, X, U, k, K)


def to_scenario_minor(x: torch.Tensor) -> torch.Tensor:
    """(B, steps, ...) -> contiguous (steps, C, B): the kernels' layout."""
    B, steps = x.shape[:2]
    return x.reshape(B, steps, -1).permute(1, 2, 0).contiguous()


def from_scenario_minor(y: torch.Tensor, trailing: tuple) -> torch.Tensor:
    """(steps, C, B) -> (B, steps, *trailing)."""
    steps, _, B = y.shape
    return y.permute(2, 0, 1).reshape((B, steps) + trailing)


def check_cuda_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    """Raise unless t is a float32 CUDA tensor of the given shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def dyn_constants(p: SolverParams) -> dict:
    """Model.cpp:17-30 step constants shared by both kernels' configs."""
    return dict(
        dt=p.timestep, acc_min=p.acc_min, acc_max=p.acc_max,
        tan_lo=math.tan(p.steer_angle_min) / p.wheelbase,
        tan_hi=math.tan(p.steer_angle_max) / p.wheelbase,
        speed_max=p.speed_max,
    )


SCENARIOS_PER_WARP = 16  # T of csrc/riccati.cu: the scratch's innermost extent


def _kernel_input(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """t as the kernel reads it: checked, contiguous and 16-byte aligned
    (copied only if it is not)."""
    check_cuda_f32(name, t, shape)
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=64)
def params_arg(p: SolverParams) -> str:
    """p as the ops' ``params`` argument: its fields as JSON (floats written
    by ``repr``, so they read back exactly)."""
    return json.dumps(dataclasses.asdict(p), sort_keys=True)


@functools.lru_cache(maxsize=64)
def params_of(arg: str) -> SolverParams:
    """The SolverParams of an op's ``params`` argument."""
    return SolverParams(**json.loads(arg))


@torch.library.custom_op(
    "cilqr_torch::riccati", mutates_args=(), device_types="cpu",
    schema="(str params, Tensor l_x, Tensor l_xx, Tensor l_u, Tensor l_uu, Tensor X, "
           "Tensor U, Tensor lamb, bool do_forward) -> (Tensor, Tensor)")
def _riccati(params, l_x, l_xx, l_u, l_uu, X, U, lamb, do_forward):
    """K2 as an op: (X_new, U_new) with ``do_forward``, else (k, K).  On
    the CPU the plain version; on the card the kernel (``_riccati_kernel``)."""
    d = CostDerivs(l_x, l_xx, l_u, l_uu, None)
    plain = backward_forward_plain if do_forward else backward_plain
    return plain(params_of(params), d, X, U, lamb)


@_riccati.register_kernel("cuda")
def _riccati_kernel(params, l_x, l_xx, l_u, l_uu, X, U, lamb, do_forward):
    """The op on the card: one launch on batch-major tensors, on the current
    stream."""
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    p = params_of(params)
    N = p.horizon
    B = X.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    lx, lxx, lu, luu, Xc, Uc, lamb_c = (_kernel_input(name, t, shape_) for name, t, shape_ in (
        ("l_x", l_x, (B, N, 4)), ("l_xx", l_xx, (B, N, 4, 4)),
        ("l_u", l_u, (B, N, 2)), ("l_uu", l_uu, (B, N, 2, 2)),
        ("X", X, (B, N + 1, 4)), ("U", U, (B, N, 2)), ("lamb", lamb, (B,)),
    ))

    lib = build.load_library()
    if lib.cilqr_riccati_config_size() != ctypes.sizeof(_RiccatiConfig):
        raise RuntimeError("RiccatiConfig layout differs between Python and CUDA")
    f32 = dict(dtype=torch.float32, device=X.device)
    k = K = Xn = Un = scratch = None
    if do_forward:
        Xn, Un = torch.empty((B, N + 1, 4), **f32), torch.empty((B, N, 2), **f32)
        # k and K between the passes: [warp][step][component][T]
        T = SCENARIOS_PER_WARP
        scratch = torch.empty((-(-B // T), N, 10, T), **f32)
    else:
        k, K = torch.empty((B, N, 2), **f32), torch.empty((B, N, 2, 4), **f32)
    cfg = _RiccatiConfig(B=B, N=N, do_forward=int(do_forward), **dyn_constants(p))
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_riccati(
            ctypes.byref(cfg), lx.data_ptr(), lxx.data_ptr(), lu.data_ptr(), luu.data_ptr(),
            lamb_c.data_ptr(), Xc.data_ptr(), Uc.data_ptr(), ptr(k), ptr(K), ptr(Xn), ptr(Un),
            ptr(scratch), stream)
    build.check(lib, rc, "riccati kernel launch")
    LAUNCHES += 1
    return (Xn, Un) if do_forward else (k, K)


def _launch(p: SolverParams, d: CostDerivs, X, U, lamb, do_forward: bool):
    """K2 on batch-major CUDA tensors, through its op."""
    return torch.ops.cilqr_torch.riccati(params_arg(p), d.l_x, d.l_xx, d.l_u, d.l_uu, X, U,
                                         lamb, do_forward)


def backward_batched(p: SolverParams, d: CostDerivs, X, U, lamb):
    """Backward recursion -> (k (B, N, 2), K (B, N, 2, 4))."""
    if X.device.type == "cpu":
        return backward_plain(p, d, X, U, lamb)
    return _launch(p, d, X, U, lamb, do_forward=False)


def backward_forward_batched(p: SolverParams, d: CostDerivs, X, U, lamb):
    """Backward recursion, then the closed-loop rollout on its gains ->
    (X_new (B, N+1, 4), U_new (B, N, 2))."""
    if X.device.type == "cpu":
        return backward_forward_plain(p, d, X, U, lamb)
    return _launch(p, d, X, U, lamb, do_forward=True)


graphs.LAUNCHERS.append((sys.modules[__name__], "_launch", _launch))
