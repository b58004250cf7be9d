"""Batched backward Riccati recursion + closed-loop rollout: CUDA kernel K2.

Port of ``cilqr_tpu/ops/riccati_pallas.py`` (``_kernel`` + ``_fwd_kernel``).
The kernel (``csrc/riccati.cu``) runs one thread per scenario over the whole
horizon; ``backward_forward_batched`` chains the rollout after the
recursion, ``backward_batched`` stops after it.

For a tensor on the CPU both take the plain PyTorch version
(``backward_forward_plain`` / ``backward_plain``: the port's
``solver.backward_from_derivs`` + ``forward_pass`` on a leading batch
dimension, in any float dtype).  For a CUDA tensor they launch the kernel
(float32 only) or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.models import solver
from cilqr_tpu_torch.models.costs import CostDerivs

LAUNCHES = 0  # kernel launches made by this module's wrappers


class _RiccatiConfig(ctypes.Structure):
    """Mirror of ``RiccatiConfig`` in csrc/riccati.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "N", "do_forward")] + [
        (n, ctypes.c_float)
        for n in ("dt", "acc_min", "acc_max", "tan_lo", "tan_hi", "speed_max")
    ]


def backward_plain(p: SolverParams, d: CostDerivs, X, U, lamb):
    """Plain version of the backward-only kernel -> (k (B,N,2), K (B,N,2,4))."""
    return solver.backward_from_derivs(p, d, X, U, lamb)


def backward_forward_plain(p: SolverParams, d: CostDerivs, X, U, lamb):
    """Plain version of the backward + rollout kernel -> (X_new, U_new)."""
    k, K = solver.backward_from_derivs(p, d, X, U, lamb)
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


def _launch(p: SolverParams, d: CostDerivs, X, U, lamb, do_forward: bool):
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    N = p.horizon
    B = X.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    for name, t, shape in (
        ("l_x", d.l_x, (B, N, 4)), ("l_xx", d.l_xx, (B, N, 4, 4)),
        ("l_u", d.l_u, (B, N, 2)), ("l_uu", d.l_uu, (B, N, 2, 2)),
        ("X", X, (B, N + 1, 4)), ("U", U, (B, N, 2)), ("lamb", lamb, (B,)),
    ):
        check_cuda_f32(name, t, shape)

    lib = build.load_library()
    if lib.cilqr_riccati_config_size() != ctypes.sizeof(_RiccatiConfig):
        raise RuntimeError("RiccatiConfig layout differs between Python and CUDA")
    lx = to_scenario_minor(d.l_x)
    lxx = to_scenario_minor(d.l_xx)
    lu = to_scenario_minor(d.l_u)
    luu = to_scenario_minor(
        torch.stack([d.l_uu[..., 0, 0], d.l_uu[..., 0, 1], d.l_uu[..., 1, 1]], dim=-1))
    # Jacobian ingredients at the successor states (iLQR.cpp:102-106)
    vta = to_scenario_minor(torch.stack([X[:, 1:, 2], X[:, 1:, 3], U[:, :, 0]], dim=-1))
    lamb_c = lamb.contiguous()
    Xs = to_scenario_minor(X)
    Us = to_scenario_minor(U)
    f32 = dict(dtype=torch.float32, device=X.device)
    k = torch.empty((N, 2, B), **f32)
    K = torch.empty((N, 8, B), **f32)
    Xn = torch.empty((N + 1, 4, B), **f32) if do_forward else None
    Un = torch.empty((N, 2, B), **f32) if do_forward else None
    cfg = _RiccatiConfig(B=B, N=N, do_forward=int(do_forward), **dyn_constants(p))
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.cilqr_riccati(
        ctypes.byref(cfg), lx.data_ptr(), lxx.data_ptr(), lu.data_ptr(), luu.data_ptr(),
        vta.data_ptr(), lamb_c.data_ptr(), Xs.data_ptr(), Us.data_ptr(), k.data_ptr(),
        K.data_ptr(), ptr(Xn), ptr(Un), stream)
    build.check(lib, rc, "riccati kernel launch")
    LAUNCHES += 1
    if do_forward:
        return from_scenario_minor(Xn, (4,)), from_scenario_minor(Un, (2,))
    return from_scenario_minor(k, (2,)), from_scenario_minor(K, (2, 4))


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
