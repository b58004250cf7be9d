"""CILQR solver core — the port of ``cilqr_tpu/models/solver.py``.

Reference semantics: ``iLQR.cpp``.  Every documented quirk of the C++
solver is kept (docs/ARCHITECTURE.md §3):

* Jacobians at the successor states X[1:] with accelerations from U
  (iLQR.cpp:102-106).
* V_x/V_xx seeded from the running cost at step N-1, which enters the
  recursion again at j = N-1 (iLQR.cpp:108-113,133).
* Q_uu regularized by eigenvalue clamp + lambda shift (iLQR.cpp:155-175),
  the closed-form 2x2 path of ``ops.eig2x2``.
* V_x = Q_x - K^T Q_uu k and V_xx = Q_xx - K^T Q_uu K (iLQR.cpp:180-181).
* A single rollout U + k + K (X_new - X), no alpha line search
  (iLQR.cpp:68-86).
* J on the pre-update trajectory, without barrier terms (iLQR.cpp:217).
* lambda starts at lamb_init, /lamb_factor on accept, x on reject, abort
  above lamb_max; accept + |dJ| < tol terminates (iLQR.cpp:211-239).

Functions take a leading batch dimension where the JAX code used ``vmap``;
the LM loop keeps per-lane masks so each lane stops on its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.models import costs as costs_mod
from cilqr_tpu_torch.models import dynamics
from cilqr_tpu_torch.models.reference_path import LocalPlan, get_local_plan
from cilqr_tpu_torch.ops.eig2x2 import regularized_inverse


class SolveResult(NamedTuple):
    X: torch.Tensor           # (..., N+1, 4) optimal state trajectory
    U: torch.Tensor           # (..., N, 2) optimal control sequence
    ref_x: torch.Tensor       # (..., num_of_local_wpts) local plan x
    ref_y: torch.Tensor       # (..., num_of_local_wpts) local plan fitted y
    iterations: torch.Tensor  # (...) int32 LM iterations executed
    J: torch.Tensor           # (...) final acceptance cost
    lamb: torch.Tensor        # (...) final LM damping


def initial_controls(p: SolverParams, dtype=torch.float32, device=None) -> torch.Tensor:
    """Cold-start guess (iLQR.cpp:9-15): a = 0.5; yaw-rate 0 for the first
    N/2 steps, then 0.1."""
    N = p.horizon
    acc = torch.full((N,), 0.5, dtype=dtype, device=device)
    yr = torch.full((N,), 0.1, dtype=dtype, device=device)
    yr[: N // 2] = 0.0
    return torch.stack([acc, yr], dim=-1)


def backward_from_derivs(p: SolverParams, d: costs_mod.CostDerivs, X: torch.Tensor,
                         U: torch.Tensor, lamb: torch.Tensor):
    """Riccati backward recursion from precomputed cost derivatives
    (iLQR.cpp:91-195) -> (k (..., N, 2), K (..., N, 2, 4))."""
    if p.backward_impl == "pscan":
        raise NotImplementedError(
            "backward_impl='pscan' is not ported yet (ROADMAP.md Queue 1, "
            "item 14: ops/riccati_pscan.py)")
    N = p.horizon
    fx, fu = dynamics.jacobians(p, X[..., 1:, 2], X[..., 1:, 3], U[..., 0])
    fxT = fx.transpose(-1, -2)
    fuT = fu.transpose(-1, -2)
    V_x = d.l_x[..., N - 1, :, None]
    V_xx = d.l_xx[..., N - 1, :, :]
    ks, Ks = [None] * N, [None] * N
    for j in reversed(range(N)):
        fx_j, fu_j = fx[..., j, :, :], fu[..., j, :, :]
        Q_x = d.l_x[..., j, :, None] + fxT[..., j, :, :] @ V_x
        Q_u = d.l_u[..., j, :, None] + fuT[..., j, :, :] @ V_x
        Q_xx = d.l_xx[..., j, :, :] + fxT[..., j, :, :] @ V_xx @ fx_j
        Q_ux = fuT[..., j, :, :] @ V_xx @ fx_j  # l_ux == 0 (Constraints.cpp:501-506)
        Q_uu = d.l_uu[..., j, :, :] + fuT[..., j, :, :] @ V_xx @ fu_j

        Q_uu_inv = regularized_inverse(Q_uu, lamb)
        k_j = -Q_uu_inv @ Q_u
        K_j = -Q_uu_inv @ Q_ux
        K_jT = K_j.transpose(-1, -2)
        V_x = Q_x - K_jT @ (Q_uu @ k_j)
        V_xx = Q_xx - K_jT @ (Q_uu @ K_j)
        ks[j], Ks[j] = k_j[..., 0], K_j
    return torch.stack(ks, dim=-2), torch.stack(Ks, dim=-3)


def forward_pass(p: SolverParams, X: torch.Tensor, U: torch.Tensor, k: torch.Tensor,
                 K: torch.Tensor):
    """Closed-loop rollout U_new = U + k + K (X_new - X) (iLQR.cpp:68-86)."""
    x = X[..., 0, :]
    xs, us = [x], []
    for j in range(U.shape[-2]):
        dx = x - X[..., j, :]
        u = U[..., j, :] + k[..., j, :] + (K[..., j, :, :] @ dx[..., None])[..., 0]
        x = dynamics.step(p, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def optimize(p: SolverParams, plan: LocalPlan, x0: torch.Tensor, U_init: torch.Tensor,
             obstacles=None, unc_map=None, iteration=None):
    """Levenberg-Marquardt solve (iLQR.cpp:201-245) from x0 (..., 4) and
    U_init (..., N, 2), with per-lane masks: a lane that has stopped keeps
    its state, so every lane gets the result it would get alone.

    iteration(X, U, lamb) -> (X_new, U_new, J) is one LM iteration: by
    default the cost derivatives and J at (X, U) on (plan, obstacles,
    unc_map), the backward recursion and the rollout, in plain PyTorch; the
    batched paths pass their kernels' iteration instead.  The loop ends
    when every lane has stopped, which reads the done mask on the host once
    per iteration.  Returns (X, U, iterations, J, lamb)."""
    if iteration is None:
        def iteration(X, U, lamb):
            d, J = costs_mod.all_cost_derivs_and_J(p, plan, X, U, obstacles, unc_map)
            k, K = backward_from_derivs(p, d, X, U, lamb)
            return (*forward_pass(p, X, U, k, K), J)

    X, U = dynamics.rollout(p, x0, U_init), U_init
    batch = U_init.shape[:-2]
    kw = dict(dtype=X.dtype, device=X.device)
    J_old = torch.full(batch, torch.finfo(X.dtype).max, **kw)
    lamb = torch.full(batch, p.lamb_init, **kw)
    it = torch.zeros(batch, dtype=torch.int32, device=X.device)
    done = torch.zeros(batch, dtype=torch.bool, device=X.device)
    # Divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, and the abort test
    # lamb_n > lamb_max sits exactly on 1e4 after x10 / /10 chains, so the
    # last bit of the division decides whether a lane stops.
    lamb_factor = torch.full_like(lamb, p.lamb_factor)
    for _ in range(p.max_iterations):
        if bool(done.all()):
            break
        X_new, U_new, J_new = iteration(X, U, lamb)

        accept = J_new < J_old
        take = (accept & ~done)[..., None, None]
        X = torch.where(take, X_new, X)
        U = torch.where(take, U_new, U)
        lamb_n = torch.where(accept, lamb / lamb_factor, lamb * lamb_factor)
        stop = torch.where(accept, (J_new - J_old).abs() < p.tolerance, lamb_n > p.lamb_max)
        J_old = torch.where(done, J_old, J_new)
        lamb = torch.where(done, lamb, lamb_n)
        it = torch.where(done, it, it + 1)
        done = done | stop
    return X, U, it, J_old, lamb


def run_step(p: SolverParams, plan_xy: torch.Tensor, plan_n, ego_state: torch.Tensor,
             U_warm: torch.Tensor, obstacles=None, unc_map=None) -> SolveResult:
    """One receding-horizon planning cycle (iLQR.cpp:247-255).

    plan_xy: (P, 2) padded global plan; plan_n: valid count; ego_state
    (..., 4) with noise already injected; U_warm (..., N, 2) warm start.
    ``unc_map`` is one shared map or, for ego_state (B, 4), one map per
    scenario (values (B, H, W), geometry and frame leaves with leading B).
    """
    plan = get_local_plan(p, plan_xy, plan_n, ego_state)
    X, U, it, J, lamb = optimize(p, plan, ego_state, U_warm, obstacles, unc_map)
    return SolveResult(X, U, plan.x_wpts, plan.y_fit, it, J, lamb)
