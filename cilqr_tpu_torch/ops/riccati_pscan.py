"""Associative-scan (parallel-prefix) Riccati backward pass — the B=1
latency option.

Port of ``cilqr_tpu/ops/riccati_pscan.py`` in plain PyTorch: no TPU kernel
stands behind it (the JAX module is ``jax.lax.associative_scan``), so none
stands behind the port either.  ``SolverParams(backward_impl="pscan")``
routes ``solver.backward_from_derivs`` here; the kernels K1, K2 and K3 and
their plain versions always run the sequential recursion.

The reference backward pass is a strictly sequential N-step recursion
(``iLQR.cpp:133-191``).  This module computes all value functions
V_j = (V_xx, V_x) in O(log N) sequential depth, then every step's gains
(k_j, K_j) in one batched pass.

Math.  Each backward step maps the successor value function (P', p') to

    P = l_xx + A^T P' (I + C P')^-1 A            C = B R~^-1 B^T
    p = l_x  + A^T (I + P' C)^-1 (p' + P' b)     b = -B R~^-1 l_u

with A = fx, B = fu, R~ = l_uu + lambda*I (l_ux == 0 here,
Constraints.cpp:501-506).  Maps of this family e = (A, b, C, eta, J) are
closed under composition; for z = y∘x (x applied first, i.e. x is the
later-in-time step):

    L  = (I + C_y J_x)^-1
    A_z   = A_x L A_y
    b_z   = b_x + A_x L (b_y - C_y eta_x)
    C_z   = C_x + A_x L C_y A_x^T
    eta_z = eta_y + A_y^T L^T (eta_x + J_x b_y)
    J_z   = J_y + A_y^T L^T J_x A_y

(the parallel-LQT element algebra of Sarkka & Garcia-Fernandez).  A
constant seed element (A=0, J=V_xx0, eta=V_x0) makes each inclusive prefix
the V consumed by that step's gains, and reproduces the quirk that step
N-1's running cost both seeds the recursion and re-enters it
(iLQR.cpp:108-113,133).

Semantics divergence (documented, opt-in, as in the JAX package): the
reference propagates V_xx through the regularized-inverse sandwich
Q_xx - Q_ux^T M Q_uu M Q_ux with M = (clamp(eig(Q_uu)) + lambda)^-1
(iLQR.cpp:164-181), which admits no exact associative decomposition.  This
module propagates the textbook damped recursion V_xx <- Q_xx - Q_ux^T M~
Q_ux, M~ = (Q_uu + lambda)^-1 (identical as lambda -> 0 and once the solve
has converged); the per-step gains use the reference's clamped regularized
inverse exactly.  ``backward_standard_seq`` is the sequential oracle of the
same textbook recursion: ``backward_pscan`` equals it to machine precision
for any lambda.

Every function takes any leading batch axes, as ``solver.backward_from_derivs``
does: d with l_x (..., N, 4), l_xx (..., N, 4, 4), l_u (..., N, 2),
l_uu (..., N, 2, 2); X (..., N+1, 4); U (..., N, 2); lamb (...).
"""

from __future__ import annotations

import torch

from cilqr_tpu_torch.models import dynamics
from cilqr_tpu_torch.ops.eig2x2 import regularized_inverse


def _inv2x2(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a (batched ...x2x2) matrix."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., n, m) x (..., m) -> (..., n)."""
    return (M @ v[..., None])[..., 0]


def _elements(d, fx: torch.Tensor, fu: torch.Tensor, lamb: torch.Tensor) -> tuple:
    """Per-step scan elements (A, b, C, eta, J) from the cost derivatives and
    the Jacobians fx (..., N, 4, 4), fu (..., N, 4, 2) at the successor
    states (iLQR.cpp:102-106).

    Returns the (N)-long sequences with the scan axis FIRST: the seed, then
    steps N-1, N-2, ..., 1 (step 0's element is never consumed: its V is
    the prefix of step 1)."""
    N = fx.shape[-3]
    I2 = torch.eye(2, dtype=fx.dtype, device=fx.device)
    Rt = d.l_uu + lamb[..., None, None, None] * I2   # (..., N, 2, 2), PSD + lamb > 0
    fuR = fu @ _inv2x2(Rt)                           # (..., N, 4, 2)
    C = fuR @ fu.transpose(-1, -2)                   # fu R~^-1 fu^T
    b = -_mv(fuR, d.l_u)
    seed = (torch.zeros_like(fx[..., :1, :, :]), torch.zeros_like(d.l_x[..., :1, :]),
            torch.zeros_like(fx[..., :1, :, :]), d.l_x[..., N - 1:N, :],
            d.l_xx[..., N - 1:N, :, :])
    steps = (fx, b, C, d.l_x, d.l_xx)
    out = []
    for s0, full in zip(seed, steps):
        axis = -3 if full.ndim == fx.ndim else -2
        rev = full.narrow(axis, 1, N - 1).flip(axis)  # steps N-1 .. 1
        out.append(torch.cat([s0, rev], dim=axis).movedim(axis, 0))
    return tuple(out)


def _combine(x: tuple, y: tuple) -> tuple:
    """z = y∘x (x applied first); batched over the leading axes."""
    Ax, bx, Cx, ex, Jx = x
    Ay, by, Cy, ey, Jy = y
    n = Ax.shape[-1]
    I = torch.eye(n, dtype=Ax.dtype, device=Ax.device)
    # L = (I + Cy Jx)^-1 applied to [Ay | Cy | (by - Cy ex)]
    rhs = torch.cat([Ay, Cy, (by - _mv(Cy, ex))[..., None]], dim=-1)
    sol = torch.linalg.solve_ex(I + Cy @ Jx, rhs)[0]
    LAy, LCy, Lb = sol[..., :n], sol[..., n:2 * n], sol[..., 2 * n]
    # L^T = (I + Jx Cy)^-1 applied to [(ex + Jx by) | Jx Ay]
    rhsT = torch.cat([(ex + _mv(Jx, by))[..., None], Jx @ Ay], dim=-1)
    solT = torch.linalg.solve_ex(I + Jx @ Cy, rhsT)[0]
    Lte, LtJA = solT[..., 0], solT[..., 1:]

    Az = Ax @ LAy
    bz = bx + _mv(Ax, Lb)
    Cz = Cx + Ax @ (LCy @ Ax.transpose(-1, -2))
    ez = ey + _mv(Ay.transpose(-1, -2), Lte)
    Jz = Jy + Ay.transpose(-1, -2) @ LtJA
    # C and J are symmetric by construction; re-symmetrize against drift
    Cz = 0.5 * (Cz + Cz.transpose(-1, -2))
    Jz = 0.5 * (Jz + Jz.transpose(-1, -2))
    return Az, bz, Cz, ez, Jz


def inclusive_scan(combine, elems: tuple) -> tuple:
    """Inclusive prefix of a sequence of elements under an associative
    ``combine(earlier, later)``, the scan axis first in every tensor:
    out[i] = combine(... combine(elems[0], elems[1]) ..., elems[i]).

    Hillis-Steele: ceil(log2 n) rounds; round r combines every element
    i >= 2^r with element i - 2^r of the previous round, so the operands keep
    their order (the earlier one on the left).  O(n log n) work, which at
    the horizons here (n <= ~100) costs less than the depth saves."""
    n = elems[0].shape[0]
    step = 1
    while step < n:
        later = tuple(e[step:] for e in elems)
        earlier = tuple(e[:-step] for e in elems)
        merged = combine(earlier, later)
        elems = tuple(torch.cat([e[:step], m], dim=0) for e, m in zip(elems, merged))
        step *= 2
    return elems


def backward_pscan(p, d, X: torch.Tensor, U: torch.Tensor, lamb: torch.Tensor):
    """Parallel-prefix backward pass -> (k (..., N, 2), K (..., N, 2, 4)).

    Drop-in for ``solver.backward_seq`` (same seeding and successor-state
    Jacobian quirks; value propagation per the module docstring).
    Sequential depth O(log N) instead of O(N)."""
    lamb = torch.as_tensor(lamb, dtype=X.dtype, device=X.device)
    fx, fu = dynamics.jacobians(p, X[..., 1:, 2], X[..., 1:, 3], U[..., 0])
    _, _, _, p_all, P_all = inclusive_scan(_combine, _elements(d, fx, fu, lamb))
    # prefix i is the V consumed by step j = N-1-i; flip to step order
    P = P_all.flip(0).movedim(0, -3)   # (..., N, 4, 4), P[j] = V_xx at j+1
    pv = p_all.flip(0).movedim(0, -2)  # (..., N, 4)
    # every step's gains at once, with the reference's clamped inverse
    fuT = fu.transpose(-1, -2)
    Qu = d.l_u + _mv(fuT, pv)
    Quu = d.l_uu + fuT @ P @ fu
    Qux = fuT @ P @ fx
    M = regularized_inverse(Quu, lamb[..., None].expand(Quu.shape[:-2]))
    return -_mv(M, Qu), -(M @ Qux)


def backward_standard_seq(p, d, X: torch.Tensor, U: torch.Tensor, lamb: torch.Tensor):
    """Sequential oracle of the same textbook damped recursion the pscan
    propagates (V_xx <- Q_xx - Q_ux^T M~ Q_ux, M~ = (Q_uu + lambda)^-1,
    gains via the clamped regularized inverse).  It locks the pscan
    algebra: pscan == this to machine precision for any lambda."""
    lamb = torch.as_tensor(lamb, dtype=X.dtype, device=X.device)
    N = p.horizon
    fx, fu = dynamics.jacobians(p, X[..., 1:, 2], X[..., 1:, 3], U[..., 0])
    I2 = torch.eye(2, dtype=X.dtype, device=X.device)
    V_x, V_xx = d.l_x[..., N - 1, :], d.l_xx[..., N - 1, :, :]
    ks, Ks = [None] * N, [None] * N
    for j in reversed(range(N)):
        fx_j, fu_j = fx[..., j, :, :], fu[..., j, :, :]
        fxT, fuT = fx_j.transpose(-1, -2), fu_j.transpose(-1, -2)
        Q_x = d.l_x[..., j, :] + _mv(fxT, V_x)
        Q_u = d.l_u[..., j, :] + _mv(fuT, V_x)
        Q_xx = d.l_xx[..., j, :, :] + fxT @ V_xx @ fx_j
        Q_ux = fuT @ V_xx @ fx_j
        Q_uu = d.l_uu[..., j, :, :] + fuT @ V_xx @ fu_j
        M = regularized_inverse(Q_uu, lamb)
        ks[j], Ks[j] = -_mv(M, Q_u), -(M @ Q_ux)
        Mt = _inv2x2(Q_uu + lamb[..., None, None] * I2)
        Q_uxT = Q_ux.transpose(-1, -2)
        V_x = Q_x - _mv(Q_uxT, _mv(Mt, Q_u))
        V_xx = Q_xx - Q_uxT @ (Mt @ Q_ux)
        V_xx = 0.5 * (V_xx + V_xx.transpose(-1, -2))
    return torch.stack(ks, dim=-2), torch.stack(Ks, dim=-3)
