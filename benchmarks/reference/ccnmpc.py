"""Plain PyTorch reference of one chance-constrained NMPC planning cycle:
the reference planner's CCNMPC baseline (``CCNMPC/readme.md``), batched
over lanes and computed in the dtype it is given (float64 to judge the
program, bfloat16 for the benchmark's control).

The CCNMPC of the reference repository was built elsewhere (its ``src/`` is
empty), so the algorithm is the program's reconstruction, written here
again from its description (Blackmore & Ono style linearized chance
constraints):

1. the nominal trajectory: the rollout of the current controls from the
   ego;
2. the ego covariance along it, Sigma_0 = Sigma0 and Sigma_{k+1} = A_k
   Sigma_k A_k^T + W, with W the per-cycle localization noise (N(0, sigma)
   on x, y and yaw, the speed exact) and A_k the bicycle Jacobian at the
   predecessor state X_k and the acceleration of U_k (``Model.cpp:100-127``);
3. every obstacle's safety ellipse at step k grown by kappa sigma on each
   of its axes, sigma^2 = e^T Sigma_k[:2, :2] e along the obstacle's own
   axis e and kappa = sqrt(-2 ln delta), the 2-DOF Gaussian quantile:
   a_k = L/2 + |v cos th| t_safe + s_safe_a + ego_rad + kappa sigma_a,k and
   b_k = W/2 + |v sin th| t_safe + s_safe_b + ego_rad + 1 + kappa sigma_b,k;
4. the CILQR solve (``benchmarks/reference/cilqr.py``'s semantics, no
   uncertainty map) on those per-lane, per-step ellipses, from the current
   controls; the controls it returns start the next round, ``n_sqp``
   rounds in all.

Where this departs from the program's way of computing the same equations:

* the half-axes are grown by kappa sigma directly; the program adds
  2 kappa sigma to the obstacle's length and width and halves them;
* only the real obstacles are summed, one after another; the program pads
  to ``max_obstacles`` slots (masked, far away) and sums over the slots;
* the covariance's and the backward pass's products are broadcast sums, so
  that no matrix unit (nor its reduced-precision modes) takes part;
* the plan is fitted once per cycle; the program fits it in every round,
  at the same ego, to the same plan.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cilqr as ref

# the covariance is a chain of matrix products: full precision throughout
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Chance(NamedTuple):
    """The chance constraints: the violation probability per (obstacle,
    step) and the linearize-tighten-solve rounds."""

    delta: float
    n_sqp: int

    @property
    def kappa(self) -> float:
        return math.sqrt(-2.0 * math.log(self.delta))


def process_noise(sigmas, dtype, device) -> torch.Tensor:
    """W (4, 4): diag(sigma_x^2, sigma_y^2, 0, sigma_yaw^2)."""
    sx, sy, sth = sigmas
    return torch.diag(torch.tensor([sx * sx, sy * sy, 0.0, sth * sth], dtype=dtype,
                                   device=device))


def covariance(p: ref.Params, X, U, Sigma0, W):
    """Sigma_k along X (L, N+1, 4) under U (L, N, 2): (L, N+1, 4, 4)."""
    S = Sigma0.expand(X.shape[0], 4, 4)
    out = [S]
    for k in range(U.shape[1]):
        A, _ = ref._jacobians(p, X[:, k, 2], X[:, k, 3], U[:, k, 0])
        S = ref._mm(ref._mm(A, S), ref._T(A)) + W
        out.append(S)
    return torch.stack(out, dim=1)


def half_axes(p: ref.Params, kappa: float, obstacles, Sigmas, N: int):
    """The grown half-axes (a, b), each (L, M, N), of the obstacles (M, 6)
    rows [x, y, yaw, length, width, speed] at the steps 0..N-1."""
    s00, s01, s11 = Sigmas[:, :N, 0, 0], Sigmas[:, :N, 0, 1], Sigmas[:, :N, 1, 1]
    a_all, b_all = [], []
    for _, _, oth, length, width, speed in obstacles.tolist():
        co, so = math.cos(oth), math.sin(oth)
        var_a = co * co * s00 + 2.0 * co * so * s01 + so * so * s11
        var_b = so * so * s00 - 2.0 * co * so * s01 + co * co * s11
        a = length / 2.0 + abs(speed * co) * p.t_safe + p.s_safe_a + p.ego_rad
        b = width / 2.0 + abs(speed * so) * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
        a_all.append(a + kappa * var_a.clamp(min=0.0).sqrt())
        b_all.append(b + kappa * var_b.clamp(min=0.0).sqrt())
    return torch.stack(a_all, 1), torch.stack(b_all, 1)


def _obstacle_terms(p: ref.Params, obstacles, a_all, b_all, X):
    """``Obstacle.cpp:39-112`` on per-lane, per-step half-axes, summed over
    the obstacles: (L, N, 2), (L, N, 2, 2)."""
    vx = torch.zeros(X.shape[:-1] + (2,), dtype=X.dtype, device=X.device)
    mx = torch.zeros(X.shape[:-1] + (2, 2), dtype=X.dtype, device=X.device)
    for m, (ox, oy, oth, _, _, _) in enumerate(obstacles.tolist()):
        a2, b2 = a_all[:, m] * a_all[:, m], b_all[:, m] * b_all[:, m]
        co, so = math.cos(oth), math.sin(oth)
        for sign, reach, q1, q2 in ((1.0, p.ego_front, p.q1_front, p.q2_front),
                                    (-1.0, p.ego_rear, p.q1_rear, p.q2_rear)):
            ex = X[..., 0] + sign * torch.cos(X[..., 3]) * reach - ox
            ey = X[..., 1] + sign * torch.sin(X[..., 3]) * reach - oy
            dx = co * ex + so * ey
            dy = -so * ex + co * ey
            c = 1.0 - (dx * dx / a2 + dy * dy / b2)
            g = torch.stack([-2.0 * (co * dx / a2 - so * dy / b2),
                             -2.0 * (so * dx / a2 + co * dy / b2)], dim=-1)
            e = q1 * torch.exp(q2 * c)
            vx = vx + (q2 * e)[..., None] * g
            mx = mx + (q2 * q2 * e)[..., None, None] * ref._outer(g)
    return vx, mx


def derivatives_and_J(p: ref.Params, plan: ref.Plan, obstacles, axes, X, U):
    """``ref.derivatives_and_J`` without a map, the obstacle terms on the
    grown half-axes ``axes`` = (a, b)."""
    none = ref.World(None, torch.zeros((0, 6), dtype=X.dtype), None, None, None, None, None)
    l_x, l_xx, l_u, l_uu, J = ref.derivatives_and_J(p, plan, none, X, U)
    vx, mx = _obstacle_terms(p, obstacles, *axes, X[:, :p.horizon])
    l_x = torch.cat([l_x[..., :2] + p.w_obstacle * vx, l_x[..., 2:]], dim=-1)
    l_xx[..., :2, :2] += p.w_obstacle * mx
    return l_x, l_xx, l_u, l_uu, J


def iteration(p: ref.Params, plan: ref.Plan, obstacles, axes, X, U, lamb):
    """One LM iteration (``ref.iteration`` on the grown half-axes): the
    derivatives and J at (X, U), the backward pass, the closed-loop
    rollout."""
    N = p.horizon
    l_x, l_xx, l_u, l_uu, J = derivatives_and_J(p, plan, obstacles, axes, X, U)
    V_x = l_x[:, N - 1, :, None]
    V_xx = l_xx[:, N - 1]
    ks, Ks = [None] * N, [None] * N
    mm, T = ref._mm, ref._T
    for j in reversed(range(N)):
        fx, fu = ref._jacobians(p, X[:, j + 1, 2], X[:, j + 1, 3], U[:, j, 0])
        Q_x = l_x[:, j, :, None] + mm(T(fx), V_x)
        Q_u = l_u[:, j, :, None] + mm(T(fu), V_x)
        Q_xx = l_xx[:, j] + mm(mm(T(fx), V_xx), fx)
        Q_ux = mm(mm(T(fu), V_xx), fx)
        Q_uu = l_uu[:, j] + mm(mm(T(fu), V_xx), fu)
        inv = ref._clamped_inverse(Q_uu, lamb)
        k = -mm(inv, Q_u)
        K = -mm(inv, Q_ux)
        V_x = Q_x - mm(T(K), mm(Q_uu, k))
        V_xx = Q_xx - mm(T(K), mm(Q_uu, K))
        ks[j], Ks[j] = k[..., 0], K
    x = X[:, 0]
    xs, us = [x], []
    for j in range(N):
        u = U[:, j] + ks[j] + mm(Ks[j], (x - X[:, j])[..., None])[..., 0]
        x = ref.step(p, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, 1), torch.stack(us, 1), J


def solve(p: ref.Params, plan: ref.Plan, obstacles, axes, ego, U_init) -> ref.Result:
    """The LM loop of ``ref.solve`` on the grown half-axes, from U_init."""
    dtype, dev = ego.dtype, ego.device
    X = ref.rollout(p, ego, U_init)
    U = U_init.clone()
    L = ego.shape[0]
    lamb = torch.full((L,), p.lamb_init, dtype=dtype, device=dev)
    J_old = torch.full((L,), torch.finfo(dtype).max, dtype=dtype, device=dev)
    it = torch.zeros(L, dtype=torch.int64, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    shrink = torch.tensor(p.lamb_factor, dtype=dtype, device=dev).reciprocal()
    for _ in range(p.max_iterations):
        if bool(done.all()):
            break
        X_new, U_new, J_new = iteration(p, plan, obstacles, axes, X, U, lamb)
        accept = J_new < J_old
        take = (accept & ~done)[:, None, None]
        X = torch.where(take, X_new, X)
        U = torch.where(take, U_new, U)
        lamb_n = torch.where(accept, lamb * shrink, lamb * p.lamb_factor)
        stop = torch.where(accept, (J_new - J_old).abs() < p.tolerance, lamb_n > p.lamb_max)
        J_old = torch.where(done, J_old, J_new)
        lamb = torch.where(done, lamb, lamb_n)
        it = torch.where(done, it, it + 1)
        done = done | stop
    return ref.Result(X, U, it, J_old)


def cycle(p: ref.Params, chance: Chance, route, obstacles, ego, U_warm, W,
          Sigma0=None) -> list:
    """One CCNMPC planning cycle of every lane: ego (L, 4), U_warm (L, N,
    2), the route (n, 2), the obstacles (M, 6), W (4, 4); Sigma0 = W unless
    given.  Returns each round's ``ref.Result``; the last is the plan."""
    Sigma0 = W if Sigma0 is None else Sigma0
    plan = ref.local_plan(p, route, ego)
    rounds, U = [], U_warm
    for _ in range(chance.n_sqp):
        X_nom = ref.rollout(p, ego, U)
        axes = half_axes(p, chance.kappa, obstacles, covariance(p, X_nom, U, Sigma0, W),
                         p.horizon)
        res = solve(p, plan, obstacles, axes, ego, U)
        rounds.append(res)
        U = res.U
    return rounds
