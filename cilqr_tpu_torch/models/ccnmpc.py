"""Chance-constrained NMPC baseline — the reference's `CCNMPC/` algorithm.

Port of ``cilqr_tpu/models/ccnmpc.py``, batched over a leading B axis of
ego states.  The standard linearized chance-constraint tightening
(Blackmore & Ono style):

  1. propagate the ego state covariance along the nominal trajectory
     through the linearized dynamics, Sigma_{k+1} = A_k Sigma_k A_k^T + W,
     with W the per-cycle localization noise the experiment injects
     (ilqr_uncertainty_node.cpp:82-110) and A_k the analytic bicycle
     Jacobian (Model.cpp:100-127);
  2. inflate each obstacle's safety ellipse per time step by the
     kappa(delta)-sigma bound of the position covariance projected onto the
     obstacle frame; for a 2-DOF Gaussian kappa = sqrt(-2 ln delta);
  3. solve the tightened problem with the CILQR solver, and repeat the
     linearize-tighten-solve loop ``n_sqp`` times.

The tightened obstacles differ per lane, so each round's solve is the
two-phase LM loop on per-scenario obstacles: plain PyTorch derivatives and
the Riccati kernel K2 once per LM iteration.  A round is one
``solver.solve`` whose stage (``_round_before``) runs the rollout, the
covariance, the tightening and the plan fit: on the card a start graph and
one launch of the device-side loop (``utils.graphs.Loop``), elsewhere the
same functions eagerly.  Without obstacles it is the shared-world solve
(K1).

Spans (``utils.profiling``): each round, ``ccnmpc.round`` with its index.
Host counters (entered in ``profiling.HOST_COUNTERS``, read by
``profiling.counters()``): ``ROUNDS``, the rounds run, and ``TIGHTENED``,
the (lane, obstacle slot, step) tightenings they issued.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional

import torch

from cilqr_tpu_torch.models import dynamics, obstacles as obs_mod, solver, solver_batched
from cilqr_tpu_torch.utils import profiling
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

#: SQP rounds run (host counter, ``profiling.counters()``)
ROUNDS = 0
#: (lane, obstacle slot, step) tightenings the rounds issued, padding slots
#: included, as ``tightened_obstacles`` grows every slot (host counter)
TIGHTENED = 0
profiling.HOST_COUNTERS.extend([(sys.modules[__name__], "ROUNDS"),
                                (sys.modules[__name__], "TIGHTENED")])


@dataclasses.dataclass(frozen=True)
class CCParams:
    """Chance-constraint configuration."""

    delta: float = 0.05   # per-(obstacle, timestep) violation probability
    n_sqp: int = 2        # linearize-tighten-solve outer iterations

    @property
    def kappa(self) -> float:
        """sqrt(chi2_2dof quantile at 1-delta) = sqrt(-2 ln delta)."""
        return math.sqrt(-2.0 * math.log(self.delta))


def process_noise(noise: NoiseParams, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-cycle localization noise as a (4, 4) state covariance increment:
    N(0, sigma) on x / y / theta, the speed observed exactly."""
    return torch.diag(torch.tensor([noise.sigma_x ** 2, noise.sigma_y ** 2, 0.0,
                                    noise.sigma_theta ** 2], dtype=dtype, device=resolve(device)))


def propagate_covariance(p: SolverParams, X: torch.Tensor, U: torch.Tensor,
                         Sigma0: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Sigma_k along nominal trajectories: X (..., N+1, 4), U (..., N, 2),
    Sigma0 and W (4, 4) or with X's leading dims.  Returns (..., N+1, 4, 4).

    The Jacobians are taken at the predecessor states (EKF-style
    propagation).  Float32 products run at full precision (no TF32)."""
    fx, _ = dynamics.jacobians(p, X[..., :-1, 2], X[..., :-1, 3], U[..., 0])
    S = Sigma0.expand(X.shape[:-2] + (4, 4))
    out = [S]
    for k in range(U.shape[-2]):
        A = fx[..., k, :, :]
        S = A @ S @ A.transpose(-1, -2) + W
        out.append(S)
    return torch.stack(out, dim=-3)


def tightened_obstacles(p: SolverParams, cc: CCParams, obstacles: obs_mod.Obstacles,
                        Sigmas: torch.Tensor) -> obs_mod.Obstacles:
    """Every obstacle's per-step footprint inflated by the kappa-sigma bound
    of the ego position covariance projected onto the obstacle frame.

    Sigmas (..., N+1, 4, 4); obstacles shared (dims (M, N, 2)).  The cost
    derives half-axes a = dims[0]/2 + ..., so adding 2 kappa sigma_axis to
    ``dims`` grows each half-axis by kappa sigma_axis.  Returns obstacles
    with Sigmas' leading dims: dims and pos (..., M, N, ·), mask shared."""
    N = obstacles.dims.shape[-2]
    Sxy = Sigmas[..., None, :N, :2, :2]           # (..., 1, N, 2, 2)
    oth = obstacles.pos[..., 3]                   # (M, N)
    co, so = torch.cos(oth), torch.sin(oth)
    s00, s01, s11 = Sxy[..., 0, 0], Sxy[..., 0, 1], Sxy[..., 1, 1]
    # the variance along the obstacle-frame major/minor axes: e^T Sigma e
    var_a = co * co * s00 + 2.0 * co * so * s01 + so * so * s11   # (..., M, N)
    var_b = so * so * s00 - 2.0 * co * so * s01 + co * co * s11
    grow = 2.0 * cc.kappa * torch.stack(
        [torch.sqrt(torch.clamp(var_a, min=0.0)), torch.sqrt(torch.clamp(var_b, min=0.0))],
        dim=-1)                                   # (..., M, N, 2)
    dims = obstacles.dims + grow
    pos = obstacles.pos.expand(dims.shape[:-1] + (4,))
    return obs_mod.Obstacles(dims, pos, obstacles.mask)


def _round_before(p: SolverParams, egos: torch.Tensor, U: torch.Tensor, plan_xy, plan_n,
                  obstacles: obs_mod.Obstacles, Sigma0: torch.Tensor, W: torch.Tensor,
                  cc: CCParams) -> tuple:
    """One linearize-tighten round up to its LM loop (a ``solver.solve``
    stage): the rollout of the current controls, the covariance along it,
    the tightened obstacles, then the plan fit and the two-phase iteration
    on them (``solver_batched.two_phase_before``)."""
    X_nom = dynamics.rollout(p, egos, U)
    ob_t = tightened_obstacles(p, cc, obstacles, propagate_covariance(p, X_nom, U, Sigma0, W))
    return solver_batched.two_phase_before(p, egos, U, plan_xy, plan_n, ob_t, None)


def solve_round(p: SolverParams, cc: CCParams, plan_xy: torch.Tensor, plan_n,
                egos: torch.Tensor, U: torch.Tensor, obstacles: obs_mod.Obstacles,
                Sigma0: torch.Tensor, W: torch.Tensor) -> solver.SolveResult:
    """One SQP round from the controls U (B, N, 2): ``_round_before``, then
    the two-phase LM loop on the tightened obstacles."""
    global ROUNDS, TIGHTENED
    ROUNDS += 1
    TIGHTENED += egos.shape[0] * obstacles.dims.shape[-3] * obstacles.dims.shape[-2]
    (X, U, it, J, lamb), (x_wpts, y_fit) = solver.solve(p, solver.Stage(
        _round_before, (egos, U, plan_xy, plan_n, obstacles, Sigma0, W, cc)))
    return solver.SolveResult(X, U, x_wpts, y_fit, it, J, lamb)


def run_steps(p: SolverParams, cc: CCParams, noise: NoiseParams, plan_xy: torch.Tensor,
              plan_n, egos: torch.Tensor, U_warm: torch.Tensor, obstacles=None,
              Sigma0: Optional[torch.Tensor] = None) -> solver.SolveResult:
    """One chance-constrained planning cycle per lane (``run_step`` of the
    JAX package, vmapped): egos (B, 4), U_warm (B, N, 2).  No uncertainty
    map is read: CCNMPC handles uncertainty by tightening the constraints
    (that is the axis the reference's experiments compare).  Each of the
    ``cc.n_sqp`` rounds is ``solve_round`` on the last round's controls."""
    W = process_noise(noise, egos.dtype, egos.device)
    if Sigma0 is None:
        Sigma0 = W
    if obstacles is None:
        return solver_batched.run_steps_batched(p, plan_xy, plan_n, egos, U_warm.contiguous())

    res, U = None, U_warm
    for i in range(cc.n_sqp):
        with profiling.span("ccnmpc.round", index=i):
            res = solve_round(p, cc, plan_xy, plan_n, egos, U.contiguous(), obstacles, Sigma0, W)
        U = res.U
    return res
