"""Batch-level CILQR solver: the throughput fast path.

Port of ``cilqr_tpu/models/solver_batched.py``.  Two implementations of the
same algorithm, each matching ``solver.run_step`` per lane:

  impl="mega"       the whole LM loop in one kernel (``ops.lm_cuda``, K1)
  impl="two_phase"  LM loop here: batched cost derivatives in PyTorch, then
                    the backward + rollout kernel (``ops.riccati_cuda``, K2)

Any batch size works: the kernels mask b < B, so nothing is padded.
"""

from __future__ import annotations

import torch

from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.models import solver
from cilqr_tpu_torch.models.reference_path import get_local_plan
from cilqr_tpu_torch.ops import lm_cuda, riccati_cuda

_WORLD_BATCHED = (
    "world_batched=True (one world per scenario) is not ported yet: "
    "ROADMAP.md Queue 2, K3 (lm_pallas._iter_kernel, the hybrid per-scenario-map mode)"
)


def batched_optimize(p: SolverParams, plans, x0s: torch.Tensor, U_init: torch.Tensor,
                     obstacles=None, unc_map=None, world_batched: bool = False):
    """LM loop over a (B, ...) batch with the backward + rollout kernel.

    plans: LocalPlan with leading batch B.  Returns (X (B,N+1,4), U (B,N,2),
    iterations (B,), J (B,), lamb (B,))."""
    if world_batched:
        raise NotImplementedError(_WORLD_BATCHED)
    return solver.optimize(
        p, plans, x0s, U_init, obstacles, unc_map,
        lambda d, X, U, lamb: riccati_cuda.backward_forward_batched(p, d, X, U, lamb))


def run_steps_batched(p: SolverParams, plan_xy: torch.Tensor, plan_n, egos: torch.Tensor,
                      U_warm: torch.Tensor, obstacles=None, unc_map=None,
                      impl: str = "mega", world_batched: bool = False) -> solver.SolveResult:
    """Batched ``run_step`` (iLQR.cpp:247-255): egos (B, 4), U_warm (B, N, 2).

    impl: "mega" (default) or "two_phase" (see the module docstring).
    world_batched=True is not ported yet and raises NotImplementedError.
    """
    if world_batched:
        raise NotImplementedError(_WORLD_BATCHED)
    plans = get_local_plan(p, plan_xy, plan_n, egos)
    if impl == "mega":
        X, U, it, J, lamb = lm_cuda.fused_optimize(p, plans, egos, U_warm, obstacles, unc_map)
    elif impl == "two_phase":
        X, U, it, J, lamb = batched_optimize(p, plans, egos, U_warm, obstacles, unc_map)
    else:
        raise ValueError(f"impl must be 'mega' or 'two_phase', got {impl!r}")
    return solver.SolveResult(X, U, plans.x_wpts, plans.y_fit, it, J, lamb)
