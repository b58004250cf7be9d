"""Batch-level CILQR solver: the throughput fast path.

Port of ``cilqr_tpu/models/solver_batched.py``.  Two implementations of the
same algorithm, each matching ``solver.run_step`` per lane:

  impl="mega"       a shared world: the whole LM loop in one kernel
                    (``ops.lm_cuda``, K1); one uncertainty map per scenario
                    (``world_batched``): the hybrid loop, the map sampled in
                    PyTorch at each iteration's trajectory and one
                    LM-iteration kernel (K3) per iteration
  impl="two_phase"  LM loop here: batched cost derivatives in PyTorch, then
                    the backward + rollout kernel (``ops.riccati_cuda``, K2)

Any batch size works: the kernels mask b < B, so nothing is padded.
"""

from __future__ import annotations

import torch

from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.models import costs, solver
from cilqr_tpu_torch.models import uncertainty as uncertainty_mod
from cilqr_tpu_torch.models.reference_path import get_local_plan
from cilqr_tpu_torch.ops import lm_cuda, riccati_cuda


def batched_optimize(p: SolverParams, plans, x0s: torch.Tensor, U_init: torch.Tensor,
                     obstacles=None, unc_map=None):
    """LM loop over a (B, ...) batch with the backward + rollout kernel.

    plans: LocalPlan with leading batch B; obstacles and unc_map shared or
    per scenario (see ``costs.state_cost_derivs``).  Returns (X (B,N+1,4),
    U (B,N,2), iterations (B,), J (B,), lamb (B,))."""
    def iteration(X, U, lamb):
        d, J = costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, unc_map)
        return (*riccati_cuda.backward_forward_batched(p, d, X, U, lamb), J)

    return solver.optimize(p, plans, x0s, U_init, iteration=iteration)


def map_sampler(p: SolverParams, unc_map):
    """(B, N, >=2) states -> (B, N, 3) planes [e, gx, gy] of one map per
    scenario (``uncertainty.uncertainty_sample_batched``), or None without
    a map.  Its kernels run inside a profiler range of the function's name."""
    if unc_map is None:
        return None

    def sample(Xb):
        with torch.profiler.record_function("uncertainty_sample_batched"):
            return torch.stack(uncertainty_mod.uncertainty_sample_batched(p, unc_map, Xb), dim=-1)

    return sample


def run_steps_batched(p: SolverParams, plan_xy: torch.Tensor, plan_n, egos: torch.Tensor,
                      U_warm: torch.Tensor, obstacles=None, unc_map=None,
                      impl: str = "mega", world_batched: bool = False) -> solver.SolveResult:
    """Batched ``run_step`` (iLQR.cpp:247-255): egos (B, 4), U_warm (B, N, 2).

    impl: "mega" (default) or "two_phase" (see the module docstring).
    world_batched=True: unc_map carries a leading B axis (one map per
    scenario, values (B, H, W)); obstacles are shared or per scenario
    (pos (B, M, N, 4)).  Per-scenario obstacles take the two-phase path.
    """
    if impl not in ("mega", "two_phase"):
        raise ValueError(f"impl must be 'mega' or 'two_phase', got {impl!r}")
    obs_batched = obstacles is not None and obstacles.pos.ndim == 4
    map_batched = unc_map is not None and unc_map.values.ndim == 3
    if (obs_batched or map_batched) and not world_batched:
        raise ValueError("per-scenario obstacles or maps need world_batched=True")
    if world_batched and unc_map is not None and not map_batched:
        raise ValueError("world_batched=True takes one map per scenario: values (B, H, W)")
    if impl == "mega" and obs_batched:
        impl = "two_phase"
    plans = get_local_plan(p, plan_xy, plan_n, egos)
    if impl == "mega" and not world_batched:
        X, U, it, J, lamb = lm_cuda.fused_optimize(p, plans, egos, U_warm, obstacles, unc_map)
    elif impl == "mega":
        X, U, it, J, lamb = lm_cuda.fused_optimize(
            p, plans, egos, U_warm, obstacles, None, unc_sampler=map_sampler(p, unc_map))
    else:
        X, U, it, J, lamb = batched_optimize(p, plans, egos, U_warm, obstacles, unc_map)
    return solver.SolveResult(X, U, plans.x_wpts, plans.y_fit, it, J, lamb)
