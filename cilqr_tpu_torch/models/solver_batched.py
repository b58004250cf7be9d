"""Batch-level CILQR solver: the throughput fast path.

Port of ``cilqr_tpu/models/solver_batched.py``.  Two implementations of the
same algorithm, each matching ``solver.run_step`` per lane:

  impl="mega"       a shared world: the whole LM loop in one kernel
                    (``ops.lm_cuda``, K1); one uncertainty map per scenario
                    (``world_batched``): the hybrid loop, one step kernel
                    per LM iteration over the lanes still running (each
                    lane's map sampled in it, then K3's iteration and the
                    update; ``lm_cuda.fused_step``)
  impl="two_phase"  LM loop here: batched cost derivatives and J (on the
                    card one kernel, ``ops.cost_cuda``; elsewhere plain
                    PyTorch), then the backward + rollout kernel
                    (``ops.riccati_cuda``, K2)

On the card every call is CUDA graphs (``solver.GRAPHS``): the shared-world
mega solve (the plan fit, the world's payload and K1) one graph
(``solver.run``); the LM loops a start graph, which fits the plan and
prepares the iteration's payload, and one replay of the step graph per LM
iteration (``solver.solve``).

Any batch size works: the kernels mask b < B, so nothing is padded.
"""

from __future__ import annotations

import torch

from cilqr_tpu_torch.utils.params import SolverParams
from cilqr_tpu_torch.models import costs, solver
from cilqr_tpu_torch.models.reference_path import get_local_plan
from cilqr_tpu_torch.models import uncertainty as uncertainty_mod
from cilqr_tpu_torch.ops import cost_cuda, lm_cuda, riccati_cuda
from cilqr_tpu_torch.utils import profiling


def uncertainty_planes(p: SolverParams, unc_map, Xh: torch.Tensor):
    """(B, N, 3) planes [e, gx, gy] of ``unc_map`` at the states Xh (B, N,
    >=2): one map per scenario (``map_sampler``) or one shared map
    (``uncertainty.uncertainty_sample``); None without a map."""
    if unc_map is None:
        return None
    if unc_map.values.ndim == 3:
        return map_sampler(p, unc_map)(Xh)
    return torch.stack(uncertainty_mod.uncertainty_sample(p, unc_map, Xh), dim=-1)


def _on_kernel(t: torch.Tensor) -> bool:
    """Whether the two-phase step's derivatives take the kernel: float32
    CUDA tensors."""
    return t.is_cuda and t.dtype == torch.float32


def _two_phase(p: SolverParams, plans, obstacles, unc_map, prepared):
    """The two-phase iteration (X, U, lamb) -> (X_new, U_new, J): the cost
    derivatives and J, then the backward + rollout kernel K2.  On float32
    CUDA tensors the derivatives are one kernel (``cost_cuda``) on
    ``prepared``, (table, fit) of ``lm_cuda.prep_iteration(plans)``, the map
    sampled into planes before it; elsewhere ``costs.all_cost_derivs_and_J``.
    The ``build`` of ``two_phase_iteration``'s ``solver.Iteration``."""
    def iteration(X, U, lamb):
        if _on_kernel(X):
            planes = uncertainty_planes(p, unc_map, X[:, :p.horizon])
            d, J = cost_cuda.cost_derivs(p, plans, X, U, obstacles, planes, prepared)
        else:
            d, J = costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, unc_map)
        return (*riccati_cuda.backward_forward_batched(p, d, X, U, lamb), J)

    return iteration


def two_phase_iteration(plans, obstacles=None, unc_map=None) -> solver.Iteration:
    """The two-phase LM iteration on (obstacles, unc_map), as
    ``solver.optimize`` takes it (on the card: replayed as CUDA graphs).
    For ``plans`` of float32 CUDA tensors the derivatives kernel's payload
    (``lm_cuda.prep_iteration``) is prepared here, once per solve (None
    elsewhere)."""
    prepared = None
    if _on_kernel(plans.coeffs):
        prep = lm_cuda.prep_iteration(plans)
        prepared = (prep.table, prep.fit)
    return solver.Iteration(_two_phase, (obstacles, unc_map, prepared))


def batched_optimize(p: SolverParams, plans, x0s: torch.Tensor, U_init: torch.Tensor,
                     obstacles=None, unc_map=None):
    """LM loop over a (B, ...) batch with the backward + rollout kernel.

    plans: LocalPlan with leading batch B; obstacles and unc_map shared or
    per scenario (see ``costs.state_cost_derivs``).  Returns (X (B,N+1,4),
    U (B,N,2), iterations (B,), J (B,), lamb (B,))."""
    return solver.optimize(p, plans, x0s, U_init,
                           iteration=two_phase_iteration(plans, obstacles, unc_map))


def map_sampler(p: SolverParams, unc_map):
    """(B, N, >=2) states -> (B, N, 3) planes [e, gx, gy] of one map per
    scenario (``lm_cuda.MapSampler``), or None without a map."""
    return None if unc_map is None else lm_cuda.MapSampler(p, unc_map)


def _mega(p: SolverParams, egos, U_warm, plan_xy, plan_n, obstacles, unc_map):
    """The shared-world mega solve: the plan fit, then K1."""
    plans = get_local_plan(p, plan_xy, plan_n, egos)
    X, U, it, J, lamb = lm_cuda.fused_optimize(p, plans, egos, U_warm, obstacles, unc_map)
    return solver.SolveResult(X, U, plans.x_wpts, plans.y_fit, it, J, lamb)


def hybrid_before(p: SolverParams, egos, U_warm, plan_xy, plan_n, obstacles, unc_map) -> tuple:
    """What comes before the hybrid LM loop (a ``solver.solve`` stage): the
    plan fit and the hybrid iteration on one map per scenario, K3's payload
    prepared.  -> (x0, U_init, plans, iteration, (x_wpts, y_fit))."""
    plans = get_local_plan(p, plan_xy, plan_n, egos)
    iteration = lm_cuda.hybrid_iteration(p, plans, obstacles, map_sampler(p, unc_map),
                                         lm_cuda.fused_iteration)
    return egos, U_warm, plans, iteration, (plans.x_wpts, plans.y_fit)


def two_phase_before(p: SolverParams, egos, U_warm, plan_xy, plan_n, obstacles, unc_map):
    """What comes before the two-phase LM loop: the plan fit and the
    derivatives kernel's payload."""
    plans = get_local_plan(p, plan_xy, plan_n, egos)
    return (egos, U_warm, plans, two_phase_iteration(plans, obstacles, unc_map),
            (plans.x_wpts, plans.y_fit))


@profiling.spanned("entry.run_steps_batched")
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
    args = (egos, U_warm, plan_xy, plan_n, obstacles, unc_map)
    if impl == "mega" and not map_batched:
        return solver.run(p, solver.Stage(_mega, args))
    before = hybrid_before if impl == "mega" else two_phase_before
    (X, U, it, J, lamb), (x_wpts, y_fit) = solver.solve(p, solver.Stage(before, args))
    return solver.SolveResult(X, U, x_wpts, y_fit, it, J, lamb)
