"""cilqr_tpu_torch — the CILQR trajectory optimizer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``cilqr_tpu`` that keeps its layout: every module here has its
JAX reference at the same path under ``cilqr_tpu/``.  Entry points:

  SolverParams / CostmapParams / NoiseParams   configuration (utils.params)
  models.solver.run_step                       one planning cycle (faithful)
  models.solver_batched.run_steps_batched      batched fast path (CUDA kernels)
  parallel.monte_carlo.monte_carlo             sampled covariances, one batch
  sim.plant.closed_loop_full_stack_batched     costmap rebuild + solve per cycle
  parallel.batch.make_sharded_solver           scenario sharding over a mesh
  parallel.campaign.run_campaign               checkpointed Monte-Carlo rounds
  sim.example_scenario.example_scenario        the benchmark world

The port imports ``torch`` and never ``jax``, and nothing of ``cilqr_tpu``:
it keeps its own copy of the configuration dataclasses (``utils.params``;
``utils.interop`` carries a JAX-side parameter set across).  Constructors
allocate on the card unless the caller passes ``device="cpu"``
(``utils.device``); functions of tensors follow their tensors.
"""

from cilqr_tpu_torch.utils.params import (  # noqa: F401
    CostmapParams,
    NoiseParams,
    SolverParams,
    DEFAULT_COSTMAP,
    DEFAULT_NOISE,
    DEFAULT_PARAMS,
)

__version__ = "0.1.0"

__all__ = [
    "CostmapParams",
    "NoiseParams",
    "SolverParams",
    "DEFAULT_COSTMAP",
    "DEFAULT_NOISE",
    "DEFAULT_PARAMS",
    "__version__",
]
