"""cilqr_tpu_torch — the CILQR trajectory optimizer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``cilqr_tpu`` that keeps its layout: every module here has its
JAX reference at the same path under ``cilqr_tpu/``.  Entry points:

  SolverParams / CostmapParams / NoiseParams   shared configuration
  models.solver.run_step                       one planning cycle (faithful)
  models.solver_batched.run_steps_batched      batched fast path (CUDA kernels)
  sim.example_scenario.example_scenario        the benchmark world

The port imports ``torch`` and never ``jax``; the configuration dataclasses
are the framework-free ones of ``cilqr_tpu.utils.params``.
"""

from cilqr_tpu.utils.params import (  # noqa: F401
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
