"""Monte-Carlo uncertainty-aware CILQR: sampled covariances in one batch.

Port of ``cilqr_tpu/parallel/monte_carlo.py`` (BASELINE config 3): each
scenario draws its own localization sigma (sigma_x, sigma_y, sigma_theta)
and ego-pose noise, propagates its own uncertainty costmap, and solves.

The fast path runs the propagation kernel K4 (``ops.uncertainty_cuda``)
once for all scenarios, then the hybrid solve: the LM-iteration kernel K3
(``ops.lm_cuda``) per iteration, fed each scenario's map sample.  The
reference path is ``mc_solve_one`` on the batch: the plain propagation
oracle and the faithful per-lane solve.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cilqr_tpu.utils.params import CostmapParams, SolverParams
from cilqr_tpu_torch.models import solver, solver_batched
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.ops import uncertainty_cuda


class MCSample(NamedTuple):
    sigmas: torch.Tensor  # (B, 3) sampled (sigma_x, sigma_y, sigma_theta)
    egos: torch.Tensor    # (B, 4) noisy initial states


DEFAULT_SIGMA_LO = (0.02, 0.02, 0.005)
DEFAULT_SIGMA_HI = (0.25, 0.25, 0.05)


def ensure_window_covers(cp: CostmapParams, rows: int, cols: int, center,
                         sigma_hi=DEFAULT_SIGMA_HI) -> CostmapParams:
    """``cp`` with ``window_radius`` enlarged, if needed, to cover the 95%
    ellipse of the largest sampled covariance: a smaller window would
    silently truncate the footprint."""
    need = costmap_mod.required_window_radius(
        cp, rows, cols, center=(float(center[0]), float(center[1])), sigmas=sigma_hi)
    if need > cp.window_radius:
        return dataclasses.replace(cp, window_radius=need)
    return cp


def sample_scenarios(generator: torch.Generator, n: int, base_ego, sigma_lo=DEFAULT_SIGMA_LO,
                     sigma_hi=DEFAULT_SIGMA_HI, dtype=torch.float32, device=None) -> MCSample:
    """Per-scenario covariances, uniform in [sigma_lo, sigma_hi], and ego
    noise N(0, sigma) with the drawn sigma on x, y and yaw (the
    noise-injection feature of ilqr_uncertainty_node.cpp:82-110).  Draws on
    the generator's device, returns on ``device``.  The JAX package's PRNG
    stream is not reproduced."""
    gdev = generator.device
    u = torch.rand((n, 3), generator=generator, dtype=dtype, device=gdev)
    lo = torch.tensor(sigma_lo, dtype=dtype, device=gdev)
    hi = torch.tensor(sigma_hi, dtype=dtype, device=gdev)
    sigmas = lo + u * (hi - lo)
    r = torch.randn((n, 3), generator=generator, dtype=dtype, device=gdev)
    egos = torch.as_tensor(base_ego, dtype=dtype, device=gdev).expand(n, 4).clone()
    egos[:, 0] += sigmas[:, 0] * r[:, 0]
    egos[:, 1] += sigmas[:, 1] * r[:, 1]
    egos[:, 3] += sigmas[:, 2] * r[:, 2]
    return MCSample(sigmas.to(device), egos.to(device))


def per_scenario_map(values: torch.Tensor, geom, origin_xy, origin_yaw) -> unc_mod.UncertaintyMap:
    """UncertaintyMap of maps values (B, H, W) over one shared geometry and
    frame, every leaf broadcast to a leading B axis (no copy)."""
    B = values.shape[0]
    bc = lambda t: t.expand((B,) + tuple(t.shape))
    geom_b = type(geom)(*(bc(t) for t in geom))
    return unc_mod.UncertaintyMap(values, geom_b, bc(origin_xy), bc(origin_yaw))


def mc_solve_one(p: SolverParams, cp: CostmapParams, prior: torch.Tensor, geom, origin_xy,
                 origin_yaw, plan_xy, plan_n, sigmas: torch.Tensor, ego: torch.Tensor,
                 U0: torch.Tensor, obstacles=None) -> solver.SolveResult:
    """Propagate the costmap under the sampled covariance, then solve with
    the uncertainty barrier: sigmas (3,), ego (4,), U0 (N, 2) for one
    scenario, or with a leading scenario axis B for B at once."""
    sig = tuple(s[..., None, None] for s in sigmas.unbind(-1))
    unc_vals = costmap_mod.propagate_uncertainty_reference(cp, prior, geom, origin_yaw,
                                                           sigmas=sig)
    if unc_vals.ndim == 3:
        umap = per_scenario_map(unc_vals, geom, origin_xy, origin_yaw)
    else:
        umap = unc_mod.UncertaintyMap(unc_vals, geom, origin_xy, origin_yaw)
    return solver.run_step(p, plan_xy, plan_n, ego, U0, obstacles, umap)


def monte_carlo(p: SolverParams, cp: CostmapParams, prior: torch.Tensor, geom, origin_xy,
                origin_yaw, plan_xy, plan_n, samples: MCSample, obstacles=None,
                sigma_hi=DEFAULT_SIGMA_HI, impl: str = "auto",
                band_plan: uncertainty_cuda.BandPlan | None = None) -> solver.SolveResult:
    """Config-3 batch: per-scenario costmap + solve, (B, ...) results.

    impl:
      "fast": the propagation kernel over all scenarios (banded with
        ``band_plan``, else one full window), then the hybrid solve
        ``run_steps_batched(impl="mega", world_batched=True)``;
      "reference": ``mc_solve_one`` on the whole batch (the semantics
        oracle; float64 throughout for float64 inputs);
      "auto" (default): "fast" from 256 scenarios, else "reference".

    ``sigma_hi`` must bound the sampled sigmas: the window is enlarged to
    cover its 95% ellipse (``ensure_window_covers``), and a ``band_plan``
    built for a smaller bound is refused.
    """
    cp = ensure_window_covers(cp, prior.shape[0], prior.shape[1],
                              (float(geom.center[0]), float(geom.center[1])), sigma_hi)
    B = samples.egos.shape[0]
    if impl == "auto":
        impl = "fast" if B >= 256 else "reference"
    if impl not in ("fast", "reference"):
        raise ValueError(f"impl must be 'fast', 'reference' or 'auto', got {impl!r}")
    U0 = solver.initial_controls(p, dtype=samples.egos.dtype, device=samples.egos.device)
    U0s = U0.expand((B,) + tuple(U0.shape))
    if impl == "reference":
        return mc_solve_one(p, cp, prior, geom, origin_xy, origin_yaw, plan_xy, plan_n,
                            samples.sigmas, samples.egos, U0s, obstacles)

    if band_plan is not None:
        plan_hi = band_plan.sigma_hi
        if plan_hi is not None and any(ph < h for ph, h in zip(plan_hi, sigma_hi)):
            raise ValueError(
                f"band_plan covers sigma_hi={plan_hi} but sampling bound is "
                f"{tuple(sigma_hi)} — rebuild the plan with the larger bound "
                "(a too-small band radius silently truncates the 95% ellipse)")
        unc_vals = uncertainty_cuda.propagate_uncertainty_banded(
            cp, prior, geom, origin_yaw, samples.sigmas, band_plan)
    else:
        unc_vals = uncertainty_cuda.propagate_uncertainty_batched(
            cp, prior, geom, origin_yaw, samples.sigmas)
    umaps = per_scenario_map(unc_vals, geom, origin_xy, origin_yaw)
    return solver_batched.run_steps_batched(p, plan_xy, plan_n, samples.egos, U0s, obstacles,
                                            umaps, impl="mega", world_batched=True)
