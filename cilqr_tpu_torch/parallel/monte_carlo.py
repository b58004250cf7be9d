"""Monte-Carlo uncertainty-aware CILQR: sampled covariances in one batch.

Port of ``cilqr_tpu/parallel/monte_carlo.py`` (BASELINE config 3): each
scenario draws its own localization sigma (sigma_x, sigma_y, sigma_theta)
and ego-pose noise, propagates its own uncertainty costmap, and solves.

The fast path runs the propagation kernel K4 (``ops.uncertainty_cuda``)
once for all scenarios, then the hybrid solve: one step kernel per LM
iteration (``ops.lm_cuda.fused_step``), which samples each scenario's map.  The
reference path is ``mc_solve_one`` on the batch: the plain propagation
oracle and the faithful per-lane solve.  ``make_sharded_monte_carlo``
(config 5) runs either per shard of a mesh (``parallel.batch``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams
from cilqr_tpu_torch.models import solver, solver_batched
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.ops import uncertainty_cuda
from cilqr_tpu_torch.parallel import batch as pbatch
from cilqr_tpu_torch.utils import profiling
from cilqr_tpu_torch.utils.device import resolve


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
    the generator's device, returns on ``device`` (the card when unset).  The
    JAX package's PRNG stream is not reproduced."""
    device = resolve(device)
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


@profiling.spanned("entry.monte_carlo")
def monte_carlo(p: SolverParams, cp: CostmapParams, prior: torch.Tensor, geom, origin_xy,
                origin_yaw, plan_xy, plan_n, samples: MCSample, obstacles=None,
                sigma_hi=DEFAULT_SIGMA_HI, impl: str = "auto",
                band_plan: uncertainty_cuda.BandPlan | None = None,
                center=None) -> solver.SolveResult:
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
    built for a smaller bound is refused.  ``center``: the map centre
    ``geom.center`` as host numbers (x, y); when unset it is read from
    ``geom``, one device-to-host copy per call, except on the fast path with
    a ``band_plan``, whose bands (not the window) bound the propagation.

    On the card (``solver.GRAPHS``) the fast path's propagation, plan fit
    and K3's payload run in the hybrid loop's start graph
    (``solver.solve``), whose step graph reads the maps in place.
    """
    B = samples.egos.shape[0]
    if impl == "auto":
        impl = "fast" if B >= 256 else "reference"
    if impl not in ("fast", "reference"):
        raise ValueError(f"impl must be 'fast', 'reference' or 'auto', got {impl!r}")
    if impl == "reference" or band_plan is None:
        if center is None:
            center = tuple(float(c) for c in geom.center.tolist())
        cp = ensure_window_covers(cp, prior.shape[0], prior.shape[1], center, sigma_hi)
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
    (X, U, it, J, lamb), (x_wpts, y_fit) = solver.solve(p, solver.Stage(_fast_before, (
        cp, samples.sigmas, samples.egos, U0s, prior, geom, origin_xy, origin_yaw, plan_xy,
        plan_n, obstacles, band_plan)))
    return solver.SolveResult(X, U, x_wpts, y_fit, it, J, lamb)


def _fast_before(p: SolverParams, cp: CostmapParams, sigmas, egos, U0s, prior, geom, origin_xy,
                 origin_yaw, plan_xy, plan_n, obstacles, band_plan) -> tuple:
    """The fast path up to the hybrid LM loop (a ``solver.solve`` stage):
    the propagation kernel over every scenario's sigmas (banded with
    ``band_plan``, else one full window), then ``hybrid_before``."""
    if band_plan is not None:
        unc_vals = uncertainty_cuda.propagate_uncertainty_banded(cp, prior, geom, origin_yaw,
                                                                 sigmas, band_plan)
    else:
        unc_vals = uncertainty_cuda.propagate_uncertainty_batched(cp, prior, geom, origin_yaw,
                                                                  sigmas)
    umaps = per_scenario_map(unc_vals, geom, origin_xy, origin_yaw)
    return solver_batched.hybrid_before(p, egos, U0s, plan_xy, plan_n, obstacles, umaps)


def make_sharded_monte_carlo(p: SolverParams, cp: CostmapParams, mesh: list, obstacles=None,
                             map_shape=None, map_center=None, sigma_hi=DEFAULT_SIGMA_HI,
                             impl: str = "auto"):
    """Config 5: scenario-sharded Monte-Carlo with per-scenario
    costmap propagation, the metrics reduced over the shards and processes
    (``parallel.batch``).

    Pass ``map_shape=(rows, cols)`` and ``map_center=(x, y)``: the window is
    then sized for the sampling bound ``sigma_hi`` and the band plan built
    once, here, and no call reads the map centre back from the device.

    Returns ``(fn, mesh)``: ``fn(prior, geom, origin_xy, origin_yaw, plan_xy,
    plan_n, sigmas, egos) -> (SolveResult of this process's rows on mesh[0],
    BatchMetrics)``; sigmas and egos are tensors or ``ProcessBlock``s, each
    shard runs ``monte_carlo(impl=impl)`` on its rows."""
    band_plan, center = None, None
    if map_shape is not None and map_center is not None:
        center = (float(map_center[0]), float(map_center[1]))
        cp = ensure_window_covers(cp, map_shape[0], map_shape[1], center, sigma_hi)
        band_plan = uncertainty_cuda.make_band_plan(cp, map_shape[0], map_shape[1], center,
                                                    sigma_hi)
    obs = {dev: pbatch.to_device(obstacles, dev) for dev in set(mesh)}

    def fn(prior, geom, origin_xy, origin_yaw, plan_xy, plan_n, sigmas, egos):
        # read once per call here rather than once per shard
        c = center if center is not None else tuple(float(v) for v in geom.center.tolist())
        _, blocks = pbatch.shard_blocks(mesh, pbatch.local_rows(sigmas), pbatch.local_rows(egos))
        results, parts = [], []
        for dev, (s, e) in zip(mesh, blocks):
            world = pbatch.to_device((prior, geom, origin_xy, origin_yaw, plan_xy, plan_n), dev)
            res = monte_carlo(p, cp, *world, MCSample(s.to(dev), e.to(dev)), obs[dev],
                              sigma_hi=sigma_hi, impl=impl, band_plan=band_plan, center=c)
            results.append(res)
            parts.append(pbatch.metric_sums(p, res))
        return pbatch.concat_shards(results, mesh[0]), pbatch.reduce_metrics(parts, mesh[0])

    return fn, mesh
