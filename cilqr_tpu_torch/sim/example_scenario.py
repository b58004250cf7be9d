"""Canonical example scenario of the benchmark: a curving CARLA-scale lane,
two static obstacles and a random uncertainty costmap (the world of
``cilqr_tpu/sim/example_scenario.py``, built from the same numbers)."""

from __future__ import annotations

import numpy as np
import torch

from cilqr_tpu_torch.models import obstacles as obs_mod
from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.models import solver, uncertainty as unc_mod


def example_scenario(p, dtype=torch.float32, device=None):
    """Returns (plan (P, 2), n, ego (4,), U0 (N, 2), obstacles, unc_map)."""
    n_pts = min(120, p.max_global_plan_points)
    s = np.linspace(0.0, 119.0, n_pts)
    plan_np = np.stack([90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s], axis=1)
    plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype, device=device)
    ego = torch.tensor([100.0, -305.6, 4.0, 0.05], dtype=dtype, device=device)
    U0 = solver.initial_controls(p, dtype=dtype, device=device)
    obstacles = obs_mod.make_static_obstacles(
        p, [[115.0, -305.0], [130.0, -304.0]], [[3.63, 1.84]] * 2, [0.0, 0.2],
        dtype=dtype, device=device,
    )
    rng = np.random.default_rng(0)
    unc = unc_mod.make_uncertainty_map(
        rng.uniform(0.0, 100.0, (48, 32)), [10.0, 0.0], 0.2, ego[:2].clone(),
        float(ego[3]), dtype=dtype, device=device,
    )
    return plan, n, ego, U0, obstacles, unc
