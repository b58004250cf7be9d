"""State carried across from the JAX package, handed over as numpy arrays.

Each ``*_from_numpy`` takes any object with the JAX NamedTuple's field names
(the JAX value itself, or the same fields as numpy arrays) and returns the
port's NamedTuple of tensors on ``device`` in ``dtype``.
``solve_result_to_numpy`` goes the other way.  ``SolverParams`` and
``CostmapParams`` need no conversion: both packages use the same frozen
dataclasses.  The Monte-Carlo inputs are a prior (``tensor_from_numpy``),
a geometry, an ``MCSample`` and a ``BandPlan``.
"""

from __future__ import annotations

import numpy as np
import torch

from cilqr_tpu_torch.models.obstacles import Obstacles
from cilqr_tpu_torch.models.reference_path import LocalPlan
from cilqr_tpu_torch.models.solver import SolveResult
from cilqr_tpu_torch.models.uncertainty import UncertaintyMap
from cilqr_tpu_torch.ops.gridmap import GridGeom
from cilqr_tpu_torch.ops.uncertainty_cuda import BandPlan
from cilqr_tpu_torch.parallel.monte_carlo import MCSample


def tensor_from_numpy(a, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def _convert(cls, src, dtype, device):
    return cls(*(tensor_from_numpy(getattr(src, f), device, dtype) for f in cls._fields))


def local_plan_from_numpy(plan, device=None, dtype=torch.float32) -> LocalPlan:
    return _convert(LocalPlan, plan, dtype, device)


def obstacles_from_numpy(obs, device=None, dtype=torch.float32) -> Obstacles:
    return _convert(Obstacles, obs, dtype, device)


def grid_geom_from_numpy(geom, device=None, dtype=torch.float32) -> GridGeom:
    return _convert(GridGeom, geom, dtype, device)


def unc_map_from_numpy(m, device=None, dtype=torch.float32) -> UncertaintyMap:
    return UncertaintyMap(
        tensor_from_numpy(m.values, device, dtype),
        grid_geom_from_numpy(m.geom, device, dtype),
        tensor_from_numpy(m.origin_xy, device, dtype),
        tensor_from_numpy(m.origin_yaw, device, dtype),
    )


def mc_sample_from_numpy(s, device=None, dtype=torch.float32) -> MCSample:
    return _convert(MCSample, s, dtype, device)


def band_plan_from_numpy(plan) -> BandPlan:
    """The port's BandPlan with the fields of the JAX one (plain tuples)."""
    return BandPlan(*(getattr(plan, f) for f in BandPlan._fields))


def solve_result_to_numpy(res: SolveResult) -> SolveResult:
    """The same NamedTuple with every field a numpy array on the host."""
    return SolveResult(*(t.detach().cpu().numpy() for t in res))
