"""State carried across from the JAX package, handed over as numpy arrays.

Each ``*_from_numpy`` takes any object with the JAX NamedTuple's field names
(the JAX value itself, or the same fields as numpy arrays) and returns the
port's NamedTuple of tensors on ``device`` in ``dtype``.
``solve_result_to_numpy`` goes the other way.  ``SolverParams`` needs no
conversion: both packages use the same frozen dataclass.
"""

from __future__ import annotations

import numpy as np
import torch

from cilqr_tpu_torch.models.obstacles import Obstacles
from cilqr_tpu_torch.models.reference_path import LocalPlan
from cilqr_tpu_torch.models.solver import SolveResult
from cilqr_tpu_torch.models.uncertainty import UncertaintyMap
from cilqr_tpu_torch.ops.gridmap import GridGeom


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def _convert(cls, src, dtype, device):
    return cls(*(_tensor(getattr(src, f), dtype, device) for f in cls._fields))


def local_plan_from_numpy(plan, device=None, dtype=torch.float32) -> LocalPlan:
    return _convert(LocalPlan, plan, dtype, device)


def obstacles_from_numpy(obs, device=None, dtype=torch.float32) -> Obstacles:
    return _convert(Obstacles, obs, dtype, device)


def grid_geom_from_numpy(geom, device=None, dtype=torch.float32) -> GridGeom:
    return _convert(GridGeom, geom, dtype, device)


def unc_map_from_numpy(m, device=None, dtype=torch.float32) -> UncertaintyMap:
    return UncertaintyMap(
        _tensor(m.values, dtype, device),
        grid_geom_from_numpy(m.geom, device, dtype),
        _tensor(m.origin_xy, dtype, device),
        _tensor(m.origin_yaw, dtype, device),
    )


def solve_result_to_numpy(res: SolveResult) -> SolveResult:
    """The same NamedTuple with every field a numpy array on the host."""
    return SolveResult(*(t.detach().cpu().numpy() for t in res))
