"""State carried across from the JAX package, handed over as numpy arrays.

Each ``*_from_numpy`` takes any object with the JAX NamedTuple's field names
(the JAX value itself, or the same fields as numpy arrays) and returns the
port's NamedTuple of tensors in ``dtype`` on ``device`` (the card when
unset).  ``solve_result_to_numpy`` goes the other way.  The Monte-Carlo
inputs are a prior (``tensor_from_numpy``), a geometry, an ``MCSample`` and
a ``BandPlan``.

The port keeps its own parameter dataclasses (``utils.params``) and imports
nothing of the JAX package, so a JAX-side parameter set is carried across
field by field: ``solver_params_from_reference``,
``costmap_params_from_reference``, ``noise_params_from_reference``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cilqr_tpu_torch.models.obstacles import Obstacles
from cilqr_tpu_torch.models.reference_path import LocalPlan
from cilqr_tpu_torch.models.solver import SolveResult
from cilqr_tpu_torch.models.tracker import KFState
from cilqr_tpu_torch.models.uncertainty import UncertaintyMap
from cilqr_tpu_torch.ops.costmap import LocalCostmap
from cilqr_tpu_torch.ops.gridmap import GridGeom
from cilqr_tpu_torch.ops.uncertainty_cuda import BandPlan
from cilqr_tpu_torch.parallel.monte_carlo import MCSample
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import CostmapParams, NoiseParams, SolverParams


def tensor_from_numpy(a, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=resolve(device)).to(dtype)


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


def kf_state_from_numpy(s, device=None, dtype=torch.float32) -> KFState:
    return _convert(KFState, s, dtype, device)


def local_costmap_from_numpy(cm, device=None, dtype=torch.float32) -> LocalCostmap:
    """The port's LocalCostmap; the optional layers stay None where unset."""
    opt = lambda a: None if a is None else tensor_from_numpy(a, device, dtype)
    return LocalCostmap(
        *(tensor_from_numpy(getattr(cm, f), device, dtype)
          for f in ("vehicle_map", "bounding_box_map", "uncertainty_map", "corridor_mask")),
        grid_geom_from_numpy(cm.geom, device, dtype),
        tensor_from_numpy(cm.origin_xy, device, dtype),
        tensor_from_numpy(cm.origin_yaw, device, dtype),
        semantic_lidar_map=opt(cm.semantic_lidar_map), ellipse_map=opt(cm.ellipse_map))


def _params_from_reference(cls, src):
    """``cls`` built from the fields of ``src`` (a dataclass instance or a
    dict): every field of ``cls`` must be there and no other."""
    if dataclasses.is_dataclass(src) and not isinstance(src, type):
        given = {f.name: getattr(src, f.name) for f in dataclasses.fields(src)}
    elif isinstance(src, dict):
        given = dict(src)
    else:
        raise TypeError(f"expected a dataclass instance or a dict, got {type(src).__name__}")
    want = {f.name for f in dataclasses.fields(cls)}
    unknown, missing = sorted(set(given) - want), sorted(want - set(given))
    if unknown or missing:
        raise ValueError(f"{cls.__name__}: unknown fields {unknown}, missing fields {missing}")
    return cls(**given)


def solver_params_from_reference(p) -> SolverParams:
    return _params_from_reference(SolverParams, p)


def costmap_params_from_reference(cp) -> CostmapParams:
    return _params_from_reference(CostmapParams, cp)


def noise_params_from_reference(n) -> NoiseParams:
    return _params_from_reference(NoiseParams, n)


def band_plan_from_numpy(plan) -> BandPlan:
    """The port's BandPlan with the fields of the JAX one (plain tuples)."""
    return BandPlan(*(getattr(plan, f) for f in BandPlan._fields))


def solve_result_to_numpy(res: SolveResult) -> SolveResult:
    """The same NamedTuple with every field a numpy array on the host."""
    return SolveResult(*(t.detach().cpu().numpy() for t in res))
