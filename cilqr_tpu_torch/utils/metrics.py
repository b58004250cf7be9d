"""Experiment metrics — the offline rosbag/pandas/Excel pipeline.

Port of ``cilqr_tpu/utils/metrics.py``; reference semantics
``CILQR/src/ilqr/src/dataprocess.py`` (per-run metrics) and
``batch_dataprocess.py`` (multi-run batches per algorithm).  The input is
the ``start_pos`` stream of the closed-loop records.  Functions of tensors:
they follow their tensors' device, and the per-run reductions take leading
run dims, so ``analyze_batch`` is ``analyze_run`` on a (R, T, 4) batch (the
JAX package vmaps it).
"""

from __future__ import annotations

import json
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


class Stats(NamedTuple):
    min: torch.Tensor
    max: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor  # population variance (ddof=0, dataprocess.py:193)


def _stats(x: torch.Tensor) -> Stats:
    """Stats over the last dim."""
    mean = x.mean(dim=-1)
    return Stats(x.amin(dim=-1), x.amax(dim=-1), mean,
                 ((x - mean[..., None]) ** 2).mean(dim=-1))


def _gradient(f: torch.Tensor, h: float = 1.0) -> torch.Tensor:
    """``jnp.gradient`` along dim -2 with uniform spacing h, by its own
    expressions: one-sided differences at the ends, half the central
    difference inside, all over h."""
    return torch.cat([f[..., 1:2, :] - f[..., 0:1, :],
                      (f[..., 2:, :] - f[..., :-2, :]) * 0.5,
                      f[..., -1:, :] - f[..., -2:-1, :]], dim=-2) / h


def spatial_window_mask(positions: torch.Tensor, start_pos, end_pos,
                        planning_time: Optional[torch.Tensor] = None,
                        planning_time_threshold: float = 0.0) -> torch.Tensor:
    """Row filter of ``data_process`` (dataprocess.py:72-95): keep cycles
    whose start position lies in the rectangle spanned by start/end, with an
    optional planning-time floor."""
    kw = dict(dtype=positions.dtype, device=positions.device)
    a, b = torch.as_tensor(start_pos, **kw), torch.as_tensor(end_pos, **kw)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    m = ((positions[..., :2] >= lo) & (positions[..., :2] <= hi)).all(dim=-1)
    if planning_time is not None:
        m = m & (planning_time > planning_time_threshold)
    return m


def compute_jerks(xy: torch.Tensor, dt: float) -> torch.Tensor:
    """|jerk| along a (..., T, 2) trajectory via three nested gradients
    (dataprocess.py:117-150)."""
    j = _gradient(_gradient(_gradient(xy, dt), dt), dt)
    return torch.sqrt((j * j).sum(dim=-1))


def compute_curvature(xy: torch.Tensor) -> torch.Tensor:
    """Unsigned curvature of a (..., T, 2) trajectory (dataprocess.py:153-181);
    zero where the speed denominator vanishes."""
    d = _gradient(xy)
    dd = _gradient(d)
    num = (d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0]).abs()
    den = (d[..., 0] ** 2 + d[..., 1] ** 2) ** 1.5
    return torch.where(den == 0, torch.zeros_like(num), num / den)


def min_obstacle_distance(positions: torch.Tensor, obs_xy: torch.Tensor,
                          obs_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., T) per-cycle min center distance to any obstacle
    (``calculate_distance``, dataprocess.py:97-115 — deliberately
    center-to-center, not footprint clearance)."""
    diff = positions[..., :, None, :2] - obs_xy[:, :2]
    d = torch.sqrt((diff ** 2).sum(dim=-1))  # (..., T, M)
    if obs_mask is not None:
        d = torch.where(obs_mask > 0, d, torch.full_like(d, float("inf")))
    return d.amin(dim=-1)


def analyze_run(
    start_pos: torch.Tensor,         # (..., T, 4) per-cycle ego state
    obs_xy: torch.Tensor,            # (M, 2)
    dt: float = 0.1,
    planning_time: Optional[torch.Tensor] = None,
    obs_mask: Optional[torch.Tensor] = None,
    window=None,                     # ((x0,y0),(x1,y1)) spatial filter
    planning_time_threshold: float = 0.0,
) -> Dict[str, Stats | torch.Tensor]:
    """``data_analysis`` (dataprocess.py:185-277): planning-time stats,
    min obstacle distance, mean jerk, curvature stats, velocity stats; over
    leading run dims, each value then carries them.

    ``window`` applies the reference's row filter *before* the reductions
    (``data_process``, dataprocess.py:72-95; windows per scenario in
    ``sim.scenarios.EVAL_WINDOWS``): the gradients then run over the
    filtered sequence exactly as the pandas pipeline does.  One run only
    (the rows kept differ between runs)."""
    if window is not None:
        m = spatial_window_mask(start_pos, window[0], window[1], planning_time=planning_time,
                                planning_time_threshold=planning_time_threshold)
        start_pos = start_pos[m]
        if planning_time is not None:
            planning_time = planning_time[m]
    if start_pos.shape[-2] < 3:
        # the jerk/curvature gradients need >= 3 rows (the reference prints
        # the same complaint, dataprocess.py:131-133/158-159)
        raise ValueError(
            f"only {start_pos.shape[-2]} cycles in the evaluation window — "
            "need at least 3 for jerk/curvature"
        )
    xy = start_pos[..., :2]
    out: Dict[str, Stats | torch.Tensor] = {
        "distance_to_obstacles": _stats(min_obstacle_distance(start_pos, obs_xy, obs_mask)),
        "mean_jerk": compute_jerks(xy, dt).mean(dim=-1),
        "curvature": _stats(compute_curvature(xy)),
        "velocity": _stats(start_pos[..., 2]),
    }
    if planning_time is not None:
        out["planning_time"] = _stats(planning_time)
    return out


def map_values(fn, metrics: Dict) -> Dict:
    """fn applied to every array of a metrics dict (each field of a Stats)."""
    return {k: Stats(*map(fn, v)) if isinstance(v, Stats) else fn(v) for k, v in metrics.items()}


def analyze_batch(start_pos_batch: torch.Tensor, obs_xy, dt: float = 0.1,
                  obs_mask=None) -> Dict[str, np.ndarray]:
    """Per-run metrics over a (R, T, 4) batch of runs — the 10-bag-per-
    algorithm loop of ``process_multiple_bags`` (batch_dataprocess.py:386-447);
    NumPy arrays with a leading R axis and the keys sorted, as the JAX
    function returns them (its vmap flattens the dict in key order), so
    that rows and CSV columns come in the same order."""
    res = analyze_run(start_pos_batch, obs_xy, dt, obs_mask=obs_mask)
    return map_values(lambda t: t.detach().cpu().numpy(), dict(sorted(res.items())))


def _scalar(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(np.asarray(v))


def summary_row(name: str, metrics: Dict) -> Dict[str, float]:
    """Flatten one run's metrics into a row (the Excel-sheet row analog)."""
    row: Dict[str, float] = {"run": name}
    for k, v in metrics.items():
        if isinstance(v, Stats):
            for f in Stats._fields:
                row[f"{k}_{f}"] = _scalar(getattr(v, f))
        else:
            row[k] = _scalar(v)
    return row


def export_csv(rows, path: str) -> None:
    """CSV export replacing the Excel writer (dataprocess.py:330-334)."""
    if not rows:
        raise ValueError("no rows")
    keys = list(rows[0].keys())
    with open(path, "w") as f:
        f.write(",".join(keys) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")


def export_jsonl(rows, path: str) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def compare_algorithms(runs_by_algorithm: Dict[str, torch.Tensor], obs_xy, dt: float = 0.1,
                       obs_mask=None):
    """Multi-algorithm comparison table — the CCNMPC/CILQR/CILQR_Base/
    Frenet/NRB-RRT sweep of ``batch_dataprocess.py:459-475`` (10 bags per
    algorithm -> one summary sheet each).

    Args:
      runs_by_algorithm: name -> (R, T, 4) stacked per-run start positions.
    Returns:
      list of flat rows (one per run) + per-algorithm aggregate rows, ready
      for ``export_csv``.
    """
    rows = []
    for name, batch in runs_by_algorithm.items():
        per_run = analyze_batch(batch, obs_xy, dt, obs_mask=obs_mask)
        for r in range(batch.shape[0]):
            rows.append(summary_row(f"{name}/{r}", map_values(lambda a, r=r: a[r], per_run)))
        rows.append(summary_row(f"{name}/mean", map_values(np.mean, per_run)))
    return rows
