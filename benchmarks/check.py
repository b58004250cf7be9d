"""The comparison that decides ``correct``: solves of the timed window held
lane by lane against the plain reference.

For each sampled lane the gap is the largest absolute difference over its
whole answer, the states X (m, m/s, rad) and the controls U (m/s^2, rad/s).
Float32 solves of this problem are chaotic in a few lanes: a lane whose ego
moves by a few float32 ulps may settle in another local solution, so the
numbers compared are a share and a median over lanes, not the widest gap:

* ``lanes_off_pct``: the share of sampled lanes whose gap exceeds the
  cell's ``lane_bar``;
* ``gap_median``: the median lane's gap.

A non-finite answer is an infinite gap.  The iterations and J are printed
beside them for the record.
"""

from __future__ import annotations

import math

import torch


def gaps(X, U, ref) -> torch.Tensor:
    """Per-lane gap of (X, U) to the reference's result, in float64."""
    dx = (X.double() - ref.X.double()).abs().flatten(1).amax(1)
    du = (U.double() - ref.U.double()).abs().flatten(1).amax(1)
    g = torch.maximum(dx, du)
    finite = torch.isfinite(X).flatten(1).all(1) & torch.isfinite(U).flatten(1).all(1)
    return torch.where(finite, g, torch.full_like(g, math.inf))


def numbers(g: torch.Tensor, lane_bar: float) -> dict:
    g = torch.nan_to_num(g.double().cpu(), nan=math.inf)
    return {"lanes_off_pct": float(100.0 * (g > lane_bar).double().mean()),
            "gap_median": float(g.median())}


def record(X, U, J, it, ref) -> dict:
    """What is printed beside the numbers: the widest gap, the share of lanes
    whose iteration count differs and the median relative gap of J."""
    g = gaps(X, U, ref).cpu()
    dj = ((J.double() - ref.J.double()).abs() / ref.J.double().abs().clamp(min=1.0)).cpu()
    q = torch.quantile(torch.nan_to_num(g.double(), posinf=1e30), torch.tensor([0.9, 0.99], dtype=torch.float64))
    return {"gap_max": float(g.max()), "gap_q90": float(q[0]), "gap_q99": float(q[1]),
            "iterations_differ_pct": float(100.0 * (it.cpu().long() != ref.iterations.cpu().long())
                                           .double().mean()),
            "J_rel_median": float(dj.median()),
            "lanes": int(g.numel())}


def checks(values: dict, limits: dict) -> list:
    return [{"name": k, "value": v, "limit": limits.get(k)} for k, v in values.items()]
