"""DBSCAN point clustering.

Port of ``cilqr_tpu/ops/dbscan.py``: density clustering of 2-D points by
masked label propagation.  Core points have >= min_points neighbours within
eps (self included, as in canonical DBSCAN); labels propagate through the
core-to-core adjacency by min-label rounds until no label changes; border
points take the smallest label among their core neighbours; noise and
padding are -1.  Nothing on the planner's path calls it.
"""

from __future__ import annotations

import torch

_NONE = torch.iinfo(torch.int32).max


def dbscan(points: torch.Tensor, eps: float, mask=None, min_points: int = 3) -> torch.Tensor:
    """Cluster points (n, 2); mask (n,) marks the valid points (padding
    excluded).  Returns labels (n,) int32: each cluster is labelled by its
    smallest point index; -1 for noise and invalid points."""
    n = points.shape[0]
    dev = points.device
    mask = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else mask.to(torch.bool)

    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(dim=-1)
    adj = (d2 <= eps * eps) & mask[:, None] & mask[None, :]
    core = (adj.sum(dim=1) >= min_points) & mask
    core_adj = adj & core[:, None] & core[None, :]
    none = torch.full((n,), _NONE, dtype=torch.int32, device=dev)
    labels = torch.where(core, torch.arange(n, dtype=torch.int32, device=dev), none)
    while True:
        # min label over the core neighbours (label propagation on the core graph)
        neigh = torch.where(core_adj, labels[None, :], none[:, None]).amin(dim=1)
        new = torch.minimum(labels, neigh)
        if torch.equal(new, labels):
            break
        labels = new

    border = torch.where(adj & core[None, :], labels[None, :], none[:, None]).amin(dim=1)
    out = torch.where(core, labels, border)
    out = torch.where(out == _NONE, torch.full_like(out, -1), out)
    return torch.where(mask, out, torch.full_like(out, -1))
