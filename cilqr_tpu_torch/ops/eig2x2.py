"""Closed-form 2x2 symmetric eigendecomposition — the Q_uu regularizer.

The reference regularizes Q_uu per backward step with an Eigen solver
(iLQR.cpp:155-175): eigenvalues clamped at >= 0, shifted by lambda,
inverted and recomposed.  Q_uu is symmetric 2x2, so the analytic form
batches over (scenario x timestep) with no data-dependent control flow.
"""

from __future__ import annotations

import torch


def eigh2x2(M: torch.Tensor):
    """Eigenvalues/vectors of symmetric [[a, b], [b, c]] (batched ...x2x2).

    Returns (w (..., 2), V (..., 2, 2)) with the eigenvectors as the columns
    of V and w[..., 0] <= w[..., 1].
    """
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 1]
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    disc = torch.sqrt(half_diff * half_diff + b * b)
    w_lo = half_tr - disc
    w_hi = half_tr + disc

    # The degeneracy threshold is relative to the diagonal (the machine
    # epsilon of the dtype: 1.1920929e-07 in float32): an absolute cutoff
    # admits b values whose squares underflow, which NaNs the normalizer.
    scale = a.abs() + c.abs()
    eps = torch.finfo(M.dtype).eps
    safe = b.abs() > eps * scale
    a_ge = a >= c
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    vx = torch.where(safe, b, torch.where(a_ge, one, zero))
    vy = torch.where(safe, w_hi - a, torch.where(a_ge, zero, one))
    n = torch.sqrt(vx * vx + vy * vy)
    vx = vx / n
    vy = vy / n
    V = torch.stack(
        [torch.stack([-vy, vx], dim=-1), torch.stack([vx, vy], dim=-1)], dim=-1
    )  # columns: [v_lo, v_hi]
    w = torch.stack([w_lo, w_hi], dim=-1)
    return w, V


def regularized_inverse(M: torch.Tensor, lamb: torch.Tensor) -> torch.Tensor:
    """V diag(1 / (max(w, 0) + lamb)) V^T  (iLQR.cpp:164-175)."""
    w, V = eigh2x2(M)
    w_inv = 1.0 / (w.clamp(min=0.0) + lamb[..., None])
    return (V * w_inv[..., None, :]) @ V.transpose(-1, -2)
