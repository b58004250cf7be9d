"""Uncertainty propagation of the local costmap engine (the slice the
Monte-Carlo path uses).

Port of part of ``cilqr_tpu/ops/costmap.py``: the per-cell covariance terms
(``cell_sigma_rho``), the window sizing (``required_window_radius``) and the
semantics oracle of the propagation (``propagate_uncertainty_reference``).
The propagation kernel lives in ``ops/uncertainty_cuda.py``.

For every cell i the propagated occupancy is
``u_i = sum_j f_ij p_j / sum_j f_ij`` over the cells j inside the 95%
ellipse of cell i's covariance and inside the map, with f the correlated 2D
Gaussian (``ARBIT.cuh:103-107``); the data-dependent EllipseIterator becomes
a fixed (2R+1)^2 offset scan with the analytic inside test
``d^T cov^-1 d <= chi^2``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from cilqr_tpu.utils.params import CostmapParams
from cilqr_tpu_torch.ops import gridmap


def cell_sigma_rho(cp: CostmapParams, xs: torch.Tensor, ys: torch.Tensor, ego_yaw,
                   faithful: bool = False, sigmas=None):
    """Per-cell propagated covariance terms (sigma_x_i, sigma_y_i, rho),
    (..., rows, cols) (``uncertainty_error_functor``, ARBIT.cuh:51-69).

    xs (..., rows) and ys (..., cols) are the cell-center coordinates
    (``gridmap.cell_positions``).  ``ego_yaw`` and each of ``sigmas``
    (sigma_x, sigma_y, sigma_theta; default: the configured ones) are
    numbers or tensors that broadcast against (..., rows, cols), e.g.
    (B, 1, 1) for one map per scenario.

    Default (map frame): the lever of the pose's theta uncertainty is
    R(-yaw) g_g = (-Cy, Cx), yaw-free, and the translational diagonal is
    rotated into the map frame in the delta form d = sx^2 - sy^2 (exact for
    anisotropic sigmas, bit-identical to the isotropic form when d == 0).
    ``faithful=True`` reproduces the reference formula: the global-frame
    lever and its cross-term sign defect, which makes |rho| exceed 1 at some
    yaws; callers keep the prior on such cells.  See the JAX docstring for
    the derivation.
    """
    Cx = xs[..., :, None]
    Cy = ys[..., None, :]
    yaw = torch.as_tensor(ego_yaw, dtype=Cx.dtype, device=Cx.device)
    if faithful:
        s, c = torch.sin(yaw), torch.cos(yaw)
        g1 = -s * Cx - c * Cy
        g2 = c * Cx - s * Cy
        t = s * c * (Cx * Cx - Cy * Cy) + Cx * Cy * (s * s - c * c)
    else:
        g1 = -Cy + 0.0 * Cx  # broadcast to (..., rows, cols)
        g2 = Cx + 0.0 * Cy
        t = g1 * g2
    u = g1 * g1
    v = g2 * g2
    if sigmas is None:
        s_x, s_y, s_t = cp.sigma_x, cp.sigma_y, cp.sigma_theta
    else:
        s_x, s_y, s_t = sigmas
    if faithful:
        dxx = dyy = dxy = 0.0  # reference form: unrotated diag
    else:
        sin_y, cos_y = torch.sin(yaw), torch.cos(yaw)
        d = s_x**2 - s_y**2
        dxx = -d * sin_y * sin_y
        dyy = d * sin_y * sin_y
        dxy = -d * sin_y * cos_y
    sx = torch.sqrt(s_x**2 + dxx + s_t**2 * u)
    sy = torch.sqrt(s_y**2 + dyy + s_t**2 * v)
    rho = (dxy + s_t**2 * t) / (sx * sy)
    return sx, sy, rho


def required_window_radius(cp: CostmapParams, rows: int, cols: int, center=(None, None),
                           sigmas=None) -> int:
    """Smallest half-window (cells) covering the worst-case 95% ellipse:
    half_major = chi sqrt(lambda_max(cov)) <= chi sqrt(sigma_x^2 + sigma_y^2
    + sigma_theta^2 |corner|^2).  ``center`` defaults to the configured
    (x_position - 5, y_position); ``sigmas`` to the configured sigmas (pass
    the sampling upper bound for Monte-Carlo)."""
    cx = center[0] if center[0] is not None else cp.x_position - 5.0
    cy = center[1] if center[1] is not None else cp.y_position
    s_x, s_y, s_t = sigmas if sigmas is not None else (cp.sigma_x, cp.sigma_y, cp.sigma_theta)
    res = cp.resolution
    corner = math.hypot(rows * res / 2 + abs(cx), cols * res / 2 + abs(cy))
    a_plus_c = s_x**2 + s_y**2 + s_t**2 * corner**2
    half_major = cp.chisquare_val * math.sqrt(a_plus_c)
    return max(1, math.ceil(half_major / res))


def offset_distance(offset: int, res: float, dtype: torch.dtype) -> float:
    """-offset * res rounded as the JAX code rounds it in ``dtype``: the
    offset and the resolution are each cast to ``dtype`` and multiplied
    there (float32 arithmetic for a float32 map)."""
    npt = np.float32 if dtype == torch.float32 else np.float64
    return float(npt(-offset) * npt(res))


def propagate_uncertainty_reference(cp: CostmapParams, prior: torch.Tensor,
                                    geom: gridmap.GridGeom, ego_yaw,
                                    faithful_rho: bool = False, sigmas=None) -> torch.Tensor:
    """Plain PyTorch uncertainty propagation: the semantics oracle of the
    propagation kernel (division ``dx / sx``, row-major offset loop, full
    (2R+1)^2 window of ``cp.window_radius``).

    prior (rows, cols); ``sigmas`` as in ``cell_sigma_rho``: shaped
    (B, 1, 1) they give one map per draw, (B, rows, cols).  Cells whose
    covariance is not PSD (reachable with ``faithful_rho=True``) or whose
    weights are all zero keep the prior; the rest are clipped to [0, 100].
    """
    rows, cols = prior.shape[-2:]
    dtype = prior.dtype
    R = cp.window_radius
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    sx, sy, rho = cell_sigma_rho(cp, xs, ys, ego_yaw, faithful=faithful_rho, sigmas=sigmas)
    sx, sy, rho = sx.to(dtype), sy.to(dtype), rho.to(dtype)

    psd = rho.abs() < 1.0
    rho = torch.where(psd, rho, torch.zeros_like(rho))
    one_m_rho2 = 1.0 - rho * rho
    inv_det2 = 1.0 / (2.0 * one_m_rho2)
    # the Gaussian normalizer depends only on the output cell: it cancels
    chi2 = cp.chisquare_val**2
    thresh = chi2 * one_m_rho2
    two_rho = rho + rho

    # neighbour j at index offset (di, dj) sits at position offset
    # (-di*res, -dj*res) (indices grow against position)
    prior_pad = F.pad(prior, (R, R, R, R))
    valid_pad = F.pad(torch.ones_like(prior), (R, R, R, R))
    kw = dict(dtype=dtype, device=prior.device)
    num = torch.zeros(torch.broadcast_shapes(sx.shape, prior.shape), **kw)
    den = torch.zeros_like(num)
    W = 2 * R + 1
    for k in range(W * W):
        di = k // W - R
        dj = k % W - R
        dx = torch.tensor(offset_distance(di, cp.resolution, dtype), **kw)
        dy = torch.tensor(offset_distance(dj, cp.resolution, dtype), **kw)
        p_j = prior_pad[..., di + R: di + R + rows, dj + R: dj + R + cols]
        v_j = valid_pad[..., di + R: di + R + rows, dj + R: dj + R + cols]
        zx = dx / sx
        zy = dy / sy
        q = (zx - two_rho * zy) * zx + zy * zy
        f = torch.exp(-q * inv_det2)
        w = torch.where((q <= thresh) & (v_j > 0), f, torch.zeros_like(f))
        num = num + w * p_j
        den = den + w
    return torch.where(psd & (den > 0), (num / den).clamp(0.0, 100.0), prior)
