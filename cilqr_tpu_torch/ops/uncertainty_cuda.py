"""Batched uncertainty propagation: CUDA kernel K4.

Port of ``cilqr_tpu/ops/uncertainty_pallas.py``.  Its three TPU kernels
(``_kernel``, ``_kernel_band``, ``_kernel_bands_fused``) share one body;
here one CUDA kernel (``csrc/uncertainty.cu``) serves all three entry
points, with the row bands' radii and disc cuts passed as data:

  propagate_uncertainty            one map (the single-map kernel)
  propagate_uncertainty_batched    B maps over one full-window band
  propagate_uncertainty_banded     B maps over a ``BandPlan``'s row bands

The per-cell covariance fields are plain PyTorch (``prep_fields``), as they
are XLA in the JAX package.  ``propagate_banded`` launches the kernel for
CUDA tensors (float32) and takes the plain version
(``propagate_banded_plain``, any float dtype) for CPU tensors.

The band planner (``BandPlan``, ``make_band_plan``,
``make_band_plan_bounds``) is the JAX package's numpy logic.  Not ported:
the Mosaic-only static-unroll ceiling, the aligned-group row loop and the
unfused per-band launches (``fuse_bands=False``); the band plan's "auto"
count is therefore always 8-row bands, where the JAX planner falls back to
4 bands above its unroll ceiling (windows wider than 63 cells).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cilqr_tpu_torch.utils.params import CostmapParams
from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.ops import gridmap, riccati_cuda

LAUNCHES = 0  # kernel launches made by this module's wrappers


class BandPlan(NamedTuple):
    """Static row-band decomposition for batched propagation.

    bands: ((row0, band_rows, radius), ...) contiguous from row 0;
    sigma_hi: the (sigma_x, sigma_y, sigma_theta) bound the radii cover
    (None for a plain full-map window); x_range / y_range: the map-frame
    center interval the radii cover; disc_radii: per-band float disc radii
    (cells) of the exact disc cut, or None for the full square window.
    """

    bands: tuple
    sigma_hi: tuple | None
    x_range: tuple | None = None
    y_range: tuple | None = None
    disc_radii: tuple | None = None


def make_band_plan(cp: CostmapParams, rows: int, cols: int, center, sigma_hi,
                   max_bands="auto") -> BandPlan:
    """Row bands with per-band window radii for one fixed map center: each
    band's radius is its own worst row's 95%-ellipse bound, so the
    accumulation shrinks near the ego, exactly (offsets beyond a cell's
    ellipse have w = 0)."""
    cx, cy = float(center[0]), float(center[1])
    return make_band_plan_bounds(cp, rows, cols, (cx, cx), (cy, cy), sigma_hi,
                                 max_bands=max_bands)


def make_band_plan_bounds(cp: CostmapParams, rows: int, cols: int, x_range, y_range,
                          sigma_hi, max_bands="auto") -> BandPlan:
    """``make_band_plan`` for an interval of map-frame centers: per band the
    lever arm is maximized over the intervals, so the plan is exact for
    every scenario whose center stays inside them.  ``max_bands="auto"``
    gives 8-row bands."""
    res = cp.resolution
    x_lo, x_hi = float(x_range[0]), float(x_range[1])
    y_lo, y_hi = float(y_range[0]), float(y_range[1])
    if x_lo > x_hi or y_lo > y_hi:
        raise ValueError(f"empty center range {x_range} x {y_range}")
    # row i cell x = center_x + off_i; worst |x| is at an interval endpoint
    off = 0.5 * rows * res - 0.5 * res - res * np.arange(rows)
    max_x = np.maximum(np.abs(x_lo + off), np.abs(x_hi + off))
    max_y = max(abs(y_lo), abs(y_hi)) + 0.5 * cols * res - 0.5 * res
    lever = np.hypot(max_x, max_y)
    s_x, s_y, s_t = sigma_hi
    need = np.ceil(
        cp.chisquare_val * np.sqrt(s_x * s_x + s_y * s_y + s_t * s_t * lever * lever) / res
    ).astype(int)
    need = np.maximum(need, 1)
    # exact disc radius: |d| <= chi sqrt(lambda_max), lambda_max <=
    # max(s_x, s_y)^2 + s_t^2 lever^2 (diagonal + rank-1 split)
    s_m = max(s_x, s_y)
    disc = cp.chisquare_val * np.sqrt(s_m * s_m + s_t * s_t * lever * lever) / res

    n_bands = max(1, rows // 8) if max_bands == "auto" else int(max_bands)
    n_b = min(n_bands, rows)
    bounds = np.linspace(0, rows, n_b + 1).astype(int)
    bands, radii = [], []
    for k in range(n_b):
        r0, r1 = int(bounds[k]), int(bounds[k + 1])
        if r1 > r0:
            bands.append((r0, r1 - r0, int(need[r0:r1].max())))
            radii.append(float(disc[r0:r1].max()))
    return BandPlan(tuple(bands), (float(s_x), float(s_y), float(s_t)),
                    (x_lo, x_hi), (y_lo, y_hi), tuple(radii))


def full_window_plan(cp: CostmapParams, rows: int) -> BandPlan:
    """One band of ``cp.window_radius`` over the whole map, no disc cut."""
    return BandPlan(((0, rows, cp.window_radius),), None)


def check_band_plan(bands, rows: int) -> None:
    """Raise unless the bands are contiguous from row 0 and cover ``rows``."""
    covered = 0
    for (r0, br, _) in bands:
        if r0 != covered:
            raise ValueError(f"band plan not contiguous at row {covered}: {bands}")
        covered += br
    if covered != rows:
        raise ValueError(f"band plan covers {covered} rows but the prior has {rows} — "
                         "stale plan for a different map shape")


def prep_fields(cp: CostmapParams, geom: gridmap.GridGeom, ego_yaw, sigmas, faithful_rho: bool,
                rows: int, cols: int, dtype=torch.float32):
    """Per-scenario covariance fields (sx, sy, rho, psd), each (B, rows, cols)
    in ``dtype`` (``uncertainty_pallas._prep_fields``).

    Any of geom (center (B, 2)), ego_yaw ((B,)) and sigmas ((B, 3); None:
    the configured sigmas) may carry the scenario axis; with none of them
    batched, B = 1.  rho is zeroed where the covariance is not PSD (psd = 0).
    """
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    xs, ys = xs.reshape(-1, rows), ys.reshape(-1, cols)
    yaw = torch.as_tensor(ego_yaw, dtype=xs.dtype, device=xs.device).reshape(-1, 1, 1)
    sig = None if sigmas is None else tuple(
        s.reshape(-1, 1, 1)
        for s in torch.as_tensor(sigmas, dtype=xs.dtype, device=xs.device).unbind(-1))
    sx, sy, rho = costmap_mod.cell_sigma_rho(cp, xs, ys, yaw, faithful=faithful_rho, sigmas=sig)
    sx, sy, rho = torch.broadcast_tensors(sx, sy, rho)
    psd = (rho.abs() < 1.0).to(dtype)
    rho = torch.where(psd > 0, rho, torch.zeros_like(rho))
    return tuple(t.to(dtype).contiguous() for t in (sx, sy, rho)) + (psd.contiguous(),)


def propagate_banded_plain(cp: CostmapParams, prior: torch.Tensor, fields, bands,
                           disc_radii=None) -> torch.Tensor:
    """Plain version of the kernel: the Pallas accumulation in PyTorch, band
    by band, column offset outer and row offset inner, with reciprocals
    1/sx, 1/sy, the band radii and the disc cut.

    prior (rows, cols) shared or (B, rows, cols) per scenario; fields
    (sx, sy, rho, psd) from ``prep_fields``.  Returns (B, rows, cols)."""
    sx, sy, rho, psd = fields
    B, rows, cols = sx.shape
    dtype, dev = sx.dtype, sx.device
    disc_radii = disc_radii or (None,) * len(bands)
    prior_b = prior.to(dtype).reshape(-1, rows, cols)
    P = max(R for (_, _, R) in bands)
    prior_pad = F.pad(prior_b, (P, P, P, P))
    inv_sx, inv_sy = torch.reciprocal(sx), torch.reciprocal(sy)
    two_rho = rho + rho
    one_m_rho2 = 1.0 - rho * rho
    inv_det2 = torch.reciprocal(2.0 * one_m_rho2)
    thresh = cp.chisquare_val**2 * one_m_rho2
    col_id = torch.arange(cols, device=dev)
    out = torch.empty((B, rows, cols), dtype=dtype, device=dev)
    for (r0, br, R), r_disc in zip(bands, disc_radii):
        sl = slice(r0, r0 + br)
        row_id = (torch.arange(br, device=dev) + r0)[:, None]
        rd2 = None if r_disc is None else float(r_disc) * float(r_disc)
        num = torch.zeros((B, br, cols), dtype=dtype, device=dev)
        den = torch.zeros_like(num)
        for djo in range(-R, R + 1):
            if rd2 is not None and djo * djo > rd2:
                continue
            m = R if rd2 is None else min(R, int(math.floor(math.sqrt(rd2 - djo * djo))))
            col_ok = (col_id + djo >= 0) & (col_id + djo < cols)
            zy = -djo * cp.resolution * inv_sy[:, sl]
            t2 = two_rho[:, sl] * zy
            zy2 = zy * zy
            for dio in range(-m, m + 1):
                dx = costmap_mod.offset_distance(dio, cp.resolution, dtype)
                p_j = prior_pad[:, P + r0 + dio: P + r0 + dio + br, P + djo: P + djo + cols]
                in_map = col_ok & (row_id + dio >= 0) & (row_id + dio < rows)
                zx = dx * inv_sx[:, sl]
                q = (zx - t2) * zx + zy2
                f = torch.exp(-q * inv_det2[:, sl])
                w = torch.where((q <= thresh[:, sl]) & in_map, f, torch.zeros_like(f))
                num = num + w * p_j
                den = den + w
        good = (psd[:, sl] > 0.0) & (den > 0.0)
        out[:, sl] = torch.where(good, (num / den).clamp(0.0, 100.0), prior_b[:, sl])
    return out


def _row_tables(bands, disc_radii, rows: int, device):
    """Per-row band radius (int32) and squared disc radius (float64, +inf
    where the band has no disc cut)."""
    disc_radii = disc_radii or (None,) * len(bands)
    row_R = np.zeros(rows, np.int32)
    row_rd2 = np.zeros(rows, np.float64)
    for (r0, br, R), r_disc in zip(bands, disc_radii):
        row_R[r0:r0 + br] = R
        row_rd2[r0:r0 + br] = math.inf if r_disc is None else float(r_disc) * float(r_disc)
    return torch.from_numpy(row_R).to(device), torch.from_numpy(row_rd2).to(device)


def _launch(cp: CostmapParams, prior: torch.Tensor, fields, bands, disc_radii):
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    sx, sy, rho, psd = fields
    B, rows, cols = sx.shape
    if B < 1:
        raise ValueError("empty batch")
    for name, t in (("sx", sx), ("sy", sy), ("rho", rho), ("psd", psd)):
        riccati_cuda.check_cuda_f32(name, t, (B, rows, cols))
    if prior.ndim == 2:
        riccati_cuda.check_cuda_f32("prior", prior, (rows, cols))
        stride = 0
    else:
        riccati_cuda.check_cuda_f32("prior", prior, (B, rows, cols))
        stride = rows * cols
    prior = prior.contiguous()
    fields = [t.contiguous() for t in fields]
    row_R, row_rd2 = _row_tables(bands, disc_radii, rows, sx.device)
    out = torch.empty((B, rows, cols), dtype=torch.float32, device=sx.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(sx.device).cuda_stream
    rc = lib.cilqr_propagate(
        B, rows, cols, float(np.float32(cp.resolution)), float(cp.resolution),
        float(np.float32(cp.chisquare_val**2)), prior.data_ptr(), stride,
        *(t.data_ptr() for t in fields), row_R.data_ptr(), row_rd2.data_ptr(),
        out.data_ptr(), stream)
    build.check(lib, rc, "propagation kernel launch")
    LAUNCHES += 1
    return out


def propagate_banded(cp: CostmapParams, prior: torch.Tensor, fields, bands,
                     disc_radii=None) -> torch.Tensor:
    """(B, rows, cols) propagated maps from the fields of ``prep_fields``:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if prior.device.type == "cpu":
        return propagate_banded_plain(cp, prior, fields, bands, disc_radii)
    return _launch(cp, prior, fields, bands, disc_radii)


def propagate_uncertainty(cp: CostmapParams, prior: torch.Tensor, geom: gridmap.GridGeom,
                          ego_yaw, faithful_rho: bool = False, sigmas=None) -> torch.Tensor:
    """One map: the fast path of ``costmap.propagate_uncertainty_reference``
    (full window of ``cp.window_radius``).  ``sigmas`` (3,) overrides the
    configured (sigma_x, sigma_y, sigma_theta)."""
    rows, cols = prior.shape
    fields = prep_fields(cp, geom, ego_yaw, sigmas, faithful_rho, rows, cols,
                         _kernel_dtype(prior))
    plan = full_window_plan(cp, rows)
    return propagate_banded(cp, prior, fields, plan.bands)[0].to(prior.dtype)


def propagate_uncertainty_batched(cp: CostmapParams, prior: torch.Tensor,
                                  geom: gridmap.GridGeom, ego_yaw, sigmas: torch.Tensor,
                                  faithful_rho: bool = False) -> torch.Tensor:
    """Per-scenario sigmas (B, 3) over one shared prior, full window of
    ``cp.window_radius``: (B, rows, cols)."""
    return propagate_uncertainty_banded(cp, prior, geom, ego_yaw, sigmas,
                                        full_window_plan(cp, prior.shape[-2]), faithful_rho)


def propagate_uncertainty_banded(cp: CostmapParams, prior: torch.Tensor,
                                 geom: gridmap.GridGeom, ego_yaw, sigmas, band_plan,
                                 faithful_rho: bool = False) -> torch.Tensor:
    """B maps over the row bands of ``band_plan`` (a ``BandPlan`` or a
    tuple of (row0, rows, radius)).  Exact as long as the sampled sigmas
    stay within the plan's sigma_hi bound.

    prior (rows, cols) shared or (B, rows, cols) per scenario; geom, ego_yaw
    and sigmas as in ``prep_fields``, at least one of them batched."""
    rows, cols = prior.shape[-2:]
    bands = band_plan.bands if isinstance(band_plan, BandPlan) else tuple(band_plan)
    disc_radii = band_plan.disc_radii if isinstance(band_plan, BandPlan) else None
    check_band_plan(bands, rows)
    batched = (geom.center.ndim == 2 or torch.as_tensor(ego_yaw).ndim == 1
               or sigmas is not None)
    if not batched:
        raise ValueError("no batched input among (geom, ego_yaw, sigmas)")
    fields = prep_fields(cp, geom, ego_yaw, sigmas, faithful_rho, rows, cols,
                         _kernel_dtype(prior))
    return propagate_banded(cp, prior, fields, bands, disc_radii).to(prior.dtype)


def _kernel_dtype(prior: torch.Tensor) -> torch.dtype:
    """The kernel computes in float32; the plain version in the prior's dtype."""
    return prior.dtype if prior.device.type == "cpu" else torch.float32
