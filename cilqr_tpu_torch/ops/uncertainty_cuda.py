"""Batched uncertainty propagation: CUDA kernel K4.

Port of ``cilqr_tpu/ops/uncertainty_pallas.py``.  Its three TPU kernels
(``_kernel``, ``_kernel_band``, ``_kernel_bands_fused``) share one body;
here one CUDA kernel (``csrc/uncertainty.cu``) serves all three entry
points, with the row bands' radii and disc cuts passed as data:

  propagate_uncertainty            one map (the single-map kernel)
  propagate_uncertainty_batched    B maps over one full-window band
  propagate_uncertainty_banded     B maps over a ``BandPlan``'s row bands

For CUDA tensors (float32) the three entry points launch the kernel in its
fused form: the per-cell covariance fields are computed in the kernel from
a table of 12 floats per scenario (``scenario_table``), so no
(B, rows, cols) field tensor exists.  For CPU tensors they take the plain
version (``propagate_fused_plain``: ``prep_fields``, plain PyTorch as the
fields are XLA in the JAX package, then ``propagate_banded_plain``, any
float dtype).  ``propagate_banded`` is the same kernel reading given
fields.  A cell scans the box of its own 95% ellipse and, per column,
the interval of rows that can lie inside it (``scanned_offsets``), within
its band's window.  Every entry point reaches the kernel, or on the CPU its
plain version, through the op ``cilqr_torch::propagate`` (``_propagate_op``:
tensors in, a new tensor out), so a stream planner and a CUDA graph see
the launch as one op.

The band planner (``BandPlan``, ``make_band_plan``,
``make_band_plan_bounds``) is the JAX package's numpy logic.  Not ported:
the Mosaic-only static-unroll ceiling, the aligned-group row loop and the
unfused per-band launches (``fuse_bands=False``); the band plan's "auto"
count is therefore always 8-row bands, where the JAX planner falls back to
4 bands above its unroll ceiling (windows wider than 63 cells).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import sys
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import CostmapParams
from cilqr_tpu_torch.ops import costmap as costmap_mod
from cilqr_tpu_torch.ops import gridmap, riccati_cuda

LAUNCHES = 0  # propagation-kernel launches made by this module's wrappers
graphs.COUNTERS.append((sys.modules[__name__], "LAUNCHES"))
FIELD_LAUNCHES = 0  # launches of the fields-only kernel (``fields_on_card``)
TABLE_FLOATS = 12  # per-scenario floats of ``scenario_table`` (csrc/uncertainty.cu)
TILE_ROWS = 8  # rows of the prior tile a block stages (kTileRows)
MAX_SHARED_BYTES = 232448  # shared memory one block can use on an H100
RANGE_MIN_DET = 1.0 / 65536.0  # a cell's scan is cut to its ellipse where 1 - rho^2 >= this
RANGE_SLACK = 1e-3  # float32 rounding allowance of the inside test in the scan's bounds
CELL_MARGIN = 0.01  # cells added to a scan bound before it is floored


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
                           disc_radii=None, scanned=None) -> torch.Tensor:
    """Plain version of the kernel: the Pallas accumulation in PyTorch, band
    by band, column offset outer and row offset inner, with reciprocals
    1/sx, 1/sy, the band radii and the disc cut.

    prior (rows, cols) shared or (B, rows, cols) per scenario; fields
    (sx, sy, rho, psd) from ``prep_fields``.  ``scanned`` (dio, djo) ->
    bool (B, rows, cols) (``scanned_offsets``) drops the offsets that the
    kernel does not visit; the result keeps its bits.  Returns
    (B, rows, cols)."""
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
                if scanned is not None:
                    in_map = in_map & scanned(dio, djo)[:, sl]
                zx = dx * inv_sx[:, sl]
                q = (zx - t2) * zx + zy2
                f = torch.exp(-q * inv_det2[:, sl])
                w = torch.where((q <= thresh[:, sl]) & in_map, f, torch.zeros_like(f))
                num = num + w * p_j
                den = den + w
        good = (psd[:, sl] > 0.0) & (den > 0.0)
        out[:, sl] = torch.where(good, (num / den).clamp(0.0, 100.0), prior_b[:, sl])
    return out


def _scan_terms(cp: CostmapParams, fields):
    """The float32 terms the kernel's scan bounds are made of, by its own
    operations: (ranged, reach, rows_per_z, cols_per_z, 1 - rho^2)."""
    sx, sy, rho, _ = (t.float() for t in fields)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=sx.device)
    one_m_rho2 = 1.0 - rho * rho
    inv_det2 = torch.reciprocal(2.0 * one_m_rho2)
    reach = torch.sqrt(f32(cp.chisquare_val**2) + f32(2.0 * np.float32(RANGE_SLACK)) * inv_det2)
    inv_res = f32(1.0 / cp.resolution)
    return one_m_rho2 >= RANGE_MIN_DET, reach, sx * inv_res, sy * inv_res, one_m_rho2


def cell_half_extents(cp: CostmapParams, fields, cap: int):
    """(hi, hj), int32 (B, rows, cols): the half extents in rows and columns
    of the box that the kernel scans around each cell, by the kernel's
    formula in float32: min(cap, floor(reach s / res + CELL_MARGIN)) with reach =
    sqrt(chi^2 + RANGE_SLACK / (1 - rho^2)), s = sx for rows and sy for
    columns, and ``cap`` (the band radius) where 1 - rho^2 <
    ``RANGE_MIN_DET``.  No offset with q <= thresh lies outside it
    (csrc/uncertainty.cu, design step a)."""
    ranged, reach, rows_per_z, cols_per_z, _ = _scan_terms(cp, fields)
    ext = lambda per_z: torch.where(
        ranged, torch.clamp(torch.floor(reach * per_z + np.float32(CELL_MARGIN)),
                            max=float(cap)),
        torch.full_like(per_z, float(cap))).to(torch.int32)
    return ext(rows_per_z), ext(cols_per_z)


def scanned_offsets(cp: CostmapParams, fields, cap: torch.Tensor):
    """The offsets the kernel visits, by its own float32 formulas: a
    function (dio, djo) -> bool (B, rows, cols), true where the offset lies
    in the cell's box (``cell_half_extents``, inside the band radius
    ``cap`` (B, rows, cols) or broadcastable) and in the column's interval
    of rows: those with (zx - rho zy)^2 <= (1 - rho^2)(chi^2 - zy^2) +
    ``RANGE_SLACK``, each bound widened by ``CELL_MARGIN``.  Where 1 - rho^2 <
    ``RANGE_MIN_DET`` it is the whole window of ``cap``.  No offset with
    q <= thresh lies outside (csrc/uncertainty.cu, design step a).  The
    kernel's square root of the interval's half width is good to ~3 ulps
    where this one is exact: a millionth of the slack."""
    _, sy, rho, _ = (t.float() for t in fields)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=sy.device)
    hi, hj = (torch.minimum(h, cap) for h in cell_half_extents(cp, fields, int(cap.max())))
    ranged, _, rows_per_z, _, one_m_rho2 = _scan_terms(cp, fields)
    inv_sy = torch.reciprocal(sy)
    chi2 = f32(cp.chisquare_val**2)

    def scanned(dio: int, djo: int) -> torch.Tensor:
        zy = f32(abs(djo) * cp.resolution) * inv_sy * (-1.0 if djo > 0 else 1.0)
        h2 = one_m_rho2 * (chi2 - zy * zy) + f32(RANGE_SLACK)
        h = torch.sqrt(h2.clamp(min=0.0))
        cz = rho * zy
        lo = -torch.floor((cz + h) * rows_per_z + f32(CELL_MARGIN))
        up = torch.floor((h - cz) * rows_per_z + f32(CELL_MARGIN))
        in_range = (h2 >= 0.0) & (lo <= dio) & (dio <= up)
        return (abs(dio) <= hi) & (abs(djo) <= hj) & (in_range | ~ranged)

    return scanned


def scenario_table(cp: CostmapParams, geom: gridmap.GridGeom, ego_yaw, sigmas,
                   faithful_rho: bool) -> torch.Tensor:
    """(B, TABLE_FLOATS) float32: what the kernel needs per scenario to form
    a cell's covariance fields: [first_x, first_y, res, s, c, sc, ssmcc, a,
    b, dxy, st2, 0] (``gridmap.first_position``, ``costmap.sigma_rho_terms``),
    by the expressions of ``prep_fields`` on (B,)-sized tensors, so that
    every term has the bits it has there.  geom, ego_yaw and sigmas as in
    ``prep_fields``; the geometry must be float32."""
    first = gridmap.first_position(geom)
    kw = dict(dtype=first.dtype, device=first.device)
    yaw = torch.as_tensor(ego_yaw, **kw).reshape(-1)
    sig = None if sigmas is None else tuple(
        s.reshape(-1) for s in torch.as_tensor(sigmas, **kw).unbind(-1))
    terms = costmap_mod.sigma_rho_terms(cp, yaw, faithful_rho, sig)
    columns = [first[..., 0], first[..., 1], geom.resolution,
               *(0.0 if t is None else t for t in terms), 0.0]
    # a number becomes a filled tensor: a copy from the host cannot be captured
    columns = [(t.to(torch.float32) if isinstance(t, torch.Tensor)
                else torch.full((), t, dtype=torch.float32, device=first.device)).reshape(-1)
               for t in columns]
    B = max(t.numel() for t in columns)
    return torch.stack([t.expand(B) for t in columns], dim=1).contiguous()


def fields_from_table(table: torch.Tensor, rows: int, cols: int, faithful_rho: bool):
    """Plain version of the kernel's ``cell_fields``: (sx, sy, rho, psd),
    each (B, rows, cols) float32, from a ``scenario_table``."""
    col = lambda k: table[:, k].reshape(-1, 1, 1)
    ar = lambda n: torch.arange(n, dtype=table.dtype, device=table.device)
    Cx = (col(0) - col(2) * ar(rows).reshape(1, rows, 1))
    Cy = (col(1) - col(2) * ar(cols).reshape(1, 1, cols))
    sx, sy, rho = costmap_mod.sigma_rho_cells(Cx, Cy, tuple(col(k) for k in range(3, 11)),
                                              faithful_rho)
    sx, sy, rho = torch.broadcast_tensors(sx, sy, rho)
    psd = (rho.abs() < 1.0).to(table.dtype)
    rho = torch.where(psd > 0, rho, torch.zeros_like(rho))
    return sx.contiguous(), sy.contiguous(), rho.contiguous(), psd.contiguous()


@functools.lru_cache(maxsize=None)  # kept: a CUDA graph may read them
def _row_table(bands: tuple, disc_radii: tuple | None, rows: int, res: float, device: str):
    """(int32 (rows, r_max + 2) on ``device``, float32 (r_max + 1,), r_max):
    per row its band's radius R, then for |dj| = 0..r_max the row half
    extent m that the disc cut leaves in that column (min(R,
    floor(sqrt(r_disc^2 - dj^2))); R without a disc cut; -1 where the column
    lies outside the disc or the band's window); and |dj| * res, formed in
    float64 and rounded once."""
    disc_radii = disc_radii or (None,) * len(bands)
    r_max = max(R for (_, _, R) in bands)
    tab = np.full((rows, r_max + 2), -1, np.int32)
    for (r0, br, R), r_disc in zip(bands, disc_radii):
        tab[r0:r0 + br, 0] = R
        rd2 = None if r_disc is None else float(r_disc) * float(r_disc)
        for dj in range(R + 1):
            if rd2 is None:
                tab[r0:r0 + br, 1 + dj] = R
            elif dj * dj <= rd2:
                tab[r0:r0 + br, 1 + dj] = min(R, int(math.floor(math.sqrt(rd2 - dj * dj))))
    dy = (np.arange(r_max + 1) * float(res)).astype(np.float32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(dy).to(device), r_max


def _run_kernel(cp: CostmapParams, prior: torch.Tensor, B: int, bands, disc_radii,
                fields=None, table=None, faithful_rho: bool = False) -> torch.Tensor:
    """One launch of the propagation kernel, on given fields or on a
    ``scenario_table`` (the fused form)."""
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    rows, cols = prior.shape[-2:]
    if B < 1:
        raise ValueError("empty batch")
    if prior.ndim == 2:
        riccati_cuda.check_cuda_f32("prior", prior, (rows, cols))
        stride = 0
    else:
        riccati_cuda.check_cuda_f32("prior", prior, (B, rows, cols))
        stride = rows * cols
    prior = prior.contiguous()
    if table is None:
        for name, t in zip(("sx", "sy", "rho", "psd"), fields):
            riccati_cuda.check_cuda_f32(name, t, (B, rows, cols))
        fields = [t.contiguous() for t in fields]
        field_ptrs = [t.data_ptr() for t in fields]
    else:
        riccati_cuda.check_cuda_f32("scenario table", table, (B, TABLE_FLOATS))
        field_ptrs = [None] * 4
    row_tab, dy_tab, r_max = _row_table(
        tuple(bands), None if disc_radii is None else tuple(disc_radii), rows,
        float(cp.resolution), str(prior.device))
    if (TILE_ROWS + 2 * r_max) * cols * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"a tile of {TILE_ROWS} rows with a halo of {r_max} over {cols} columns "
                         f"does not fit the kernel's {MAX_SHARED_BYTES} bytes of shared memory")
    out = torch.empty((B, rows, cols), dtype=torch.float32, device=prior.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(prior.device).cuda_stream
    with torch.cuda.device(prior.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_propagate(
            B, rows, cols, r_max, int(table is not None), int(faithful_rho),
            float(np.float32(cp.resolution)), float(np.float32(1.0 / cp.resolution)),
            float(np.float32(cp.chisquare_val**2)),
            prior.data_ptr(), stride, None if table is None else table.data_ptr(), *field_ptrs,
            row_tab.data_ptr(), dy_tab.data_ptr(), out.data_ptr(), stream)
    build.check(lib, rc, "propagation kernel launch")
    LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=64)
def _config_arg(cp: CostmapParams, bands: tuple, disc_radii) -> str:
    """The op's ``config`` argument: the costmap parameters, the bands and
    their disc radii as JSON (floats written by ``repr``, so they read back
    exactly)."""
    return json.dumps([dataclasses.asdict(cp), [list(b) for b in bands],
                       None if disc_radii is None else list(disc_radii)], sort_keys=True)


@functools.lru_cache(maxsize=64)
def _config_of(arg: str) -> tuple:
    """(cp, bands, disc_radii) of an op's ``config`` argument."""
    cp, bands, disc = json.loads(arg)
    return (CostmapParams(**cp), tuple(tuple(b) for b in bands),
            None if disc is None else tuple(disc))


@torch.library.custom_op(
    "cilqr_torch::propagate", mutates_args=(), device_types="cpu",
    schema="(str config, Tensor prior, Tensor[] fields, Tensor[] geom, Tensor? ego_yaw, "
           "Tensor? sigmas, bool faithful_rho, int B) -> Tensor")
def _propagate_op(config, prior, fields, geom, ego_yaw, sigmas, faithful_rho, B):
    """K4 as an op -> (B, rows, cols): on given ``fields`` (sx, sy, rho, psd),
    or fused (none given: the fields of ``geom``'s fields, ``ego_yaw`` and
    ``sigmas``, formed per cell).  On the CPU the plain version; on the card
    the kernel (``_propagate_kernel``)."""
    cp, bands, disc_radii = _config_of(config)
    if fields:
        return propagate_banded_plain(cp, prior, fields, bands, disc_radii)
    return propagate_fused_plain(cp, prior, gridmap.GridGeom(*geom), ego_yaw, sigmas,
                                 faithful_rho, bands, disc_radii)


@_propagate_op.register_fake
def _propagate_fake(config, prior, fields, geom, ego_yaw, sigmas, faithful_rho, B):
    dtype = (torch.float32 if prior.device.type != "cpu" else
             fields[0].dtype if fields else prior.dtype)
    return prior.new_empty((B,) + tuple(prior.shape[-2:]), dtype=dtype)


@_propagate_op.register_kernel("cuda")
def _propagate_kernel(config, prior, fields, geom, ego_yaw, sigmas, faithful_rho, B):
    """The op on the card: one launch of the kernel on the current stream,
    reading the fields or (fused) a ``scenario_table``."""
    cp, bands, disc_radii = _config_of(config)
    if fields:
        return _run_kernel(cp, prior, B, bands, disc_radii, fields=fields)
    table = scenario_table(cp, gridmap.GridGeom(*geom), ego_yaw, sigmas, faithful_rho)
    if table.shape[0] != B:
        table = table.expand(B, TABLE_FLOATS).contiguous()
    return _run_kernel(cp, prior, B, bands, disc_radii, table=table, faithful_rho=faithful_rho)


def _as_tensor(x, device):
    """A number or sequence as a float64 tensor on ``device`` (a tensor as
    it is): rounded later to the working dtype, its bits are those of the
    number rounded there."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float64, device=device)


def _op(cp: CostmapParams, prior: torch.Tensor, bands, disc_radii, fields=(), geom=None,
        ego_yaw=None, sigmas=None, faithful_rho: bool = False) -> torch.Tensor:
    """K4's op: on ``fields``, or fused on (geom, ego_yaw, sigmas)."""
    if fields:
        B = fields[0].shape[0]
    else:
        ego_yaw, sigmas = _as_tensor(ego_yaw, prior.device), _as_tensor(sigmas, prior.device)
        B = max(geom.center.reshape(-1, 2).shape[0], geom.resolution.numel(), ego_yaw.numel(),
                1 if sigmas is None else sigmas.reshape(-1, 3).shape[0])
        if prior.ndim == 3:
            B = max(B, prior.shape[0])
    return torch.ops.cilqr_torch.propagate(
        _config_arg(cp, bands, disc_radii), prior, list(fields),
        [] if geom is None else list(geom), ego_yaw, sigmas, faithful_rho, B)


def _launch(cp: CostmapParams, prior: torch.Tensor, fields, bands, disc_radii):
    return _op(cp, prior, bands, disc_radii, fields=fields)


def _launch_fused(cp: CostmapParams, prior: torch.Tensor, geom: gridmap.GridGeom, ego_yaw,
                  sigmas, faithful_rho: bool, bands, disc_radii):
    riccati_cuda.check_cuda_f32("geometry center", geom.center, tuple(geom.center.shape))
    return _op(cp, prior, bands, disc_radii, geom=geom, ego_yaw=ego_yaw, sigmas=sigmas,
               faithful_rho=faithful_rho)


def fields_on_card(cp: CostmapParams, geom: gridmap.GridGeom, ego_yaw, sigmas,
                   faithful_rho: bool, rows: int, cols: int):
    """(sx, sy, rho, psd), each (B, rows, cols) float32, written by the
    kernel's own ``cell_fields``: what the fused form computes per cell and
    never stores.  Only for holding it to ``prep_fields`` bit for bit."""
    global FIELD_LAUNCHES
    from cilqr_tpu_torch.utils import build

    riccati_cuda.check_cuda_f32("geometry center", geom.center, tuple(geom.center.shape))
    table = scenario_table(cp, geom, ego_yaw, sigmas, faithful_rho)
    B = table.shape[0]
    out = [torch.empty((B, rows, cols), dtype=torch.float32, device=table.device)
           for _ in range(4)]
    lib = build.load_library()
    with torch.cuda.device(table.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_fields(B, rows, cols, int(faithful_rho), table.data_ptr(),
                              *(t.data_ptr() for t in out),
                              torch.cuda.current_stream(table.device).cuda_stream)
    build.check(lib, rc, "fields kernel launch")
    FIELD_LAUNCHES += 1
    return tuple(out)


def propagate_banded(cp: CostmapParams, prior: torch.Tensor, fields, bands,
                     disc_radii=None) -> torch.Tensor:
    """(B, rows, cols) propagated maps from the fields of ``prep_fields``:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if prior.device.type == "cpu":
        return _op(cp, prior, bands, disc_radii, fields=fields)
    return _launch(cp, prior, fields, bands, disc_radii)


def propagate_fused_plain(cp: CostmapParams, prior: torch.Tensor, geom: gridmap.GridGeom,
                          ego_yaw, sigmas, faithful_rho: bool, bands, disc_radii):
    """Plain version of the fused form: the PyTorch fields, then the plain
    accumulation, in the prior's dtype on the CPU and float32 on the card."""
    fields = prep_fields(cp, geom, ego_yaw, sigmas, faithful_rho, *prior.shape[-2:],
                         _kernel_dtype(prior))
    return propagate_banded_plain(cp, prior, fields, bands, disc_radii)


def _propagate(cp: CostmapParams, prior: torch.Tensor, geom, ego_yaw, sigmas,
               faithful_rho: bool, bands, disc_radii) -> torch.Tensor:
    """The fused kernel for CUDA tensors, the plain version for CPU tensors."""
    if prior.device.type == "cpu":
        return _op(cp, prior, bands, disc_radii, geom=geom, ego_yaw=ego_yaw, sigmas=sigmas,
                   faithful_rho=faithful_rho)
    return _launch_fused(cp, prior, geom, ego_yaw, sigmas, faithful_rho, bands, disc_radii)


def propagate_uncertainty(cp: CostmapParams, prior: torch.Tensor, geom: gridmap.GridGeom,
                          ego_yaw, faithful_rho: bool = False, sigmas=None) -> torch.Tensor:
    """One map: the fast path of ``costmap.propagate_uncertainty_reference``
    (full window of ``cp.window_radius``).  ``sigmas`` (3,) overrides the
    configured (sigma_x, sigma_y, sigma_theta)."""
    plan = full_window_plan(cp, prior.shape[0])
    return _propagate(cp, prior, geom, ego_yaw, sigmas, faithful_rho, plan.bands,
                      None)[0].to(prior.dtype)


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
    rows = prior.shape[-2]
    bands = band_plan.bands if isinstance(band_plan, BandPlan) else tuple(band_plan)
    disc_radii = band_plan.disc_radii if isinstance(band_plan, BandPlan) else None
    check_band_plan(bands, rows)
    batched = (geom.center.ndim == 2 or torch.as_tensor(ego_yaw).ndim == 1
               or sigmas is not None)
    if not batched:
        raise ValueError("no batched input among (geom, ego_yaw, sigmas)")
    return _propagate(cp, prior, geom, ego_yaw, sigmas, faithful_rho, bands,
                      disc_radii).to(prior.dtype)


def _kernel_dtype(prior: torch.Tensor) -> torch.dtype:
    """The kernel computes in float32; the plain version in the prior's dtype."""
    return prior.dtype if prior.device.type == "cpu" else torch.float32


graphs.LAUNCHERS.extend([(sys.modules[__name__], "_launch", _launch),
                         (sys.modules[__name__], "_launch_fused", _launch_fused)])
