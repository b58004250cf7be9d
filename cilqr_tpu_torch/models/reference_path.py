"""Reference-path layer: global-plan windowing + polynomial local plan.

Reference semantics: ``LocalPlanner.cpp`` and the densified closest-point
lookup at ``Constraints.cpp:24-59``; the port of
``cilqr_tpu/models/reference_path.py``.  Functions take a leading batch of
ego states where the JAX code used ``vmap``:

* the degree-5 polynomial is fitted in a centered + scaled basis
  ``t = (x - x_mid) / x_scale`` (well conditioned in float32);
* the window fetch is a plain index gather;
* ``find_closest_points`` is a (N, n_samples) distance argmin in the
  window-local frame followed by an exact 3-candidate refine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.utils.params import SolverParams


class LocalPlan(NamedTuple):
    """Fitted local reference plan; every field may carry leading batch dims."""

    coeffs: torch.Tensor   # (..., poly_order+1) in the scaled basis
    x_mid: torch.Tensor    # (...) basis center
    x_scale: torch.Tensor  # (...) basis scale (>= tiny)
    x_wpts: torch.Tensor   # (..., num_of_local_wpts) window x (global frame)
    y_fit: torch.Tensor    # (..., num_of_local_wpts) polynomial at x_wpts
    # densified sample table used by find_closest_point (Constraints.cpp:28-42)
    sample_x: torch.Tensor   # (..., n_samples)
    sample_y: torch.Tensor   # (..., n_samples)
    # window-local channels of the table for the tournament argmin
    sample_xl: torch.Tensor  # (..., n_samples)
    sample_yl: torch.Tensor  # (..., n_samples)
    sample_r: torch.Tensor   # (..., n_samples) sample_xl^2 + sample_yl^2
    # table generator [x0r, dr, ox, oy, cph, sph, qx, qy]: sx = ox + cph*sxr
    # - sph*syr, sy = oy + sph*sxr + cph*syr with sxr_s = x0r + dr*s,
    # syr_s = poly(sxr_s); (qx, qy, cph, sph) is the query frame.  The LM
    # kernel regenerates the table from these (ops/lm_cuda).
    samp_frame: torch.Tensor  # (..., 8)


def closest_point_index(plan_xy: torch.Tensor, n_valid, point: torch.Tensor) -> torch.Tensor:
    """Index of the nearest global-plan point (LocalPlanner.cpp:25-41).

    plan_xy: (P, 2) padded plan; n_valid: number of real points (padding is
    masked out); point: (..., >=2) queries.  Returns (...,) int64; ties go to
    the earliest index.
    """
    d = ((plan_xy - point[..., None, :2]) ** 2).sum(dim=-1)  # (..., P)
    idx = torch.arange(plan_xy.shape[0], device=plan_xy.device)
    d = torch.where(idx < n_valid, d, torch.full_like(d, float("inf")))
    return torch.argmin(d, dim=-1)


def polyfit_scaled(x: torch.Tensor, y: torch.Tensor, order: int,
                   weights: torch.Tensor | None = None):
    """Least-squares polynomial fit in a centered/scaled basis, batched over
    leading dims of x, y (..., W).  Returns (coeffs ascending in t, mid, scale).

    The Gram matrix of the Vandermonde is a Hankel matrix of power sums
    s_m = sum_k w_k t_k^m, solved by an unrolled Cholesky.  ``weights``
    (per row >= 0) gives weighted least squares with a tiny ridge, for the
    exact end-of-plan window shrink.
    """
    x_mid = 0.5 * (x.amax(dim=-1) + x.amin(dim=-1))
    x_scale = (0.5 * (x.amax(dim=-1) - x.amin(dim=-1))).clamp(min=1e-6)
    t = (x - x_mid[..., None]) / x_scale[..., None]
    tp = [torch.ones_like(t)]  # t^0 .. t^(2*order), exact repeated multiply
    for _ in range(2 * order):
        tp.append(tp[-1] * t)
    if weights is not None:
        wsum = weights.sum(dim=-1).clamp(min=1.0)
        y_mid = (weights * y).sum(dim=-1) / wsum
        rsum = lambda a: (weights * a).sum(dim=-1)
        ridge = 1e-9
    else:
        y_mid = y.mean(dim=-1)
        rsum = lambda a: a.sum(dim=-1)
        ridge = 0.0
    y0 = y - y_mid[..., None]
    s = [rsum(tpm) for tpm in tp]
    G = torch.stack(
        [
            torch.stack([s[i + j] + (ridge if i == j else 0.0) for j in range(order + 1)], dim=-1)
            for i in range(order + 1)
        ],
        dim=-2,
    )
    b = torch.stack([rsum(y0 * tp[i]) for i in range(order + 1)], dim=-1)
    coeffs = _chol_solve(G, b)
    coeffs = torch.cat([coeffs[..., :1] + y_mid[..., None], coeffs[..., 1:]], dim=-1)
    return coeffs, x_mid, x_scale


def _chol_solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD G x = b (..., m, m) by an unrolled Cholesky (small static m)."""
    m = G.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s.clamp(min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    z = [None] * m
    for i in range(m):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    x = [None] * m
    for i in reversed(range(m)):
        s = z[i]
        for k in range(i + 1, m):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def polyval_scaled(coeffs, x_mid, x_scale, x):
    """Evaluate the scaled-basis polynomial at raw x (..., n) by Horner."""
    t = (x - x_mid[..., None]) / x_scale[..., None]
    r = torch.zeros_like(t)
    for i in reversed(range(coeffs.shape[-1])):
        r = r * t + coeffs[..., i, None]
    return r


def polyval_scaled_inv(coeffs, x_mid, inv_scale, x):
    """Horner with a precomputed reciprocal scale (the sample table's form,
    which the LM kernel reproduces op for op)."""
    t = (x - x_mid[..., None]) * inv_scale[..., None]
    r = torch.zeros_like(t)
    for i in reversed(range(coeffs.shape[-1])):
        r = r * t + coeffs[..., i, None]
    return r


def _local_channels(sx, sy, qx, qy, cph, sph):
    """Query-frame sample channels for the expanded-form distance tournament:
    d(p, s) = |p_l|^2 + r_s - 2 (x_l*sxl + y_l*syl) in a window-local frame
    keeps float32 rounding ~1e-4 m^2.  The LM kernel mirrors the order."""
    dx0 = sx - qx
    dy0 = sy - qy
    sxl = cph * dx0 + sph * dy0
    syl = cph * dy0 - sph * dx0
    r = sxl * sxl + syl * syl
    return sxl, syl, r


def get_local_plan(p: SolverParams, plan_xy: torch.Tensor, n_valid,
                   ego_state: torch.Tensor) -> LocalPlan:
    """Window the global plan at the ego pose(s) (..., 4) and fit the local
    polynomial (LocalPlanner.cpp:47-96).

    The window clamps at the end of the plan so trailing points repeat
    (identical while >= num_of_local_wpts points remain).  Also builds the
    closest-point sample table (Constraints.cpp:28-42) once per solve.
    """
    start = closest_point_index(plan_xy, n_valid, ego_state)  # (...)
    P, W = plan_xy.shape[0], p.num_of_local_wpts
    ar_w = torch.arange(W, device=plan_xy.device)
    fit_w = (
        ((start[..., None] + ar_w) < n_valid).to(plan_xy.dtype)
        if p.exact_end_shrink else None
    )
    plan_ext = torch.cat([plan_xy, plan_xy[-1:].expand(W, 2)], dim=0)  # (P+W, 2)
    w = plan_ext[start[..., None] + ar_w]  # (..., W, 2)
    x_w, y_w = w[..., 0], w[..., 1]
    n = p.n_closest_samples
    ar_n = torch.arange(n, dtype=plan_xy.dtype, device=plan_xy.device)

    if p.chord_frame_fit:
        # fit in the chord-aligned frame (a function for any road direction),
        # then rotate the waypoints and the sample table back
        x0w, y0w = x_w[..., 0], y_w[..., 0]
        cx, cyw = x_w[..., -1] - x0w, y_w[..., -1] - y0w
        chord = torch.sqrt(cx * cx + cyw * cyw)
        ok = chord > 1e-6
        cph = torch.where(ok, cx / chord.clamp(min=1e-6), torch.ones_like(cx))
        sph = torch.where(ok, cyw / chord.clamp(min=1e-6), torch.zeros_like(cx))
        dxw = x_w - x0w[..., None]
        dyw = y_w - y0w[..., None]
        xr = cph[..., None] * dxw + sph[..., None] * dyw
        yr = -sph[..., None] * dxw + cph[..., None] * dyw

        coeffs, x_mid, x_scale = polyfit_scaled(xr, yr, p.poly_order, weights=fit_w)
        yr_fit = polyval_scaled(coeffs, x_mid, x_scale, xr)
        gx_w = x0w[..., None] + cph[..., None] * xr - sph[..., None] * yr_fit
        gy_w = y0w[..., None] + sph[..., None] * xr + cph[..., None] * yr_fit

        dr = (xr[..., -1] - xr[..., 0]) / n
        sxr = xr[..., :1] + dr[..., None] * ar_n
        syr = polyval_scaled_inv(coeffs, x_mid, 1.0 / x_scale, sxr)
        sx = x0w[..., None] + cph[..., None] * sxr - sph[..., None] * syr
        sy = y0w[..., None] + sph[..., None] * sxr + cph[..., None] * syr
        sxl, syl, sr = _local_channels(sx, sy, x0w[..., None], y0w[..., None],
                                       cph[..., None], sph[..., None])
        frame = torch.stack([xr[..., 0], dr, x0w, y0w, cph, sph, x0w, y0w], dim=-1)
        return LocalPlan(coeffs, x_mid, x_scale, gx_w, gy_w, sx, sy,
                         sxl, syl, sr, frame)

    coeffs, x_mid, x_scale = polyfit_scaled(x_w, y_w, p.poly_order, weights=fit_w)
    y_fit = polyval_scaled(coeffs, x_mid, x_scale, x_w)

    dx = (x_w[..., -1] - x_w[..., 0]) / n
    sx = x_w[..., :1] + dx[..., None] * ar_n
    sy = polyval_scaled_inv(coeffs, x_mid, 1.0 / x_scale, sx)

    zero = torch.zeros_like(x_mid)
    one = torch.ones_like(x_mid)
    sxl, syl, sr = _local_channels(sx, sy, x_w[..., :1], y_w[..., :1], 1.0, 0.0)
    frame = torch.stack([x_w[..., 0], dx, zero, zero, one, zero, x_w[..., 0], y_w[..., 0]],
                        dim=-1)
    return LocalPlan(coeffs, x_mid, x_scale, x_w, y_fit, sx, sy, sxl, syl, sr, frame)


def find_closest_points(plan: LocalPlan, states: torch.Tensor) -> torch.Tensor:
    """Closest densified-sample point for each state (Constraints.cpp:24-59).

    states: (..., N, >=2) with the plan's leading dims.  Returns (..., N, 2).

    A tournament over the expanded local-frame form d_rel = r_s - 2 p_l.s_l
    selects j (first minimum wins); comparing {j-1, j, j+1} with the exact
    global (dx^2 + dy^2) restores the reference's argmin semantics for the
    generic near-tie.  The LM kernel uses the same expression order.
    """
    S = plan.sample_x.shape[-1]
    fr = plan.samp_frame[..., None, :]  # (..., 1, 8)
    qx, qy, cph, sph = fr[..., 6], fr[..., 7], fr[..., 4], fr[..., 5]
    dx0 = states[..., 0] - qx
    dy0 = states[..., 1] - qy
    xl = cph * dx0 + sph * dy0
    yl = cph * dy0 - sph * dx0
    n0 = -2.0 * xl
    n1 = -2.0 * yl
    d = (
        plan.sample_r[..., None, :] + n0[..., None] * plan.sample_xl[..., None, :]
    ) + n1[..., None] * plan.sample_yl[..., None, :]  # (..., N, S)
    j = torch.argmin(d, dim=-1)  # (..., N)

    cand = torch.stack([(j - 1).clamp(min=0), j, (j + 1).clamp(max=S - 1)], dim=-1)
    lead = cand.shape[:-2]
    flat = cand.reshape(*lead, -1)  # (..., N*3)
    px = torch.gather(plan.sample_x, -1, flat).reshape(cand.shape)
    py = torch.gather(plan.sample_y, -1, flat).reshape(cand.shape)
    dxg = states[..., 0:1] - px
    dyg = states[..., 1:2] - py
    dg = dxg * dxg + dyg * dyg  # (..., N, 3)

    # earliest-min merge (strict <, candidates in index order)
    bd, bx, by = dg[..., 0], px[..., 0], py[..., 0]
    for c in (1, 2):
        m = dg[..., c] < bd
        bd = torch.where(m, dg[..., c], bd)
        bx = torch.where(m, px[..., c], bx)
        by = torch.where(m, py[..., c], by)
    return torch.stack([bx, by], dim=-1)


def pad_global_plan(p: SolverParams, plan_xy, dtype=torch.float32, device=None):
    """Pad a (n, 2) waypoint array to the static (P, 2) shape + valid count.

    Padding repeats the final waypoint so out-of-range gathers stay sane.
    """
    device = resolve(device)
    plan_xy = torch.as_tensor(plan_xy, dtype=dtype, device=device)
    n = plan_xy.shape[0]
    P = p.max_global_plan_points
    if n > P:
        raise ValueError(f"global plan has {n} > max_global_plan_points={P} points")
    pad = plan_xy[-1:].expand(P - n, 2)
    return torch.cat([plan_xy, pad], dim=0), torch.tensor(n, dtype=torch.int32, device=device)
