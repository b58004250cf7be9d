"""Costmap propagation (cilqr_tpu_torch/ops/costmap, uncertainty_cuda: kernel
K4) vs the JAX package.

The same float64 inputs, made with numpy from a seed, go through each JAX
function and its port: the covariance fields, the window sizing and the
propagation oracle at 1e-10 of scale (same algebra, float64 rounding), the
band planner exactly (the same numpy logic).  The kernel's plain version
(reciprocals, band radii, disc cut) is held to the vmapped JAX oracle at
1e-10 of scale in float64, where no offset sits on the ellipse boundary.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.ops import costmap as jcm, gridmap as jgrid, uncertainty_pallas as jup
from cilqr_tpu.utils.params import CostmapParams
from cilqr_tpu_torch.ops import costmap as tcm, gridmap as tgrid, uncertainty_cuda as tuc
from cilqr_tpu_torch.utils import interop

DEV = "cpu"  # the port allocates on the card unless told otherwise

REL = 1e-10
SIGMA_HI = (0.16, 0.16, 0.017)
CENTER = (10.0, 0.0)


def close(got, want, rel=REL):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(1.0, float(np.abs(w).max())))


@pytest.fixture(scope="module")
def world():
    """A 24x24 map at R=8 (tests/test_monte_carlo.py), both packages."""
    cp = dataclasses.replace(CostmapParams(), rows=24, cols=24, window_radius=8)
    rng = np.random.default_rng(41)
    prior = rng.uniform(0.0, 100.0, (24, 24))
    sig = np.concatenate([rng.uniform(0.02, 0.16, (5, 2)), rng.uniform(0.005, 0.017, (5, 1))], 1)
    jgeom = jgrid.make_geom(CENTER, cp.resolution, 24, 24, dtype=jnp.float64)
    tgeom = interop.grid_geom_from_numpy(jgeom, dtype=torch.float64, device=DEV)
    return cp, prior, sig, jgeom, tgeom


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("yaw", [0.0, 2.1])
def test_cell_sigma_rho_matches_jax(world, yaw, faithful):
    """Both modes, anisotropic sigmas (the delta-form rotation is active)."""
    cp, _, _, jgeom, tgeom = world
    sig = (0.11, 0.04, 0.02)
    want = jcm.cell_sigma_rho(cp, *jgrid.cell_positions(jgeom, 24, 24), jnp.asarray(yaw),
                              faithful=faithful, sigmas=sig)
    got = tcm.cell_sigma_rho(cp, *tgrid.cell_positions(tgeom, 24, 24), yaw,
                             faithful=faithful, sigmas=sig)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("center,sigmas", [((None, None), None), ((15.0, 0.0), SIGMA_HI),
                                           ((4.0, -3.0), (0.25, 0.25, 0.05))])
def test_required_window_radius_matches_jax(center, sigmas):
    cp = CostmapParams()
    assert (tcm.required_window_radius(cp, 152, 104, center, sigmas)
            == jcm.required_window_radius(cp, 152, 104, center, sigmas))


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("yaw", [0.0, 2.1])
def test_propagate_reference_matches_jax(world, yaw, faithful):
    """The oracle, with the non-PSD cells of the faithful formula."""
    cp, prior, _, jgeom, tgeom = world
    sig = (0.09, 0.05, 0.03)
    want = jcm.propagate_uncertainty_reference(cp, jnp.asarray(prior), jgeom, jnp.asarray(yaw),
                                               faithful_rho=faithful, sigmas=sig)
    got = tcm.propagate_uncertainty_reference(cp, torch.tensor(prior), tgeom, yaw,
                                              faithful_rho=faithful, sigmas=sig)
    close(got, want)
    single = tuc.propagate_uncertainty(cp, torch.tensor(prior), tgeom, yaw, faithful, sig)
    close(single, want)


@pytest.mark.parametrize("rows,cols,center,max_bands", [
    (24, 24, CENTER, "auto"), (152, 104, (15.0, 0.0), "auto"), (40, 20, (4.0, 0.0), 3)])
def test_band_plan_matches_jax(rows, cols, center, max_bands):
    cp = CostmapParams()
    want = jup.make_band_plan(cp, rows, cols, center, SIGMA_HI, max_bands=max_bands)
    got = tuc.make_band_plan(cp, rows, cols, center, SIGMA_HI, max_bands=max_bands)
    assert tuple(got) == tuple(want)
    assert interop.band_plan_from_numpy(want) == got


def test_band_plan_bounds_matches_jax():
    cp = CostmapParams()
    args = (cp, 152, 104, (12.0, 18.0), (-2.0, 1.5), SIGMA_HI)
    assert tuple(tuc.make_band_plan_bounds(*args)) == tuple(jup.make_band_plan_bounds(*args))
    with pytest.raises(ValueError, match="empty center range"):
        tuc.make_band_plan_bounds(cp, 152, 104, (3.0, 2.0), (0.0, 0.0), SIGMA_HI)


def test_prep_fields_match_jax(world):
    """Float32 fields from float64 geometry: the same values as
    uncertainty_pallas._prep_fields (both compute in float64, then round)."""
    cp, _, sig, jgeom, tgeom = world
    want = jup._prep_fields(cp, jgeom, jnp.asarray(0.7), jnp.asarray(sig), False, 24, 24)
    got = tuc.prep_fields(cp, tgeom, torch.tensor(0.7, dtype=torch.float64), torch.tensor(sig),
                          False, 24, 24)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _vmapped_reference(cp, priors, jgeom, yaw, sig):
    return jax.jit(jax.vmap(lambda pr, s: jcm.propagate_uncertainty_reference(
        cp, pr, jgeom, jnp.asarray(yaw), sigmas=(s[0], s[1], s[2]))))(priors, jnp.asarray(sig))


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("per_scenario_prior", [False, True])
def test_plain_version_matches_vmapped_reference(world, banded, per_scenario_prior):
    """The kernel's plain version over one shared prior (the Monte-Carlo
    form) and over one prior per scenario (the full-stack form), full window
    or the band plan of the sampling bound."""
    cp, prior, sig, jgeom, tgeom = world
    B = sig.shape[0]
    priors = (np.random.default_rng(7).uniform(0.0, 100.0, (B, 24, 24)) if per_scenario_prior
              else np.broadcast_to(prior, (B, 24, 24)))
    want = _vmapped_reference(cp, jnp.asarray(priors), jgeom, 0.7, sig)
    tprior = torch.tensor(priors if per_scenario_prior else prior)
    plan = (tuc.make_band_plan(cp, 24, 24, CENTER, SIGMA_HI) if banded
            else tuc.full_window_plan(cp, 24))
    got = tuc.propagate_uncertainty_banded(cp, tprior, tgeom, torch.tensor(0.7, dtype=torch.float64),
                                           torch.tensor(sig), plan)
    assert got.shape == (B, 24, 24) and got.dtype == torch.float64
    close(got, want)
    assert float((got[0] - got[-1]).abs().max()) > 1e-3  # per-scenario sigmas reach the maps


def test_cpu_tensors_take_the_plain_version(world):
    cp, prior, sig, _, tgeom = world
    before = tuc.LAUNCHES
    tuc.propagate_uncertainty_batched(cp, torch.tensor(prior), tgeom, 0.3, torch.tensor(sig))
    assert tuc.LAUNCHES == before


def test_band_plan_checks(world):
    cp, prior, sig, _, tgeom = world
    args = (cp, torch.tensor(prior), tgeom, 0.3, torch.tensor(sig))
    with pytest.raises(ValueError, match="not contiguous"):
        tuc.propagate_uncertainty_banded(*args, ((0, 8, 4), (10, 14, 4)))
    with pytest.raises(ValueError, match="covers 16 rows"):
        tuc.propagate_uncertainty_banded(*args, ((0, 8, 4), (8, 8, 4)))
    with pytest.raises(ValueError, match="no batched input"):
        tuc.propagate_uncertainty_banded(cp, torch.tensor(prior), tgeom, 0.3, None,
                                         tuc.full_window_plan(cp, 24))


@pytest.mark.slow
def test_plain_version_matches_pallas_kernel_interpret(world):
    """Against the TPU kernel (the fused-band form) in the Pallas
    interpreter, float32, at its own kernel-vs-reference bar
    (tests/test_uncertainty_pallas.py)."""
    cp, prior, sig, jgeom, tgeom = world
    jplan = jup.make_band_plan(cp, 24, 24, CENTER, SIGMA_HI)
    geom32 = jgrid.make_geom(CENTER, cp.resolution, 24, 24, dtype=jnp.float32)
    want = jup.propagate_uncertainty_tpu_banded(
        cp, jnp.asarray(prior, jnp.float32), geom32, jnp.asarray(0.7, jnp.float32),
        jnp.asarray(sig, jnp.float32), jplan, interpret=True)
    got = tuc.propagate_uncertainty_banded(
        cp, torch.tensor(prior, dtype=torch.float32),
        interop.grid_geom_from_numpy(geom32, dtype=torch.float32, device=DEV),
        torch.tensor(0.7, dtype=torch.float32), torch.tensor(sig, dtype=torch.float32),
        interop.band_plan_from_numpy(jplan))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-4)


def _cell_sigma_rho_unsplit(cp, xs, ys, ego_yaw, faithful=False, sigmas=None):
    """``cell_sigma_rho`` as it stood before it was split into per-scenario
    terms and per-cell arithmetic: the split must keep every bit."""
    Cx = xs[..., :, None]
    Cy = ys[..., None, :]
    yaw = torch.as_tensor(ego_yaw, dtype=Cx.dtype, device=Cx.device)
    if faithful:
        s, c = torch.sin(yaw), torch.cos(yaw)
        g1 = -s * Cx - c * Cy
        g2 = c * Cx - s * Cy
        t = s * c * (Cx * Cx - Cy * Cy) + Cx * Cy * (s * s - c * c)
    else:
        g1 = -Cy + 0.0 * Cx
        g2 = Cx + 0.0 * Cy
        t = g1 * g2
    u = g1 * g1
    v = g2 * g2
    if sigmas is None:
        s_x, s_y, s_t = cp.sigma_x, cp.sigma_y, cp.sigma_theta
    else:
        s_x, s_y, s_t = sigmas
    if faithful:
        dxx = dyy = dxy = 0.0
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


def _scenario_inputs(cp, dtype, tensor_sigmas, frames, B=6, seed=17):
    """Per-scenario yaws (all quadrants), optionally sigmas and frames."""
    rng = np.random.default_rng(seed)
    yaw = torch.tensor(rng.uniform(-np.pi, np.pi, B), dtype=dtype)
    sig = None
    if tensor_sigmas:
        sig = torch.tensor(np.concatenate([rng.uniform(0.02, 0.16, (B, 2)),
                                           rng.uniform(0.005, 0.017, (B, 1))], 1), dtype=dtype)
    center = (torch.tensor(np.stack([rng.uniform(5.0, 20.0, B), rng.uniform(-3.0, 3.0, B)], 1),
                           dtype=dtype) if frames else torch.tensor(CENTER, dtype=dtype))
    return tcm.vehicle_geom(cp, center), yaw, sig


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("tensor_sigmas", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cell_sigma_rho_split_keeps_every_bit(world, dtype, tensor_sigmas, faithful):
    """Per-scenario terms + per-cell arithmetic == the unsplit function, in
    float32 and float64, for configured (Python float) and tensor sigmas."""
    cp = world[0]
    geom, yaw, sig = _scenario_inputs(cp, dtype, tensor_sigmas, frames=True)
    xs, ys = tgrid.cell_positions(geom, 24, 24)
    sig3 = None if sig is None else tuple(s.reshape(-1, 1, 1) for s in sig.unbind(-1))
    args = (cp, xs, ys, yaw.reshape(-1, 1, 1))
    got = tcm.cell_sigma_rho(*args, faithful=faithful, sigmas=sig3)
    want = _cell_sigma_rho_unsplit(*args, faithful=faithful, sigmas=sig3)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (6, 24, 24)
        assert torch.equal(g, w) or torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
        assert torch.equal(torch.isnan(g), torch.isnan(w))


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("tensor_sigmas", [False, True])
@pytest.mark.parametrize("frames", [False, True])
def test_fields_from_scenario_table_equal_prep_fields(world, frames, tensor_sigmas, faithful):
    """The kernel's table of 12 floats per scenario and its per-cell
    arithmetic (plain version) give prep_fields' float32 fields bit for bit."""
    cp = world[0]
    geom, yaw, sig = _scenario_inputs(cp, torch.float32, tensor_sigmas, frames)
    want = tuc.prep_fields(cp, geom, yaw, sig, faithful, 24, 24)
    table = tuc.scenario_table(cp, geom, yaw, sig, faithful)
    assert table.shape == (6, tuc.TABLE_FLOATS) and table.dtype == torch.float32
    got = tuc.fields_from_table(table, 24, 24, faithful)
    for name, g, w in zip(("sx", "sy", "rho", "psd"), got, want):
        assert torch.equal(g, w), name
    if faithful:
        assert 0 < int((want[3] == 0).sum()) < want[3].numel()  # non-PSD cells exist


def test_scenario_table_of_one_map(world):
    """Unbatched geometry, yaw and configured sigmas: a table of one row."""
    cp = world[0]
    geom = tgrid.make_geom(CENTER, cp.resolution, 24, 24, dtype=torch.float32, device=DEV)
    table = tuc.scenario_table(cp, geom, 2.1, None, True)
    assert table.shape == (1, tuc.TABLE_FLOATS)
    want = tuc.prep_fields(cp, geom, 2.1, None, True, 24, 24)
    for g, w in zip(tuc.fields_from_table(table, 24, 24, True), want):
        assert torch.equal(g, w)


def _box_case(case):
    """(cp, float32 fields, bands, disc radii, prior) of one box test."""
    rng = np.random.default_rng(23)
    if case == "monte_carlo":  # the sampling bound itself among the draws
        cp = dataclasses.replace(CostmapParams(), rows=40, cols=32, window_radius=9)
        center = (15.0, 0.0)
        plan = tuc.make_band_plan(cp, 40, 32, center, SIGMA_HI)
        geom = tgrid.make_geom(center, cp.resolution, 40, 32, dtype=torch.float32, device=DEV)
        sig = np.concatenate([rng.uniform(0.02, 0.16, (4, 2)), rng.uniform(0.005, 0.017, (4, 1))], 1)
        sig[0] = SIGMA_HI
        fields = tuc.prep_fields(cp, geom, torch.tensor(0.05), torch.tensor(sig, dtype=torch.float32),
                                 False, 40, 32)
    elif case == "frames":  # one frame and yaw per scenario, configured sigmas
        cp = dataclasses.replace(CostmapParams(), rows=40, cols=32)
        plan = tuc.make_band_plan_bounds(cp, 40, 32, (5.0, 20.0), (-3.0, 3.0),
                                         (cp.sigma_x, cp.sigma_y, cp.sigma_theta))
        geom, yaw, _ = _scenario_inputs(cp, torch.float32, False, True, B=4)
        fields = tuc.prep_fields(cp, geom, yaw, None, False, 40, 32)
    else:  # the faithful formula: |rho| reaches and passes 1
        cp = dataclasses.replace(CostmapParams(), rows=24, cols=24, window_radius=8)
        plan = tuc.full_window_plan(cp, 24)
        geom = tgrid.make_geom(CENTER, cp.resolution, 24, 24, dtype=torch.float32, device=DEV)
        fields = tuc.prep_fields(cp, geom, float(case.split("=")[1]), None, True, 24, 24)
    prior = torch.tensor(rng.uniform(0.0, 100.0, fields[0].shape[-2:]), dtype=torch.float32)
    return cp, fields, plan.bands, plan.disc_radii, prior


@pytest.mark.parametrize("case", ["monte_carlo", "frames", "faithful=0.0", "faithful=2.1"])
def test_cell_box_holds_every_offset_inside_the_ellipse(case):
    """No offset of a band's window that passes the float32 inside test
    q <= thresh lies outside what the kernel visits (``scanned_offsets``:
    the cell's box and, per column, its interval of rows, by the kernel's
    formulas), and the plain version restricted to the visited offsets
    keeps every bit of the unrestricted one."""
    cp, fields, bands, discs, prior = _box_case(case)
    sx, sy, rho, psd = fields
    r_max = max(R for (_, _, R) in bands)
    row_R = torch.zeros(sx.shape[1], dtype=torch.int32)
    for (r0, br, R) in bands:
        row_R[r0:r0 + br] = R
    cap = row_R[None, :, None].expand_as(sx)
    hi, hj = (torch.minimum(h, cap) for h in tuc.cell_half_extents(cp, fields, r_max))
    assert bool((hi < cap).any()) and bool((hj < cap).any())  # the boxes do cut the windows
    scanned = tuc.scanned_offsets(cp, fields, cap)
    inv_sx, inv_sy = torch.reciprocal(sx), torch.reciprocal(sy)
    one_m_rho2 = 1.0 - rho * rho
    thresh = cp.chisquare_val**2 * one_m_rho2
    inside_total = visited_total = window_total = 0
    for djo in range(-r_max, r_max + 1):
        zy = -djo * cp.resolution * inv_sy
        for dio in range(-r_max, r_max + 1):
            zx = tcm.offset_distance(dio, cp.resolution, torch.float32) * inv_sx
            q = (zx - (rho + rho) * zy) * zx + zy * zy
            window = (psd > 0) & (abs(dio) <= cap) & (abs(djo) <= cap)
            inside = (q <= thresh) & window
            visited = scanned(dio, djo) & window
            inside_total += int(inside.sum())
            visited_total += int(visited.sum())
            window_total += int(window.sum())
            assert not bool((inside & ~visited).any()), (dio, djo)
            assert not bool((visited & ((abs(dio) > hi) | (abs(djo) > hj))).any()), (dio, djo)
    assert inside_total >= int((psd > 0).sum()) > 0  # every PSD cell holds its own centre
    assert inside_total <= visited_total < window_total  # and the scan is cut
    want = tuc.propagate_banded_plain(cp, prior, fields, bands, discs)
    got = tuc.propagate_banded_plain(cp, prior, fields, bands, discs, scanned=scanned)
    assert torch.equal(got, want)


def test_scan_constants_mirror_cuda_source():
    """The Python mirror of the kernel's scan uses the kernel's constants."""
    from pathlib import Path

    src = (Path(tuc.__file__).resolve().parent.parent / "csrc" / "uncertainty.cu").read_text()
    for line in (f"constexpr int kTileRows = {tuc.TILE_ROWS};",
                 f"constexpr int kTableFloats = {tuc.TABLE_FLOATS};",
                 "constexpr float kRangeMinDet = 1.0f / 65536.0f;",
                 "constexpr float kRangeSlack = 1e-3f;", "constexpr float kCellMargin = 0.01f;"):
        assert line in src, line
    assert (tuc.RANGE_MIN_DET, tuc.RANGE_SLACK, tuc.CELL_MARGIN) == (1.0 / 65536.0, 1e-3, 0.01)


def test_row_table_matches_the_plain_disc_cut():
    """The kernel's per-row table: the band radius, then per |dj| the row
    half extent the plain version's disc cut leaves (-1: column outside)."""
    cp = CostmapParams()
    plan = tuc.make_band_plan(cp, 152, 104, (15.0, 0.0), SIGMA_HI)
    tab, dy, r_max = tuc._row_table(plan.bands, plan.disc_radii, 152, cp.resolution, "cpu")
    assert dy.dtype == torch.float32 and dy.tolist() == [
        float(np.float32(k * cp.resolution)) for k in range(r_max + 1)]
    assert r_max == max(R for (_, _, R) in plan.bands) and tab.shape == (152, r_max + 2)
    for (r0, br, R), r_disc in zip(plan.bands, plan.disc_radii):
        assert bool((tab[r0:r0 + br, 0] == R).all())
        for dj in range(r_max + 1):
            inside = dj <= R and dj * dj <= r_disc * r_disc
            want = min(R, int(np.floor(np.sqrt(r_disc * r_disc - dj * dj)))) if inside else -1
            assert bool((tab[r0:r0 + br, 1 + dj] == want).all()), (r0, dj)
    full, _, _ = tuc._row_table(tuc.full_window_plan(cp, 152).bands, None, 152, cp.resolution,
                                "cpu")
    assert bool((full == cp.window_radius).all())


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_kernel_matches_plain_on_card(world):
    """The CUDA kernel vs its plain version on the card, float32, shared and
    per-scenario priors, at rtol 2e-5 + atol 2e-4 (see chip_smoke.py phase 8
    for the full-size check): with the fields given and in its fused form,
    which must give the fields-given bits; the kernel's own fields equal
    prep_fields' on every cell, both rho formulas."""
    cp, prior, sig, _, _ = world
    dev = torch.device("cuda")
    geom = tgrid.make_geom(CENTER, cp.resolution, 24, 24, dtype=torch.float32, device=dev)
    yaw = torch.tensor(0.7, device=dev)
    tsig = torch.tensor(sig, dtype=torch.float32, device=dev)
    for faithful in (False, True):
        want_f = tuc.prep_fields(cp, geom, yaw, tsig, faithful, 24, 24)
        for g, w in zip(tuc.fields_on_card(cp, geom, yaw, tsig, faithful, 24, 24), want_f):
            assert torch.equal(g, w)
    fields = tuc.prep_fields(cp, geom, yaw, tsig, False, 24, 24)
    plan = tuc.make_band_plan(cp, 24, 24, CENTER, SIGMA_HI)
    for pr in (prior, np.random.default_rng(3).uniform(0.0, 100.0, (sig.shape[0], 24, 24))):
        tprior = torch.tensor(pr, dtype=torch.float32, device=dev)
        before = tuc.LAUNCHES
        got = tuc.propagate_banded(cp, tprior, fields, plan.bands, plan.disc_radii)
        fused = tuc.propagate_uncertainty_banded(cp, tprior, geom, yaw, tsig, plan)
        torch.cuda.synchronize()
        assert tuc.LAUNCHES == before + 2
        want = tuc.propagate_banded_plain(cp, tprior, fields, plan.bands, plan.disc_radii)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
        assert torch.equal(fused, got)
    single = tuc.propagate_uncertainty(cp, torch.tensor(prior, dtype=torch.float32, device=dev),
                                       geom, yaw, faithful_rho=True)
    want1 = tuc.propagate_fused_plain(cp, torch.tensor(prior, dtype=torch.float32, device=dev),
                                      geom, yaw, None, True, tuc.full_window_plan(cp, 24).bands,
                                      None)[0]
    torch.testing.assert_close(single, want1, rtol=2e-5, atol=2e-4)
    # every cell of a small map sits next to an edge.  The scans that reach
    # furthest: the faithful formula at the yaws where |rho| reaches and
    # passes 1 (the band's whole window), and sigmas that are huge (every
    # scan is cut by the band radius and the map), tiny (the own cell alone),
    # zero, infinite and NaN (the prior is kept).  Two maps that only the
    # right cells may read lie around each prior in memory: the kernel must
    # give the same bits when they change.
    full = tuc.full_window_plan(cp, 24)
    odd = torch.tensor([[5.0, 5.0, 0.5], [1e-4, 1e-4, 1e-5], [0.0, 0.0, 0.0],
                        [float("inf"), 0.1, 0.01], [float("nan"), 0.1, 0.01],
                        [0.1, 0.1, float("nan")]], device=dev)
    yaws = torch.tensor([0.0, 2.1, 0.7, -3.0, 1.5708, 0.3], device=dev)
    for faithful, sig_c in ((True, None), (True, odd), (False, odd)):
        for pl in (full, plan):
            block = torch.tensor(np.random.default_rng(7).uniform(0.0, 100.0, (8, 24, 24)),
                                 dtype=torch.float32, device=dev)
            priors = block[1:7]
            fused = tuc.propagate_uncertainty_banded(cp, priors, geom, yaws, sig_c, pl, faithful)
            f_c = tuc.prep_fields(cp, geom, yaws, sig_c, faithful, 24, 24)
            given = tuc.propagate_banded(cp, priors, f_c, pl.bands, pl.disc_radii)
            want_c = tuc.propagate_banded_plain(cp, priors, f_c, pl.bands, pl.disc_radii)
            assert torch.equal(fused, given)
            torch.testing.assert_close(given, want_c, rtol=2e-5, atol=2e-4)
            kept = f_c[3] == 0
            assert torch.equal(given[kept], priors[kept])
            block[0], block[7] = -1e6, float("nan")  # the maps before and after in memory
            again = tuc.propagate_uncertainty_banded(cp, priors, geom, yaws, sig_c, pl, faithful)
            assert torch.equal(again, fused)
