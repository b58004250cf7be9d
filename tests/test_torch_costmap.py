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
    tgeom = interop.grid_geom_from_numpy(jgeom, dtype=torch.float64)
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
        interop.grid_geom_from_numpy(geom32, dtype=torch.float32),
        torch.tensor(0.7, dtype=torch.float32), torch.tensor(sig, dtype=torch.float32),
        interop.band_plan_from_numpy(jplan))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_kernel_matches_plain_on_card(world):
    """The CUDA kernel vs its plain version on the card, float32, shared and
    per-scenario priors, at rtol 2e-5 + atol 2e-4 (see chip_smoke.py phase 8
    for the full-size check)."""
    cp, prior, sig, _, _ = world
    dev = torch.device("cuda")
    geom = tgrid.make_geom(CENTER, cp.resolution, 24, 24, dtype=torch.float32, device=dev)
    fields = tuc.prep_fields(cp, geom, torch.tensor(0.7, device=dev),
                             torch.tensor(sig, dtype=torch.float32, device=dev), False, 24, 24)
    plan = tuc.make_band_plan(cp, 24, 24, CENTER, SIGMA_HI)
    for pr in (prior, np.random.default_rng(3).uniform(0.0, 100.0, (sig.shape[0], 24, 24))):
        tprior = torch.tensor(pr, dtype=torch.float32, device=dev)
        before = tuc.LAUNCHES
        got = tuc.propagate_banded(cp, tprior, fields, plan.bands, plan.disc_radii)
        torch.cuda.synchronize()
        assert tuc.LAUNCHES == before + 1
        want = tuc.propagate_banded_plain(cp, tprior, fields, plan.bands, plan.disc_radii)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
