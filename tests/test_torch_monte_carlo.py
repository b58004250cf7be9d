"""The Monte-Carlo path (cilqr_tpu_torch/parallel/monte_carlo) and the
per-scenario-world solve vs the JAX package.

JAX's PRNG stream cannot be reproduced, so both packages get the same
pre-drawn ``MCSample`` (numpy, from a seed).  On the CPU the port's fast
path runs its kernels' plain versions (propagation, the hybrid LM loop on
the LM-iteration kernel's plain version); every path is held to JAX's
``monte_carlo(impl="reference")`` in float64: iteration counts equal, U and
X within 1e-8 (float64 rounding of different summation orders and of
reciprocals instead of divisions, amplified along the horizon).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import obstacles as jobs, reference_path as jrp, solver as jsolver
from cilqr_tpu.models import uncertainty as junc
from cilqr_tpu.ops import costmap as jcm, gridmap as jgrid, uncertainty_pallas as jup
from cilqr_tpu.parallel import monte_carlo as jmc
from cilqr_tpu.utils.params import CostmapParams
from cilqr_tpu_torch.models import reference_path as trp, solver_batched as tsb
from cilqr_tpu_torch.models import uncertainty as tunc
from cilqr_tpu_torch.parallel import monte_carlo as tmc
from cilqr_tpu_torch.utils import interop

SIGMA_HI = (0.16, 0.16, 0.017)
B = 8


@pytest.fixture(scope="module")
def setup(params):
    """tests/test_monte_carlo.py's setup (24x24 map at R=8, N=12) with
    sigmas and egos pre-drawn in numpy."""
    p = dataclasses.replace(params, horizon=12, max_iterations=5)
    cp = dataclasses.replace(CostmapParams(), rows=24, cols=24, window_radius=8)
    rng = np.random.default_rng(41)
    prior = rng.uniform(0, 100, (cp.rows, cp.cols))
    s = np.linspace(0, 119, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.0 * np.sin(0.05 * s)], axis=1)
    ego = np.array([100.0, -305.8, 4.0, 0.05])
    sig = np.concatenate([rng.uniform(0.02, 0.16, (B, 2)), rng.uniform(0.005, 0.017, (B, 1))], 1)
    noise = rng.normal(0.0, 1.0, (B, 3)) * sig
    egos = ego + np.stack([noise[:, 0], noise[:, 1], np.zeros(B), noise[:, 2]], axis=1)
    jgeom = jgrid.make_geom([10.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float64)
    jplan, jn = jrp.pad_global_plan(p, plan_np, dtype=jnp.float64)
    jargs = (p, cp, jnp.asarray(prior), jgeom, jnp.asarray(ego[:2]), jnp.asarray(ego[3]), jplan,
             jn, jmc.MCSample(jnp.asarray(sig), jnp.asarray(egos)))
    tplan, tn = trp.pad_global_plan(p, plan_np, dtype=torch.float64)
    targs = (p, cp, torch.tensor(prior), interop.grid_geom_from_numpy(jgeom, dtype=torch.float64),
             torch.tensor(ego[:2]), torch.tensor(ego[3]), tplan, tn,
             interop.mc_sample_from_numpy(jargs[-1], dtype=torch.float64))
    return jargs, targs


@pytest.fixture(scope="module")
def jax_reference(setup):
    jargs, _ = setup
    return jmc.monte_carlo(*jargs, sigma_hi=SIGMA_HI, impl="reference")


def _band_plan(cp):
    return interop.band_plan_from_numpy(jup.make_band_plan(cp, 24, 24, (10.0, 0.0), SIGMA_HI))


@pytest.mark.parametrize("impl,banded", [("reference", False), ("fast", False), ("fast", True)])
def test_monte_carlo_matches_jax_reference(setup, jax_reference, impl, banded):
    _, targs = setup
    plan = _band_plan(targs[1]) if banded else None
    got = tmc.monte_carlo(*targs, sigma_hi=SIGMA_HI, impl=impl, band_plan=plan)
    want = jax_reference
    assert got._fields == want._fields
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    for f in ("U", "X"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-8, err_msg=f)
    np.testing.assert_allclose(got.J.numpy(), np.asarray(want.J), rtol=1e-9, atol=0)
    assert np.std(got.U.numpy()[:, 0, 0]) > 1e-6  # the draws lead to different solutions


def test_band_plan_for_a_smaller_bound_is_refused(setup):
    _, targs = setup
    with pytest.raises(ValueError, match="rebuild the plan"):
        tmc.monte_carlo(*targs, impl="fast", band_plan=_band_plan(targs[1]))  # default bound


def test_auto_and_window_sizing(setup, jax_reference):
    """impl="auto" takes the reference path below 256 scenarios;
    ensure_window_covers agrees with JAX's, keeping R=8 for SIGMA_HI and
    enlarging it for the default bound."""
    jargs, targs = setup
    cp = targs[1]
    for s, R in ((SIGMA_HI, 8), (tmc.DEFAULT_SIGMA_HI, 9)):
        got = tmc.ensure_window_covers(cp, 24, 24, (10.0, 0.0), s)
        assert got == jmc.ensure_window_covers(cp, 24, 24, (10.0, 0.0), s)
        assert got.window_radius == R
    auto = tmc.monte_carlo(*targs, sigma_hi=SIGMA_HI, impl="auto")
    np.testing.assert_array_equal(auto.iterations.numpy(), np.asarray(jax_reference.iterations))
    with pytest.raises(ValueError, match="impl"):
        tmc.monte_carlo(*targs, impl="vmap")


def test_sample_scenarios():
    """Sigmas inside the bounds, noise only on x, y and yaw, and the same
    draws from the same generator seed."""
    ego = torch.tensor([100.0, -305.8, 4.0, 0.05])
    a = tmc.sample_scenarios(torch.Generator().manual_seed(3), 500, ego, sigma_hi=SIGMA_HI)
    b = tmc.sample_scenarios(torch.Generator().manual_seed(3), 500, ego, sigma_hi=SIGMA_HI)
    assert a.sigmas.shape == (500, 3) and a.egos.shape == (500, 4)
    assert bool((a.sigmas >= torch.tensor(tmc.DEFAULT_SIGMA_LO)).all())
    assert bool((a.sigmas <= torch.tensor(SIGMA_HI)).all())
    assert bool((a.egos[:, 2] == 4.0).all()) and float(a.egos[:, 0].std()) > 0.01
    torch.testing.assert_close(a.egos, b.egos, rtol=0, atol=0)


@pytest.fixture(scope="module")
def batched_world(setup):
    """One map per scenario (propagated by the JAX oracle), per-scenario
    obstacles, and jax.vmap(solver.run_step) over both as the reference."""
    jargs, targs = setup
    p, cp, prior, jgeom, oxy, oyaw, jplan, jn, samples = jargs
    maps = jax.vmap(lambda s: jcm.propagate_uncertainty_reference(
        cp, prior, jgeom, oyaw, sigmas=(s[0], s[1], s[2])))(samples.sigmas)
    rng = np.random.default_rng(5)
    centers = np.array([[112.0, -305.5], [125.0, -304.6]]) + rng.normal(0, 0.5, (B, 2, 2))
    jobs_b = jax.vmap(lambda c: jobs.make_static_obstacles(
        p, c, [[3.63, 1.84]] * 2, [0.0, 0.3], dtype=jnp.float64))(jnp.asarray(centers))
    U0 = jnp.broadcast_to(jsolver.initial_controls(p, dtype=jnp.float64), (B, p.horizon, 2))
    one = lambda m, e, u, ob: jsolver.run_step(
        p, jplan, jn, e, u, ob, junc.UncertaintyMap(m, jgeom, oxy, oyaw))
    shared_obs = jobs.make_static_obstacles(p, [[112.0, -305.5]], [[3.63, 1.84]], [0.0],
                                            dtype=jnp.float64)
    want_shared = jax.jit(jax.vmap(lambda m, e, u: one(m, e, u, shared_obs)))(
        maps, samples.egos, U0)
    want_batched = jax.jit(jax.vmap(one))(maps, samples.egos, U0, jobs_b)
    tmaps = tmc.per_scenario_map(torch.tensor(np.asarray(maps)), targs[3], targs[4], targs[5])
    tobs_shared = interop.obstacles_from_numpy(shared_obs, dtype=torch.float64)
    tobs_b = interop.obstacles_from_numpy(jobs_b, dtype=torch.float64)
    return (targs[0], targs[6], targs[7], targs[8].egos, torch.tensor(np.asarray(U0)), tmaps,
            tobs_shared, tobs_b, want_shared, want_batched)


def _same(got, want):
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    for f in ("U", "X"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-8, err_msg=f)


@pytest.mark.parametrize("impl", ["mega", "two_phase"])
def test_world_batched_solve_matches_jax(batched_world, impl):
    """One map per scenario with shared obstacles: mega is the hybrid loop
    (sampler + LM-iteration kernel), two_phase the batched derivatives."""
    p, plan, n, egos, U0, tmaps, tobs_shared, _, want, _ = batched_world
    got = tsb.run_steps_batched(p, plan, n, egos, U0, tobs_shared, tmaps, impl=impl,
                                world_batched=True)
    _same(got, want)


def test_per_scenario_obstacles_take_two_phase(batched_world):
    """Per-scenario obstacles force the two-phase path for impl="mega"."""
    p, plan, n, egos, U0, tmaps, _, tobs_b, _, want = batched_world
    assert tobs_b.pos.ndim == 4
    got = tsb.run_steps_batched(p, plan, n, egos, U0, tobs_b, tmaps, impl="mega",
                                world_batched=True)
    _same(got, want)


def test_world_batched_argument_checks(batched_world):
    p, plan, n, egos, U0, tmaps, tobs_shared, tobs_b, _, _ = batched_world
    with pytest.raises(ValueError, match="world_batched=True"):
        tsb.run_steps_batched(p, plan, n, egos, U0, tobs_shared, tmaps)
    with pytest.raises(ValueError, match="world_batched=True"):
        tsb.run_steps_batched(p, plan, n, egos, U0, tobs_b, None)
    shared_map = tunc.UncertaintyMap(tmaps.values[0], type(tmaps.geom)(*(t[0] for t in tmaps.geom)),
                                     tmaps.origin_xy[0], tmaps.origin_yaw[0])
    with pytest.raises(ValueError, match="one map per scenario"):
        tsb.run_steps_batched(p, plan, n, egos, U0, None, shared_map, world_batched=True)


def test_interop_carries_mc_inputs(setup):
    jargs, targs = setup
    samples = targs[-1]
    for f in samples._fields:
        np.testing.assert_array_equal(getattr(samples, f).numpy(), np.asarray(getattr(jargs[-1], f)))
    prior = interop.tensor_from_numpy(jargs[2], dtype=torch.float64)
    np.testing.assert_array_equal(prior.numpy(), np.asarray(jargs[2]))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_fast_path_on_card_goes_through_the_kernels(setup):
    """On the card the fast path launches the propagation kernel once and the
    LM-iteration kernel once per iteration, and no other kernel of the port
    (chip_smoke.py phase 10 holds it to the reference at full size)."""
    from cilqr_tpu_torch.ops import lm_cuda, riccati_cuda, uncertainty_cuda

    _, (p, cp, prior, geom, oxy, oyaw, plan, n, samples) = setup
    dev = torch.device("cuda")
    f32 = lambda t: t.to(dev, torch.float32)
    args = (p, cp, f32(prior), type(geom)(*map(f32, geom)), f32(oxy), f32(oyaw), f32(plan),
            torch.as_tensor(n).to(dev), tmc.MCSample(*map(f32, samples)))
    lm_cuda.LAUNCHES = lm_cuda.ITER_LAUNCHES = riccati_cuda.LAUNCHES = 0
    uncertainty_cuda.LAUNCHES = 0
    res = tmc.monte_carlo(*args, sigma_hi=SIGMA_HI, impl="fast", band_plan=_band_plan(cp))
    torch.cuda.synchronize()
    assert uncertainty_cuda.LAUNCHES == 1
    assert lm_cuda.ITER_LAUNCHES == int(res.iterations.max())
    assert lm_cuda.LAUNCHES == riccati_cuda.LAUNCHES == 0
    assert bool(torch.isfinite(res.U).all())
