"""The simulation layer (cilqr_tpu_torch/sim/collision, perception, plant;
models/tracker) vs the JAX package.

The same float64 inputs go through each JAX function and its port:
collision, tracker and perception at 1e-10 of scale (booleans exactly), the
four closed loops for 2-3 cycles at the bars of tests/test_torch_slice.py:
identical iteration counts, states within 1e-6, J within 1e-9 relative.

JAX's PRNG stream cannot be reproduced in PyTorch, so each loop test
reproduces the JAX loop's key discipline (``split(key, T)``, per cycle
``split(key_t, B)`` in the batched loops, ``normal(k, (3,))`` for the
localization noise and ``normal(fold_in(k, 7), (4,))`` for the camera) to
pre-draw the numbers the JAX loop will draw, and feeds them to the port.

The JAX batched loops reach Pallas kernels, which on the CPU would run in
the interpreter in float32: ``closed_loop_batched`` is run with its batched
solve replaced by ``vmap(solver.run_step)`` (the solve the kernel is held to
by the JAX package's own tests), ``closed_loop_full_stack_batched`` with
``use_pallas=False`` and the same solve through its ``plan_step_batched``
hook.  Nothing in the JAX package changes for that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import obstacles as jobs, reference_path as jrp, solver as jsolver
from cilqr_tpu.models import solver_batched as jsb, tracker as jtracker
from cilqr_tpu.models import uncertainty as junc
from cilqr_tpu.ops import costmap as jcm, gridmap as jgrid
from cilqr_tpu.sim import collision as jcol, perception as jperc, plant as jplant
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams
from cilqr_tpu_torch.models import tracker as ttracker
from cilqr_tpu_torch.ops import costmap as tcm
from cilqr_tpu_torch.sim import collision as tcol, perception as tperc, plant as tplant
from cilqr_tpu_torch.utils import interop

DEV = "cpu"  # the port allocates on the card unless told otherwise
REL = 1e-10


def close(got, want, rel=REL):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(1.0, float(np.abs(w).max())))


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------------------- collision
def test_sat_cases_of_the_jax_tests():
    """tests/test_sim.py: disjoint, overlapping, the rotated near miss and
    the touching pair."""
    a = (0.0, 0.0, 0.0, 4.0, 2.0)
    cases = [((10.0, 0.0, 0.0, 4.0, 2.0), False), ((3.0, 0.5, 0.3, 4.0, 2.0), True),
             ((3.8, 2.8, np.pi / 4, 4.0, 2.0), False), ((2.5, 1.0, np.pi / 4, 4.0, 2.0), True)]
    for b, want in cases:
        assert bool(tcol.is_collision(tuple(map(t64, a)), tuple(map(t64, b)))) is want
        assert bool(jcol.is_collision(a, b)) is want


def test_sat_matches_jax_on_random_pairs():
    """100 random pairs at once on the leading axis: corners at 1e-10, the
    verdicts exactly."""
    rng = np.random.default_rng(17)
    v1 = np.stack([rng.uniform(-5, 5, 100), rng.uniform(-5, 5, 100), rng.uniform(-3, 3, 100),
                   np.full(100, 4.0), np.full(100, 2.0)])
    v2 = np.stack([rng.uniform(-5, 5, 100), rng.uniform(-5, 5, 100), rng.uniform(-3, 3, 100),
                   np.full(100, 4.0), np.full(100, 2.0)])
    want = np.array([bool(jcol.is_collision(tuple(v1[:, i]), tuple(v2[:, i]))) for i in range(100)])
    got = tcol.is_collision(tuple(t64(c) for c in v1), tuple(t64(c) for c in v2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 10 < want.sum() < 90
    close(tcol.obb_corners(*(t64(c) for c in v1))[7], jcol.obb_corners(*v1[:, 7]))


def test_check_collisions_and_noise_and_ackermann_match_jax():
    p_j = SolverParams()
    p = interop.solver_params_from_reference(p_j)
    rng = np.random.default_rng(2)
    states = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 2.0, (30, 4))
    obs = np.array([[103.0, -305.0, 0.2], [98.0, -303.0, 1.0], [101.0, -306.0, 0.0]])
    sizes = np.array([[3.63, 1.84], [2.0, 1.0], [4.0, 2.0]])
    mask = np.array([1.0, 1.0, 0.0])
    want = jax.vmap(lambda s: jplant.check_collisions(p_j, s, jnp.asarray(obs), jnp.asarray(sizes),
                                                      jnp.asarray(mask)))(jnp.asarray(states))
    got = tplant.check_collisions(p, t64(states), t64(obs), t64(sizes), t64(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 30
    assert bool(tplant.check_collisions(p, t64(states[0]), t64(obs), t64(sizes[0]), t64(mask))) == \
        bool(jplant.check_collisions(p_j, jnp.asarray(states[0]), jnp.asarray(obs),
                                     jnp.asarray(sizes[0]), jnp.asarray(mask)))

    noise_j = NoiseParams(0.16, 0.1, 0.017)
    key = jax.random.key(4)
    r = np.asarray(jax.random.normal(key, (3,), dtype=jnp.float64))
    close(tplant.inject_noise(interop.noise_params_from_reference(noise_j), t64(r), t64(states[0])),
          jplant.inject_noise(noise_j, key, jnp.asarray(states[0])), rel=1e-14)

    cmd = tplant.to_ackermann(t64(4.0), t64([0.5, 0.1]))
    want_cmd = jplant.to_ackermann(jnp.asarray(4.0), jnp.asarray([0.5, 0.1]))
    assert cmd._fields == want_cmd._fields
    for g, w in zip(cmd, want_cmd):
        assert float(g) == float(w)
    assert float(cmd.speed) == 4.5 and float(cmd.steering_angle) == 0.1


# ------------------------------------------------------ tracker, perception
def test_tracker_matches_jax():
    """predict, correct, step (valid and coasting) and track on the noisy
    stream of tests/test_perception_loop.py."""
    rng = np.random.default_rng(7)
    T = 40
    zs = np.stack([[-35.0 + 0.1 * t, 120.0, 15.0, 8.0] for t in range(T)]) + rng.normal(0, 0.8,
                                                                                        (T, 4))
    valids = np.ones(T, bool)
    valids[[5, 6, 20]] = False
    js = jtracker.init(dtype=jnp.float64, x0=jnp.asarray(np.r_[zs[0], 0.0, 0.0]))
    ts = ttracker.init(dtype=torch.float64, x0=np.r_[zs[0], 0.0, 0.0], device=DEV)
    close(ts.P, js.P)
    jp_, tp_ = jtracker.predict(js), ttracker.predict(ts)
    close(tp_.x, jp_.x), close(tp_.P, jp_.P)
    jc, tc = jtracker.correct(jp_, jnp.asarray(zs[1])), ttracker.correct(tp_, t64(zs[1]))
    close(tc.x, jc.x), close(tc.P, jc.P)
    for v in (True, False):
        (jn_, jbox), (tn_, tbox) = (jtracker.step(js, jnp.asarray(zs[1]), jnp.asarray(v)),
                                    ttracker.step(ts, t64(zs[1]), torch.tensor(v)))
        close(tn_.x, jn_.x), close(tn_.P, jn_.P), close(tbox, jbox)
    close(ttracker.track(t64(zs), torch.tensor(valids), dtype=torch.float64),
          jtracker.track(jnp.asarray(zs), jnp.asarray(valids), dtype=jnp.float64))
    back = interop.kf_state_from_numpy(jc, dtype=torch.float64, device=DEV)
    close(back.x, jc.x), close(back.P, jc.P)
    # a batch of filters is the single filter per lane
    tb = ttracker.init(dtype=torch.float64, batch=(3,), device=DEV)
    zb = t64(zs[:3])
    nb, boxb = ttracker.step(tb, zb, torch.tensor([True, False, True]))
    n0, box0 = ttracker.step(ttracker.init(dtype=torch.float64, device=DEV), zb[2],
                             torch.tensor(True))
    close(nb.x[2], n0.x), close(nb.P[2], n0.P), close(boxb[2], box0)
    assert float(boxb[1].abs().max()) == 0.0


def test_bbox_measurement_matches_jax():
    """The roundtrip and out-of-plane cases of tests/test_perception_loop.py,
    with detector noise, per scenario against the vmapped JAX call."""
    cp_j = dataclasses.replace(CostmapParams(), rows=64, cols=48)
    cp = interop.costmap_params_from_reference(cp_j)
    jg = jgrid.make_geom([0.0, 0.0], cp_j.resolution, 64, 48, dtype=jnp.float64)
    tg = interop.grid_geom_from_numpy(jg, dtype=torch.float64, device=DEV)
    obs = (np.array([13.0, 6.0]), np.array([3.0, 1.6]), np.array(0.5))
    egos = np.array([[10.0, 5.0, 0.3], [11.0, 5.5, -0.4], [500.0, 0.0, 0.0]])
    keys = jax.random.split(jax.random.key(9), 3)
    draws = np.stack([np.asarray(jax.random.normal(k, (4,), dtype=jnp.float64)) for k in keys])
    want_z, want_v = jax.vmap(lambda e, k: jperc.bbox_measurement(
        cp_j, jg, e[:2], e[2], *map(jnp.asarray, obs), key=k, sigma=0.4))(jnp.asarray(egos), keys)
    got_z, got_v = tperc.bbox_measurement(cp, tg, t64(egos[:, :2]), t64(egos[:, 2]),
                                          *map(t64, obs), draws=t64(draws), sigma=0.4)
    close(got_z, want_z)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.tolist() == [True, True, False]
    z0, v0 = tperc.bbox_measurement(cp, tg, t64(egos[0, :2]), t64(egos[0, 2]), *map(t64, obs))
    jz0, _ = jperc.bbox_measurement(cp_j, jg, jnp.asarray(egos[0, :2]), jnp.asarray(egos[0, 2]),
                                    *map(jnp.asarray, obs))
    close(z0, jz0)
    painted = tcm.rasterize_tracked_bbox(tg, 64, 48, z0, v0)
    np.testing.assert_array_equal(
        painted.numpy(), np.asarray(jcm.rasterize_tracked_bbox(jg, 64, 48, jz0, jnp.asarray(True))))
    assert float(painted.max()) == 100.0


# ------------------------------------------------------------- closed loops
T_CYCLES, B = 3, 4


@pytest.fixture(scope="module")
def world():
    """A small world in both packages: N=10, a 64x48 costmap around the ego
    (10 look-ahead waypoints), a 40x40 global map at 1 m, one obstacle that
    the ellipse barrier, the rasterization and the SAT check all see."""
    p_j = dataclasses.replace(SolverParams(), horizon=10, max_iterations=3, num_of_local_wpts=8,
                              closest_point_samples_per_wpt=5)
    cp_j = dataclasses.replace(CostmapParams(), rows=64, cols=48, window_radius=3,
                               look_ahead_waypoints=10)
    rng = np.random.default_rng(31)
    gm = np.zeros((40, 40))
    gm[10:30, 12:20] = rng.uniform(20.0, 100.0, (20, 8))
    jgg = jgrid.make_geom([110.0, -300.0], 1.0, 40, 40, dtype=jnp.float64)
    s = np.linspace(0.0, 119.0, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s], axis=1)
    jplan, jn = jrp.pad_global_plan(p_j, plan_np, dtype=jnp.float64)
    obs_xyyaw = np.array([[103.0, -305.5, 0.05]])
    obs_size = np.array([[4.5, 2.0]])
    jo = jobs.make_static_obstacles(p_j, obs_xyyaw[:, :2], obs_size, obs_xyyaw[:, 2],
                                    dtype=jnp.float64)
    ju = junc.make_uncertainty_map(rng.uniform(0.0, 100.0, (12, 10)), [3.0, 0.0], 0.5,
                                   [100.0, -305.6], 0.05, dtype=jnp.float64)
    x0s = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.2, (B, 4))
    j = dict(p=p_j, cp=cp_j, gm=jnp.asarray(gm), gg=jgg, plan=jplan, n=jn, ob=jo, unc=ju,
             obs=(jnp.asarray(obs_xyyaw), jnp.asarray(obs_size), jnp.ones((1,))))
    p = interop.solver_params_from_reference(p_j)
    from cilqr_tpu_torch.models import reference_path as trp

    tplan, tn = trp.pad_global_plan(p, plan_np, dtype=torch.float64, device=DEV)
    t = dict(p=p, cp=interop.costmap_params_from_reference(cp_j), gm=t64(gm),
             gg=interop.grid_geom_from_numpy(jgg, dtype=torch.float64, device=DEV), plan=tplan,
             n=tn, ob=interop.obstacles_from_numpy(jo, dtype=torch.float64, device=DEV),
             unc=interop.unc_map_from_numpy(ju, dtype=torch.float64, device=DEV),
             obs=(t64(obs_xyyaw), t64(obs_size), torch.ones(1, dtype=torch.float64)))
    return j, t, x0s


NOISES = [NoiseParams(0.0, 0.0, 0.0), NoiseParams(0.05, 0.04, 0.005)]


def draws_single(key, T):
    """What ``closed_loop`` / ``closed_loop_full_stack`` draw from ``key``."""
    keys = jax.random.split(key, T)
    noise = np.stack([np.asarray(jax.random.normal(k, (3,), dtype=jnp.float64)) for k in keys])
    cam = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, 7), (4,),
                                                 dtype=jnp.float64)) for k in keys])
    return t64(noise), t64(cam)


def draws_batched(key, T, n_lanes):
    """What the batched loops draw: the cycle key split per lane."""
    noise, cam = np.zeros((T, n_lanes, 3)), np.zeros((T, n_lanes, 4))
    for t, key_t in enumerate(jax.random.split(key, T)):
        for b, k in enumerate(jax.random.split(key_t, n_lanes)):
            noise[t, b] = np.asarray(jax.random.normal(k, (3,), dtype=jnp.float64))
            cam[t, b] = np.asarray(jax.random.normal(jax.random.fold_in(k, 7), (4,),
                                                     dtype=jnp.float64))
    return t64(noise), t64(cam)


def compare_records(got: dict, want: dict, xf_got, xf_want):
    """The bars of tests/test_torch_slice.py: iterations (and the booleans)
    equal, states and boxes within 1e-6, J within 1e-9 relative."""
    assert set(got) == set(want)
    close(xf_got, xf_want, rel=1e-8)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in ("iterations", "collided", "bbox_valid"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "J":
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("noise_j", NOISES, ids=["no-noise", "noise"])
def test_closed_loop_matches_jax(world, noise_j):
    j, t, x0s = world
    key = jax.random.key(11)
    xf_w, rec_w = jplant.closed_loop(j["p"], noise_j, j["plan"], j["n"], jnp.asarray(x0s[0]), key,
                                     T_CYCLES, j["ob"], j["unc"], *j["obs"])
    noise_draws, _ = draws_single(key, T_CYCLES)
    xf_g, rec_g = tplant.closed_loop(t["p"], interop.noise_params_from_reference(noise_j), t["plan"],
                                     t["n"], t64(x0s[0]), None, T_CYCLES, t["ob"], t["unc"],
                                     *t["obs"], noise_draws=noise_draws)
    assert rec_g._fields == rec_w._fields
    compare_records(rec_g._asdict(), rec_w._asdict(), xf_g, xf_w)
    assert float(xf_g[0]) > x0s[0, 0] + 0.5  # the ego advanced


def test_closed_loop_draws_from_a_generator(world):
    """With a generator the loop draws its own (T, 3) block: the same seed
    gives the same run, and it is the run on that block pre-drawn."""
    _, t, x0s = world
    noise = interop.noise_params_from_reference(NOISES[1])
    run = lambda **kw: tplant.closed_loop(t["p"], noise, t["plan"], t["n"], t64(x0s[0]),
                                          kw.pop("g", None), 2, t["ob"], t["unc"], **kw)
    xa, _ = run(g=torch.Generator().manual_seed(5))
    xb, _ = run(g=torch.Generator().manual_seed(5))
    block = torch.randn((2, 3), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    xc, _ = run(noise_draws=block)
    assert torch.equal(xa, xb) and torch.equal(xa, xc)
    with pytest.raises(ValueError, match="torch.Generator or pre-drawn"):
        run()
    with pytest.raises(ValueError, match="must have shape"):
        run(noise_draws=block[:1])


def _percept(vel=(0.5, 0.0), sigma=0.3):
    return (jperc.PerceptionSim(0, jnp.asarray(vel), bbox_sigma=sigma),
            tperc.PerceptionSim(0, t64(vel), bbox_sigma=sigma))


@pytest.mark.parametrize("noise_j,percept", [(NOISES[0], False), (NOISES[1], True)],
                         ids=["no-noise", "noise+camera"])
def test_closed_loop_full_stack_matches_jax(world, noise_j, percept):
    """One vehicle: per-cycle costmap rebuild (oracle propagation) + solve;
    with the camera -> tracker -> semantic layer channel and its noise."""
    j, t, x0s = world
    key = jax.random.key(12)
    jpc, tpc = _percept() if percept else (None, None)
    xf_w, rec_w = jplant.closed_loop_full_stack(
        j["p"], j["cp"], noise_j, j["gm"], j["gg"], j["plan"], j["n"], jnp.asarray(x0s[1]), key,
        T_CYCLES, j["ob"], *j["obs"], percept=jpc)
    noise_draws, camera_draws = draws_single(key, T_CYCLES)
    xf_g, rec_g = tplant.closed_loop_full_stack(
        t["p"], t["cp"], interop.noise_params_from_reference(noise_j), t["gm"], t["gg"], t["plan"],
        t["n"], t64(x0s[1]), None, T_CYCLES, t["ob"], *t["obs"], percept=tpc,
        noise_draws=noise_draws, camera_draws=camera_draws)
    compare_records(rec_g, rec_w, xf_g, xf_w)
    assert float(rec_g["uncertainty_max"].max()) > 0.0
    if percept:
        assert bool(rec_g["bbox_valid"].all()) and float(rec_g["semantic_max"].max()) == 100.0


@pytest.mark.parametrize("noise_j", NOISES, ids=["no-noise", "noise"])
def test_closed_loop_batched_matches_jax(world, noise_j, monkeypatch):
    """The JAX loop with its batched solve replaced by vmap(run_step)."""
    j, t, x0s = world

    def vmapped_run_step(p, plan_xy, plan_n, egos, U_warm, obstacles=None, unc_map=None):
        return jax.vmap(lambda e, u: jsolver.run_step(p, plan_xy, plan_n, e, u, obstacles,
                                                      unc_map))(egos, U_warm)

    monkeypatch.setattr(jsb, "run_steps_batched", vmapped_run_step)
    key = jax.random.key(13)
    xf_w, rec_w = jplant.closed_loop_batched(j["p"], noise_j, j["plan"], j["n"], jnp.asarray(x0s),
                                             key, T_CYCLES, j["ob"], j["unc"], *j["obs"])
    noise_draws, _ = draws_batched(key, T_CYCLES, B)
    xf_g, rec_g = tplant.closed_loop_batched(
        t["p"], interop.noise_params_from_reference(noise_j), t["plan"], t["n"], t64(x0s), None,
        T_CYCLES, t["ob"], t["unc"], *t["obs"], noise_draws=noise_draws)
    compare_records(rec_g, rec_w, xf_g, xf_w)
    assert rec_g["J"].shape == (T_CYCLES, B)


@pytest.mark.parametrize("noise_j,percept", [(NOISES[0], False), (NOISES[1], True)],
                         ids=["no-noise", "noise+camera"])
def test_closed_loop_full_stack_batched_matches_jax(world, noise_j, percept):
    """The JAX loop with ``use_pallas=False`` and vmap(run_step) as its
    planner; the port on its default route (on CPU tensors: the plain
    versions of K5, K4 and K3 in the hybrid solve) and on its reference
    route."""
    j, t, x0s = world
    key = jax.random.key(14)
    jpc, tpc = _percept() if percept else (None, None)

    def plan_step_batched(noisy, U_warm, umaps):
        return jax.vmap(lambda e, u, m: jsolver.run_step(j["p"], j["plan"], j["n"], e, u, j["ob"],
                                                         m))(noisy, U_warm, umaps)

    xf_w, rec_w = jplant.closed_loop_full_stack_batched(
        j["p"], j["cp"], noise_j, j["gm"], j["gg"], j["plan"], j["n"], jnp.asarray(x0s), key,
        T_CYCLES, j["ob"], *j["obs"], percept=jpc, plan_step_batched=plan_step_batched,
        use_pallas=False)
    noise_draws, camera_draws = draws_batched(key, T_CYCLES, B)
    for use_kernels in (True, False):
        xf_g, rec_g = tplant.closed_loop_full_stack_batched(
            t["p"], t["cp"], interop.noise_params_from_reference(noise_j), t["gm"], t["gg"],
            t["plan"], t["n"], t64(x0s), None, T_CYCLES, t["ob"], *t["obs"], global_res=1.0,
            percept=tpc, use_kernels=use_kernels, noise_draws=noise_draws,
            camera_draws=camera_draws)
        compare_records(rec_g, rec_w, xf_g, xf_w)
    assert rec_g["uncertainty_max"].shape == (T_CYCLES, B)
    if percept:
        assert bool(rec_g["bbox_valid"].all()) and float(rec_g["semantic_max"].max()) == 100.0
