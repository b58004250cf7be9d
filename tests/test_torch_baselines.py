"""The baseline planners of the port (models/frenet, models/ccnmpc) and
ops/dbscan vs the JAX package.

Every test of tests/test_baselines.py has its mirror here, as the same
behaviour on the port, each also held against the JAX function on the same
float64 inputs; the three ``test_dbscan_*`` tests of tests/test_components.py
likewise.  The port's planners are batched (egos (B, 4)); the JAX ones are
single-lane and vmapped.  The bar is the experiment layer's: |got - want| <=
1e-9 * max(1, max |want|), integers and booleans equal; the covariance
propagation and the tightening within 1e-12.  The two tests JAX marks
``slow`` (the comparison grid and the full-stack comparison) are sized here
to run in this tier: horizon 10 and 40 at 2 and 1 runs, 4 and 3 cycles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import ccnmpc as jcc, dynamics as jdyn, frenet as jfr
from cilqr_tpu.models import obstacles as jobs, reference_path as jrp, solver as jsolver
from cilqr_tpu.models import uncertainty as junc
from cilqr_tpu.ops import dbscan as jdbscan
from cilqr_tpu.sim import runner as jrunner, scenarios as jsc
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams
from cilqr_tpu_torch.models import ccnmpc as tcc, dynamics as tdyn, frenet as tfr
from cilqr_tpu_torch.models import obstacles as tobs, reference_path as trp, solver as tsolver
from cilqr_tpu_torch.models import uncertainty as tunc
from cilqr_tpu_torch.ops import dbscan as tdbscan, gridmap as tgrid
from cilqr_tpu_torch.sim import runner as trunner, scenarios as tsc
from cilqr_tpu_torch.utils import interop, metrics as tmetrics

DEV = "cpu"  # the port allocates on the card unless told otherwise
REL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs: the tier runs six workers at
    once, and these small eager loops only lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rel=REL):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(1.0, float(np.abs(w).max())))


def same_result(got, want, lanes=None):
    """A batched result against a vmapped (or, with ``lanes``, single)
    JAX result: the selection / iteration count and lamb equal, the rest
    within the bar."""
    for k in want._fields:
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        if lanes is None:
            g = g[0]
        g = g.numpy()
        if k in ("iterations", "lamb"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            close(g, w)


# ------------------------------------------------------------- polynomials
def test_quintic_boundary_conditions():
    T = t64(3.0)
    p0, v0, a0, p1, v1, a1 = 0.5, 1.2, -0.3, 2.0, 0.0, 0.0
    b3, b4, b5 = tfr._quintic(T, p0, v0, a0, p1, v1, a1)
    for g, w in zip((b3, b4, b5), jfr._quintic(jnp.asarray(3.0), p0, v0, a0, p1, v1, a1)):
        close(g, w)

    def d(tau):
        return float(p0 + v0 * T * tau + 0.5 * a0 * T**2 * tau**2 + b3 * tau**3 + b4 * tau**4
                     + b5 * tau**5)

    eps, Tf = 1e-6, float(T)
    assert abs(d(1.0) - p1) < 1e-9
    assert abs((d(1.0) - d(1.0 - eps)) / (eps * Tf) - v1) < 1e-4
    assert abs((d(1.0) - 2 * d(1.0 - eps) + d(1.0 - 2 * eps)) / (eps**2 * Tf**2) - a1) < 1e-2


def test_quartic_boundary_conditions():
    T = t64(2.5)
    p0, v0, a0, v1, a1 = 10.0, 4.0, 0.5, 6.0, 0.0
    b3, b4 = tfr._quartic(T, p0, v0, a0, v1, a1)
    for g, w in zip((b3, b4), jfr._quartic(jnp.asarray(2.5), p0, v0, a0, v1, a1)):
        close(g, w)

    def s(tau):
        return float(p0 + v0 * T * tau + 0.5 * a0 * T**2 * tau**2 + b3 * tau**3 + b4 * tau**4)

    eps, Tf = 1e-6, float(T)
    assert abs((s(1.0) - s(1.0 - eps)) / (eps * Tf) - v1) < 1e-4
    assert abs((s(1.0) - 2 * s(1.0 - eps) + s(1.0 - 2 * eps)) / (eps**2 * Tf**2) - a1) < 1e-2


def test_jerk_integral_matches_quadrature():
    T, b3, b4, b5 = 2.0, 0.7, -0.3, 0.11
    got = float(tfr._jerk_integral(t64(T), 0.0, t64(b3), t64(b4), t64(b5)))
    tau = np.linspace(0, 1, 20001)
    jerk = (6 * b3 + 24 * b4 * tau + 60 * b5 * tau**2) / T**3
    want = float(np.trapezoid(jerk**2, tau) * T)
    assert abs(got - want) < 1e-6 * max(1.0, abs(want))
    close(got, jfr._jerk_integral(jnp.asarray(T), 0.0, jnp.asarray(b3), jnp.asarray(b4),
                                  jnp.asarray(b5)))


# ------------------------------------------------------------- frenet frame
@pytest.fixture(scope="module")
def lane_setup():
    """The straight lane of tests/test_baselines.py in both packages."""
    p_j = SolverParams()
    plan_np = jsc.straight_lane_plan()
    jplan, jn = jrp.pad_global_plan(p_j, plan_np, dtype=jnp.float64)
    p = interop.solver_params_from_reference(p_j)
    tplan, tn = trp.pad_global_plan(p, plan_np, dtype=torch.float64, device=DEV)
    return (p_j, jplan, jn), (p, tplan, tn)


def obstacles(centers, sizes, yaws, p_j):
    """The same static obstacles in both packages."""
    jo = jobs.make_static_obstacles(p_j, centers, sizes, yaws, dtype=jnp.float64)
    return jo, interop.obstacles_from_numpy(jo, dtype=torch.float64, device=DEV)


def frenet_both(lane_setup, fp_kw, ego, ob=(None, None), um=(None, None), sig=None):
    """(port result at B=1, JAX result) of one Frenet cycle."""
    (p_j, jplan, jn), (p, tplan, tn) = lane_setup
    want = jax.jit(lambda e: jfr.plan_step(
        p_j, jfr.FrenetParams(**fp_kw), jplan, jn, e, ob[0], um[0],
        None if sig is None else jnp.asarray(sig)))(jnp.asarray(ego))
    got = tfr.plan_steps(p, tfr.FrenetParams(**fp_kw), tplan, tn, t64(ego)[None], ob[1], um[1],
                         None if sig is None else t64(sig))
    same_result(got, want)
    return got, want


def test_projection_on_line(lane_setup):
    (p_j, jplan, jn), (p, tplan, tn) = lane_setup
    ego = np.array([100.0, -306.74, 4.0, 0.0])  # exactly on the lane
    ref = tfr._ref_line(trp.get_local_plan(p, tplan, tn, t64(ego)))
    jref = jfr._ref_line(jrp.get_local_plan(p_j, jplan, jn, jnp.asarray(ego)))
    for pt in (ego[:2], np.array([100.0, -305.74]), np.array([107.3, -309.1])):
        got = tfr._project(ref, t64(pt))
        for g, w in zip(got, jfr._project(jref, jnp.asarray(pt))):
            close(g, w)
    s0, d0, th = tfr._project(ref, t64(ego[:2]))
    assert abs(float(d0)) < 1e-6 and abs(float(th)) < 1e-6
    # 1 m left of the lane (lane heads +x, left = +y)
    _, d1, _ = tfr._project(ref, t64([100.0, -305.74]))
    assert abs(float(d1) - 1.0) < 1e-6


def test_frenet_plan_basic(lane_setup):
    p = lane_setup[1][0]
    ego = np.array([100.0, -306.5, 4.0, 0.02])
    res, _ = frenet_both(lane_setup, {}, ego)
    X = res.X[0].numpy()
    assert np.isfinite(X).all()
    assert float(res.lamb[0]) == 1.0                 # something feasible
    assert X[-1, 0] > X[0, 0] + 5.0                  # forward progress
    assert res.U.shape == (1, p.horizon, 2)
    np.testing.assert_allclose(X[0], ego, atol=1e-6)  # starts at the ego state
    # tracks toward the lane: final offset smaller than initial
    assert abs(X[-1, 1] + 306.74) <= abs(X[0, 1] + 306.74) + 1e-6


def test_frenet_avoids_obstacle(lane_setup):
    ob = obstacles([[115.0, -306.74]], [[4.8, 2.0]], [0.0], lane_setup[0][0])
    res, _ = frenet_both(lane_setup, {}, np.array([100.0, -306.74, 5.0, 0.0]), ob)
    assert float(res.lamb[0]) == 1.0
    X = res.X[0].numpy()
    # clearance at least the front-disc inflated half-width
    assert np.hypot(X[:, 0] - 115.0, X[:, 1] + 306.74).min() > 2.0


def test_frenet_expansion_more_conservative(lane_setup):
    """An obstacle 3.4 m beside the lane: inside the expansion-inflated
    safety ellipse but outside the origin one, so origin keeps the lane
    while expansion shies away."""
    ob = obstacles([[115.0, -306.74 + 3.4]], [[4.8, 2.0]], [0.0], lane_setup[0][0])
    ego = np.array([100.0, -306.74, 5.0, 0.0])

    def min_dist(mode):
        res, _ = frenet_both(lane_setup, {"mode": mode}, ego, ob, sig=[0.5, 0.5, 0.02])
        assert float(res.lamb[0]) == 1.0
        X = res.X[0].numpy()
        return np.hypot(X[:, 0] - 115.0, X[:, 1] + 306.74 - 3.4).min()

    assert min_dist("expansion") > min_dist("origin") + 0.3


def test_frenet_propagation_avoids_uncertain_region(lane_setup):
    ego = np.array([100.0, -306.74, 5.0, 0.0])
    # map frame = ego frame at build time; a high-occupancy blob straight
    # ahead on the lane (x local ~ +12 m)
    vals = np.zeros((40, 40))
    vals[18:24, 22:30] = 100.0
    jum = junc.make_uncertainty_map(jnp.asarray(vals), center_xy=[10.0, 0.0], resolution=0.5,
                                    origin_xy=ego[:2], origin_yaw=ego[3], dtype=jnp.float64)
    tum = interop.unc_map_from_numpy(jum, dtype=torch.float64, device=DEV)
    res, _ = frenet_both(lane_setup, {"mode": "propagation"}, ego, um=(jum, tum))
    assert float(res.lamb[0]) == 1.0
    # the map along the winning trajectory stays under the threshold
    local = res.X[0, :, :2] - t64(ego[:2])
    u, _ = tgrid.sample_bilinear_with_grad(t64(vals), tum.geom, local)
    u = torch.where(tgrid.in_bounds(tum.geom, local), u, torch.zeros_like(u))
    assert float(u.max()) < tfr.FrenetParams().unc_threshold


def wall(p_j):
    ys = np.linspace(-306.74 - 4.0, -306.74 + 4.0, 5)
    return obstacles([[112.0, y] for y in ys], [[4.8, 2.0]] * 5, [0.0] * 5, p_j)


def test_frenet_blocked_corridor_brakes(lane_setup):
    """With braking candidates in the lattice a blocked-but-distant wall
    selects a feasible stopping maneuver."""
    res, _ = frenet_both(lane_setup, {}, np.array([100.0, -306.74, 5.0, 0.0]),
                         wall(lane_setup[0][0]))
    assert float(res.lamb[0]) == 1.0          # a stop maneuver is feasible
    X = res.X[0].numpy()
    assert X[-1, 2] < 1.0                     # ... and it brakes
    assert X[:, 0].max() < 112.0 - 2.4        # never reaches the wall


def test_frenet_infeasible_fallback_emergency_brake(lane_setup):
    """Inside the inflated safety set of a wall nothing is feasible: the
    fallback is a max-deceleration straight-line stop."""
    p = lane_setup[1][0]
    res, _ = frenet_both(lane_setup, {}, np.array([109.0, -306.74, 5.0, 0.0]),
                         wall(lane_setup[0][0]))
    assert float(res.lamb[0]) == 0.0          # flagged infeasible
    X = res.X[0].numpy()
    assert np.isfinite(X).all()
    assert X[-1, 2] == 0.0                    # brakes to a stop
    np.testing.assert_allclose(X[:, 3], 0.0, atol=1e-9)  # straight line
    assert float(res.U[0, 0, 0]) <= p.acc_min + 1e-6


def test_frenet_emitted_controls_feasible(lane_setup):
    """The recorded U never claims infeasible actuation: acc within the box,
    yaw rate within v * tan(steer_max) / L at each step's speed."""
    p = lane_setup[1][0]
    ob = obstacles([[112.0, -306.74]], [[4.8, 2.0]], [0.0], lane_setup[0][0])
    # fast, offset and misaligned: the raw finite-difference controls of
    # the winning swerve exceed the bounds
    ego = np.array([100.0, -304.0, 8.0, -0.5])
    for o in ((None, None), ob):
        res, _ = frenet_both(lane_setup, {}, ego, o)
        U, X = res.U[0].numpy(), res.X[0].numpy()
        assert (U[:, 0] >= p.acc_min - 1e-9).all() and (U[:, 0] <= p.acc_max + 1e-9).all()
        bound = X[:-1, 2] * np.tan(p.steer_angle_max) / p.wheelbase
        assert (np.abs(U[:, 1]) <= bound + 1e-9).all()


def test_frenet_expansion_requires_sigmas(lane_setup):
    (p_j, jplan, jn), (p, tplan, tn) = lane_setup
    jo, to = obstacles([[115.0, -306.0]], [[4.8, 2.0]], [0.0], p_j)
    ego = np.array([100.0, -306.74, 5.0, 0.0])
    with pytest.raises(ValueError, match="sigmas"):
        tfr.plan_steps(p, tfr.FrenetParams(mode="expansion"), tplan, tn, t64(ego)[None], to)
    with pytest.raises(ValueError, match="sigmas"):
        jfr.plan_step(p_j, jfr.FrenetParams(mode="expansion"), jplan, jn, jnp.asarray(ego), jo)


def test_frenet_bad_mode_rejected():
    with pytest.raises(ValueError, match="mode must be one of"):
        tfr.FrenetParams(mode="bogus")
    assert tfr.MODES == jfr.MODES
    assert dataclasses.asdict(tfr.FrenetParams()) == dataclasses.asdict(jfr.FrenetParams())
    assert tfr.FrenetParams().n_candidates == jfr.FrenetParams().n_candidates == 180


@pytest.mark.parametrize("mode", ["origin", "expansion", "propagation"])
def test_frenet_matches_jax_per_lane(lane_setup, mode):
    """40 lanes on the curving plan of tests/conftest.py with two obstacles
    and a random uncertainty map (every lane reads it in propagation mode):
    per lane the selected candidate and lamb equal, X, U and J within the
    bar; some lanes start inside an obstacle's safety set (the brake)."""
    p_j = SolverParams()
    p = interop.solver_params_from_reference(p_j)
    s = np.linspace(0.0, 119.0, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s], axis=1)
    jplan, jn = jrp.pad_global_plan(p_j, plan_np, dtype=jnp.float64)
    tplan, tn = trp.pad_global_plan(p, plan_np, dtype=torch.float64, device=DEV)
    rng = np.random.default_rng(8)
    egos = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, [3.0, 1.2, 1.5, 0.25], (40, 4))
    egos[:, 2] = np.abs(egos[:, 2])
    egos[-3:] = [[110.5, -305.8, 5.0, 0.0], [117.0, -303.2, 3.0, 0.3], [108.0, -305.0, 9.0, 0.6]]
    jo, to = obstacles([[112.0, -305.8], [120.0, -303.0]], [[4.5, 2.0]] * 2, [0.05, 0.3], p_j)
    jum = junc.make_uncertainty_map(rng.uniform(0.0, 100.0, (40, 40)), [10.0, 0.0], 0.5,
                                    [100.0, -305.6], 0.05, dtype=jnp.float64)
    tum = interop.unc_map_from_numpy(jum, dtype=torch.float64, device=DEV)
    sig = np.array([0.3, 0.2, 0.02])
    want = jax.jit(jax.vmap(lambda e: jfr.plan_step(
        p_j, jfr.FrenetParams(mode=mode), jplan, jn, e, jo, jum, jnp.asarray(sig))))(
        jnp.asarray(egos))
    got = tfr.plan_steps(p, tfr.FrenetParams(mode=mode), tplan, tn, t64(egos), to, tum, t64(sig))
    same_result(got, want, lanes=True)
    lamb = got.lamb.numpy()
    assert lamb.sum() >= 20 and (lamb == 0.0).sum() >= 3   # planned lanes and braking lanes
    assert len(set(got.iterations.tolist())) > 5      # many different winners
    # one map shared by the batch is the same map given per lane
    shared = tfr.plan_steps(p, tfr.FrenetParams(mode=mode), tplan, tn, t64(egos), to,
                            tunc.UncertaintyMap(tum.values.expand(40, 40, 40),
                                                tgrid.GridGeom(tum.geom.center.expand(40, 2),
                                                               tum.geom.resolution.expand(40),
                                                               tum.geom.length.expand(40, 2)),
                                                tum.origin_xy.expand(40, 2),
                                                tum.origin_yaw.expand(40)), t64(sig))
    for g, w in zip(shared, got):
        assert torch.equal(g, w)


def test_interp_and_unwrap_match_numpy():
    """numpy's semantics on the traps: points on the knots, outside them,
    repeated knots; unwrap at jumps of exactly pi and beyond."""
    rng = np.random.default_rng(4)
    xp = np.cumsum(rng.uniform(0.0, 1.0, (3, 12)), axis=1)
    xp[:, 5] = xp[:, 4]                      # a repeated knot
    fp = rng.normal(size=(3, 12))
    x = np.concatenate([xp[:, :4], rng.uniform(-1.0, 8.0, (3, 20)), xp[:, -1:] + 1.0], axis=1)
    got = tfr._interp(t64(x), t64(xp), t64(fp)).numpy()
    for b in range(3):
        # inside a segment XLA may fuse the last multiply-add and numpy
        # rounds its slope form: an ulp apart
        close(got[b], jnp.interp(x[b], xp[b], fp[b]), rel=1e-15)
        close(got[b], np.interp(x[b], xp[b], fp[b]), rel=1e-15)
        np.testing.assert_array_equal(got[b, :4], fp[b, :4])       # on the knots
        assert (got[b, -1] == fp[b, -1]) and (got[b][x[b] < xp[b, 0]] == fp[b, 0]).all()
    ph = np.concatenate([rng.uniform(-9.0, 9.0, (2, 30)), [[0.0, np.pi, 0.0, -np.pi, 2 * np.pi,
                                                            -1.0] * 5]], axis=0)
    np.testing.assert_array_equal(tfr.unwrap(t64(ph)).numpy(), np.unwrap(ph))
    # XLA's cumulative sum associates its terms in another order
    close(tfr.unwrap(t64(ph)), jnp.unwrap(ph), rel=1e-15)


# ------------------------------------------------------------------ ccnmpc
def test_covariance_propagation_vs_numpy(lane_setup):
    p_j, p = lane_setup[0][0], lane_setup[1][0]
    rng = np.random.default_rng(0)
    U = rng.uniform(-0.5, 0.5, (8, 2))
    x0 = np.array([100.0, -306.0, 4.0, 0.05])
    X = tdyn.rollout(p, t64(x0), t64(U))
    W = tcc.process_noise(NoiseParams(0.1, 0.2, 0.01), torch.float64, DEV)
    got = tcc.propagate_covariance(p, X, t64(U), 0.5 * W, W).numpy()

    fx, _ = tdyn.jacobians(p, X[:-1, 2], X[:-1, 3], t64(U)[:, 0])
    want = [0.5 * W.numpy()]
    for k in range(8):
        want.append(fx[k].numpy() @ want[-1] @ fx[k].numpy().T + W.numpy())
    np.testing.assert_allclose(got, np.stack(want), atol=1e-12)
    # covariance grows along the horizon (positive process noise)
    assert np.trace(got[-1]) > np.trace(got[0])
    # the JAX function, and batched lanes equal to single ones
    Xj = jdyn.rollout(p_j, jnp.asarray(x0), jnp.asarray(U))
    Wj = jcc.process_noise(NoiseParams(0.1, 0.2, 0.01), jnp.float64)
    np.testing.assert_array_equal(W.numpy(), np.asarray(Wj))
    np.testing.assert_allclose(got, np.asarray(jcc.propagate_covariance(p_j, Xj, jnp.asarray(U),
                                                                        0.5 * Wj, Wj)),
                               rtol=0, atol=1e-12)
    Ub = t64(rng.uniform(-0.5, 0.5, (3, 8, 2)))
    Xb = tdyn.rollout(p, t64(x0).expand(3, 4), Ub)
    batched = tcc.propagate_covariance(p, Xb, Ub, W, W)
    for b in range(3):
        close(batched[b], tcc.propagate_covariance(p, Xb[b], Ub[b], W, W), rel=1e-15)


def test_kappa_monotone_and_analytic():
    # chi2_2 quantile: 1 - exp(-x/2) = 1 - delta  =>  x = -2 ln(delta)
    assert abs(tcc.CCParams(delta=0.05).kappa - 2.4477468) < 1e-6
    assert tcc.CCParams(delta=0.01).kappa > tcc.CCParams(delta=0.1).kappa
    for d in (0.01, 0.05, 0.2):
        assert tcc.CCParams(delta=d).kappa == jcc.CCParams(delta=d).kappa


def test_tightened_obstacles_grow(lane_setup):
    p_j, p = lane_setup[0][0], lane_setup[1][0]
    jo, to = obstacles([[10.0, 0.0]], [[4.0, 2.0]], [0.7], p_j)
    S = torch.eye(4, dtype=torch.float64).expand(p.horizon + 1, 4, 4) * 0.04
    ob_t = tcc.tightened_obstacles(p, tcc.CCParams(), to, S)
    grow = (ob_t.dims - to.dims).numpy()[0]
    # isotropic 0.2-sigma: growth = 2 * kappa * 0.2 on both axes at every step
    np.testing.assert_allclose(grow, 2 * tcc.CCParams().kappa * 0.2, atol=1e-9)
    assert torch.equal(ob_t.pos, to.pos) and torch.equal(ob_t.mask, to.mask)
    # against JAX on anisotropic covariances, and per lane in a batch
    rng = np.random.default_rng(1)
    L = rng.normal(size=(3, p.horizon + 1, 4, 4))
    Sb = L @ np.swapaxes(L, -1, -2) * 0.05
    jo2, to2 = obstacles([[10.0, 0.0], [14.0, 2.0]], [[4.0, 2.0], [3.0, 1.5]], [0.7, -2.1], p_j)
    got = tcc.tightened_obstacles(p, tcc.CCParams(), to2, t64(Sb))
    assert got.dims.shape == (3, p.max_obstacles, p.horizon, 2)
    assert got.pos.shape == (3, p.max_obstacles, p.horizon, 4)
    for b in range(3):
        want = jcc.tightened_obstacles(p_j, jcc.CCParams(), jo2, jnp.asarray(Sb[b]))
        np.testing.assert_allclose(got.dims[b].numpy(), np.asarray(want.dims), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got.pos[b].numpy(), np.asarray(want.pos))


def ccnmpc_world(lane_setup, horizon, iters):
    (p_j, jplan, jn), (_, tplan, tn) = lane_setup
    p_j = dataclasses.replace(p_j, horizon=horizon, max_iterations=iters)
    p = interop.solver_params_from_reference(p_j)
    jo, to = obstacles([[120.0, -306.0]], [[4.8, 2.0]], [0.0], p_j)
    U0 = np.asarray(jsolver.initial_controls(p_j, dtype=jnp.float64))
    return p_j, p, jplan, jn, tplan, tn, jo, to, U0


def test_ccnmpc_more_conservative_than_base(lane_setup):
    p_j, p, jplan, jn, tplan, tn, jo, to, U0 = ccnmpc_world(lane_setup, 20, 8)
    ego = np.array([100.0, -305.6, 4.0, 0.05])
    noise = NoiseParams()
    res_cc = tcc.run_steps(p, tcc.CCParams(), noise, tplan, tn, t64(ego)[None], t64(U0)[None], to)
    res_b = tsolver.run_step(p, tplan, tn, t64(ego), t64(U0), to, None)
    want = jax.jit(lambda e: jcc.run_step(p_j, jcc.CCParams(), noise, jplan, jn, e,
                                          jnp.asarray(U0), jo))(jnp.asarray(ego))
    same_result(res_cc, want)

    def mind(X):
        return np.hypot(X[:, 0] - 120.0, X[:, 1] + 306.0).min()

    assert np.isfinite(res_cc.X.numpy()).all()
    assert mind(res_cc.X[0].numpy()) >= mind(res_b.X.numpy()) - 1e-6


def test_ccnmpc_sigma_zero_matches_base(lane_setup):
    """n_sqp=1 at sigma 0: the tightening is exactly zero and the one solve
    is the base CILQR's."""
    p_j, p, jplan, jn, tplan, tn, jo, to, U0 = ccnmpc_world(lane_setup, 15, 6)
    ego = np.array([100.0, -305.6, 4.0, 0.05])
    zero = NoiseParams(0.0, 0.0, 0.0)
    res_cc = tcc.run_steps(p, tcc.CCParams(n_sqp=1), zero, tplan, tn, t64(ego)[None],
                           t64(U0)[None], to)
    res_b = tsolver.run_step(p, tplan, tn, t64(ego), t64(U0), to, None)
    np.testing.assert_allclose(res_cc.U[0].numpy(), res_b.U.numpy(), atol=1e-9)
    want = jcc.run_step(p_j, jcc.CCParams(n_sqp=1), zero, jplan, jn, jnp.asarray(ego),
                        jnp.asarray(U0), jo)
    same_result(res_cc, want)


@pytest.mark.parametrize("sigma", [0.0, 0.16], ids=["sigma0", "sigma0.16"])
def test_ccnmpc_matches_jax_per_lane(lane_setup, sigma):
    """16 lanes, warm starts perturbed, two obstacles (one of them beside
    the lane), n_sqp=2: per lane the iteration count equal, X, U and J within
    the bar, against the vmapped JAX run_step; and without obstacles (the
    shared-world solve)."""
    p_j, p, jplan, jn, tplan, tn, _, _, U0 = ccnmpc_world(lane_setup, 15, 6)
    jo, to = obstacles([[118.0, -306.2], [112.0, -303.0]], [[4.8, 2.0]] * 2, [0.0, 0.2], p_j)
    rng = np.random.default_rng(6)
    egos = np.array([100.0, -306.2, 4.0, 0.0]) + rng.normal(0, [2.0, 0.6, 1.0, 0.1], (16, 4))
    Us = U0 + rng.normal(0, 0.1, (16,) + U0.shape)
    noise = NoiseParams(sigma, sigma, sigma * 0.1)
    for jworld, tworld in ((jo, to), (None, None)):
        want = jax.jit(jax.vmap(lambda e, u: jcc.run_step(p_j, jcc.CCParams(), noise, jplan, jn,
                                                          e, u, jworld)))(
            jnp.asarray(egos), jnp.asarray(Us))
        got = tcc.run_steps(p, tcc.CCParams(), noise, tplan, tn, t64(egos), t64(Us), tworld)
        same_result(got, want, lanes=True)


# ------------------------------------------------------- comparison runner
def test_algorithm_comparison_grid(global_plan, tmp_path):
    p = dataclasses.replace(interop.solver_params_from_reference(SolverParams()), horizon=10,
                            max_iterations=4)
    sc = tsc.Scenario("cmp", np.array([[120.0, -305.0, 0.0]]))
    results, rows = trunner.run_algorithm_comparison(
        p, NoiseParams(0.05, 0.05, 0.005), global_plan,
        np.array([100.0, -305.6, 4.0, 0.05]), n_cycles=4, scenario=sc,
        algorithms=("cilqr", "ccnmpc", "frenet_origin"), n_runs=2, dtype=torch.float64,
        generator=torch.Generator().manual_seed(0), device=DEV)
    assert set(results) == {"cilqr", "ccnmpc", "frenet_origin"}
    assert len(rows) == 6
    assert all(np.isfinite(r["velocity_mean"]) for r in rows)
    tmetrics.export_csv(rows, str(tmp_path / "cmp.csv"))
    text = (tmp_path / "cmp.csv").read_text()
    assert "algorithm" in text.splitlines()[0]
    assert "frenet_origin" in text


def test_unknown_algorithm_rejected(lane_setup):
    (p_j, jplan, jn), (p, tplan, tn) = lane_setup
    with pytest.raises(ValueError, match="unknown algorithm"):
        trunner.make_plan_step("rrt", p, NoiseParams(), tplan, tn)
    with pytest.raises(ValueError):
        jrunner.make_plan_step("rrt", p_j, NoiseParams(), jplan, jn)


def test_full_stack_comparison_differentiates(global_plan):
    """With per-cycle costmaps `cilqr` and `cilqr_base` diverge, and so do
    `frenet_propagation` and `frenet_origin` (without them the uncertainty
    term has nothing to consume).  Horizon 40, so the planned tail reaches
    the corridor costmap ~12 m ahead of the ego."""
    p = dataclasses.replace(interop.solver_params_from_reference(SolverParams()),
                            max_iterations=4)
    cp = dataclasses.replace(interop.costmap_params_from_reference(CostmapParams()), rows=32,
                             cols=48, window_radius=4)
    ggeom = tgrid.make_geom([130.0, -280.0], 1.0, 128, 128, dtype=torch.float64, device=DEV)
    xs, ys = tgrid.cell_positions(ggeom, 128, 128)
    xs, ys = xs.numpy(), ys.numpy()
    gm = np.where(((xs > 103) & (xs < 118))[:, None] & ((ys > -307.5) & (ys < -303.0))[None, :],
                  90.0, 0.0)
    sc = tsc.Scenario("fs", np.array([[120.0, -305.0, 0.0]]))
    draws = torch.randn((3, 1, 3), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    outs = {}
    for algo in ("cilqr", "cilqr_base", "frenet_origin", "frenet_propagation"):
        out, rows = trunner.run_experiment_batch(
            p, NoiseParams(0.05, 0.05, 0.005), global_plan,
            np.array([100.0, -305.6, 4.0, 0.05]), n_cycles=3, scenario=sc, n_runs=1,
            dtype=torch.float64, algorithm=algo, costmap_params=cp, global_map=t64(gm),
            global_geom=ggeom, noise_draws=draws, device=DEV)
        assert all(np.isfinite(r["velocity_mean"]) for r in rows)
        outs[algo] = out["record"]["start_pos"]
    # the same noise: any difference comes from the uncertainty-map term
    assert not torch.allclose(outs["cilqr"], outs["cilqr_base"])
    assert not torch.allclose(outs["frenet_propagation"], outs["frenet_origin"])


# ------------------------------------------------------------------- dbscan
def labels_both(pts, eps, min_points, mask=None):
    got = tdbscan.dbscan(t64(pts), eps, None if mask is None else torch.tensor(mask),
                         min_points=min_points)
    want = jdbscan.dbscan(jnp.asarray(pts), eps, None if mask is None else jnp.asarray(mask),
                          min_points)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


def test_dbscan_two_blobs_and_noise():
    rng = np.random.default_rng(35)
    pts = np.concatenate([rng.normal([0, 0], 0.2, (20, 2)), rng.normal([5, 5], 0.2, (20, 2)),
                          np.array([[10.0, -10.0], [-8.0, 9.0]])])
    labels = labels_both(pts, 1.0, 4)
    l1, l2 = set(labels[:20]), set(labels[20:40])
    assert len(l1) == 1 and len(l2) == 1 and l1 != l2
    assert (labels[40:] == -1).all()


def test_dbscan_padding_masked():
    pts = np.concatenate([np.random.default_rng(0).normal(0, 0.1, (10, 2)), np.zeros((6, 2))])
    labels = labels_both(pts, 0.5, 3, mask=np.array([True] * 10 + [False] * 6))
    assert (labels[10:] == -1).all()
    assert len(set(labels[:10])) == 1


def test_dbscan_chain_connectivity():
    """A chain of core points merges into one cluster (label propagation
    over many hops)."""
    labels = labels_both(np.stack([np.arange(30) * 0.4, np.zeros(30)], axis=1), 0.5, 2)
    assert len(set(labels)) == 1 and labels[0] != -1


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_ccnmpc_on_card_holds_plain_versions(global_plan):
    """CCNMPC on the card, 256 lanes at horizon 40: every two-phase solve
    launches the Riccati kernel K2 once per LM iteration; the batch against
    the same batch on the plain versions (``route.plain()``) by
    chip_smoke.check_lanes's rules
    (the float32 and float64 plain references, 2-ulp nudges to find the
    chaotic lanes, the second, warm-started solve within the closed loop's
    allowance)."""
    import chip_smoke as cs
    from cilqr_tpu_torch.ops import riccati_cuda, route

    dev = torch.device("cuda")
    p = interop.solver_params_from_reference(SolverParams())
    rng = np.random.default_rng(17)
    egos = torch.tensor(np.array([100.0, -305.6, 4.0, 0.05])
                        + rng.normal(0, [2.0, 0.5, 1.0, 0.1], (256, 4)), dtype=torch.float32,
                        device=dev)
    noise = NoiseParams(0.16, 0.16, 0.017)

    def run(e, dtype=torch.float32):
        plan, n = trp.pad_global_plan(p, global_plan, dtype=dtype, device=dev)
        ob = tobs.make_static_obstacles(p, [[112.0, -305.8], [125.0, -303.5]], [[4.5, 2.0]] * 2,
                                        [0.05, 0.1], dtype=dtype, device=dev)
        U0 = tsolver.initial_controls(p, dtype=dtype, device=dev).expand(
            e.shape[0], p.horizon, 2).contiguous()
        return cs.pick(tcc.run_steps(p, tcc.CCParams(), noise, plan, n, e.to(dtype), U0, ob))

    before = riccati_cuda.LAUNCHES
    got = run(egos)
    torch.cuda.synchronize()
    assert riccati_cuda.LAUNCHES - before >= tcc.CCParams().n_sqp
    assert all(bool(torch.isfinite(t).all()) for t in got)
    with route.plain():
        k2 = riccati_cuda.LAUNCHES
        want32, want64 = run(egos), run(egos.double(), torch.float64)
        nudged = cs.nudged_results(run, egos, cs.NUDGES)
        assert riccati_cuda.LAUNCHES == k2
    cs.check_lanes("ccnmpc", got, want32, want64, nudged, chaotic_it_off=2, by_spread=True,
                   calm_it_off=cs.FS_CALM_IT_OFF)
