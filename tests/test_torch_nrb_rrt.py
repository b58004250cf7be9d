"""The NRB-RRT baseline of the port (models/nrb_rrt) vs the JAX package.

The six tests of tests/test_nrb_rrt.py, as the same behaviours on the port
(``test_deterministic_given_state``, ``slow`` in JAX, at horizon 20 and 48
iterations), each also held against JAX's ``plan_step`` on the same float64
inputs: per lane the node count and lamb equal, X, U and J within 1e-9 of
max(1, max |want|).  The draws come from ``utils.prng``, JAX's threefry bit
for bit, so the trees grow alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import nrb_rrt as jnrb, obstacles as jobs, reference_path as jrp
from cilqr_tpu.sim import plant as jplant, runner as jrunner, scenarios as jsc
from cilqr_tpu.utils.params import NoiseParams, SolverParams
from cilqr_tpu_torch.models import nrb_rrt as tnrb, reference_path as trp
from cilqr_tpu_torch.sim import plant as tplant, runner as trunner, scenarios as tsc
from cilqr_tpu_torch.utils import interop

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


def same_lanes(got, want):
    """Per lane: node count and lamb equal, X, U, J within the bar."""
    for k in want._fields:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in ("iterations", "lamb"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=REL * max(1.0, float(np.abs(w).max())),
                                       err_msg=k)


def world(horizon, global_plan, obs_x=112.0, obs_y=-305.8):
    """The world of tests/test_nrb_rrt.py in both packages."""
    p_j = dataclasses.replace(SolverParams(), horizon=horizon)
    jplan, jn = jrp.pad_global_plan(p_j, global_plan, dtype=jnp.float64)
    jo = jobs.make_static_obstacles(p_j, np.array([[obs_x, obs_y]]), np.array([[4.5, 2.0]]),
                                    np.array([0.05]), dtype=jnp.float64)
    p = interop.solver_params_from_reference(p_j)
    tplan, tn = trp.pad_global_plan(p, global_plan, dtype=torch.float64, device=DEV)
    return (p_j, jplan, jn, jo), (p, tplan, tn,
                                  interop.obstacles_from_numpy(jo, dtype=torch.float64, device=DEV))


def both(w, np_, egos, sig=None, ob=True):
    """(port result, vmapped JAX result) of one planning cycle per ego."""
    (p_j, jplan, jn, jo), (p, tplan, tn, to) = w
    egos = np.atleast_2d(egos)
    want = jax.jit(jax.vmap(lambda e: jnrb.plan_step(
        p_j, jnrb.NRBParams(**dataclasses.asdict(np_)), jplan, jn, e, jo if ob else None, None,
        None if sig is None else jnp.asarray(sig))))(jnp.asarray(egos))
    got = tnrb.plan_steps(p, np_, tplan, tn, t64(egos), to if ob else None, None,
                          None if sig is None else t64(sig))
    same_lanes(got, want)
    return got


def min_obstacle_distance(X, obs_xy):
    return float(np.min(np.linalg.norm(np.asarray(X)[:, :2] - obs_xy, axis=1)))


def test_plans_forward_and_clear(ego_state, global_plan):
    w = world(30, global_plan)
    p = w[1][0]
    res = both(w, tnrb.NRBParams(), ego_state, [0.16, 0.16, 0.017])
    X, U = res.X[0].numpy(), res.U[0].numpy()
    assert float(res.lamb[0]) == 1.0          # admissible path found
    assert np.isfinite(X).all()
    assert X[-1, 0] > X[0, 0] + 1.0           # progress
    # the DR-inflated obstacle set is respected
    assert min_obstacle_distance(X, np.array([112.0, -305.8])) > 2.0
    # emitted controls are actuation-feasible
    assert (U[:, 0] <= p.acc_max + 1e-9).all() and (U[:, 0] >= p.acc_min - 1e-9).all()
    assert (np.abs(U[:, 1]) <= X[:-1, 2] * p.yawrate_gain + 2e-9).all()


def test_deterministic_given_state(ego_state, global_plan):
    """fold_in(ego bits) randomness: identical state -> identical plan, and
    a lane of a batch plans as it does alone."""
    w = world(20, global_plan)
    np_ = tnrb.NRBParams(n_iters=48)
    moved = ego_state + np.array([0.01, 0.0, 0.0, 0.0])
    a = both(w, np_, np.stack([ego_state, ego_state, moved]))
    assert torch.equal(a.X[0], a.X[1])
    assert not torch.equal(a.X[0], a.X[2])
    (p, tplan, tn, to) = w[1]
    alone = tnrb.plan_steps(p, np_, tplan, tn, t64(moved)[None], to)
    for g, b in zip(alone, a):
        assert torch.equal(g[0], b[2])


def test_risk_bound_blocks_when_tight(ego_state, global_plan):
    """A huge DR margin (tiny alpha, large sigma) closes the corridor: no
    admissible edge -> the emergency brake; a loose bound plans."""
    w = world(20, global_plan, obs_x=112.0, obs_y=-305.6)
    sig_huge = [3.0, 3.0, 0.017]
    r_tight = both(w, tnrb.NRBParams(risk_alpha=0.001, n_iters=48), ego_state, sig_huge)
    r_loose = both(w, tnrb.NRBParams(risk_alpha=0.5, n_iters=48), ego_state, sig_huge)
    # kappa(0.001) ~ 31.6 x sigma 4.2: every sample inadmissible
    assert float(r_tight.lamb[0]) == 0.0 and int(r_tight.iterations[0]) == 1
    assert float(r_tight.J[0]) == 1e6
    assert float(r_tight.X[0, -1, 2]) < float(ego_state[2])   # brakes along the heading
    # kappa(0.5) = 1: the tree still grows, and keeps its clearance
    assert float(r_loose.lamb[0]) == 1.0
    assert min_obstacle_distance(r_loose.X[0], np.array([112.0, -305.6])) > 2.0


def test_closed_loop_via_runner(ego_state, global_plan):
    """algorithm='nrb_rrt' through the same closed loop as every other
    planner (the batched loop with the runner's step as its hook, one run),
    against JAX's closed loop on its key's draws."""
    w = world(20, global_plan)
    (p_j, jplan, jn, _), (p, tplan, tn, _) = w
    noise = NoiseParams(0.05, 0.05, 0.005)
    sc = jsc.Scenario("t", np.array([[115.0, -305.0, 0.0]]))
    jo, *jobs_arr = jrunner.build_scenario_inputs(p_j, sc, jnp.float64)
    step = jrunner.make_plan_step("nrb_rrt", p_j, noise, jplan, jn, obstacles=jo)
    key = jax.random.key(3)
    xf_w, rec_w = jax.jit(lambda x, k: jplant.closed_loop(
        p_j, noise, jplan, jn, x, k, 6, obstacles=jo, obs_xyyaw=jobs_arr[0],
        obs_size=jobs_arr[1], obs_mask=jobs_arr[2], plan_step=step))(jnp.asarray(ego_state), key)
    draws = np.stack([np.asarray(jax.random.normal(k, (3,), dtype=jnp.float64))
                      for k in jax.random.split(key, 6)])[:, None]
    tsc_ = tsc.Scenario("t", np.array([[115.0, -305.0, 0.0]]))
    to, *tobs_arr = trunner.build_scenario_inputs(p, tsc_, torch.float64, DEV)
    tstep = trunner.make_plan_step("nrb_rrt", p, noise, tplan, tn, obstacles=to)
    xf, rec = tplant.closed_loop_batched(
        p, noise, tplan, tn, t64(ego_state)[None], None, 6, obstacles=to, obs_xyyaw=tobs_arr[0],
        obs_size=tobs_arr[1], obs_mask=tobs_arr[2], noise_draws=t64(draws), plan_step_batched=tstep)
    assert np.isfinite(xf.numpy()).all()
    assert float(xf[0, 0]) > float(ego_state[0])
    assert not bool(rec["collided"].any())
    np.testing.assert_allclose(xf[0].numpy(), np.asarray(xf_w), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(rec["iterations"][:, 0].numpy(), np.asarray(rec_w.iterations))
    np.testing.assert_allclose(rec["J"][:, 0].numpy(), np.asarray(rec_w.J), rtol=REL)
    np.testing.assert_allclose(rec["start_pos"][:, 0].numpy(), np.asarray(rec_w.start_pos),
                               rtol=0, atol=1e-9)


def test_corridor_band_derivation():
    """nrb_params_for_scenario: the gauntlet's wall faces minus the ego
    half-width + margin; scenarios without a band keep +-lat_max.  Equal to
    JAX's band."""
    p_j = SolverParams()
    p = interop.solver_params_from_reference(p_j)
    np_ = trunner.nrb_params_for_scenario(p, tsc.make_gauntlet())
    half = p.width / 2.0 + np_.collision_margin
    assert np_.lat_lo == pytest.approx(-2.1 + half)
    assert np_.lat_hi == pytest.approx(3.0)  # 5.0 - half clipped by lat_max
    assert np_.lat_lo > -2.1 and np_.lat_hi < 5.0
    assert dataclasses.asdict(np_) == dataclasses.asdict(
        jrunner.nrb_params_for_scenario(p_j, jsc.make_gauntlet()))
    plain = tsc.Scenario("t", np.array([[115.0, -305.0, 0.0]]))
    np_plain = trunner.nrb_params_for_scenario(p, plain)
    assert np_plain.lat_lo is None and np_plain.lat_hi is None
    assert dataclasses.asdict(np_plain) == dataclasses.asdict(jnrb.NRBParams())
    base = tnrb.NRBParams(collision_margin=3.0)  # a degenerate band keeps the base
    assert trunner.nrb_params_for_scenario(p, tsc.make_gauntlet(), base=base) == base
    assert tnrb.NRBParams().kappa == jnrb.NRBParams().kappa


def test_gauntlet_sigma0_plans_inside_corridor(global_plan):
    """At sigma=0 the gauntlet cell is not sampler-infeasible: with the
    corridor band the planner finds admissible edges and its trajectory
    stays off both wall faces."""
    w = world(30, global_plan)
    (p_j, jplan, jn, _), (p, tplan, tn, _) = w
    sc = tsc.make_gauntlet()
    to = trunner.build_scenario_inputs(p, sc, torch.float64, DEV)[0]
    jo = jrunner.build_scenario_inputs(p_j, jsc.make_gauntlet(), jnp.float64)[0]
    np_ = trunner.nrb_params_for_scenario(p, sc)
    y_ref = -306.74
    egos = np.array([[x, y_ref, 4.0, 0.0] for x in (85.0, 95.0, 110.0, 118.0)])
    res = both(((p_j, jplan, jn, jo), (p, tplan, tn, to)), np_, egos, [0.0, 0.0, 0.0])
    assert (res.lamb.numpy() == 1.0).all(), "no admissible path"
    lat = res.X[..., 1].numpy() - y_ref
    assert lat.min() > -2.1 + p.width / 2.0 - 1e-6
    assert lat.max() < 5.0 - p.width / 2.0 + 1e-6


def test_plan_matches_jax_per_lane(global_plan):
    """24 ego states along and off the plan, two near its end (windows of
    repeated last waypoints: the guarded tangents), with and without the
    gauntlet band and sigma, and without obstacles: per lane node count,
    lamb, X, U and J.  The route-end lanes keep at least poly_order + 1
    distinct waypoints in their window: with fewer, the degree-5 local fit
    is rank-deficient and its values (up to 1e24 and beyond) depend on the
    rounding of each implementation, JAX's jitted and eager forms included
    (ROADMAP.md, Queue 3)."""
    w = world(20, global_plan)
    rng = np.random.default_rng(12)
    egos = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, [4.0, 1.0, 1.5, 0.2], (24, 4))
    egos[:, 2] = np.abs(egos[:, 2])
    egos[-4:] = [[203.0, -302.0, 4.0, 0.0], [202.0, -301.0, 2.0, 0.1], [110.0, -305.8, 6.0, 0.0],
                 [113.0, -305.8, 0.0, 3.1]]
    band = trunner.nrb_params_for_scenario(w[1][0], tsc.make_gauntlet(), tnrb.NRBParams(n_iters=40))
    for np_, sig, ob in ((tnrb.NRBParams(n_iters=40), [0.16, 0.16, 0.017], True),
                         (band, None, True), (tnrb.NRBParams(n_iters=24, seed=9), None, False)):
        res = both(w, np_, egos, sig, ob)
        assert float(res.lamb.sum()) >= 12  # most lanes grow an admissible path


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_graph_replay_equals_eager_on_card():
    """On the card the planner after the local plan runs as a CUDA graph:
    the first call of a batch shape captures it, later calls replay it on
    their own inputs.  Every call equals the eager run bit for bit (float32,
    the gauntlet's obstacles and band, horizon 40), a second shape captures
    its own graph, and a returned result is not overwritten by the next
    replay."""
    dev = torch.device("cuda")
    p = interop.solver_params_from_reference(SolverParams())
    sc = tsc.make_gauntlet()
    plan, n = trp.pad_global_plan(p, tsc.plan_for("gauntlet"), device=dev)
    ob = trunner.build_scenario_inputs(p, sc, torch.float32, dev)[0]
    np_ = trunner.nrb_params_for_scenario(p, sc)
    sig = torch.tensor([0.16, 0.16, 0.017], device=dev)
    rng = np.random.default_rng(5)

    def egos(B):
        return torch.tensor(np.array(sc.start) + rng.normal(0, [3.0, 0.3, 1.0, 0.05], (B, 4)),
                            dtype=torch.float32, device=dev)

    def eager(e):
        tnrb.GRAPHS = False
        try:
            return tnrb.plan_steps(p, np_, plan, n, e, ob, sigmas=sig)
        finally:
            tnrb.GRAPHS = True

    first = None
    for e in (egos(10), egos(10), egos(50), egos(10)):
        got = tnrb.plan_steps(p, np_, plan, n, e, ob, sigmas=sig)
        want = eager(e)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if first is None:
            first = (got, [t.clone() for t in got])
    for g, kept in zip(*first):
        assert torch.equal(g, kept)
    assert float(first[0].lamb.sum()) >= 5


def test_tree_follows_the_ego_bits(global_plan):
    """The tree's draws are keyed by the ego's float32 bit pattern, in the
    port as in JAX: an ego moved by one float32 ulp in one component grows
    another tree (controls metres per second squared apart, not a rounding
    apart), a float64 ego moved without changing its float32 bits the same
    tree, and the two packages the same tree from the same bits.  So a
    closed loop whose egos differ in the last bit at some cycle (another
    backend's rounding) draws unrelated trees from there on, and its
    per-world outcome does too."""
    w = world(20, global_plan)
    np_ = tnrb.NRBParams(n_iters=40)
    sig = [0.16, 0.16, 0.017]
    ego = np.array([100.0, -305.6, 4.0, 0.05], np.float32)
    moved = ego.copy()
    moved[0] = np.nextafter(ego[0], np.float32(np.inf))
    a = both(w, np_, ego.astype(np.float64), sig)
    b = both(w, np_, moved.astype(np.float64), sig)
    c = both(w, np_, ego.astype(np.float64) + [1e-12, 0.0, 0.0, 0.0], sig)
    assert float((a.U - b.U).abs().max()) > 0.5
    assert torch.equal(a.U, c.U) and torch.equal(a.X[..., 1:, 2:], c.X[..., 1:, 2:])
