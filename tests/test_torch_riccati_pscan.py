"""The parallel-prefix Riccati pass (cilqr_tpu_torch/ops/riccati_pscan) and
its routing, mirroring tests/test_riccati_pscan.py and held against the JAX
package in float64.

  * pscan equals the sequential oracle of the same textbook recursion at
    N in {13, 50} and lambda in {1, 1e-4} within 1e-9 relative + 1e-11
    (the JAX test's bars), and JAX's ``backward_pscan`` on the same
    derivatives at the same bars (both scans compose in another order);
  * at small lambda it approaches the reference recursion (2e-2 at 1e-3,
    1e-4 at 1e-6);
  * a full solve with ``backward_impl="pscan"`` is finite and within 5e-2 of
    the sequential solve (the JAX test's bars), and equals JAX's pscan
    solve (iterations equal, X and U within 1e-6, J within 1e-9 relative);
  * the routing is the JAX package's: ``solver.backward_from_derivs`` and
    the LM loop of ``run_step`` take pscan, while the plain versions of the
    kernels K1, K2 and K3 stay on the sequential recursion, as the kernels
    (and the JAX package's mega and two-phase paths) do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import costs as jcosts, dynamics as jdyn, obstacles as jobs
from cilqr_tpu.models import reference_path as jrp, solver as jsolver
from cilqr_tpu.ops import riccati_pscan as jpscan
from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.models import dynamics as tdyn, reference_path as trp, solver as tsolver
from cilqr_tpu_torch.models import solver_batched as tsb
from cilqr_tpu_torch.models.costs import CostDerivs
from cilqr_tpu_torch.ops import lm_cuda, riccati_cuda, riccati_pscan
from cilqr_tpu_torch.utils import interop

DEV = "cpu"  # the port allocates on the card unless told otherwise


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


def _obstacles(p):
    return jobs.make_static_obstacles(p, np.array([[112.0, -304.0]]), np.array([[4.5, 2.0]]),
                                      np.array([0.1]), dtype=jnp.float64)


def _problem(p, ego, global_plan):
    """Derivatives at the initial rollout, from the JAX package, in both."""
    plan_xy, n = jrp.pad_global_plan(p, global_plan, dtype=jnp.float64)
    plan = jrp.get_local_plan(p, plan_xy, n, jnp.asarray(ego))
    U = jsolver.initial_controls(p, dtype=jnp.float64)
    X = jdyn.rollout(p, jnp.asarray(ego), U)
    d = jcosts.all_cost_derivs(p, plan, X, U, _obstacles(p), None)
    return (d, X, U), (CostDerivs(*(t64(a) for a in d)), t64(X), t64(U))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("lamb", [1.0, 1e-4])
@pytest.mark.parametrize("N", [13, 50])
def test_pscan_matches_sequential_standard_and_jax(ego_state, global_plan, N, lamb):
    p = dataclasses.replace(SolverParams(), horizon=N)
    (d, X, U), (td, tX, tU) = _problem(p, ego_state, global_plan)
    lam = torch.tensor(lamb, dtype=torch.float64)
    k_p, K_p = riccati_pscan.backward_pscan(p, td, tX, tU, lam)
    k_s, K_s = riccati_pscan.backward_standard_seq(p, td, tX, tU, lam)
    _close(k_p, k_s, 1e-9, 1e-11)
    _close(K_p, K_s, 1e-9, 1e-11)
    k_j, K_j = jax.jit(jpscan.backward_pscan, static_argnums=0)(p, d, X, U,
                                                                jnp.asarray(lamb, jnp.float64))
    _close(k_p, k_j, 1e-9, 1e-11)
    _close(K_p, K_j, 1e-9, 1e-11)
    k_js, K_js = jax.jit(jpscan.backward_standard_seq, static_argnums=0)(
        p, d, X, U, jnp.asarray(lamb, jnp.float64))
    _close(k_s, k_js, 1e-9, 1e-11)
    _close(K_s, K_js, 1e-9, 1e-11)


def test_pscan_approaches_reference_at_small_lambda(ego_state, global_plan):
    p = dataclasses.replace(SolverParams(), horizon=20)
    _, (td, tX, tU) = _problem(p, ego_state, global_plan)
    for lamb, tol in ((1e-3, 2e-2), (1e-6, 1e-4)):
        lam = torch.tensor(lamb, dtype=torch.float64)
        k_p, K_p = riccati_pscan.backward_pscan(p, td, tX, tU, lam)
        k_r, K_r = tsolver.backward_seq(p, td, tX, tU, lam)
        _close(k_p, k_r, tol, tol)
        _close(K_p, K_r, tol, tol)


def test_pscan_takes_leading_batch_axes(ego_state, global_plan):
    """(B, ...) derivatives with one lambda per lane: each lane equals its
    own unbatched pass (the lanes never mix)."""
    p = dataclasses.replace(SolverParams(), horizon=13)
    _, (td, tX, tU) = _problem(p, ego_state, global_plan)
    B = 3
    bat = lambda t: torch.stack([t * (1.0 + 0.01 * i) for i in range(B)])
    lam = torch.tensor([1.0, 1e-2, 1e-4], dtype=torch.float64)
    tdb = CostDerivs(*(bat(t) for t in td))
    k, K = riccati_pscan.backward_pscan(p, tdb, tX.expand(B, -1, -1), tU.expand(B, -1, -1), lam)
    for i in range(B):
        k_i, K_i = riccati_pscan.backward_pscan(p, CostDerivs(*(t[i] for t in tdb)), tX, tU, lam[i])
        _close(k[i], k_i, 1e-12, 1e-13)
        _close(K[i], K_i, 1e-12, 1e-13)


def test_inclusive_scan_keeps_the_order():
    """A non-commutative combine (2x2 products, the later on the left):
    every prefix of the log-depth scan equals the sequential fold."""
    g = torch.Generator().manual_seed(0)
    M = torch.randn((11, 2, 2), generator=g, dtype=torch.float64)
    (out,) = riccati_pscan.inclusive_scan(lambda a, b: (b[0] @ a[0],), (M,))
    acc = M[0]
    for i in range(11):
        if i:
            acc = M[i] @ acc
        _close(out[i], acc, 1e-13, 1e-13)


@pytest.fixture(scope="module")
def full_solve(ego_state, global_plan):
    p_ref = dataclasses.replace(SolverParams(), horizon=40)
    p_ps = dataclasses.replace(p_ref, backward_impl="pscan")
    plan_xy, n = jrp.pad_global_plan(p_ref, global_plan, dtype=jnp.float64)
    ego, U0, jo = jnp.asarray(ego_state), jsolver.initial_controls(p_ref, dtype=jnp.float64), _obstacles(p_ref)
    tplan, tn = trp.pad_global_plan(p_ref, global_plan, dtype=torch.float64, device=DEV)
    to = interop.obstacles_from_numpy(jo, dtype=torch.float64, device=DEV)
    targs = (tplan, tn, t64(ego_state), t64(U0), to)
    r_ref = tsolver.run_step(p_ref, *targs)
    r_ps = tsolver.run_step(p_ps, *targs)
    j_ps = jsolver.run_step(p_ps, plan_xy, n, ego, U0, jo, None)
    return p_ref, p_ps, targs, r_ref, r_ps, j_ps


def test_full_solve_with_pscan_backward(full_solve):
    p_ref, _, _, r_ref, r_ps, j_ps = full_solve
    assert bool(torch.isfinite(r_ps.X).all())
    assert int(r_ps.iterations) <= p_ref.max_iterations
    _close(r_ps.X, r_ref.X, 5e-2, 5e-2)
    assert abs(float(r_ps.J) - float(r_ref.J)) < 5e-2 * max(1.0, float(r_ref.J))
    # the same solve as the JAX package's pscan route
    assert int(r_ps.iterations) == int(j_ps.iterations)
    _close(r_ps.U, j_ps.U, 0, 1e-6)
    _close(r_ps.X, j_ps.X, 0, 1e-6)
    _close(r_ps.J, j_ps.J, 1e-9, 0)
    # and not the sequential one: the knob reached the LM loop
    assert not torch.equal(r_ps.U, r_ref.U)


def test_backward_from_derivs_routes_on_the_knob(ego_state, global_plan):
    p = dataclasses.replace(SolverParams(), horizon=13)
    _, (td, tX, tU) = _problem(p, ego_state, global_plan)
    lam = torch.tensor(1.0, dtype=torch.float64)
    p_ps = dataclasses.replace(p, backward_impl="pscan")
    for got, want in zip(tsolver.backward_from_derivs(p_ps, td, tX, tU, lam),
                         riccati_pscan.backward_pscan(p, td, tX, tU, lam)):
        assert torch.equal(got, want)
    for got, want in zip(tsolver.backward_from_derivs(p, td, tX, tU, lam),
                         tsolver.backward_seq(p_ps, td, tX, tU, lam)):
        assert torch.equal(got, want)


def test_plain_versions_stay_sequential(full_solve):
    """K1's, K2's and K3's plain versions give the same bits under
    backward_impl="pscan" as under "seq", and equal the sequential solve
    (what the JAX package's mega and two-phase paths compute whatever the
    knob says: their kernels always run the sequential recursion)."""
    p_ref, p_ps, (tplan, tn, ego, U0, to), r_ref, r_ps, _ = full_solve
    egos, U = ego[None], U0[None]
    plans = trp.get_local_plan(p_ref, tplan, tn, egos)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    # K1: the whole LM loop
    k1 = [lm_cuda.fused_optimize_plain(q, plans, egos, U, to) for q in (p_ref, p_ps)]
    assert same(*k1)
    _close(k1[0][1][0], r_ref.U, 0, 1e-9)
    assert int(k1[0][2][0]) == int(r_ref.iterations)
    # K3: one LM iteration, and the hybrid loop around it
    world = lm_cuda.prep_world(p_ref, to, None, torch.float64, DEV)
    X = tdyn.rollout(p_ref, egos, U)
    lamb = torch.ones(1, dtype=torch.float64)
    assert same(*(lm_cuda.fused_iteration_plain(q, world, plans, X, U, lamb) for q in (p_ref, p_ps)))
    # K2: the backward pass, alone and with the rollout; the two-phase loop
    from cilqr_tpu_torch.models import costs

    d = costs.all_cost_derivs(p_ref, plans, X, U, to)
    assert same(*(riccati_cuda.backward_plain(q, d, X, U, lamb) for q in (p_ref, p_ps)))
    assert same(*(riccati_cuda.backward_forward_plain(q, d, X, U, lamb) for q in (p_ref, p_ps)))
    two = [tsb.run_steps_batched(q, tplan, tn, egos, U, to, impl="two_phase") for q in (p_ref, p_ps)]
    assert same(two[0], two[1])
    assert int(two[0].iterations[0]) == int(r_ref.iterations)
    mega = [tsb.run_steps_batched(q, tplan, tn, egos, U, to, impl="mega") for q in (p_ref, p_ps)]
    assert same(mega[0], mega[1])
    # against the JAX package's sequential solve, which its kernels are held to
    _close(two[0].U[0], r_ref.U, 0, 1e-9)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_kernels_ignore_the_knob_on_card(full_solve):
    """On the card: K1 (mega), K2 (two-phase) and K3 (the hybrid loop) give
    the same bits under backward_impl="pscan" as under "seq"."""
    p_ref, p_ps, (tplan, tn, ego, U0, to), *_ = full_solve
    dev = torch.device("cuda")
    from cilqr_tpu_torch.models import uncertainty as tunc
    from cilqr_tpu_torch.parallel import monte_carlo as tmc

    f32 = lambda t: t.to(dev, torch.float32)
    plan, n = f32(tplan), tn.to(dev)
    egos = f32(ego)[None].expand(64, 4).clone()
    egos[:, 0] += torch.linspace(-1.0, 1.0, 64, device=dev)
    U = f32(U0)[None].expand(64, -1, -1).contiguous()
    obs = type(to)(*(f32(t) for t in to))
    one = tunc.make_uncertainty_map(np.random.default_rng(0).uniform(0, 100, (48, 32)),
                                    [10.0, 0.0], 0.2, [100.0, -305.6], 0.05, dtype=torch.float32,
                                    device=dev)
    maps = tmc.per_scenario_map(one.values.expand(64, -1, -1).contiguous(), one.geom,
                                one.origin_xy, one.origin_yaw)
    for impl, world in (("mega", None), ("two_phase", None), ("mega", maps)):
        runs = []
        for q in (p_ref, p_ps):
            before = (lm_cuda.LAUNCHES, lm_cuda.ITER_LAUNCHES, lm_cuda.STEP_LAUNCHES,
                      riccati_cuda.LAUNCHES)
            runs.append(tsb.run_steps_batched(q, plan, n, egos, U, obs, world, impl=impl,
                                              world_batched=world is not None))
            torch.cuda.synchronize()
            assert (lm_cuda.LAUNCHES, lm_cuda.ITER_LAUNCHES, lm_cuda.STEP_LAUNCHES,
                    riccati_cuda.LAUNCHES) != before
        assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])), impl
