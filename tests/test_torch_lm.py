"""LM kernel module (cilqr_tpu_torch/ops/lm_cuda, kernel K1) vs the JAX package.

On the CPU ``fused_optimize`` runs its plain version, the batched LM loop on
the port's cost stack; it is held against ``jax.vmap(solver.run_step)`` in
float64 (the comparison tests/test_lm_pallas.py uses for the TPU kernel):
identical iteration counts, U and X within 1e-6, J within 1e-9 relative —
float64 rounding of different summation orders, amplified along the horizon.
The world payloads are held against ``lm_pallas``'s own.  One LM iteration
with external uncertainty planes (kernel K3's plain version) is held to the
same iteration composed from the JAX cost stack, backward pass and rollout
at 1e-10 of scale.
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import costs as jcosts, obstacles as jobs, reference_path as jrp
from cilqr_tpu.models import solver as jsolver, uncertainty as junc
from cilqr_tpu.ops import lm_pallas
from cilqr_tpu_torch.models import dynamics as tdyn, obstacles as tobs, reference_path as trp
from cilqr_tpu_torch.models import solver_batched as tsb, uncertainty as tunc
from cilqr_tpu_torch.ops import lm_cuda
from cilqr_tpu_torch.parallel import monte_carlo as tmc

CSRC = Path(lm_cuda.__file__).resolve().parent.parent / "csrc"


def _p(params, horizon=8, max_iterations=4):
    return dataclasses.replace(params, horizon=horizon, max_iterations=max_iterations,
                               num_of_local_wpts=8, closest_point_samples_per_wpt=5)


def _world(p, jdtype, tdtype, yaw=0.05):
    """Two obstacles (one moving) and the 48x32 random costmap, in both."""
    ob = ([[112.0, -305.5], [125.0, -304.6]], [[3.63, 1.84]] * 2, [0.0, 0.3], [1.0, 0.0])
    vals = np.random.default_rng(0).uniform(0.0, 100.0, (48, 32))
    margs = (vals, [10.0, 0.0], 0.2, [100.0, -305.6], yaw)
    return (jobs.make_static_obstacles(p, *ob, dtype=jdtype),
            junc.make_uncertainty_map(*margs, dtype=jdtype),
            tobs.make_static_obstacles(p, *ob, dtype=tdtype),
            tunc.make_uncertainty_map(*margs, dtype=tdtype))


def _batch(p, global_plan, B, seed, jdtype, tdtype):
    rng = np.random.default_rng(seed)
    egos = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.4, (B, 4))
    U0 = np.broadcast_to(np.asarray(jsolver.initial_controls(p, dtype=jnp.float64)),
                         (B, p.horizon, 2))
    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jdtype)
    tplan, tn = trp.pad_global_plan(p, global_plan, dtype=tdtype)
    return (jplan, jn, jnp.asarray(egos, jdtype), jnp.asarray(U0, jdtype),
            tplan, tn, torch.tensor(egos, dtype=tdtype), torch.tensor(U0, dtype=tdtype))


def test_prep_obstacles_matches_jax(params):
    p = _p(params)
    jo, _, to, _ = _world(p, jnp.float64, torch.float64)
    np.testing.assert_allclose(lm_cuda.prep_obstacles(p, to, torch.float64).numpy(),
                               np.asarray(lm_pallas.prep_obstacles(p, jo, jnp.float64)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(lm_cuda.prep_obstacles(p, None).numpy(),
                                  np.asarray(lm_pallas.prep_obstacles(p, None)))


@pytest.mark.parametrize("with_map", [True, False])
def test_map_frame_scalars_match_jax(params, with_map):
    """The port's (values, scl) equal prep_unc_map's map and scl
    (lm_pallas.py:144-151); without a map the box is empty (lo > hi)."""
    p = _p(params)
    _, ju, _, tu = _world(p, jnp.float64, torch.float64, yaw=0.7)
    values, scl = lm_cuda.prep_unc_map(tu if with_map else None, torch.float64)
    _, jscl, hw = lm_pallas.prep_unc_map(ju if with_map else None, jnp.float64)
    np.testing.assert_allclose(scl.numpy(), np.asarray(jscl)[0], rtol=1e-14, atol=0)
    assert tuple(values.shape) == tuple(hw)
    if with_map:
        np.testing.assert_array_equal(values.numpy(), np.asarray(ju.values))


def test_fit_payload_matches_jax(params, global_plan):
    """lm_pallas._fit_payload is float32: the port's float64 payload rounds to
    the same float32 values (the two float64 fits agree to ~1e-14)."""
    p = _p(params)
    jplan, jn, jeg, _, tplan, tn, teg, _ = _batch(p, global_plan, 16, 1, jnp.float64, torch.float64)
    jp = jax.jit(jax.vmap(lambda e: jrp.get_local_plan(p, jplan, jn, e)))(jeg)
    want = np.asarray(lm_pallas._fit_payload(jp))
    got = lm_cuda._fit_payload(trp.get_local_plan(p, tplan, tn, teg))
    assert got.shape == want.shape == (16, p.poly_order + 11)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -23, atol=0)


@pytest.fixture(scope="module")
def solved(params, global_plan):
    """fused_optimize_plain and jax.vmap(solver.run_step) on the same plans,
    full world, float64, B=16."""
    p = _p(params)
    jo, ju, to, tu = _world(p, jnp.float64, torch.float64)
    jplan, jn, jeg, jU, tplan, tn, teg, tU = _batch(p, global_plan, 16, 61, jnp.float64,
                                                    torch.float64)
    want = jax.jit(jax.vmap(lambda e, u: jsolver.run_step(p, jplan, jn, e, u, jo, ju)))(jeg, jU)
    plans = trp.get_local_plan(p, tplan, tn, teg)
    got = lm_cuda.fused_optimize_plain(p, plans, teg, tU, to, tu)
    return p, plans, teg, tU, to, tu, got, want


def test_fused_optimize_plain_matches_vmap_run_step(solved):
    *_, got, want = solved
    X, U, it, J, lamb = got
    np.testing.assert_array_equal(it.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(U.numpy(), np.asarray(want.U), rtol=0, atol=1e-6)
    np.testing.assert_allclose(X.numpy(), np.asarray(want.X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(J.numpy(), np.asarray(want.J), rtol=1e-9, atol=0)
    np.testing.assert_allclose(lamb.numpy(), np.asarray(want.lamb), rtol=1e-12, atol=0)


def test_cpu_tensors_take_the_plain_version(solved):
    p, plans, teg, tU, to, tu, got, _ = solved
    before = lm_cuda.LAUNCHES
    again = lm_cuda.fused_optimize(p, plans, teg, tU, to, tu)
    assert lm_cuda.LAUNCHES == before
    for a, b in zip(again, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_config_struct_mirrors_cuda_source():
    """ctypes mirror of LMConfig (DynConst expanded in place): same fields,
    order and C types."""
    src = (CSRC / "lm.cu").read_text()
    common = (CSRC / "cilqr_common.cuh").read_text()
    fields = lambda body: [(n.strip(), t) for t, names in re.findall(r"(int|float) ([^;]+);", body)
                           for n in names.split(",")]
    dyn = fields(re.search(r"struct DynConst \{(.*?)\};", common, re.S).group(1))
    body = re.search(r"struct LMConfig \{(.*?)\};", src, re.S).group(1)
    body = body.replace("DynConst dyn;", " ".join(f"float {n};" for n, _ in dyn))
    got = [(n, "int" if t is ctypes.c_int else "float") for n, t in lm_cuda._LMConfig._fields_]
    assert got == fields(body)


@pytest.mark.slow
def test_plain_matches_pallas_kernel_interpret(params, global_plan):
    """Against the TPU kernel (lm_pallas.fused_optimize, the whole-LM-loop
    form) in the Pallas interpreter, float32, one 1024-scenario tile, at the
    bars of tests/test_lm_pallas.py."""
    from cilqr_tpu.ops import riccati_pallas

    p = _p(params, horizon=4, max_iterations=3)
    B = riccati_pallas.TILE
    jo, ju, to, tu = _world(p, jnp.float32, torch.float32)
    jplan, jn, jeg, jU, tplan, tn, teg, tU = _batch(p, global_plan, B, 23, jnp.float32,
                                                    torch.float32)
    jp = jax.vmap(lambda e: jrp.get_local_plan(p, jplan, jn, e))(jeg)
    want = lm_pallas.fused_optimize(p, jp, jeg, jU, jo, ju, interpret=True)
    got = lm_cuda.fused_optimize_plain(p, trp.get_local_plan(p, tplan, tn, teg), teg, tU, to, tu)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_kernel_matches_plain_on_card(params, global_plan):
    """The CUDA kernel vs the plain version on the card, float32, N=50:
    iteration counts equal on >= 99% of lanes and within 1 on all (see
    chip_smoke.py for the trajectory bars and their reason)."""
    p = dataclasses.replace(params, horizon=50)
    _, _, to, tu = _world(p, jnp.float32, torch.float32)
    *_, tplan, tn, teg, tU = _batch(p, global_plan, 256, 5, jnp.float32, torch.float32)
    dev = torch.device("cuda")
    to = tobs.Obstacles(*(t.to(dev) for t in to))
    tu = tunc.make_uncertainty_map(tu.values, tu.geom.center, 0.2, tu.origin_xy,
                                   float(tu.origin_yaw), dtype=torch.float32, device=dev)
    teg, tU = teg.to(dev), tU.to(dev)
    plans = trp.get_local_plan(p, tplan.to(dev), tn.to(dev), teg)
    before = lm_cuda.LAUNCHES
    got = lm_cuda.fused_optimize(p, plans, teg, tU, to, tu)
    torch.cuda.synchronize()
    assert lm_cuda.LAUNCHES == before + 1
    want = lm_cuda.fused_optimize_plain(p, plans, teg, tU, to, tu)
    assert float((got[2] == want[2]).float().mean()) >= 0.99
    assert int((got[2] - want[2]).abs().max()) <= 1
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())


def _iteration_inputs(p, global_plan, B, seed, jdtype, tdtype):
    """B scenarios at the initial rollout with random lambdas, shared
    obstacles and one random 48x32 map per scenario, in both packages."""
    jo, ju, to, tu = _world(p, jdtype, tdtype)
    jplan, jn, jeg, jU, tplan, tn, teg, tU = _batch(p, global_plan, B, seed, jdtype, tdtype)
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 100.0, (B, 48, 32))
    lamb = rng.uniform(0.1, 10.0, B)
    tmaps = tmc.per_scenario_map(torch.tensor(vals, dtype=tdtype), tu.geom, tu.origin_xy,
                                 tu.origin_yaw)
    plans = trp.get_local_plan(p, tplan, tn, teg)
    X = tdyn.rollout(p, teg, tU)
    planes = tsb.map_sampler(p, tmaps)(X[:, :p.horizon])
    jaxin = (jplan, jn, jeg, jU, jo, ju, jnp.asarray(vals, jdtype), jnp.asarray(lamb, jdtype))
    return jaxin, (plans, X, tU, torch.tensor(lamb, dtype=tdtype), to, tmaps, planes)


def test_fused_iteration_plain_with_planes_matches_jax(params, global_plan):
    """K3's plain version on external (e, gx, gy) planes sampled from each
    scenario's map vs JAX: all_cost_derivs_and_J on that map, the backward
    recursion and the rollout, vmapped, float64."""
    p = _p(params)
    (jplan, jn, jeg, jU, jo, ju, jvals, jlamb), (plans, X, U, lamb, to, tmaps, planes) = (
        _iteration_inputs(p, global_plan, 16, 13, jnp.float64, torch.float64))

    def one(e, X1, U1, l1, v):
        plan = jrp.get_local_plan(p, jplan, jn, e)
        m = junc.UncertaintyMap(v, ju.geom, ju.origin_xy, ju.origin_yaw)
        d, J = jcosts.all_cost_derivs_and_J(p, plan, X1, U1, jo, m)
        k, K = jsolver.backward_from_derivs(p, d, X1, U1, l1)
        return (*jsolver.forward_pass(p, X1, U1, k, K), J)

    want = jax.jit(jax.vmap(one))(jeg, jnp.asarray(X.numpy()), jU, jlamb, jvals)
    world = lm_cuda.prep_world(p, to, None, torch.float64)
    got = lm_cuda.fused_iteration(p, world, plans, X, U, lamb, planes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10 * max(1.0, float(np.abs(np.asarray(w)).max())))
    # the planes give what the per-scenario map gives to the cost stack
    on_map = lm_cuda.fused_iteration_plain(p, world._replace(unc_map=tmaps), plans, X, U, lamb)
    for g, w in zip(got, on_map):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_hybrid_loop_needs_exactly_one_map_source(params, global_plan):
    p = _p(params)
    _, (plans, X, U, lamb, to, tmaps, planes) = _iteration_inputs(
        p, global_plan, 4, 3, jnp.float64, torch.float64)
    sampler = tsb.map_sampler(p, tmaps)
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm_cuda.fused_optimize(p, plans, X[:, 0], U, to, tmaps, unc_sampler=sampler)
    before = lm_cuda.ITER_LAUNCHES
    res = lm_cuda.fused_optimize(p, plans, X[:, 0], U, to, unc_sampler=sampler)
    assert lm_cuda.ITER_LAUNCHES == before  # CPU tensors: the plain iteration
    want = lm_cuda.fused_optimize_plain(p, plans, X[:, 0], U, to, unc_sampler=sampler)
    for a, b in zip(res, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.slow
def test_iteration_plain_matches_pallas_kernel_interpret(params, global_plan):
    """Against the TPU kernel (lm_pallas.fused_iteration, external planes) in
    the Pallas interpreter, float32, one 1024-scenario tile, at the bars of
    tests/test_lm_pallas.py."""
    from cilqr_tpu.ops.riccati_pallas import TILE, _from_tiles, _to_tiles

    p = _p(params, horizon=4)
    B = TILE
    (jplan, jn, jeg, _, jo, _, _, _), (plans, X, U, lamb, to, _, planes) = _iteration_inputs(
        p, global_plan, B, 29, jnp.float32, torch.float32)
    jp = jax.vmap(lambda e: jrp.get_local_plan(p, jplan, jn, e))(jeg)
    f32 = lambda t: jnp.asarray(t.numpy(), jnp.float32)
    sxy = jnp.stack([jp.sample_xl, jp.sample_yl, jp.sample_r], axis=-1)
    Xn_t, Un_t, J_t = lm_pallas.fused_iteration(
        p, lm_pallas.prep_world(p, jo, None), _to_tiles(lm_pallas._fit_payload(jp)[:, :, None], B),
        _to_tiles(sxy, B), _to_tiles(f32(X), B), _to_tiles(f32(U), B),
        _to_tiles(f32(lamb)[:, None], B)[:, 0], _to_tiles(f32(planes), B), interpret=True)
    world = lm_cuda.prep_world(p, to, None)
    got = lm_cuda.fused_iteration_plain(p, world, plans, X, U, lamb, planes)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(_from_tiles(Un_t, B, (2,))),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(_from_tiles(Xn_t, B, (4,))),
                               rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(J_t).reshape(B), rtol=1e-4)
    assert got[3].shape == (B, p.horizon, 2) and got[4].shape == (B, p.horizon, 2, 4)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_iteration_kernel_matches_plain_on_card(params, global_plan):
    """K3 vs its plain version on the card, float32, N=50, external planes:
    the gains within 1e-4 relative + 1e-5 absolute (chip_smoke.py phase 9
    adds the rollout step by step and the whole hybrid loop)."""
    p = dataclasses.replace(params, horizon=50)
    _, (plans, X, U, lamb, to, _, planes) = _iteration_inputs(
        p, global_plan, 256, 17, jnp.float32, torch.float32)
    dev = torch.device("cuda")
    plans = type(plans)(*(t.to(dev) for t in plans))
    X, U, lamb, planes = X.to(dev), U.to(dev), lamb.to(dev), planes.to(dev)
    world = lm_cuda.prep_world(p, tobs.Obstacles(*(t.to(dev) for t in to)), None, device=dev)
    before = lm_cuda.ITER_LAUNCHES
    got = lm_cuda.fused_iteration(p, world, plans, X, U, lamb, planes)
    torch.cuda.synchronize()
    assert lm_cuda.ITER_LAUNCHES == before + 1
    want = lm_cuda.fused_iteration_plain(p, world, plans, X, U, lamb, planes)
    for g, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=0)
