"""LM kernel module (cilqr_tpu_torch/ops/lm_cuda, kernel K1) vs the JAX package.

On the CPU ``fused_optimize`` runs its plain version, the batched LM loop on
the port's cost stack; it is held against ``jax.vmap(solver.run_step)`` in
float64 (the comparison tests/test_lm_pallas.py uses for the TPU kernel):
identical iteration counts, U and X within 1e-6, J within 1e-9 relative —
float64 rounding of different summation orders, amplified along the horizon.
The world payloads are held against ``lm_pallas``'s own.  One LM iteration
with external uncertainty planes (kernel K3's plain version) is held to the
same iteration composed from the JAX cost stack, backward pass and rollout
at 1e-10 of scale.  What surrounds the kernels is plain Python and runs here:
the split tournament's plain version against the sequential first minimum,
the launch-shape rule, and K3's once-per-solve inputs.
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

DEV = "cpu"  # the port allocates on the card unless told otherwise

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
            tobs.make_static_obstacles(p, *ob, dtype=tdtype, device=DEV),
            tunc.make_uncertainty_map(*margs, dtype=tdtype, device=DEV))


def _batch(p, global_plan, B, seed, jdtype, tdtype):
    rng = np.random.default_rng(seed)
    egos = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.4, (B, 4))
    U0 = np.broadcast_to(np.asarray(jsolver.initial_controls(p, dtype=jnp.float64)),
                         (B, p.horizon, 2))
    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jdtype)
    tplan, tn = trp.pad_global_plan(p, global_plan, dtype=tdtype, device=DEV)
    return (jplan, jn, jnp.asarray(egos, jdtype), jnp.asarray(U0, jdtype),
            tplan, tn, torch.tensor(egos, dtype=tdtype), torch.tensor(U0, dtype=tdtype))


def test_prep_obstacles_matches_jax(params):
    p = _p(params)
    jo, _, to, _ = _world(p, jnp.float64, torch.float64)
    np.testing.assert_allclose(lm_cuda.prep_obstacles(p, to, torch.float64, device=DEV).numpy(),
                               np.asarray(lm_pallas.prep_obstacles(p, jo, jnp.float64)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(lm_cuda.prep_obstacles(p, None, device=DEV).numpy(),
                                  np.asarray(lm_pallas.prep_obstacles(p, None)))


@pytest.mark.parametrize("with_map", [True, False])
def test_map_frame_scalars_match_jax(params, with_map):
    """The port's (values, scl) equal prep_unc_map's map and scl
    (lm_pallas.py:144-151); without a map the box is empty (lo > hi)."""
    p = _p(params)
    _, ju, _, tu = _world(p, jnp.float64, torch.float64, yaw=0.7)
    values, scl = lm_cuda.prep_unc_map(tu if with_map else None, torch.float64, device=DEV)
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


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_kernel_on_the_local_costmap_grid_on_card(params, global_plan):
    """K1 on the local costmap's grid (152 x 104 cells at 0.2 m: the map the
    single-map build feeds ``run``), smooth blobs as the propagation leaves
    them, N=40: at B=256 the iteration counts equal the plain version's on
    >= 99% of lanes and lie within 1 on all; solved alone (B=1), each of 8
    scenarios gives the bits it gets in the batch."""
    p = dataclasses.replace(params, horizon=40)
    rows, cols, res = 152, 104, 0.2
    rng = np.random.default_rng(7)
    ii, jj = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    vals = np.zeros((rows, cols))
    for ci, cj, s in zip(rng.uniform(0, rows, 6), rng.uniform(0, cols, 6), rng.uniform(3, 12, 6)):
        vals += 100.0 * np.exp(-((ii - ci) ** 2 + (jj - cj) ** 2) / (2.0 * s * s))
    dev = torch.device("cuda")
    _, _, to, _ = _world(p, jnp.float32, torch.float32)
    to = tobs.Obstacles(*(t.to(dev) for t in to))
    tu = tunc.make_uncertainty_map(np.minimum(vals, 100.0), [15.0, 0.0], res, [100.0, -305.6],
                                   0.05, dtype=torch.float32, device=dev)
    *_, tplan, tn, teg, tU = _batch(p, global_plan, 256, 9, jnp.float32, torch.float32)
    teg, tU = teg.to(dev), tU.to(dev)
    plans = trp.get_local_plan(p, tplan.to(dev), tn.to(dev), teg)
    got = lm_cuda.fused_optimize(p, plans, teg, tU, to, tu)
    want = lm_cuda.fused_optimize_plain(p, plans, teg, tU, to, tu)
    assert float((got[2] == want[2]).float().mean()) >= 0.99
    assert int((got[2] - want[2]).abs().max()) <= 1
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    for i in range(8):
        one = lm_cuda.fused_optimize(p, type(plans)(*(t[i:i + 1] for t in plans)),
                                     teg[i:i + 1], tU[i:i + 1], to, tu)
        assert all(torch.equal(a, b[i:i + 1]) for a, b in zip(one, got))


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
    world = lm_cuda.prep_world(p, to, None, torch.float64, device=DEV)
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
    world = lm_cuda.prep_world(p, to, None, device=DEV)
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


def _distances_with_ties(S, seed):
    """(6, 5, S) float32 distances in which every row's minimum is planted
    at two to four places (exactly equal values), first, last and middle
    samples among them."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 2.0, (6, 5, S)).astype(np.float32)
    for i in range(6):
        for j in range(5):
            where = rng.choice(S, size=min(S, 2 + (i + j) % 3), replace=False)
            d[i, j, where] = np.float32(0.25)
    d[0, 0, :] = np.float32(1.5)          # every sample ties: sample 0 wins
    d[1, 0, [0, S - 1]] = np.float32(0.125)
    d[2, 0, S - 1] = np.float32(0.0)      # a lone minimum at the last sample
    return d


@pytest.mark.parametrize("S", [7, 33, 200])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 32])
def test_split_tournament_is_the_sequential_first_minimum(G, S):
    """G lanes scanning samples g, g+G, ... with a strict <, merged by
    (d, j) lexicographically, find the first minimum of the row, as
    ``torch.argmin`` / ``numpy.argmin`` do, with exact ties planted and S
    not a multiple of G."""
    d = _distances_with_ties(S, seed=100 * G + S)
    want = np.argmin(d, axis=-1)          # numpy: the first of equal minima
    got = lm_cuda.split_tournament(torch.tensor(d), G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == 0 and int(got[1, 0]) == 0 and int(got[2, 0]) == S - 1


def test_split_tournament_without_a_finite_distance_takes_sample_zero():
    d = torch.full((3, 9), float("inf"))
    assert lm_cuda.split_tournament(d, 4).tolist() == [0, 0, 0]


@pytest.mark.parametrize("B", [1, 2, 31, 64, 1024, 8192, 32768, 100000])
def test_launch_shape_is_allowed_and_fits(B, params):
    S = params.n_closest_samples
    T, G = lm_cuda.launch_shape(B, S)
    assert G in lm_cuda.GROUP_SIZES and T * G == 32  # a block is one warp
    assert lm_cuda.table_bytes(T, S) <= lm_cuda.MAX_SHARED_BYTES == 232448
    assert lm_cuda._check_group(G, S) == T
    if B == 1:
        assert G == 32  # one scenario: the whole warp


def test_launch_shape_follows_the_batch_and_the_table(params):
    S = params.n_closest_samples
    groups = [lm_cuda.launch_shape(B, S)[1] for B in (1, 64, 1024, 8192, 32768)]
    assert groups == sorted(groups, reverse=True) and groups[0] == 32 and groups[-1] <= 2
    # a table too large for 32 scenarios per warp: fewer scenarios per warp
    T, G = lm_cuda.launch_shape(32768, 2000)
    assert lm_cuda.table_bytes(T, 2000) <= lm_cuda.MAX_SHARED_BYTES < lm_cuda.table_bytes(32, 2000)
    with pytest.raises(ValueError, match="shared memory"):
        lm_cuda.launch_shape(8, 40000)  # one scenario's table alone does not fit
    with pytest.raises(ValueError, match="built for"):
        lm_cuda._check_group(4, S)
    with pytest.raises(ValueError, match="shared memory"):
        lm_cuda._check_group(1, 2000)


def test_iteration_inputs_prepared_once_equal_the_per_call_layout(params, global_plan):
    """``prep_iteration`` (built once per solve by the hybrid loop) gives,
    bit for bit, the scenario-minor layout of the stacked [sxl, syl] table
    and the transposed fit payload; r is what the kernel recomputes from
    them: sxl*sxl + syl*syl, each operation rounded."""
    from cilqr_tpu_torch.ops import riccati_cuda

    p = _p(params)
    *_, tplan, tn, teg, _ = _batch(p, global_plan, 12, 7, jnp.float32, torch.float32)
    plans = trp.get_local_plan(p, tplan, tn, teg)
    prep = lm_cuda.prep_iteration(plans)
    S = p.n_closest_samples
    assert tuple(prep.table.shape) == (S, 2, 12) and prep.table.is_contiguous()
    assert tuple(prep.fit.shape) == (p.poly_order + 11, 12) and prep.fit.is_contiguous()
    table = torch.stack([plans.sample_xl, plans.sample_yl], dim=-1)
    assert torch.equal(prep.table, riccati_cuda.to_scenario_minor(table))
    assert torch.equal(prep.table[:, 0].t(), plans.sample_xl)
    assert torch.equal(prep.table[:, 1].t(), plans.sample_yl)
    assert torch.equal(prep.fit, lm_cuda._fit_payload(plans).t().contiguous())
    sxl, syl = prep.table[:, 0], prep.table[:, 1]
    assert torch.equal((sxl * sxl + syl * syl).t(), plans.sample_r)


def test_hybrid_loop_carries_the_prepared_inputs_only_on_the_card(params, global_plan):
    """On the CPU the hybrid loop runs the plain step (``fused_step_plain``:
    ``lm_step`` on the plain iteration) and prepares nothing; a world
    without prepared inputs stays valid for ``fused_iteration`` (it prepares
    them itself on the card)."""
    p = _p(params)
    _, (plans, X, U, lamb, to, tmaps, planes) = _iteration_inputs(
        p, global_plan, 4, 5, jnp.float64, torch.float64)
    world = lm_cuda.prep_world(p, to, None, torch.float64, device=DEV)
    assert world.iteration is None
    seen = []
    saved = lm_cuda.fused_iteration_plain

    def spy(p_, world_, *rest):
        seen.append(world_.iteration)
        return saved(p_, world_, *rest)

    lm_cuda.fused_iteration_plain = spy
    try:
        lm_cuda.fused_optimize(p, plans, X[:, 0], U, to, unc_sampler=tsb.map_sampler(p, tmaps))
    finally:
        lm_cuda.fused_iteration_plain = saved
    assert seen and all(s is None for s in seen)


def test_prepared_inputs_of_other_plans_are_refused(params, global_plan):
    """A world that carries K3's prepared inputs serves only the plans they
    were made from: other plans of the same batch size raise, before
    anything is launched."""
    p = _p(params)
    _, (plans, X, U, lamb, to, _, planes) = _iteration_inputs(
        p, global_plan, 4, 5, jnp.float32, torch.float32)
    other = plans._replace(sample_xl=plans.sample_xl + 1.0)
    world = lm_cuda.prep_world(p, to, None, torch.float32, device=DEV)
    world = world._replace(iteration=lm_cuda.prep_iteration(other))
    assert world.iteration.plans is other
    with pytest.raises(ValueError, match="other plans"):
        lm_cuda._launch_iteration(p, world, plans, X, U, lamb, planes)
