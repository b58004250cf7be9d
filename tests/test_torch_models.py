"""PyTorch port (cilqr_tpu_torch) vs the JAX package, module by module.

The same float64 inputs, made with numpy from a seed, go through each JAX
function and its port.  Bar: 1e-10 relative to the array's scale (floored
at 1): the algebra is the same and only the summation order differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import costs as jcosts, dynamics as jdyn, obstacles as jobs
from cilqr_tpu.models import reference_path as jrp, solver as jsolver
from cilqr_tpu.models import uncertainty as junc
from cilqr_tpu.ops import eig2x2 as jeig, gridmap as jgrid
from cilqr_tpu_torch.models import costs as tcosts, dynamics as tdyn, obstacles as tobs
from cilqr_tpu_torch.models import reference_path as trp, solver as tsolver
from cilqr_tpu_torch.models import uncertainty as tunc
from cilqr_tpu_torch.ops import eig2x2 as teig, gridmap as tgrid
from cilqr_tpu_torch.utils import interop

REL = 1e-10


def jvmap(f, *args, **kw):
    """jit(vmap(f)): one compile instead of op-by-op dispatch under vmap."""
    return jax.jit(jax.vmap(f, *args, **kw))


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rel=REL):
    """|got - want| <= rel * max(1, max|want|), elementwise, for tensors or
    (nested) tuples of them against JAX/numpy arrays."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rel)
        return
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
        return
    scale = max(1.0, float(np.max(np.abs(w)))) if w.size else 1.0
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def p(params):
    return dataclasses.replace(params, horizon=8, num_of_local_wpts=8,
                               closest_point_samples_per_wpt=5)


def _states(rng, B, N, ego=(100.0, -305.6, 4.0, 0.05), sd=(0.5, 0.5, 1.0, 0.2)):
    return np.asarray(ego) + rng.normal(0, 1, (B, N, 4)) * np.asarray(sd)


def test_dynamics_match_jax(p):
    rng = np.random.default_rng(0)
    x = _states(rng, 16, 1)[:, 0]
    x[:3, 2] = [0.0, 29.9, 31.0]  # speed clamps
    u = rng.normal(0, [3.0, 0.6], (16, 2))
    close(tdyn.clamp_control(p, T(x), T(u)), jdyn.clamp_control(p, jnp.asarray(x), jnp.asarray(u)))
    close(tdyn.step(p, T(x), T(u)), jdyn.step(p, jnp.asarray(x), jnp.asarray(u)))
    U = rng.normal(0, [1.0, 0.2], (16, p.horizon, 2))
    want = jvmap(lambda a, b: jdyn.rollout(p, a, b))(jnp.asarray(x), jnp.asarray(U))
    close(tdyn.rollout(p, T(x), T(U)), want)
    v, th, a = (rng.normal(m, s, (16, p.horizon)) for m, s in ((4, 1), (0, 1), (0, 1)))
    close(tdyn.jacobians(p, T(v), T(th), T(a)),
          jvmap(lambda *z: jdyn.jacobians(p, *z))(jnp.asarray(v), jnp.asarray(th), jnp.asarray(a)))


def test_eig2x2_matches_jax():
    rng = np.random.default_rng(1)
    a, b, c = rng.normal(0, 5, (3, 200))
    b[:20] = 0.0        # numerically diagonal: the degenerate branch
    c[20:30] = a[20:30]  # equal diagonal
    M = np.stack([np.stack([a, b], -1), np.stack([b, c], -1)], -2)
    lamb = rng.uniform(1e-3, 100.0, 200)
    close(teig.eigh2x2(T(M)), jeig.eigh2x2(jnp.asarray(M)))
    close(teig.regularized_inverse(T(M), T(lamb)),
          jeig.regularized_inverse(jnp.asarray(M), jnp.asarray(lamb)))


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(2)
    vals = rng.uniform(0, 100, (9, 7))
    args = ([1.0, 0.5], 0.25, 9, 7)
    pos = rng.uniform(-2.0, 4.0, (40, 2))  # inside and outside the map
    return vals, args, pos


def test_gridmap_geometry_matches_jax(grid):
    vals, args, pos = grid
    jg, tg = jgrid.make_geom(*args, dtype=jnp.float64), tgrid.make_geom(*args, dtype=torch.float64)
    close(tuple(tg), tuple(jg))
    close(tgrid.cell_positions(tg, 9, 7), jgrid.cell_positions(jg, 9, 7))
    close(tgrid.continuous_index(tg, T(pos)), jgrid.continuous_index(jg, jnp.asarray(pos)))
    close(tgrid.index_from_position(tg, T(pos)), jgrid.index_from_position(jg, jnp.asarray(pos)))
    idx = np.random.default_rng(3).integers(0, 7, (10, 2))
    close(tgrid.position_from_index(tg, T(idx)), jgrid.position_from_index(jg, jnp.asarray(idx)))
    close(tgrid.in_bounds(tg, T(pos)), jgrid.in_bounds(jg, jnp.asarray(pos)))


@pytest.mark.parametrize("use_onehot", [True, False])
def test_bilinear_sample_matches_jax(grid, use_onehot):
    vals, args, pos = grid
    jg, tg = jgrid.make_geom(*args, dtype=jnp.float64), tgrid.make_geom(*args, dtype=torch.float64)
    want = jgrid.sample_bilinear_with_grad(jnp.asarray(vals), jg, jnp.asarray(pos), use_onehot=use_onehot)
    close(tgrid.sample_bilinear_with_grad(T(vals), tg, T(pos)), want)


def test_bilinear_sample_batched_matches_jax():
    rng = np.random.default_rng(4)
    B = 5
    vals = rng.uniform(0, 100, (B, 6, 8))
    centers = rng.normal(0, 1, (B, 2))
    pos = rng.uniform(-1.5, 1.5, (B, 12, 2))
    jg = jvmap(lambda c: jgrid.make_geom(c, 0.3, 6, 8, dtype=jnp.float64))(jnp.asarray(centers))
    tg = tgrid.GridGeom(T(centers), torch.full((B,), 0.3, dtype=torch.float64),
                        torch.tensor([[1.8, 2.4]] * B, dtype=torch.float64))
    want = jgrid.sample_bilinear_with_grad_batched(jnp.asarray(vals), jg, jnp.asarray(pos))
    close(tgrid.sample_bilinear_with_grad_batched(T(vals), tg, T(pos)), want)


def _padded(p, global_plan):
    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jnp.float64)
    tplan, tn = trp.pad_global_plan(p, global_plan, dtype=torch.float64)
    return jplan, jn, tplan, tn


def test_pad_global_plan_and_closest_index_match_jax(p, global_plan):
    jplan, jn, tplan, tn = _padded(p, global_plan)
    close(tplan, jplan)
    assert int(tn) == int(jn)
    pts = _states(np.random.default_rng(5), 12, 1, sd=(10.0, 1.0, 0, 0))[:, 0]
    want = jvmap(lambda q: jrp.closest_point_index(jplan, jn, q))(jnp.asarray(pts))
    close(trp.closest_point_index(tplan, tn, T(pts)), want)


@pytest.mark.parametrize("variant", ["default", "chord_frame_fit", "exact_end_shrink"])
def test_local_plan_matches_jax(p, global_plan, variant):
    if variant != "default":
        p = dataclasses.replace(p, **{variant: True})
    jplan, jn, tplan, tn = _padded(p, global_plan)
    rng = np.random.default_rng(6)
    egos = _states(rng, 8, 1)[:, 0]
    egos[-2:, 0] = [200.0, 203.0]  # near the end of the plan: the window clamps
    want = jvmap(lambda e: jrp.get_local_plan(p, jplan, jn, e))(jnp.asarray(egos))
    got = trp.get_local_plan(p, tplan, tn, T(egos))
    assert got._fields == want._fields
    close(tuple(got), tuple(want))


@pytest.mark.parametrize("weighted", [False, True])
def test_polyfit_scaled_matches_jax(weighted):
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(90, 130, (4, 20)), axis=-1)
    y = -306 + 0.1 * (x - 100) + rng.normal(0, 0.2, x.shape)
    w = (rng.uniform(size=x.shape) > 0.3).astype(float) if weighted else None
    want = jvmap(lambda a, b, c: jrp.polyfit_scaled(a, b, 5, c))(
        jnp.asarray(x), jnp.asarray(y), None if w is None else jnp.asarray(w))
    close(trp.polyfit_scaled(T(x), T(y), 5, None if w is None else T(w)), want)


def test_find_closest_points_matches_jax(p, global_plan):
    jplan, jn, tplan, tn = _padded(p, global_plan)
    rng = np.random.default_rng(8)
    egos = _states(rng, 6, 1)[:, 0]
    states = _states(rng, 6, p.horizon, sd=(3.0, 1.0, 0, 0))
    jp = jvmap(lambda e: jrp.get_local_plan(p, jplan, jn, e))(jnp.asarray(egos))
    want = jvmap(jrp.find_closest_points)(jp, jnp.asarray(states))
    close(trp.find_closest_points(interop.local_plan_from_numpy(jp, dtype=torch.float64),
                                  T(states)), want)


@pytest.fixture(scope="module")
def world(p):
    """Obstacles (one moving, one rotated) and an uncertainty map, for both."""
    centers, sizes, yaws, speeds = [[112.0, -305.5], [104.0, -305.0]], [[3.63, 1.84]] * 2, [0.0, 0.4], [1.5, 0.0]
    jo = jobs.make_static_obstacles(p, centers, sizes, yaws, speeds, dtype=jnp.float64)
    to = tobs.make_static_obstacles(p, centers, sizes, yaws, speeds, dtype=torch.float64)
    vals = np.random.default_rng(0).uniform(0.0, 100.0, (48, 32))
    margs = (vals, [10.0, 0.0], 0.2, [100.0, -305.6], 0.05)
    ju = junc.make_uncertainty_map(*margs, dtype=jnp.float64)
    tu = tunc.make_uncertainty_map(*margs, dtype=torch.float64)
    return jo, to, ju, tu


def test_make_static_obstacles_matches_jax(world):
    jo, to, _, _ = world
    close(tuple(to), tuple(jo))


def test_obstacle_cost_derivs_match_jax(p, world):
    jo, to, _, _ = world
    X = _states(np.random.default_rng(9), 5, p.horizon, ego=(108.0, -305.4, 4.0, 0.05),
                sd=(4.0, 1.0, 1.0, 0.3))
    want = jvmap(lambda x: jobs.obstacle_cost_derivs(p, jo, x))(jnp.asarray(X))
    close(tobs.obstacle_cost_derivs(p, to, T(X)), want)


def test_uncertainty_cost_matches_jax(p, world):
    _, _, ju, tu = world
    X = _states(np.random.default_rng(10), 5, p.horizon, sd=(6.0, 4.0, 1.0, 0.3))
    X[0, :, 0] += 30.0  # the first scenario leaves the map: silent zero
    want = jvmap(lambda x: junc.uncertainty_cost(p, ju, x))(jnp.asarray(X))
    got = tunc.uncertainty_cost(p, tu, T(X))
    close(got, want)
    assert float(got[0][0].abs().max()) == 0.0


def test_uncertainty_sample_batched_matches_jax(p, world):
    _, _, ju, tu = world
    B = 4
    rng = np.random.default_rng(11)
    vals = rng.uniform(0, 100, (B, 48, 32))
    yaw = rng.normal(0, 0.3, B)
    jb = ju._replace(values=jnp.asarray(vals),
                     geom=jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), ju.geom),
                     origin_xy=jnp.broadcast_to(ju.origin_xy, (B, 2)), origin_yaw=jnp.asarray(yaw))
    tb = interop.unc_map_from_numpy(jb, dtype=torch.float64)
    X = _states(rng, B, p.horizon, sd=(6.0, 4.0, 1.0, 0.3))
    close(tunc.uncertainty_sample_batched(p, tb, T(X)),
          junc.uncertainty_sample_batched(p, jb, jnp.asarray(X)))


def test_cost_derivs_and_J_match_jax(p, global_plan, world):
    jo, to, ju, tu = world
    jplan, jn, tplan, tn = _padded(p, global_plan)
    rng = np.random.default_rng(12)
    egos = _states(rng, 6, 1)[:, 0]
    U = rng.normal(0, [1.5, 0.4], (6, p.horizon, 2))
    X = jvmap(lambda e, u: jdyn.rollout(p, e, u))(jnp.asarray(egos), jnp.asarray(U))
    jp = jvmap(lambda e: jrp.get_local_plan(p, jplan, jn, e))(jnp.asarray(egos))
    tp = trp.get_local_plan(p, tplan, tn, T(egos))
    want = jvmap(lambda pl, x, u: jcosts.all_cost_derivs_and_J(p, pl, x, u, jo, ju))(
        jp, X, jnp.asarray(U))
    got = tcosts.all_cost_derivs_and_J(p, tp, T(X), T(U), to, tu)
    close((tuple(got[0]), got[1]), (tuple(want[0]), want[1]))
    close(tuple(tcosts.all_cost_derivs(p, tp, T(X), T(U))),
          tuple(jvmap(lambda pl, x, u: jcosts.all_cost_derivs(p, pl, x, u))(jp, X, jnp.asarray(U))))
    close(tcosts.control_cost_derivs(p, T(X), T(U)),
          jvmap(lambda x, u: jcosts.control_cost_derivs(p, x, u))(X, jnp.asarray(U)))
    close(tcosts.total_cost_J(p, tp, T(X), T(U)),
          jvmap(lambda pl, x, u: jcosts.total_cost_J(p, pl, x, u))(jp, X, jnp.asarray(U)))


def test_barrier_matches_jax():
    rng = np.random.default_rng(13)
    c, cd = rng.normal(0, 1, 7), rng.normal(0, 1, (7, 3))
    close(tcosts.barrier(1.5, 2.5, T(c), T(cd)), jcosts.barrier(1.5, 2.5, jnp.asarray(c), jnp.asarray(cd)))


def test_initial_controls_match_jax(p):
    close(tsolver.initial_controls(p, dtype=torch.float64),
          jsolver.initial_controls(p, dtype=jnp.float64))
