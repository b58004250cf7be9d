"""The ported slice as a whole: the batched solve, the faithful per-lane
solve against the float64 oracle, the example world, interop and the
package's independence from JAX.

Bars: ``run_steps_batched`` vs ``jax.vmap(solver.run_step)`` in float64 —
identical iteration counts, U and X within 1e-6, J within 1e-9 relative
(float64 rounding of different summation orders along the horizon);
``solver.run_step`` vs the oracle — the BASELINE 1e-3 control bar of
tests/test_solver_parity.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import obstacles as jobs, reference_path as jrp, solver as jsolver
from cilqr_tpu.models import uncertainty as junc
from cilqr_tpu.sim.example_scenario import example_scenario as jax_example
from cilqr_tpu_torch.models import obstacles as tobs, reference_path as trp
from cilqr_tpu_torch.models import solver as tsolver, solver_batched as tsb
from cilqr_tpu_torch.ops import lm_cuda
from cilqr_tpu_torch.sim.example_scenario import example_scenario as torch_example
from cilqr_tpu_torch.utils import interop
from oracle import oracle_cilqr as oracle

DEV = "cpu"  # the port allocates on the card unless told otherwise

ROOT = Path(__file__).resolve().parent.parent


def _small(params, **kw):
    return dataclasses.replace(params, horizon=8, max_iterations=4, num_of_local_wpts=8,
                               closest_point_samples_per_wpt=5, **kw)


def _egos(B, seed):
    rng = np.random.default_rng(seed)
    return np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.4, (B, 4))


@pytest.fixture(scope="module")
def small_world(params):
    """The example world (obstacles + costmap) at a small size, both packages."""
    p = _small(params)
    j = jax_example(p, jnp.float64)
    t = torch_example(p, torch.float64, device=DEV)
    return p, j, t


@pytest.fixture(scope="module")
def jax_reference(small_world):
    p, (jplan, jn, _, jU0, jo, ju), _ = small_world
    egos = _egos(16, 61)
    U0 = np.broadcast_to(np.asarray(jU0), (16, p.horizon, 2))
    want = jax.jit(jax.vmap(lambda e, u: jsolver.run_step(p, jplan, jn, e, u, jo, ju)))(
        jnp.asarray(egos), jnp.asarray(U0))
    return egos, U0, want


@pytest.mark.parametrize("impl", ["mega", "two_phase"])
def test_run_steps_batched_matches_jax_vmap_run_step(small_world, jax_reference, impl):
    p, _, (tplan, tn, _, _, to, tu) = small_world
    egos, U0, want = jax_reference
    got = tsb.run_steps_batched(p, tplan, tn, torch.tensor(egos), torch.tensor(U0), to, tu,
                                impl=impl)
    assert got._fields == want._fields
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    for f in ("U", "X"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.J.numpy(), np.asarray(want.J), rtol=1e-9, atol=0)
    np.testing.assert_array_equal(got.ref_x.numpy(), np.asarray(want.ref_x))
    np.testing.assert_allclose(got.ref_y.numpy(), np.asarray(want.ref_y), rtol=0, atol=1e-9)


BENCH_LANES = 32


def _bench_egos(ego, B=BENCH_LANES):
    """The first B egos of the JAX benchmark's main path
    (cilqr_tpu/benchmark.py:133-134)."""
    return np.asarray(ego, np.float64)[None, :] + np.random.default_rng(2).normal(0, 0.3, (B, 4))


@pytest.fixture(scope="module")
def bench_reference(params):
    """jax.vmap(solver.run_step) on the benchmark's main path at full size
    (the example world, N=50, every LM iteration), one result per dtype."""
    p = dataclasses.replace(params, horizon=50)
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jplan, jn, jego, jU0, jo, ju = jax_example(p, getattr(jnp, dtype))
            egos = _bench_egos(jego)
            U0 = np.broadcast_to(np.asarray(jU0), (BENCH_LANES, p.horizon, 2))
            cache[dtype] = egos, U0, jax.jit(jax.vmap(
                lambda e, u: jsolver.run_step(p, jplan, jn, e, u, jo, ju)))(
                jnp.asarray(egos, getattr(jnp, dtype)), jnp.asarray(U0))
        return cache[dtype]

    return p, get


@pytest.mark.parametrize("route", ["two_phase", "fused_optimize_plain"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_damping_and_abort_match_jax_at_full_size(bench_reference, dtype, route):
    """Where the LM damping reaches its cap.  The reference multiplies lambda
    by the rounded 1/lamb_factor on accept (XLA folds the division), and the
    abort test lamb > lamb_max sits on that last bit after chains of x10 and
    x0.1: iteration counts and the final lambda must be equal on every lane,
    with at least a quarter of the lanes ending on the abort.  U and X within
    1e-6 (float64); in float32 at the bars of tests/test_tpu_chip.py:142-200
    (the first 10 steps within 1e-2 + 1e-2 relative, J 2e-2 relative, the
    whole horizon's controls within 0.5)."""
    p, get = bench_reference
    egos, U0, want = get(dtype)
    tdtype = getattr(torch, dtype)
    tplan, tn, _, _, to, tu = torch_example(p, tdtype, device=DEV)
    te, tU = torch.tensor(egos, dtype=tdtype), torch.tensor(U0, dtype=tdtype)
    if route == "two_phase":
        got = tsb.run_steps_batched(p, tplan, tn, te, tU, to, tu, impl="two_phase")
        X, U, it, J, lamb = got.X, got.U, got.iterations, got.J, got.lamb
    else:
        X, U, it, J, lamb = lm_cuda.fused_optimize_plain(
            p, trp.get_local_plan(p, tplan, tn, te), te, tU, to, tu)
    np.testing.assert_array_equal(it.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(lamb.numpy(), np.asarray(want.lamb))
    assert float((lamb > p.lamb_max).double().mean()) >= 0.25
    wU, wX, wJ = np.asarray(want.U), np.asarray(want.X), np.asarray(want.J)
    if dtype == "float64":
        np.testing.assert_allclose(U.numpy(), wU, rtol=0, atol=1e-6)
        np.testing.assert_allclose(X.numpy(), wX, rtol=0, atol=1e-6)
        np.testing.assert_allclose(J.numpy(), wJ, rtol=1e-9, atol=0)
    else:
        for got_h, want_h in ((U.numpy()[:, :10], wU[:, :10]), (X.numpy()[:, :10], wX[:, :10])):
            np.testing.assert_allclose(got_h, want_h, rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(J.numpy(), wJ, rtol=2e-2, atol=0)
        assert float(np.abs(U.numpy() - wU).max()) < 0.5


def test_run_step_departs_from_oracle_only_at_the_abort(params):
    """The oracle divides lambda exactly (oracle_cilqr.py:336, as iLQR.cpp
    does), the JAX package and the port multiply by the rounded reciprocal:
    on the benchmark's egos (float64, no obstacles, no costmap) the oracle
    runs one LM iteration more, and only on lanes where the port stops on the
    abort test a few ulps above lambda = 1e4; elsewhere the counts are equal,
    and the controls stay within the 1e-3 control bar everywhere."""
    p = dataclasses.replace(params, horizon=50)
    plan, n, ego, U0, _, _ = torch_example(p, torch.float64, device=DEV)
    egos = _bench_egos(ego.numpy(), 8)
    res = tsolver.run_step(p, plan, n, torch.tensor(egos), U0.expand(8, p.horizon, 2))
    plan_xy = plan[:int(n)].numpy()
    departs = []
    for b in range(8):
        _, oU, _, oiters, _, _ = oracle.run_step(p, plan_xy, egos[b], U0.numpy())
        extra = oiters - int(res.iterations[b])
        assert extra in (0, 1), (b, oiters, int(res.iterations[b]))
        if extra:
            assert float(res.lamb[b]) > p.lamb_max, (b, float(res.lamb[b]))
            departs.append(b)
        np.testing.assert_allclose(res.U[b].numpy(), oU, atol=1e-3)
    assert departs, "no lane shows the departure"


@pytest.mark.parametrize("horizon", [30, 40, 50])
def test_run_step_matches_oracle(params, global_plan, ego_state, horizon):
    """BASELINE configs 1-2 (tests/test_solver_parity.py): one lane, tracking
    only.  +-1 iteration: the ~1e-4 polyfit-conditioning residual against the
    oracle's raw-power fit can flip one accept/reject decision."""
    p = dataclasses.replace(params, horizon=horizon)
    plan, n = trp.pad_global_plan(p, global_plan, dtype=torch.float64, device=DEV)
    U0 = tsolver.initial_controls(p, dtype=torch.float64, device=DEV)
    res = tsolver.run_step(p, plan, n, torch.tensor(ego_state), U0)
    oX, oU, _, oiters, oJ, _ = oracle.run_step(p, global_plan, np.asarray(ego_state), U0.numpy())
    assert abs(int(res.iterations) - oiters) <= 1
    np.testing.assert_allclose(float(res.J), oJ, rtol=1e-4)
    np.testing.assert_allclose(res.U.numpy(), oU, atol=1e-3)
    np.testing.assert_allclose(res.X.numpy(), oX, atol=1e-3)


def test_run_step_with_obstacle_matches_oracle(params, global_plan, ego_state):
    ob = tobs.make_static_obstacles(params, [[115.0, -306.0]], [[3.63, 1.84]], [0.0],
                                    dtype=torch.float64, device=DEV)
    oracle_obs = [(np.tile([3.63, 1.84], (params.horizon, 1)),
                   np.tile([115.0, -306.0, 0.0, 0.0], (params.horizon, 1)))]
    plan, n = trp.pad_global_plan(params, global_plan, dtype=torch.float64, device=DEV)
    U0 = tsolver.initial_controls(params, dtype=torch.float64, device=DEV)
    res = tsolver.run_step(params, plan, n, torch.tensor(ego_state), U0, obstacles=ob)
    oX, oU, _, oiters, _, _ = oracle.run_step(params, global_plan, np.asarray(ego_state),
                                              U0.numpy(), obstacles=oracle_obs)
    assert abs(int(res.iterations) - oiters) <= 1
    np.testing.assert_allclose(res.U.numpy(), oU, atol=1e-3)
    np.testing.assert_allclose(res.X.numpy(), oX, atol=1e-3)


@pytest.mark.parametrize("impl", ["mega", "two_phase"])
def test_any_batch_and_lane_zero_invariance(small_world, impl):
    """B=100 (no padding anywhere), and B=1: lane 0 does not depend on the
    other lanes of its batch."""
    p, _, (tplan, tn, _, U0, to, tu) = small_world
    egos = torch.tensor(_egos(100, 11))
    U = U0.expand(100, p.horizon, 2)
    res = tsb.run_steps_batched(p, tplan, tn, egos, U, to, tu, impl=impl)
    assert res.U.shape == (100, p.horizon, 2) and res.X.shape == (100, p.horizon + 1, 4)
    assert bool(torch.isfinite(res.U).all())
    res1 = tsb.run_steps_batched(p, tplan, tn, egos[:1], U[:1], to, tu, impl=impl)
    assert res1.U.shape == (1, p.horizon, 2)
    torch.testing.assert_close(res1.U[0], res.U[0], rtol=0, atol=1e-12)
    assert int(res1.iterations[0]) == int(res.iterations[0])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_example_scenario_matches_jax(params, dtype):
    p = dataclasses.replace(params, horizon=50)
    want = jax_example(p, getattr(jnp, dtype))
    got = torch_example(p, getattr(torch, dtype), device=DEV)
    flat = lambda tree: [np.asarray(a) for a in jax.tree.leaves(tree)]
    tflat = [got[0], got[1], got[2], got[3], *got[4], got[5].values, *got[5].geom,
             got[5].origin_xy, got[5].origin_yaw]
    wflat = flat(want)
    assert len(tflat) == len(wflat)
    for g, w in zip(tflat, wflat):
        np.testing.assert_array_equal(g.numpy(), w)


def test_interop_round_trip(params, global_plan):
    p = _small(params)
    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jnp.float64)
    ego = jnp.asarray([100.0, -305.6, 4.0, 0.05])
    jp = jrp.get_local_plan(p, jplan, jn, ego)
    tp = interop.local_plan_from_numpy(jp, dtype=torch.float64, device=DEV)
    for f in jp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    jo = jobs.make_static_obstacles(p, [[112.0, -305.5]], [[3.6, 1.8]], [0.2], dtype=jnp.float64)
    to = interop.obstacles_from_numpy(jo, dtype=torch.float64, device=DEV)
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(to, jo))
    ju = junc.make_uncertainty_map(np.ones((6, 5)), [1.0, 0.0], 0.2, [100.0, -305.0], 0.1,
                                   dtype=jnp.float64)
    tu = interop.unc_map_from_numpy(ju, dtype=torch.float64, device=DEV)
    np.testing.assert_array_equal(tu.geom.length.numpy(), np.asarray(ju.geom.length))
    assert float(tu.origin_yaw) == float(ju.origin_yaw)
    res = tsb.run_steps_batched(p, trp.pad_global_plan(p, global_plan, torch.float64, device=DEV)[0],
                                int(jn), torch.tensor(np.asarray(ego))[None],
                                tsolver.initial_controls(p, torch.float64, device=DEV)[None], to, tu)
    back = interop.solve_result_to_numpy(res)
    assert back._fields == jsolver.SolveResult._fields
    assert all(isinstance(a, np.ndarray) for a in back)
    np.testing.assert_array_equal(back.U, res.U.numpy())


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cilqr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cilqr_tpu_torch.__path__, 'cilqr_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_unported_options_raise(small_world):
    p, _, (tplan, tn, ego, U0, to, tu) = small_world
    # world_batched=True is ported: it takes one map per scenario
    with pytest.raises(ValueError, match="one map per scenario"):
        tsb.run_steps_batched(p, tplan, tn, ego[None], U0[None], to, tu, world_batched=True)
    with pytest.raises(ValueError, match="impl"):
        tsb.run_steps_batched(p, tplan, tn, ego[None], U0[None], impl="fused")
