"""Failure-mode behaviour of the port, mirroring tests/test_robustness.py:
barrier overflow, a degenerate two-point plan, and the batched closed loop.

The first two are also held against the JAX package on the same inputs:
the overflow case in float32 (both abort on the damping cap after the same
iterations, U and X within 1e-4: float32 rounding in another order), the
two-point plan in float64 (both finite after the same iterations; its
degenerate fit makes U huge in both, so U is not compared).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import obstacles as jobs, reference_path as jrp, solver as jsolver
from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.models import obstacles as tobs, reference_path as trp
from cilqr_tpu_torch.models import solver as tsolver
from cilqr_tpu_torch.sim import plant
from cilqr_tpu_torch.utils.params import NoiseParams

DEV = "cpu"  # the port allocates on the card unless told otherwise


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs: the tier runs six workers at
    once, and these small eager loops only lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_solver_survives_barrier_overflow(global_plan):
    """Ego starting inside an obstacle: the float32 barrier overflows to inf,
    the backward pass goes non-finite, every candidate is rejected (NaN < J
    is false), lambda escalates and the loop aborts; the result stays
    finite, never NaN (the analog of the reference's eigensolver-failure
    abort, iLQR.cpp:159-162,233-236)."""
    p = dataclasses.replace(SolverParams(), horizon=20)
    ego = [115.0, -305.0, 2.0, 0.0]  # on the obstacle
    plan, n = trp.pad_global_plan(p, global_plan, dtype=torch.float32, device=DEV)
    ob = tobs.make_static_obstacles(p, [[115.0, -305.0]], [[3.63, 1.84]], [0.0],
                                    dtype=torch.float32, device=DEV)
    U0 = tsolver.initial_controls(p, dtype=torch.float32, device=DEV)
    res = tsolver.run_step(p, plan, n, torch.tensor(ego), U0, obstacles=ob)
    assert bool(torch.isfinite(res.U).all()) and bool(torch.isfinite(res.X).all())
    assert float(res.lamb) > p.lamb_max  # the loop aborted on the damping cap

    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jnp.float32)
    jo = jobs.make_static_obstacles(p, [[115.0, -305.0]], [[3.63, 1.84]], [0.0], dtype=jnp.float32)
    want = jsolver.run_step_jit(p, jplan, jn, jnp.asarray(ego, jnp.float32),
                                jsolver.initial_controls(p, dtype=jnp.float32), obstacles=jo)
    assert int(res.iterations) == int(want.iterations)
    assert float(want.lamb) > p.lamb_max
    np.testing.assert_allclose(res.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.X.numpy(), np.asarray(want.X), rtol=0, atol=1e-4)


def test_solver_handles_two_point_plan():
    """Degenerate global plan (2 points): the window clamps, the fit
    degenerates to a near-constant; the solve stays finite."""
    p = dataclasses.replace(SolverParams(), horizon=10, max_iterations=4)
    pts = np.array([[0.0, 0.0], [1.0, 0.1]])
    ego = [0.0, 0.0, 2.0, 0.0]
    plan, n = trp.pad_global_plan(p, pts, dtype=torch.float64, device=DEV)
    res = tsolver.run_step(p, plan, n, torch.tensor(ego, dtype=torch.float64),
                           tsolver.initial_controls(p, dtype=torch.float64, device=DEV))
    assert bool(torch.isfinite(res.U).all())
    jplan, jn = jrp.pad_global_plan(p, pts, dtype=jnp.float64)
    want = jsolver.run_step_jit(p, jplan, jn, jnp.asarray(ego),
                                jsolver.initial_controls(p, dtype=jnp.float64))
    # the rank-deficient fit sends U of both packages to ~1e23 and beyond
    # (ROADMAP Queue 3), so only finiteness and the iteration count compare
    assert bool(np.isfinite(np.asarray(want.U)).all())
    assert int(res.iterations) == int(want.iterations)


def test_closed_loop_batched(global_plan):
    """The batched closed loop on the fused path (on CPU tensors K1's plain
    version), 1024 scenarios (the JAX test's one kernel tile), 5 cycles
    without noise: finite, the record's shapes, forward progress."""
    p = dataclasses.replace(SolverParams(), horizon=8, max_iterations=3, num_of_local_wpts=8,
                            closest_point_samples_per_wpt=5)
    B = 1024
    plan, n = trp.pad_global_plan(p, global_plan, dtype=torch.float32, device=DEV)
    rng = np.random.default_rng(81)
    x0s = torch.tensor(np.array([100.0, -305.6, 4.0, 0.05])[None, :] + rng.normal(0, 0.3, (B, 4)),
                       dtype=torch.float32)
    xf, rec = plant.closed_loop_batched(p, NoiseParams(0.0, 0.0, 0.0), plan, n, x0s,
                                        torch.Generator().manual_seed(0), 5)
    assert xf.shape == (B, 4)
    assert rec["start_pos"].shape == (5, B, 4)
    assert bool(torch.isfinite(xf).all())
    assert float((xf[:, 0] - x0s[:, 0]).mean()) > 1.0  # forward progress on average
