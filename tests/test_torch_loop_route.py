"""The Town02 loop route and the chord-aligned plan fit (the `long`
scenario's path) on the port: tests/test_loop_route.py's four checks, with
the port's scenarios, reference path and closed loop.  The fits are also
held to the JAX package's at 1e-9."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import reference_path as jrp
from cilqr_tpu.utils.params import SolverParams as JSolverParams
from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.sim import plant, scenarios
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

DEV = "cpu"  # the port allocates on the card unless told otherwise


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs: the tier runs six workers at
    once, and these small eager loops only lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def local_plan(p, plan_np, ego):
    plan, n = rp.pad_global_plan(p, plan_np, dtype=torch.float64, device=DEV)
    return rp.get_local_plan(p, plan, n, torch.tensor(ego, dtype=torch.float64))


def jax_local_plan(chord: bool, plan_np, ego):
    p = dataclasses.replace(JSolverParams(), chord_frame_fit=chord)
    plan, n = jrp.pad_global_plan(p, plan_np, dtype=jnp.float64)
    return jrp.get_local_plan(p, plan, n, jnp.asarray(ego))


def test_loop_plan_geometry():
    plan = scenarios.town02_loop_plan()
    assert plan.shape[0] <= SolverParams().max_global_plan_points
    # every `long` obstacle sits within 5 m of the route (they line the road)
    obs = scenarios.get_scenario("long").obstacles_xyyaw[:, :2]
    d = np.linalg.norm(plan[None, :, :] - obs[:, None, :], axis=-1).min(axis=1)
    assert d.max() < 5.0
    # consecutive spacing is bounded (no jumps at the leg/arc joins)
    seg = np.linalg.norm(np.diff(plan, axis=0), axis=-1)
    assert seg.max() < 2.0 and seg.min() > 0.05


def test_chord_fit_matches_parity_on_straight(global_plan):
    p0 = SolverParams()
    p1 = dataclasses.replace(p0, chord_frame_fit=True)
    ego = [100.0, -305.6, 4.0, 0.05]
    lp0, lp1 = local_plan(p0, global_plan, ego), local_plan(p1, global_plan, ego)
    # same fitted geometry to within the least-squares re-weighting the
    # rotation induces (the chord frame is benign on a y(x) road; sub-cm)
    np.testing.assert_allclose(lp1.sample_y.numpy(), lp0.sample_y.numpy(), atol=1e-2)
    np.testing.assert_allclose(lp1.y_fit.numpy(), lp0.y_fit.numpy(), atol=1e-2)
    want = jax_local_plan(True, global_plan, ego)
    np.testing.assert_allclose(lp1.sample_y.numpy(), np.asarray(want.sample_y), rtol=1e-9)


def test_chord_fit_tracks_vertical_leg():
    p = dataclasses.replace(SolverParams(), chord_frame_fit=True)
    plan_np = scenarios.town02_loop_plan()
    ego = [190.14, -250.0, 5.0, np.pi / 2]
    lp = local_plan(p, plan_np, ego)
    # sample table runs north along the x ~ 190.14 road
    assert abs(float(lp.sample_x.mean()) - 190.14) < 0.5
    assert float(lp.sample_y.max() - lp.sample_y.min()) > 10.0
    want = jax_local_plan(True, plan_np, ego)
    np.testing.assert_allclose(lp.sample_x.numpy(), np.asarray(want.sample_x), rtol=1e-9)
    np.testing.assert_allclose(lp.sample_y.numpy(), np.asarray(want.sample_y), rtol=1e-9)
    # the parity fit (global y(x) basis) is degenerate here: its sample
    # table spans almost no y — the failure mode the flag exists for
    lp_bad = local_plan(SolverParams(), plan_np, ego)
    assert float(lp_bad.sample_y.max() - lp_bad.sample_y.min()) < 1.0


def test_closed_loop_turns_corner():
    p = dataclasses.replace(SolverParams(), chord_frame_fit=True, horizon=20, max_iterations=8)
    plan, n = rp.pad_global_plan(p, scenarios.town02_loop_plan(), dtype=torch.float64,
                                 device=DEV)
    x0 = torch.tensor([170.0, -306.74, 5.0, 0.0], dtype=torch.float64)
    xf, rec = plant.closed_loop(p, NoiseParams(0.05, 0.05, 0.005), plan, n, x0,
                                torch.Generator().manual_seed(0), 100)
    traj = rec.start_pos.numpy()
    assert np.isfinite(traj).all()
    assert traj[:, 0].max() < 195.0       # stays in the corridor
    assert traj[-1, 1] > -295.0           # turned the corner, heading north
    assert abs(float(xf[3]) - np.pi / 2) < 0.3
