"""Mirrors of the closed-loop perception tests (tests/test_perception_loop.py)
and of the rotated-site tests (tests/test_h301_site.py) on the port.

Each test asserts the behaviour its JAX counterpart asserts, on the port,
and holds the port's numbers against the JAX function on the same float64
inputs: the single-vehicle full-stack loop (``sim/plant.closed_loop_full_stack``,
camera -> Kalman filter -> ``semantic_lidar_map`` -> costmap -> planner)
with the JAX loop's key discipline reproduced to pre-draw its noise
(``split(key, T)``, ``normal(k, (3,))`` for the localization noise and
``normal(fold_in(k, 7), (4,))`` for the camera), at the bars of
tests/test_torch_sim.py: iteration counts and booleans equal, states and
boxes within 1e-6, J within 1e-9 relative.  JAX marks two of the three
perception tests ``slow``; here they run at horizon 10 and 10 cycles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import reference_path as jrp
from cilqr_tpu.ops import costmap as jcm, gridmap as jgrid
from cilqr_tpu.sim import perception as jperc, plant as jplant
from cilqr_tpu.utils import maps as jmaps
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams
from cilqr_tpu_torch.models import reference_path as trp
from cilqr_tpu_torch.ops import costmap as tcm, gridmap as tgrid
from cilqr_tpu_torch.sim import perception as tperc, plant as tplant
from cilqr_tpu_torch.utils import interop, maps as tmaps

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


def draws_single(key, T):
    """What ``closed_loop_full_stack`` draws from ``key``: (noise (T, 3),
    camera (T, 4))."""
    keys = jax.random.split(key, T)
    noise = np.stack([np.asarray(jax.random.normal(k, (3,), dtype=jnp.float64)) for k in keys])
    cam = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, 7), (4,),
                                                 dtype=jnp.float64)) for k in keys])
    return t64(noise), t64(cam)


def same_records(got: dict, want: dict, xf_got, xf_want):
    assert set(got) == set(want)
    np.testing.assert_allclose(xf_got.numpy(), np.asarray(xf_want), rtol=0, atol=1e-6)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in ("iterations", "collided", "bbox_valid"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "J":
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def setup(global_plan):
    """tests/test_perception_loop.py's ``_setup`` in both packages: N=10,
    3 LM iterations, a 64x48 costmap (window 5) around the ego, an all-free
    128x128 prior at 1 m."""
    p_j = dataclasses.replace(SolverParams(), horizon=10, max_iterations=3)
    cp_j = dataclasses.replace(CostmapParams(), rows=64, cols=48, window_radius=5,
                               look_ahead_waypoints=10)
    noise = NoiseParams(0.02, 0.02, 0.002)
    jgg = jgrid.make_geom([130.0, -280.0], 1.0, 128, 128, dtype=jnp.float64)
    jplan, jn = jrp.pad_global_plan(p_j, global_plan, dtype=jnp.float64)
    p = interop.solver_params_from_reference(p_j)
    tplan, tn = trp.pad_global_plan(p, global_plan, dtype=torch.float64, device=DEV)
    j = dict(p=p_j, cp=cp_j, gm=jnp.zeros((128, 128)), gg=jgg, plan=jplan, n=jn)
    t = dict(p=p, cp=interop.costmap_params_from_reference(cp_j),
             gm=torch.zeros((128, 128), dtype=torch.float64),
             gg=interop.grid_geom_from_numpy(jgg, dtype=torch.float64, device=DEV), plan=tplan, n=tn)
    return j, t, noise


def loops(setup, seed, n_cycles, obs_xyyaw, obs_mask, vel, percept_on=True):
    """(port (xf, rec), JAX (xf, rec)) of the single full-stack loop with
    one obstacle seen by the camera only (no ellipse barrier)."""
    j, t, noise = setup
    x0 = np.array([100.0, -305.6, 4.0, 0.05])
    size = np.array([[4.5, 2.0]])
    key = jax.random.key(seed)
    jpc = jperc.PerceptionSim(0, jnp.asarray(vel), bbox_sigma=0.5) if percept_on else None
    want = jplant.closed_loop_full_stack(
        j["p"], j["cp"], noise, j["gm"], j["gg"], j["plan"], j["n"], jnp.asarray(x0), key,
        n_cycles, obstacles=None, obs_xyyaw=jnp.asarray(obs_xyyaw), obs_size=jnp.asarray(size),
        obs_mask=jnp.asarray(obs_mask), percept=jpc)
    noise_draws, camera_draws = draws_single(key, n_cycles)
    tpc = tperc.PerceptionSim(0, t64(vel), bbox_sigma=0.5) if percept_on else None
    got = tplant.closed_loop_full_stack(
        t["p"], t["cp"], noise, t["gm"], t["gg"], t["plan"], t["n"], t64(x0), None, n_cycles,
        obstacles=None, obs_xyyaw=t64(obs_xyyaw), obs_size=t64(size), obs_mask=t64(obs_mask),
        percept=tpc, noise_draws=noise_draws, camera_draws=camera_draws)
    same_records(got[1], want[1], got[0], want[0])
    return got


def test_closed_loop_tracked_box_shapes_costmap(setup):
    """Full stack with the camera channel: the tracked box reaches the
    planner's uncertainty map and changes the plan."""
    n_cycles = 10
    # one obstacle 3 m ahead in-lane, creeping forward; camera-only channel
    obs = np.array([[103.0, -305.5, 0.05]])
    xf_on, rec_on = loops(setup, 11, n_cycles, obs, np.ones(1), [0.5, 0.0])
    # blind: the same world, no sensor channel sees the obstacle at all
    xf_off, rec_off = loops(setup, 11, n_cycles, obs, np.zeros(1), [0.5, 0.0], percept_on=False)

    assert rec_on["tracked_box"].shape == (n_cycles, 4)
    assert bool(rec_on["bbox_valid"].all())
    # the tracked box is painted into semantic_lidar_map every cycle
    assert (rec_on["semantic_max"] == 100.0).all()
    # and flows into the propagated map the planner samples
    assert (rec_on["uncertainty_max"][2:] > rec_off["uncertainty_max"][2:]).all()
    # the noise draws are the same in both runs, so every difference is
    # perception: the ego eases off while approaching the box, then
    # accelerates out of the smear once alongside
    assert not torch.allclose(xf_on, xf_off, atol=1e-3)
    v_on, v_off = rec_on["start_pos"][:, 2], rec_off["start_pos"][:, 2]
    assert (v_on[2:8] < v_off[2:8]).all(), (v_on, v_off)     # approach braking
    assert float(xf_on[2]) > float(xf_off[2]) + 0.05          # escape acceleration
    # the painted box is the KF estimate, not the raw measurement
    tb, zm = rec_on["tracked_box"][3:], rec_on["bbox_meas"][3:]
    assert not torch.allclose(tb, zm, atol=1e-6)
    assert float((tb - zm).abs().mean()) < 2.5


def test_closed_loop_invalid_camera_coasts(setup):
    """Out-of-plane readings: the layer stays empty, the track coasts, the
    loop stays intact."""
    # obstacle far off the grid -> every measurement gated invalid
    xf, rec = loops(setup, 2, 6, np.array([[400.0, -100.0, 0.0]]), np.ones(1), [0.0, 0.0])
    assert not bool(rec["bbox_valid"].any())
    assert (rec["semantic_max"] == 0.0).all()
    assert (rec["tracked_box"] == 0.0).all()
    assert bool(torch.isfinite(xf).all())


def test_local_costmap_carries_layers(setup):
    """build_local_costmap populates semantic_lidar_map and ellipse_map, and
    the semantic layer overrides the vehicle map before propagation."""
    j, t, _ = setup
    ego = np.array([100.0, -305.6, 4.0, 0.05])
    box = np.array([-20.0, 120.0, 10.0, 8.0])
    args = lambda f, plan, n, gm, gg: (gm, gg, plan, n, f(ego), f(np.full((1, 2), 1e6)),
                                       f(np.ones((1, 2))), f(np.zeros(1)), f(np.zeros(1)))
    cm = tcm.build_local_costmap(t["cp"], *args(t64, t["plan"], t["n"], t["gm"], t["gg"]),
                                 tracked_box=t64(box), tracked_valid=torch.tensor(True),
                                 with_ellipse_layer=True)
    want = jcm.build_local_costmap(j["cp"], *args(jnp.asarray, j["plan"], j["n"], j["gm"], j["gg"]),
                                   tracked_box=jnp.asarray(box), tracked_valid=jnp.asarray(True),
                                   with_ellipse_layer=True)
    sem = cm.semantic_lidar_map
    assert float(sem.max()) == 100.0 and int((sem > 0).sum()) == 10 * 8
    assert float(cm.vehicle_map[sem > 90].min()) == 100.0
    ell = cm.ellipse_map
    assert float(ell.max()) == 100.0 and bool(torch.isfinite(ell).all())
    for k in ("semantic_lidar_map", "vehicle_map", "ellipse_map", "uncertainty_map"):
        np.testing.assert_allclose(getattr(cm, k).numpy(), np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-9, err_msg=k)


# ------------------------------------------------------- the rotated site
def test_site_map_generation(tmp_path):
    """The synthetic h301-class site: free centreline, occupied 1.2
    corridor half-widths to the side along the rotated normal, a genuinely
    rotated corridor; the same map and the same samples as the JAX side."""
    yaml, center = tmaps.make_synthetic_site(str(tmp_path / "t"), size_m=60.0, resolution=0.5)
    jyaml, jcenter = jmaps.make_synthetic_site(str(tmp_path / "j"), size_m=60.0, resolution=0.5)
    np.testing.assert_array_equal(center, jcenter)
    occ, info = tmaps.load_map(yaml)
    assert occ.shape == (120, 120)
    np.testing.assert_array_equal(occ, jmaps.load_map(jyaml)[0])
    arr, c = tmaps.to_gridmap_array(occ, info, unknown_value=100.0)
    geom = tgrid.make_geom(c, info.resolution, arr.shape[0], arr.shape[1], dtype=torch.float64,
                           device=DEV)
    jgeom = jgrid.make_geom(c, info.resolution, arr.shape[0], arr.shape[1], dtype=jnp.float64)
    arr_t = t64(arr)
    a25 = np.deg2rad(25.0)
    nvec = np.array([-np.sin(a25), np.cos(a25)])
    for pt in center[2:20:4]:
        for q, want in ((pt, 0.0), (pt + 4.2 * nvec, 100.0)):
            v = float(tgrid.sample_nearest(arr_t, geom, t64(q)))
            assert v == want, q
            assert v == float(jgrid.sample_nearest(jnp.asarray(arr), jgeom, jnp.asarray(q)))
    free_rows, free_cols = np.where(arr == 0.0)
    assert free_rows.std() > 5 and free_cols.std() > 5


def test_full_stack_on_rotated_site(tmp_path):
    """The closed loop along the 25-degree corridor (rotated prior gather,
    rotated-frame propagation, a polyfit on a diagonal plan), 12 cycles,
    against the JAX loop on its key's draws."""
    p_j = dataclasses.replace(SolverParams(), horizon=10, max_iterations=4, desired_speed=4.0)
    cp_j = dataclasses.replace(CostmapParams(), rows=48, cols=48, window_radius=5,
                               look_ahead_waypoints=15)
    noise = NoiseParams(0.03, 0.03, 0.003)
    yaml, center = tmaps.make_synthetic_site(str(tmp_path), size_m=120.0, resolution=0.4)
    occ, info = tmaps.load_map(yaml)
    arr, c = tmaps.to_gridmap_array(occ, info, unknown_value=100.0)
    jgg = jgrid.make_geom(c, info.resolution, arr.shape[0], arr.shape[1], dtype=jnp.float64)
    jplan, jn = jrp.pad_global_plan(p_j, center, dtype=jnp.float64)
    p = interop.solver_params_from_reference(p_j)
    tplan, tn = trp.pad_global_plan(p, center, dtype=torch.float64, device=DEV)
    a25 = np.deg2rad(25.0)
    x0 = np.array([center[3, 0], center[3, 1], 3.5, a25])
    n_cycles, key = 12, jax.random.key(9)

    xf_w, rec_w = jax.jit(lambda x, k: jplant.closed_loop_full_stack(
        p_j, cp_j, noise, jnp.asarray(arr), jgg, jplan, jn, x, k, n_cycles))(jnp.asarray(x0), key)
    noise_draws, _ = draws_single(key, n_cycles)
    xf, rec = tplant.closed_loop_full_stack(
        p, interop.costmap_params_from_reference(cp_j), noise, t64(arr),
        interop.grid_geom_from_numpy(jgg, dtype=torch.float64, device=DEV), tplan, tn, t64(x0),
        None, n_cycles, noise_draws=noise_draws)
    same_records(rec, rec_w, xf, xf_w)

    xf = xf.numpy()
    assert np.isfinite(xf).all()
    d = xf[:2] - x0[:2]
    # progressed along the rotated corridor and stayed inside it
    assert float(d @ np.array([np.cos(a25), np.sin(a25)])) > 2.0
    assert abs(float(d @ np.array([-np.sin(a25), np.cos(a25)]))) < 3.0
    assert abs(float(xf[3]) - a25) < 0.3        # heading locked to the lane
    # the rotated walls are inside the local map: propagation sees occupancy
    umax = rec["uncertainty_max"].numpy()
    assert (umax > 0.0).all() and (umax <= 100.0).all()
