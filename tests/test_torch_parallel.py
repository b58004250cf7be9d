"""The scale-out layer (cilqr_tpu_torch/parallel/batch, the sharded
Monte-Carlo, parallel/dryrun) on a mesh of 8 virtual ``cpu`` shards,
mirroring tests/test_parallel.py, and held against the JAX package on its
forced 8-device CPU mesh.

Bars: a sharded call runs each shard's rows through the same functions as
the unsharded call, so on the CPU its per-scenario results equal the
unsharded ones bit for bit, and its metrics (summed in another order) within
1e-12 relative in float64.  Against JAX in float64: iteration counts equal,
X and U within 1e-6, J within 1e-9 relative (the bars of
tests/test_torch_slice.py); the metrics within 1e-9 relative.

JAX's PRNG stream is not reproduced: the full stack's parity with JAX feeds
the port, as ``noise_draws`` / ``camera_draws``, what JAX's shards draw from
``fold_in(key, shard)`` (reproduced as tests/test_torch_sim.py does), and
the JAX reference is the per-shard ``closed_loop_full_stack_batched`` that
tests/test_parallel.py holds ``make_sharded_full_stack`` to, run with
``use_pallas=False`` and ``vmap(run_step)`` as its planner.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import obstacles as jobs, reference_path as jrp, solver as jsolver
from cilqr_tpu.models import uncertainty as junc
from cilqr_tpu.ops import gridmap as jgrid
from cilqr_tpu.parallel import batch as jbatch, monte_carlo as jmc
from cilqr_tpu.sim import perception as jperc, plant as jplant, scenarios as jsc
from cilqr_tpu.sim.runner import build_scenario_inputs as jbuild
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams
from cilqr_tpu_torch.models import reference_path as trp
from cilqr_tpu_torch.models import solver_batched as tsb
from cilqr_tpu_torch.parallel import batch as tbatch, dryrun, monte_carlo as tmc
from cilqr_tpu_torch.parallel import multihost
from cilqr_tpu_torch.sim import perception as tperc, plant as tplant
from cilqr_tpu_torch.sim.runner import build_scenario_inputs as tbuild
from cilqr_tpu_torch.utils import interop
from tests.test_torch_sim import compare_records, draws_batched

DEV = "cpu"  # the port allocates on the card unless told otherwise
MESH = [DEV] * 8


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


def small_params():
    return dataclasses.replace(SolverParams(), horizon=8, max_iterations=3,
                               max_global_plan_points=128, num_of_local_wpts=8)


def same_result(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


def near_jax(got, want):
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.J.numpy(), np.asarray(want.J), rtol=1e-9, atol=0)


def metrics_near(got, want, rtol):
    for k in tbatch.BatchMetrics._fields:
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)), rtol=rtol,
                                   atol=0, err_msg=k)


def test_mesh_has_8_shards(monkeypatch):
    mesh = tbatch.make_mesh(MESH)
    assert len(mesh) == 8 and all(d == torch.device("cpu") for d in mesh)
    # the default is every CUDA device, in order
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tbatch.make_mesh() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.make_mesh()


@pytest.fixture(scope="module")
def solve_world(global_plan):
    """tests/test_parallel.py's 16 egos on the example world's obstacles and
    a random uncertainty map, float64, in both packages."""
    p = small_params()
    rng = np.random.default_rng(31)
    B = 16
    egos = np.column_stack([rng.uniform(95, 125, B), rng.uniform(-306.5, -304.5, B),
                            rng.uniform(1, 8, B), rng.uniform(-0.2, 0.2, B)])
    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jnp.float64)
    jo = jobs.make_static_obstacles(p, [[115.0, -305.0], [130.0, -304.0]], [[3.63, 1.84]] * 2,
                                    [0.0, 0.2], dtype=jnp.float64)
    ju = junc.make_uncertainty_map(rng.uniform(0.0, 100.0, (48, 32)), [10.0, 0.0], 0.2,
                                   [100.0, -305.6], 0.05, dtype=jnp.float64)
    jU = jnp.broadcast_to(jsolver.initial_controls(p, dtype=jnp.float64), (B, p.horizon, 2))
    tplan, tn = trp.pad_global_plan(p, global_plan, dtype=torch.float64, device=DEV)
    t = dict(plan=tplan, n=tn, egos=t64(egos), U=t64(jU),
             ob=interop.obstacles_from_numpy(jo, dtype=torch.float64, device=DEV),
             unc=interop.unc_map_from_numpy(ju, dtype=torch.float64, device=DEV))
    j = dict(plan=jplan, n=jn, egos=jnp.asarray(egos), U=jU, ob=jo, unc=ju)
    return p, j, t


def test_sharded_solve_matches_unsharded_and_jax(solve_world):
    p, j, t = solve_world
    fn, mesh = tbatch.make_sharded_solver(p, tbatch.make_mesh(MESH), t["ob"], t["unc"])
    res, metrics = fn(t["plan"], t["n"], t["egos"], t["U"])
    want, want_m = tbatch.solve_and_reduce(p, t["plan"], t["n"], t["egos"], t["U"], t["ob"],
                                           t["unc"])
    same_result(res, want)
    metrics_near(metrics, want_m, 1e-12)
    np.testing.assert_allclose(float(metrics.max_J), float(want.J.max()), rtol=0)
    assert 0.0 <= float(metrics.converged_frac) <= 1.0

    jmesh = jbatch.make_mesh()
    assert jmesh.devices.size == 8
    jfn, sharding = jbatch.make_sharded_solver(p, jmesh, j["ob"], j["unc"])
    jres, jm = jfn(j["plan"], j["n"], jax.device_put(j["egos"], sharding),
                   jax.device_put(j["U"], sharding))
    near_jax(res, jres)
    metrics_near(metrics, jm, 1e-9)


def test_process_blocks_of_a_single_process(solve_world):
    """One process owns every row: put_global and scatter_local give the
    whole batch at offset 0, and the sharded call takes them as it takes
    the tensors."""
    p, _, t = solve_world
    assert not multihost.initialize()  # no address, one process: no group
    block = multihost.put_global(t["egos"])
    assert block.offset == 0 and torch.equal(block.local, t["egos"])
    assert multihost.scatter_local(t["U"]).offset == 0
    fn, _ = tbatch.make_sharded_solver(p, tbatch.make_mesh(MESH), t["ob"], t["unc"])
    res_b, m_b = fn(t["plan"], t["n"], block, multihost.scatter_local(t["U"]))
    res, m = fn(t["plan"], t["n"], t["egos"], t["U"])
    same_result(res_b, res)
    assert multihost.gather_metrics(m_b) == multihost.gather_metrics(m)
    assert multihost.global_mesh(2, device=DEV) == [torch.device("cpu")] * 2


def test_sharded_fused_solver_matches_run_steps_batched(solve_world):
    """fused=True: each shard through run_steps_batched(impl="mega") (on CPU
    tensors K1's plain version), equal to the unsharded call."""
    p, _, t = solve_world
    fn, _ = tbatch.make_sharded_solver(p, tbatch.make_mesh([DEV] * 4), t["ob"], t["unc"],
                                       fused=True)
    res, metrics = fn(t["plan"], t["n"], t["egos"], t["U"])
    want = tsb.run_steps_batched(p, t["plan"], t["n"], t["egos"], t["U"], t["ob"], t["unc"])
    same_result(res, want)
    metrics_near(metrics, tbatch._metrics_local(p, want), 1e-12)


def test_sharded_solver_rejects_indivisible_batch(solve_world):
    p, _, t = solve_world
    fn, _ = tbatch.make_sharded_solver(p, tbatch.make_mesh(MESH))
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        fn(t["plan"], t["n"], torch.zeros((6, 4), dtype=torch.float64),
           torch.zeros((6, p.horizon, 2), dtype=torch.float64))


@pytest.fixture(scope="module")
def fs_world():
    """tests/test_parallel.py's full-stack world (16x16 costmap, 32x32
    global map, scenario success1), float64, in both packages."""
    p = small_params()
    cp = dataclasses.replace(CostmapParams(), rows=16, cols=16, window_radius=4)
    sc = jsc.get_scenario("success1")
    s = np.linspace(0.0, 60.0, 61)
    plan_np = np.stack([90.0 + s, -306.0 + 0.02 * s], axis=1)
    jplan, jn = jrp.pad_global_plan(p, plan_np, dtype=jnp.float64)
    jggeom = jgrid.make_geom([100.0, -300.0], 2.0, 32, 32, dtype=jnp.float64)
    tplan, tn = trp.pad_global_plan(p, plan_np, dtype=torch.float64, device=DEV)
    B = 16
    x0s = np.asarray(sc.start)[None, :] + np.random.default_rng(13).normal(0, 0.2, (B, 4))
    j = dict(world=jbuild(p, sc, jnp.float64), plan=jplan, n=jn, gm=jnp.zeros((32, 32)),
             gg=jggeom, x0s=jnp.asarray(x0s))
    t = dict(world=tbuild(p, sc, torch.float64, DEV), plan=tplan, n=tn,
             gm=torch.zeros((32, 32), dtype=torch.float64),
             gg=interop.grid_geom_from_numpy(jggeom, dtype=torch.float64, device=DEV),
             x0s=t64(x0s))
    return p, cp, j, t


def _percept(jax_side: bool):
    if jax_side:
        return jperc.PerceptionSim(0, jnp.asarray([0.5, 0.0]), bbox_sigma=0.3)
    return tperc.PerceptionSim(0, t64([0.5, 0.0]), bbox_sigma=0.3)


def _fs_kwargs(world, percept):
    ob, obs_xyyaw, obs_size, obs_mask = world
    return dict(obstacles=ob, obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
                percept=percept)


def test_sharded_full_stack_matches_per_chunk_runs(fs_world):
    """make_sharded_full_stack on 8 shards = the 8 per-chunk runs unsharded,
    each on its shard's generator: final states within 1e-5 (the dryrun's
    bar), the record gathered on axis 1, the summary reduced."""
    p, cp, _, t = fs_world
    T, B = 2, t["x0s"].shape[0]
    kw = _fs_kwargs(t["world"], _percept(False))
    fn, _ = tbatch.make_sharded_full_stack(p, cp, tbatch.make_mesh(MESH), T, **kw)
    xf, rec, summary = fn(t["gm"], t["gg"], t["plan"], t["n"], t["x0s"], 5)
    assert rec["J"].shape == (T, B) and rec["tracked_box"].shape[:2] == (T, B)
    b = B // 8
    xf_ref, J_ref, col = [], [], []
    for i in range(8):
        xf_i, rec_i = tplant.closed_loop_full_stack_batched(
            p, cp, NoiseParams(), t["gm"], t["gg"], t["plan"], t["n"], t["x0s"][i * b:(i + 1) * b],
            tbatch.shard_generator(5, i, DEV), T, **kw)
        xf_ref.append(xf_i)
        J_ref.append(rec_i["J"])
        col.append(rec_i["collided"].any(dim=0))
    torch.testing.assert_close(xf, torch.cat(xf_ref), rtol=0, atol=1e-5)
    torch.testing.assert_close(rec["J"], torch.cat(J_ref, dim=1), rtol=0, atol=0)
    J_last = torch.cat(J_ref, dim=1)[-1]
    np.testing.assert_allclose(float(summary[0]), float(J_last.sum()) / B, rtol=1e-12)
    assert float(summary[1]) == float(torch.cat(col).double().mean())
    # the shards draw different noise: no two shards share a stream
    seeds = {tbatch.shard_generator(5, i, DEV).initial_seed() for i in range(8)}
    assert len(seeds) == 8


def test_sharded_full_stack_block_draws_its_global_shards(fs_world):
    """A process's block draws the streams of its global shards, which
    ``first_shard`` reads off the block's offset: the second half of the
    batch on 4 shards equals the second half of the 8-shard call.  An offset
    off the shard grid raises."""
    p, cp, _, t = fs_world
    T, B = 2, t["x0s"].shape[0]
    kw = _fs_kwargs(t["world"], _percept(False))
    whole, _ = tbatch.make_sharded_full_stack(p, cp, tbatch.make_mesh(MESH), T, **kw)
    half, _ = tbatch.make_sharded_full_stack(p, cp, tbatch.make_mesh(MESH[:4]), T, **kw)
    xf, rec, _ = whole(t["gm"], t["gg"], t["plan"], t["n"], t["x0s"], 5)
    block = tbatch.ProcessBlock(t["x0s"][B // 2:], B // 2)
    assert tbatch.first_shard(block, B // 8) == 4
    xf_h, rec_h, _ = half(t["gm"], t["gg"], t["plan"], t["n"], block, 5)
    assert torch.equal(xf_h, xf[B // 2:]) and torch.equal(rec_h["J"], rec["J"][:, B // 2:])
    with pytest.raises(ValueError, match="not a multiple of 2 rows per shard"):
        tbatch.first_shard(tbatch.ProcessBlock(t["x0s"][:8], 3), 2)


def test_sharded_full_stack_matches_jax_per_shard_keys(fs_world):
    """The port's sharded full stack fed JAX's per-shard draws (shard i draws
    from fold_in(key, i)) against JAX's per-shard runs of the same loop."""
    p, cp, j, t = fs_world
    T, B = 2, t["x0s"].shape[0]
    b = B // 8
    key = jax.random.key(5)
    jkw = _fs_kwargs(j["world"], _percept(True))

    def plan_step_batched(noisy, U_warm, umaps):
        return jax.vmap(lambda e, u, m: jsolver.run_step(p, j["plan"], j["n"], e, u, jkw["obstacles"],
                                                         m))(noisy, U_warm, umaps)

    @jax.jit
    def shard_run(x0s, k):
        return jplant.closed_loop_full_stack_batched(
            p, cp, NoiseParams(), j["gm"], j["gg"], j["plan"], j["n"], x0s, k, T, **jkw,
            plan_step_batched=plan_step_batched, use_pallas=False)

    xf_w, recs_w, noise, cam = [], [], [], []
    for i in range(8):
        k_i = jax.random.fold_in(key, i)
        xf_i, rec_i = shard_run(j["x0s"][i * b:(i + 1) * b], k_i)
        xf_w.append(np.asarray(xf_i))
        recs_w.append(rec_i)
        nd, cd = draws_batched(k_i, T, b)
        noise.append(nd)
        cam.append(cd)
    rec_w = {k: np.concatenate([np.asarray(r[k]) for r in recs_w], axis=1) for k in recs_w[0]}
    fn, _ = tbatch.make_sharded_full_stack(p, cp, tbatch.make_mesh(MESH), T,
                                           **_fs_kwargs(t["world"], _percept(False)))
    xf, rec, summary = fn(t["gm"], t["gg"], t["plan"], t["n"], t["x0s"], 0,
                          noise_draws=torch.cat(noise, dim=1), camera_draws=torch.cat(cam, dim=1))
    compare_records(rec, rec_w, xf, np.concatenate(xf_w))
    np.testing.assert_allclose(float(summary[0]), rec_w["J"][-1].mean(), rtol=1e-9)


@pytest.fixture(scope="module")
def mc_world(global_plan):
    """tests/test_campaign.py's Monte-Carlo world (16x16 prior), float64,
    16 scenarios drawn by JAX's sample_scenarios."""
    p = small_params()
    cp = dataclasses.replace(CostmapParams(), rows=16, cols=16, window_radius=4)
    prior = np.random.default_rng(2).uniform(0, 100, (cp.rows, cp.cols))
    jgeom = jgrid.make_geom([5.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float64)
    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jnp.float64)
    ego = np.array([100.0, -305.6, 4.0, 0.05])
    samples = jmc.sample_scenarios(jax.random.key(3), 16, ego, dtype=jnp.float64)
    tplan, tn = trp.pad_global_plan(p, global_plan, dtype=torch.float64, device=DEV)
    j = (jnp.asarray(prior), jgeom, jnp.asarray(ego[:2]), jnp.asarray(ego[3]), jplan, jn)
    t = (t64(prior), interop.grid_geom_from_numpy(jgeom, dtype=torch.float64, device=DEV),
         t64(ego[:2]), t64(ego[3]), tplan, tn)
    return p, cp, j, t, samples, interop.mc_sample_from_numpy(samples, dtype=torch.float64,
                                                              device=DEV)


def test_sharded_monte_carlo_matches_jax(mc_world):
    """Both packages size the window and the band plan when the function is
    made; 2 scenarios per shard take the reference route ("auto") in both."""
    p, cp, j, t, js, ts = mc_world
    kw = dict(map_shape=(cp.rows, cp.cols), map_center=(5.0, 0.0))
    jfn, sharding = jmc.make_sharded_monte_carlo(p, cp, jbatch.make_mesh(), **kw)
    jres, jm = jfn(*j, jax.device_put(js.sigmas, sharding), jax.device_put(js.egos, sharding))
    fn, _ = tmc.make_sharded_monte_carlo(p, cp, tbatch.make_mesh(MESH), **kw)
    res, metrics = fn(*t, ts.sigmas, ts.egos)
    near_jax(res, jres)
    metrics_near(metrics, jm, 1e-9)
    # = the unsharded call on the same samples
    want = tmc.monte_carlo(p, cp, *t, ts, impl="reference")
    same_result(res, want)


def test_sharded_monte_carlo_fast_matches_unsharded(mc_world, monkeypatch):
    """impl="fast" per shard (K4's and K3's plain versions on the CPU) on 4
    shards equals the unsharded fast call with the same band plan; the map
    centre is given at build time, so no call reads it from the device."""
    p, cp, _, t, _, ts = mc_world
    fn, _ = tmc.make_sharded_monte_carlo(p, cp, tbatch.make_mesh([DEV] * 4),
                                         map_shape=(cp.rows, cp.cols), map_center=(5.0, 0.0),
                                         impl="fast")
    res, metrics = fn(*t, ts.sigmas, ts.egos)
    cp_w = tmc.ensure_window_covers(cp, cp.rows, cp.cols, (5.0, 0.0))
    from cilqr_tpu_torch.ops import uncertainty_cuda

    band = uncertainty_cuda.make_band_plan(cp_w, cp.rows, cp.cols, (5.0, 0.0), tmc.DEFAULT_SIGMA_HI)
    want = tmc.monte_carlo(p, cp, *t, ts, impl="fast", band_plan=band)
    same_result(res, want)
    metrics_near(metrics, tbatch._metrics_local(p, want), 1e-12)

    seen = []
    inner = tmc.monte_carlo
    monkeypatch.setattr(tmc, "monte_carlo", lambda *a, **kw: seen.append(kw["center"]) or inner(*a, **kw))
    fn(*t, ts.sigmas, ts.egos)
    assert seen == [(5.0, 0.0)] * 4


def test_dryrun_multichip_runs():
    out = dryrun.dryrun_multichip(8, device=DEV)
    assert out["shards"] == 8 and out["batch"] == 16
    assert out["fs_max_abs_diff_vs_unsharded"] <= 1e-5
    assert np.isfinite(out["mean_J"]) and np.isfinite(out["mc_mean_J"])
