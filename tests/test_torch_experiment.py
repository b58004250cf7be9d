"""The experiment layer of the port (sim/scenarios, utils/maps, utils/explog,
utils/frames, ops/convert, utils/metrics, sim/runner, sim/sweep) vs the JAX
package.

The NumPy-only modules are copies: their tables, plans, PNG bytes and loaded
maps must equal the originals.  The experiment log is one C ABI: a log
written by either package reads back in the other.  Frames, conversions and
metrics match JAX at 1e-9 relative on seeded random inputs (float64).

The experiment functions run on the small world of tests/test_torch_sim.py
(N=10, 3 LM iterations, a 64x48 costmap, a 40x40 prior at 1 m) with the
gauntlet scenario, in float64, at the bars of tests/test_torch_slice.py
(iterations and collisions equal, states within 1e-6, J within 1e-9
relative; rows within 1e-9).  JAX's PRNG stream cannot be reproduced, so
each test reproduces the JAX function's key discipline to pre-draw the
numbers it will draw: ``split(key(seed), n_runs)`` then ``split(k, T)`` per
run in the batch and the sweep, one ``split`` per cycle in
``run_experiment``.  The JAX functions run with ``use_pallas=False``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.ops import convert as jconvert, gridmap as jgrid
from cilqr_tpu.sim import runner as jrunner, scenarios as jsc, sweep as jsweep
from cilqr_tpu.utils import explog as jexplog, frames as jframes, maps as jmaps
from cilqr_tpu.utils import metrics as jmetrics
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams
from cilqr_tpu_torch.ops import convert as tconvert
from cilqr_tpu_torch.sim import runner as trunner, scenarios as tsc, sweep as tsweep
from cilqr_tpu_torch.utils import explog as texplog, frames as tframes, interop
from cilqr_tpu_torch.utils import maps as tmaps, metrics as tmetrics

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


def close(got, want, rel=REL):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * 1e-3)


def same_rows(got: list, want: list, rel=REL):
    """Rows with the same keys in the same order; strings and integers
    equal, floats within rel."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=rel, atol=rel * 1e-3, err_msg=k)
            else:
                assert g[k] == w[k], k


# ------------------------------------------------------------ the copies
def same_scenario(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name
    assert (a.n_obstacles, a.n_walls) == (b.n_obstacles, b.n_walls)


@pytest.mark.parametrize("name", jsc.scenario_names())
def test_scenario_copy_equals_the_jax_module(name):
    same_scenario(tsc.get_scenario(name), jsc.get_scenario(name))
    np.testing.assert_array_equal(tsc.plan_for(name), jsc.plan_for(name))


def test_scenario_tables_gauntlet_and_rotation_equal():
    assert tsc.scenario_names() == jsc.scenario_names()
    assert tsc._SCENARIOS == jsc._SCENARIOS and tsc._STARTS == jsc._STARTS
    assert tsc.EVAL_WINDOWS == jsc.EVAL_WINDOWS
    assert (tsc.OBSTACLE_LENGTH, tsc.OBSTACLE_WIDTH) == (jsc.OBSTACLE_LENGTH, jsc.OBSTACLE_WIDTH)
    same_scenario(tsc.make_gauntlet(), jsc.make_gauntlet())
    kw = dict(wall_faces=(-2.5, 4.0), offsets=(3.0, 2.5), xs=(90.0, 130.0), wall_thickness=1.0)
    same_scenario(tsc.make_gauntlet(**kw), jsc.make_gauntlet(**kw))
    for origin in (None, (80.0, -300.0)):
        got_sc, got_plan = tsc.rotate_scenario(tsc.make_gauntlet(), tsc.plan_for("compare"),
                                               np.deg2rad(25.0), origin)
        want_sc, want_plan = jsc.rotate_scenario(jsc.make_gauntlet(), jsc.plan_for("compare"),
                                                 np.deg2rad(25.0), origin)
        same_scenario(got_sc, want_sc)
        np.testing.assert_array_equal(got_plan, want_plan)
    for spacing in (0.5, 1.0, 2.0):
        np.testing.assert_array_equal(tsc.town02_loop_plan(spacing), jsc.town02_loop_plan(spacing))
        np.testing.assert_array_equal(tsc.straight_lane_plan(x0=50.0, spacing=spacing),
                                      jsc.straight_lane_plan(x0=50.0, spacing=spacing))
    with pytest.raises(KeyError, match="unknown scenario"):
        tsc.get_scenario("nowhere")


def test_synthetic_maps_and_loading_equal(tmp_path):
    """The synthetic Town02 map (PNG bytes, YAML), its load and reorientation,
    the synthetic site, the checked-in fixture and the TGA reader."""
    ty = tmaps.make_synthetic_town(str(tmp_path / "t"))
    jy = jmaps.make_synthetic_town(str(tmp_path / "j"))
    assert (tmp_path / "t" / "town.png").read_bytes() == (tmp_path / "j" / "town.png").read_bytes()
    assert (tmp_path / "t" / "town.yaml").read_text() == (tmp_path / "j" / "town.yaml").read_text()
    (t_occ, t_info), (j_occ, j_info) = tmaps.load_map(ty), jmaps.load_map(jy)
    np.testing.assert_array_equal(t_occ, j_occ)
    assert dataclasses.asdict(t_info) == dataclasses.asdict(j_info)
    t_arr, t_center = tmaps.to_gridmap_array(t_occ, t_info, unknown_value=100.0)
    j_arr, j_center = jmaps.to_gridmap_array(j_occ, j_info, unknown_value=100.0)
    np.testing.assert_array_equal(t_arr, j_arr)
    assert t_arr.shape == (1506, 1506) and t_center == j_center

    (ts, tc), (js, jc) = (tmaps.make_synthetic_site(str(tmp_path / "ts")),
                          jmaps.make_synthetic_site(str(tmp_path / "js")))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tmaps.load_map(ts)[0], jmaps.load_map(js)[0])

    fixture = str(__import__("pathlib").Path(__file__).parent / "data" / "mini_town.yaml")
    (t_occ, t_info), (j_occ, j_info) = tmaps.load_map(fixture), jmaps.load_map(fixture)
    np.testing.assert_array_equal(t_occ, j_occ)
    assert dataclasses.asdict(t_info) == dataclasses.asdict(j_info)
    info = dataclasses.replace(j_info, negate=1)
    gray = np.random.default_rng(3).integers(0, 256, (9, 7)).astype(np.uint8)
    np.testing.assert_array_equal(tmaps.occupancy_from_image(gray, info),
                                  jmaps.occupancy_from_image(gray, info))
    np.testing.assert_array_equal(tmaps.threshold_image(gray, 100), jmaps.threshold_image(gray, 100))

    # TGA: uncompressed grayscale (bottom-up) and RLE BGR (top-down)
    h, w = 5, 6
    rgb = np.random.default_rng(4).integers(0, 256, (h, w, 3)).astype(np.uint8)
    header = lambda kind, bpp, desc: bytes([0, 0, kind] + [0] * 9) + np.array(
        [w, h], "<u2").tobytes() + bytes([bpp, desc])
    (tmp_path / "g.tga").write_bytes(header(3, 8, 0) + gray[:h, :w].tobytes())
    rle = b"".join(bytes([0x80 | 0]) + px[::-1].tobytes() for px in rgb.reshape(-1, 3))
    (tmp_path / "c.tga").write_bytes(header(10, 24, 0x20) + rle)
    for name in ("g.tga", "c.tga"):
        np.testing.assert_array_equal(tmaps.read_tga(str(tmp_path / name)),
                                      jmaps.read_tga(str(tmp_path / name)))
    tmaps.convert_tga_to_png(str(tmp_path / "c.tga"), str(tmp_path / "t.png"))
    jmaps.convert_tga_to_png(str(tmp_path / "c.tga"), str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(tmaps.read_png(str(tmp_path / "t.png")),
                                  jmaps.read_png(str(tmp_path / "j.png")))


# ------------------------------------------------------------ experiment log
def _records(n, N=10, seed=23):
    rng = np.random.default_rng(seed)
    return [dict(start_time=0.1 * i, start_pos=rng.normal(0, 1, 4),
                 planning_time=rng.uniform(0.001, 0.01), X=rng.normal(0, 1, (N + 1, 4)),
                 U=rng.normal(0, 1, (N, 2))) for i in range(n)]


def same_log_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.start_time == w["start_time"] and g.planning_time == w["planning_time"]
        for k in ("start_pos", "X", "U"):
            np.testing.assert_array_equal(getattr(g, k), np.asarray(w[k]), err_msg=k)


def test_explog_round_trip_and_both_packages_read_each_others_logs(tmp_path):
    recs = _records(6)
    # the port writes (tensors and arrays alike) and reads back
    with texplog.ExperimentLog(tmp_path / "port.log", "w") as log:
        for i, r in enumerate(recs):
            log.append(**(r if i % 2 else {k: t64(v) if isinstance(v, np.ndarray) else v
                                           for k, v in r.items()}))
        assert len(log) == 6
    with texplog.ExperimentLog(tmp_path / "port.log", "a") as log:
        log.append(**_records(1, seed=5)[0])
    recs_all = recs + _records(1, seed=5)
    with texplog.ExperimentLog(tmp_path / "port.log", "r") as log:
        same_log_records([log.read(i) for i in range(len(log))], recs_all)
        same_log_records(list(log), recs_all)
        with pytest.raises(IndexError):
            log.read(len(recs_all))
    # the JAX package reads the port's log, the port reads the JAX package's
    with jexplog.ExperimentLog(tmp_path / "port.log", "r") as log:
        same_log_records(list(log), recs_all)
    with jexplog.ExperimentLog(tmp_path / "jax.log", "w") as log:
        for r in recs:
            log.append(**r)
    with texplog.ExperimentLog(tmp_path / "jax.log", "r") as log:
        same_log_records(list(log), recs)
    got, want = (texplog.read_experiment_log(str(tmp_path / "jax.log")),
                 jexplog.read_experiment_log(str(tmp_path / "jax.log")))
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], list):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(OSError):
        texplog.ExperimentLog(tmp_path / "missing" / "x.log", "r")


# ------------------------------------------------- frames, convert, metrics
def test_frames_match_jax():
    rng = np.random.default_rng(71)
    path = rng.normal(0, 50, (3, 20, 2))
    for ego in ([10.0, -5.0, 3.0, 0.7], [-120.0, 305.0, 1.0, -2.9]):
        for name in ("global_to_vehicle", "vehicle_to_global", "global_to_vehicle_rot",
                     "vehicle_to_global_rot"):
            close(getattr(tframes, name)(t64(path), t64(ego)),
                  getattr(jframes, name)(jnp.asarray(path), jnp.asarray(ego)))


def test_convert_matches_jax():
    rng = np.random.default_rng(72)
    layer = rng.uniform(-20.0, 130.0, (12, 9))
    layer[rng.random((12, 9)) < 0.15] = np.nan
    jg = jgrid.make_geom([3.0, -7.0], 0.25, 12, 9, dtype=jnp.float64)
    tg = interop.grid_geom_from_numpy(jg, dtype=torch.float64, device=DEV)
    for yaw in (None, 0.4):
        got = tconvert.to_occupancy_grid(t64(layer), tg, -10.0, 110.0,
                                         None if yaw is None else t64(yaw))
        want = jconvert.to_occupancy_grid(jnp.asarray(layer), jg, -10.0, 110.0,
                                          None if yaw is None else jnp.asarray(yaw))
        assert got.data.dtype == torch.int8
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        for g, w in zip(got[1:], want[1:]):
            close(g, w)
        back, bgeom = tconvert.from_occupancy_grid(got, -10.0, 110.0)
        wback, wgeom = jconvert.from_occupancy_grid(want, -10.0, 110.0)
        assert back.dtype == torch.float32
        np.testing.assert_array_equal(back.numpy(), np.asarray(wback))
        for g, w in zip(bgeom, wgeom):
            close(g, w)
    msg = tconvert.to_gridmap_message({"b": t64(layer), "a": t64(layer * 2)}, tg, t64([1.0, 2.0]),
                                      t64(0.3))
    jmsg = jconvert.to_gridmap_message({"b": jnp.asarray(layer), "a": jnp.asarray(layer * 2)}, jg,
                                       jnp.asarray([1.0, 2.0]), jnp.asarray(0.3))
    assert msg.layers == jmsg.layers == ("a", "b")
    np.testing.assert_array_equal(tconvert.layer(msg, "a").numpy(), np.asarray(jconvert.layer(jmsg, "a")))


def _runs(seed, R=3, T=30):
    r = np.random.default_rng(seed)
    t = np.arange(T) * 0.1
    return np.stack([np.stack([100 + 4 * t + r.normal(0, 0.1, T), -306 + r.normal(0, 0.1, T),
                               4 + r.normal(0, 0.1, T), r.normal(0, 0.05, T)], axis=1)
                     for _ in range(R)])


def same_metrics(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], tuple):
            assert type(got[k]).__name__ == "Stats" and got[k]._fields == want[k]._fields
            for g, w in zip(got[k], want[k]):
                close(g, w)
        else:
            close(got[k], want[k])


def test_metrics_match_jax(tmp_path):
    runs = _runs(1)
    sp = runs[0]
    obs = np.array([[110.0, -306.0], [104.0, -303.0], [130.0, -300.0]])
    mask = np.array([1.0, 0.0, 1.0])
    pt = np.random.default_rng(2).uniform(0.0, 0.02, 30)
    close(tmetrics.compute_jerks(t64(sp[:, :2]), 0.1),
          jmetrics.compute_jerks(jnp.asarray(sp[:, :2]), 0.1))
    kinked = sp[:, :2].copy()
    kinked[5] = kinked[4]  # a zero-speed denominator
    kinked[6] = kinked[4]
    close(tmetrics.compute_curvature(t64(kinked)), jmetrics.compute_curvature(jnp.asarray(kinked)))
    close(tmetrics.compute_curvature(t64(runs[..., :2]))[1],
          jmetrics.compute_curvature(jnp.asarray(runs[1, :, :2])))
    for m in (None, mask):
        close(tmetrics.min_obstacle_distance(t64(sp), t64(obs), None if m is None else t64(m)),
              jmetrics.min_obstacle_distance(jnp.asarray(sp), jnp.asarray(obs),
                                             None if m is None else jnp.asarray(m)))
    win = ((100.5, -310.0), (108.0, -300.0))
    np.testing.assert_array_equal(
        tmetrics.spatial_window_mask(t64(sp), *win, planning_time=t64(pt),
                                     planning_time_threshold=0.005).numpy(),
        np.asarray(jmetrics.spatial_window_mask(jnp.asarray(sp), *win,
                                                planning_time=jnp.asarray(pt),
                                                planning_time_threshold=0.005)))
    for kw in (dict(), dict(planning_time=pt, obs_mask=mask), dict(planning_time=pt, window=win)):
        tkw = {k: t64(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        got = tmetrics.analyze_run(t64(sp), t64(obs), dt=0.1, **tkw)
        want = jmetrics.analyze_run(jnp.asarray(sp), jnp.asarray(obs), dt=0.1, **jkw)
        same_metrics(got, want)
        same_rows([tmetrics.summary_row("r", got)], [jmetrics.summary_row("r", want)])
    with pytest.raises(ValueError, match="at least 3"):
        tmetrics.analyze_run(t64(sp), t64(obs), window=((0.0, 0.0), (1.0, 1.0)))
    same_metrics(tmetrics.analyze_batch(t64(runs), t64(obs), 0.1, obs_mask=t64(mask)),
                 jmetrics.analyze_batch(jnp.asarray(runs), jnp.asarray(obs), 0.1,
                                        obs_mask=jnp.asarray(mask)))
    got_rows = tmetrics.compare_algorithms({"CILQR": t64(runs), "Base": t64(_runs(2))}, t64(obs))
    want_rows = jmetrics.compare_algorithms({"CILQR": runs, "Base": _runs(2)}, jnp.asarray(obs))
    same_rows(got_rows, want_rows)
    assert len(got_rows) == 8
    rounded = [{k: round(v, 6) if isinstance(v, float) else v for k, v in r.items()}
               for r in got_rows]
    for fn in ("export_csv", "export_jsonl"):
        getattr(tmetrics, fn)(rounded, str(tmp_path / f"t.{fn}"))
        getattr(jmetrics, fn)(rounded, str(tmp_path / f"j.{fn}"))
        assert (tmp_path / f"t.{fn}").read_text() == (tmp_path / f"j.{fn}").read_text()
    with pytest.raises(ValueError, match="no rows"):
        tmetrics.export_csv([], str(tmp_path / "empty.csv"))


# ------------------------------------------------------------ the runner
@pytest.fixture(scope="module")
def world():
    """The small world of tests/test_torch_sim.py in both packages, driven
    on the gauntlet: its two cars are barriers, rasterized and SAT-checked,
    its two walls rasterized and SAT-checked only."""
    p_j = dataclasses.replace(SolverParams(), horizon=10, max_iterations=3, num_of_local_wpts=8,
                              closest_point_samples_per_wpt=5)
    cp_j = dataclasses.replace(CostmapParams(), rows=64, cols=48, window_radius=3,
                               look_ahead_waypoints=10)
    rng = np.random.default_rng(31)
    gm = np.zeros((40, 40))
    gm[10:30, 12:20] = rng.uniform(20.0, 100.0, (20, 8))
    jgg = jgrid.make_geom([80.0, -300.0], 1.0, 40, 40, dtype=jnp.float64)
    j = dict(p=p_j, cp=cp_j, gm=jnp.asarray(gm), gg=jgg)
    t = dict(p=interop.solver_params_from_reference(p_j),
             cp=interop.costmap_params_from_reference(cp_j), gm=t64(gm),
             gg=interop.grid_geom_from_numpy(jgg, dtype=torch.float64, device=DEV))
    sc = jsc.make_gauntlet()
    return j, t, sc, jsc.plan_for("gauntlet"), np.array(sc.start)


NOISE = NoiseParams(0.05, 0.04, 0.005)


def draws_runs(seed: int, T: int, R: int):
    """What the JAX batch and sweep draw: per run ``split(key(seed), R)[r]``,
    split into T cycle keys, ``normal(k, (3,))`` each -> (T, R, 3)."""
    out = np.zeros((T, R, 3))
    for r, k in enumerate(jax.random.split(jax.random.key(seed), R)):
        for t, kt in enumerate(jax.random.split(k, T)):
            out[t, r] = np.asarray(jax.random.normal(kt, (3,), dtype=jnp.float64))
    return t64(out)


def draws_cycles(seed: int, T: int):
    """What ``run_experiment`` draws: key, k_t = split(key) per cycle."""
    key, out = jax.random.key(seed), []
    for _ in range(T):
        key, k_t = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k_t, (3,), dtype=jnp.float64)))
    return t64(np.stack(out))


def same_records(got: dict, want: dict, keys):
    for k in keys:
        g, w = got[k], np.asarray(want[k])
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in ("iterations", "collided"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "J":
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


def test_build_scenario_inputs_and_plan_step_errors(world):
    j, t, sc, _, _ = world
    got = trunner.build_scenario_inputs(t["p"], sc, torch.float64, DEV)
    want = jrunner.build_scenario_inputs(j["p"], sc, jnp.float64)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3].sum()) == 4  # two cars and two walls
    tight = dataclasses.replace(t["p"], max_obstacles=3)
    with pytest.raises(ValueError, match="obstacle slots"):
        trunner.build_scenario_inputs(tight, sc, torch.float64, DEV)
    plan = torch.zeros((4, 2), dtype=torch.float64)
    noise = interop.noise_params_from_reference(NOISE)
    for algo in ("ccnmpc", "frenet_origin", "nrb_rrt"):
        assert callable(trunner.make_plan_step(algo, t["p"], noise, plan, 4))
    with pytest.raises(ValueError, match="unknown algorithm"):
        trunner.make_plan_step("rrt_star", t["p"], noise, plan, 4)
    assert trunner.ALGORITHMS == jrunner.ALGORITHMS


R, T = 3, 3


BATCH_CASES = [(False, "cilqr"), (True, "cilqr"), (True, "cilqr_base")] + [
    (fs, a) for fs in (False, True) for a in jrunner.ALGORITHMS
    if (fs, a) not in ((False, "cilqr"), (True, "cilqr"), (True, "cilqr_base"))]


@pytest.mark.parametrize("full_stack,algorithm", BATCH_CASES,
                         ids=["blind", "full-stack", "full-stack-base"] + [
                             f"{'full-stack' if fs else 'blind'}-{a}" for fs, a in BATCH_CASES[3:]])
def test_run_experiment_batch_matches_jax(world, full_stack, algorithm):
    """Every algorithm of the axis, blind and on the full stack: records,
    final states and rows against the JAX batch (the vmapped single loop)."""
    j, t, sc, plan, x0 = world
    jkw = tkw = {}
    if full_stack:
        jkw = dict(costmap_params=j["cp"], global_map=j["gm"], global_geom=j["gg"])
        tkw = dict(costmap_params=t["cp"], global_map=t["gm"], global_geom=t["gg"])
    jout, jrows = jrunner.run_experiment_batch(
        j["p"], NOISE, plan, x0, T, sc, n_runs=R, seed=7, dtype=jnp.float64,
        algorithm=algorithm, **jkw)
    tout, trows = trunner.run_experiment_batch(
        t["p"], interop.noise_params_from_reference(NOISE), plan, x0, T, sc, n_runs=R,
        dtype=torch.float64, algorithm=algorithm, noise_draws=draws_runs(7, T, R), device=DEV,
        **tkw)
    jrec = jout["record"] if isinstance(jout["record"], dict) else jout["record"]._asdict()
    keys = ["start_pos", "noisy_pos", "J", "iterations", "collided"]
    assert set(keys) <= set(tout["record"]) <= set(jrec)
    same_records(tout["record"], jrec, keys + (["uncertainty_max"] if full_stack else []))
    np.testing.assert_allclose(tout["final_states"], jout["final_states"], rtol=0, atol=1e-6)
    same_rows(trows, jrows)
    if full_stack and algorithm == "cilqr":
        assert float(tout["record"]["uncertainty_max"].max()) > 0.0


def test_run_algorithm_comparison_feeds_every_algorithm_the_same_noise(world):
    _, t, sc, plan, x0 = world
    noise = interop.noise_params_from_reference(NOISE)
    g = torch.Generator().manual_seed(3)
    results, rows = trunner.run_algorithm_comparison(
        t["p"], noise, plan, x0, T, sc, n_runs=2, dtype=torch.float64, generator=g, device=DEV)
    assert list(results) == list(trunner.ALGORITHMS) and len(rows) == 2 * len(results)
    a, b = (results[k][0]["record"]["noisy_pos"] - results[k][0]["record"]["start_pos"]
            for k in ("cilqr", "cilqr_base"))
    assert torch.equal(a, b)  # without a map the two algorithms are one
    block = torch.randn((T, 2, 3), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float64)
    out, _ = trunner.run_experiment_batch(t["p"], noise, plan, x0, T, sc, n_runs=2,
                                          dtype=torch.float64, noise_draws=block, device=DEV)
    assert torch.equal(out["record"]["noisy_pos"], results["cilqr"][0]["record"]["noisy_pos"])


@pytest.mark.parametrize("full_stack", [False, True], ids=["blind", "full-stack"])
def test_run_experiment_matches_jax(world, full_stack, tmp_path):
    """The wall-clock loop's records without the times; the port's log holds
    them."""
    j, t, sc, plan, x0 = world
    jkw = tkw = {}
    if full_stack:
        jkw = dict(costmap_params=j["cp"], global_map=j["gm"], global_geom=j["gg"])
        tkw = dict(costmap_params=t["cp"], global_map=t["gm"], global_geom=t["gg"])
    want = jrunner.run_experiment(j["p"], NOISE, plan, x0, T, scenario=sc, seed=5,
                                  dtype=jnp.float64, **jkw)
    with texplog.ExperimentLog(tmp_path / "e.log", "w") as log:
        got = trunner.run_experiment(t["p"], interop.noise_params_from_reference(NOISE), plan, x0,
                                     T, scenario=sc, dtype=torch.float64, log=log,
                                     noise_draws=draws_cycles(5, T), device=DEV, **tkw)
    times = {"start_time", "planning_time", "costmap_time"}
    assert set(got) == set(want)
    same_records(got, want, sorted(set(want) - times) + ["X", "U"])
    assert (got["planning_time"] > 0).all() and got["planning_time"].shape == (T,)
    assert ("costmap_time" in got) == full_stack
    data = texplog.read_experiment_log(str(tmp_path / "e.log"))
    np.testing.assert_array_equal(data["start_pos"], got["start_pos"])
    np.testing.assert_array_equal(data["planning_time"], got["planning_time"])


# ------------------------------------------------------------- the sweep
def test_sweep_helpers_match_jax():
    """tests/test_sigma_sweep.py's closed-form OBB clearance and the
    all-inf contract, then every helper against JAX on given records."""
    ang = np.deg2rad(30.0)
    c, s = np.cos(ang), np.sin(ang)
    rot = tsc.Scenario("rotwall", np.zeros((0, 3)), wall_size=(50.0, 0.4),
                       walls_xyyaw=np.asarray([[-2.2 * -s, -2.2 * c, ang], [2.2 * -s, 2.2 * c, ang]]))
    pos = np.array([10.0 * c + 0.5 * -s, 10.0 * s + 0.5 * c])
    rec = {"start_pos": t64([[[pos[0], pos[1], 4.0, ang]]])}
    np.testing.assert_allclose(tsweep.wall_clearance(rec, rot, ego_width=2.0), [0.5], atol=1e-9)
    assert tsweep.wall_clearance(rec, tsc.get_scenario("compare"), 2.0) is None

    nan_row = {"sigma_xy": 0.1, "algorithm": "cilqr", "collision_runs": 0,
               "min_wall_clearance": float("nan"), "mean_min_wall_clearance": float("nan")}
    txt = tsweep.rows_to_json([nan_row])
    assert "NaN" not in txt and json.loads(txt)[0]["min_wall_clearance"] is None
    assert txt == jsweep.rows_to_json([nan_row])
    assert tsweep.format_table([nan_row]) == jsweep.format_table([nan_row])

    sc = jsc.make_gauntlet()
    p_j = SolverParams()
    p = interop.solver_params_from_reference(p_j)
    rng = np.random.default_rng(5)
    runs, cyc = 6, 40
    sp = np.zeros((runs, cyc, 4))
    sp[..., 0] = np.linspace(60.0, 160.0, cyc) + rng.normal(0, 0.1, (runs, cyc))
    sp[..., 1] = -306.74 + rng.normal(0, 1.2, (runs, cyc))
    sp[..., 2] = 4.0 + rng.normal(0, 0.2, (runs, cyc))
    sp[2, :, 0] = 30.0  # a run never alongside a wall
    collided = rng.random((runs, cyc)) < 0.05
    collided[1] = False
    jrec = {"start_pos": jnp.asarray(sp), "collided": jnp.asarray(collided)}
    trec = {"start_pos": t64(sp), "collided": torch.tensor(collided)}
    np.testing.assert_allclose(tsweep.wall_clearance(trec, sc, p.width, p.length),
                               jsweep.wall_clearance(jrec, sc, p_j.width, p_j.length), rtol=REL)
    rows_t = [tsweep.summarize_cell(trec, sc, p, a, 0.25, 0.25 * 0.1, runs)
              for a in ("cilqr", "cilqr_base")]
    rows_j = [jsweep.summarize_cell(jrec, sc, p_j, a, 0.25, 0.25 * 0.1, runs)
              for a in ("cilqr", "cilqr_base")]
    same_rows(rows_t, rows_j)
    assert tsweep.rows_to_json(rows_t) == jsweep.rows_to_json(rows_j)
    assert tsweep.format_table(rows_t) == jsweep.format_table(rows_j)
    for a, b in (("1100101", "0110100"), ("000", "000"), ("1111111111", "0000000001")):
        ra, rb = {"collided_mask": a}, {"collided_mask": b}
        assert tsweep.paired_sign_test(ra, rb) == jsweep.paired_sign_test(ra, rb)
    with pytest.raises(ValueError, match="different run counts"):
        tsweep.paired_sign_test({"collided_mask": "10"}, {"collided_mask": "1"})
    cp_j = CostmapParams()
    for s in (0.0, 0.2, 0.5):
        got = tsweep.matched_costmap_params(interop.costmap_params_from_reference(cp_j), s, s * 0.1)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jsweep.matched_costmap_params(cp_j, s, s * 0.1))
    assert tsweep.SWEEP_ALGORITHMS == jsweep.SWEEP_ALGORITHMS
    assert tsweep.MAP_CONSUMERS == jsweep.MAP_CONSUMERS


def test_run_sigma_sweep_matches_jax(world, monkeypatch):
    """2 sigmas x the six sweep algorithms x 2 runs x 3 cycles; the port on
    its oracle route and on its kernel route (the plain versions here: the
    resample, the banded propagation over the sweep's band plan, K3's, K2's
    and K1's plain versions).  The rows are held before ``summarize_cell``
    rounds them: a mean that lies on a rounding tie (nrb_rrt's speed at
    sigma 0.2 is 3.9625 within 4e-16 in both packages) would otherwise
    round apart on its last bit."""
    for mod in (jsweep, tsweep):
        monkeypatch.setattr(mod, "round", lambda x, ndigits=None: x, raising=False)
    j, t, sc, _, _ = world
    sigmas, runs = [0.0, 0.2], 2
    want = jsweep.run_sigma_sweep(sigmas, jsweep.SWEEP_ALGORITHMS, scenario=sc, p=j["p"],
                                  cp=j["cp"], global_map=j["gm"], global_geom=j["gg"],
                                  n_runs=runs, n_cycles=T, seed=4, use_pallas=False,
                                  dtype=jnp.float64)
    draws = draws_runs(4, T, runs)
    for use_kernels in (False, True):
        got = tsweep.run_sigma_sweep(sigmas, scenario=sc, p=t["p"],
                                     cp=t["cp"], global_map=t["gm"], global_geom=t["gg"],
                                     n_runs=runs, n_cycles=T, dtype=torch.float64,
                                     use_kernels=use_kernels, noise_draws=draws, device=DEV)
        same_rows(got, want)
    assert [r["algorithm"] for r in got] == list(tsweep.SWEEP_ALGORITHMS) * 2
