"""The port's programs ``cilqr_tpu_torch.scripts.*`` vs the JAX package's.

``classify_failure_modes`` and ``nrb_budget_sensitivity`` are held to the
JAX scripts' own code: the JAX ``np_sat`` and classification loop are taken
from ``scripts/classify_failure_modes.py`` by its syntax tree (the script
runs its whole experiment when imported), the NRB table to the JAX script's
arithmetic over ``runner.run_experiment_batch``.  The closed loops run on
the small world of ``tests/test_torch_experiment.py`` in float64 with the
JAX key discipline reproduced to pre-draw the noise; the JAX functions run
with ``use_pallas=False``.  ``production_sweeps`` must call
``run_sigma_sweep`` as the CLI's ``sweep`` does with the published grids'
flags, and the committed noise block must be JAX's draw.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import nrb_rrt as jnrb
from cilqr_tpu.models import reference_path as jrp
from cilqr_tpu.ops import gridmap as jgrid
from cilqr_tpu.sim import runner as jrunner, scenarios as jsc, sweep as jsweep
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams
from cilqr_tpu_torch import __main__ as tmain
from cilqr_tpu_torch import scripts as tscripts
from cilqr_tpu_torch.scripts import classify_failure_modes as tcls
from cilqr_tpu_torch.scripts import nrb_budget_sensitivity as tnrb
from cilqr_tpu_torch.scripts import production_sweeps as tps
from cilqr_tpu_torch.sim import sweep as tsweep
from cilqr_tpu_torch.utils import interop

DEV = "cpu"  # the port allocates on the card unless told otherwise
REL = 1e-9
JAX_SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "classify_failure_modes.py"


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


def draws_runs(seed: int, T: int, R: int, dtype=jnp.float64) -> np.ndarray:
    """What the JAX batch and sweep draw: per run ``split(key(seed), R)[r]``,
    split into T cycle keys, ``normal(k, (3,))`` each -> (T, R, 3)."""
    out = np.zeros((T, R, 3), np.dtype(dtype))
    for r, k in enumerate(jax.random.split(jax.random.key(seed), R)):
        for t, kt in enumerate(jax.random.split(k, T)):
            out[t, r] = np.asarray(jax.random.normal(kt, (3,), dtype=dtype))
    return out


@pytest.fixture(scope="module")
def jax_classification():
    """(np_sat, the classification statements) of the JAX script: its
    ``np_sat`` definition, and the statements of its per-cell loop body from
    ``coll = ...`` to the counting loop (the ``fn`` call before them and the
    print after them left out)."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    ns = {"np": np}
    fdef = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "np_sat")
    exec(compile(ast.Module([fdef], []), str(JAX_SCRIPT), "exec"), ns)
    outer = next(n for n in tree.body if isinstance(n, ast.For))
    inner = next(n for n in outer.body if isinstance(n, ast.For))
    body = inner.body[2:-1]
    assert ast.unparse(body[0]).startswith("coll = ")
    assert isinstance(body[-1], ast.For)
    return ns["np_sat"], compile(ast.Module(body, []), str(JAX_SCRIPT), "exec")


def jax_classify(jax_classification, start_pos, collided, sc) -> tuple:
    """(collided, wall_hits, car_hits) by the JAX script's statements."""
    np_sat, code = jax_classification
    ns = dict(np=np, np_sat=np_sat, rec={"start_pos": start_pos, "collided": collided},
              cars=np.asarray(sc.obstacles_xyyaw, np.float64),
              car_L=float(sc.obstacle_size[0]), car_W=float(sc.obstacle_size[1]),
              walls=np.asarray(sc.walls_xyyaw, np.float64),
              wall_L=float(np.asarray(sc.wall_size)[0]), wall_W=float(np.asarray(sc.wall_size)[1]))
    exec(code, ns)
    return int(ns["coll"].sum()), int(ns["nw"]), int(ns["nc"])


# ------------------------------------------------------------ the noise block
def test_committed_noise_block_is_jax_draw():
    """The committed block is JAX's (160, 50) float32 draw of seed 0 (the
    vmapped keys the batched loops use), and its leading corner is JAX's
    draw at a smaller size, as ``jax_noise`` says."""
    ck = jax.vmap(lambda k: jax.random.split(k, 160))(jax.random.split(jax.random.key(0), 50))
    want = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (3,), dtype=jnp.float32)))(ck)
    block = np.load(tscripts.NOISE_FILE)
    assert block.dtype == np.float32 and block.shape == (160, 50, 3)
    assert np.array_equal(block, np.swapaxes(np.asarray(want), 0, 1))
    got = tscripts.jax_noise(7, 3, device=DEV)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), draws_runs(0, 7, 3, jnp.float32))
    with pytest.raises(ValueError, match="committed noise block"):
        tscripts.jax_noise(161, 50, device=DEV)


# ------------------------------------------------------------ classification
@pytest.mark.parametrize("case", ["touching", "separated", "rotated_overlap",
                                  "rotated_apart", "random"])
def test_np_sat_matches_jax(jax_classification, case):
    jsat = jax_classification[0]
    L, W = tcls.EGO_L, tcls.EGO_W
    pairs = {
        # the boxes share an edge, then a corner, then stand a hair apart
        "touching": [((0.0, 0.0, 0.0, L, W), (L, 0.0, 0.0, L, W)),
                     ((0.0, 0.0, 0.0, L, W), (L, W, 0.0, L, W)),
                     ((0.0, 0.0, 0.0, L, W), (0.0, W + 1e-9, 0.0, L, W))],
        "separated": [((0.0, 0.0, 0.0, L, W), (10.0, 0.0, 0.0, 4.0, 2.0)),
                      ((0.0, 0.0, 1.0, L, W), (0.0, -5.0, 0.3, 90.0, 0.4))],
        "rotated_overlap": [((0.0, 0.0, 0.7, L, W), (2.0, 1.0, -0.4, 4.0, 2.0)),
                            ((5.0, 1.2, 0.05, L, W), (50.0, 2.3, 0.0, 90.0, 0.4))],
        # a rotated box whose bounding boxes overlap but the boxes do not
        "rotated_apart": [((0.0, 0.0, np.pi / 4, L, W), (-1.598, 1.598, np.pi / 4, L, W)),
                          ((0.0, 0.0, 0.0, L, W), (3.2, 1.9, np.pi / 4, 2.0, 1.0))],
    }.get(case)
    if pairs is None:
        rng = np.random.default_rng(11)
        pairs = [(tuple(rng.uniform([-4, -4, -np.pi, 1, 0.5], [4, 4, np.pi, 6, 3])),
                  tuple(rng.uniform([-4, -4, -np.pi, 1, 0.2], [4, 4, np.pi, 90, 3])))
                 for _ in range(300)]
    got = [tcls.np_sat(a, b) for a, b in pairs]
    assert got == [jsat(a, b) for a, b in pairs]
    if case == "random":
        assert 0 < sum(got) < len(got)
    elif case in ("separated", "rotated_apart"):
        assert not any(got)
    elif case == "rotated_overlap":
        assert all(got)


def test_classify_matches_jax_logic(jax_classification):
    """Tracks that run through the gauntlet's walls and cars, sorted by the
    port and by the JAX script's statements: every run's wall and car hits."""
    sc = jsc.make_gauntlet()
    rng = np.random.default_rng(5)
    R, T = 12, 30
    targets = np.concatenate([np.asarray(sc.walls_xyyaw), np.asarray(sc.obstacles_xyyaw)])
    sp = np.zeros((R, T, 4))
    for r in range(R):
        a = np.asarray(sc.start, np.float64)
        b = targets[r % len(targets)] + rng.normal(0.0, [1.0, 0.6, 0.2])
        s = np.linspace(0.0, 1.0 + 0.3 * (r % 3), T)[:, None]
        sp[r, :, :2] = a[:2] + s * (b[:2] - a[:2])
        sp[r, :, 3] = rng.normal(0.0, 0.3, T)
    collided = (rng.uniform(size=(R, T)) < 0.1).astype(np.float32)
    collided[0] = 0.0
    got = tcls.classify(sp, collided, sc)
    assert got == jax_classify(jax_classification, sp, collided, sc)
    assert got[1] > 0 and got[2] > 0


@pytest.fixture(scope="module")
def small_world():
    """The small world of tests/test_torch_experiment.py (N=8 and a 40x32
    costmap here)."""
    p_j = dataclasses.replace(SolverParams(), horizon=8, max_iterations=3, num_of_local_wpts=8,
                              closest_point_samples_per_wpt=5)
    cp_j = dataclasses.replace(CostmapParams(), rows=40, cols=32, window_radius=3,
                               look_ahead_waypoints=10)
    rng = np.random.default_rng(31)
    gm = np.zeros((40, 40))
    gm[10:30, 12:20] = rng.uniform(20.0, 100.0, (20, 8))
    jgg = jgrid.make_geom([80.0, -300.0], 1.0, 40, 40, dtype=jnp.float64)
    return p_j, cp_j, gm, jgg


def test_classification_run_matches_jax(jax_classification, small_world, monkeypatch):
    """3 runs x 4 cycles in float64: the port's ``run`` against the JAX
    script's cell function (``sweep.make_cell_fn``) on the same draws: each
    cell's recorded poses at the bars of tests/test_torch_slice.py, its
    collisions equal, and its counts equal to the JAX script's statements'."""
    seen = []
    classify = tcls.classify
    monkeypatch.setattr(tcls, "classify", lambda sp, coll, sc: (
        seen.append((sp, coll)), classify(sp, coll, sc))[1])
    p_j, cp_j, gm, jgg = small_world
    R, T = 3, 4
    sc = jsc.make_gauntlet()
    cp_max = jsweep.matched_costmap_params(cp_j, 0.5, 0.5 * tcls.RATIO)
    want = []
    for tag, w_unc in tcls.WEIGHTS:
        p = dataclasses.replace(p_j, w_uncertainty=w_unc)
        planj, n = jrp.pad_global_plan(p, np.asarray(jsc.plan_for("compare")), dtype=jnp.float64)
        fn = jsweep.make_cell_fn("cilqr", p, cp_max, sc, planj, n, np.array(sc.start), T, R,
                                 jnp.asarray(gm), jgg, False, jnp.float64)
        for s in tcls.SIGMAS:
            _, rec = fn(jnp.asarray(s, jnp.float64), jnp.asarray(s * tcls.RATIO, jnp.float64),
                        jax.random.key(0))
            rec = {k: np.asarray(v) for k, v in (rec.items() if isinstance(rec, dict)
                                                  else rec._asdict().items())}
            want.append((rec["start_pos"], jax_classify(jax_classification, rec["start_pos"],
                                                        rec["collided"], sc)))
    got = tcls.run(R, T, dtype=torch.float64, device=DEV,
                   p=interop.solver_params_from_reference(p_j),
                   cp=interop.costmap_params_from_reference(cp_j), global_map=t64(gm),
                   global_geom=interop.grid_geom_from_numpy(jgg, dtype=torch.float64, device=DEV),
                   noise_draws=draws_runs(0, T, R))
    assert [(r["tag"], r["sigma"]) for r in got] == [
        (tag, s) for tag, _ in tcls.WEIGHTS for s in tcls.SIGMAS]
    assert len(seen) == len(want)
    for row, (sp, coll), (want_sp, counts) in zip(got, seen, want):
        np.testing.assert_allclose(sp, want_sp, rtol=0, atol=1e-6)
        assert (row["collided"], row["wall_hits"], row["car_hits"]) == counts
        assert tcls.line(row) == (f"cilqr {row['tag']} s={row['sigma']}: collided={counts[0]}/{R} "
                                  f"wall_hits={counts[1]} car_hits={counts[2]}")


# ------------------------------------------------------------ NRB budget
def test_nrb_table_matches_jax():
    """One budget x 2 runs x 4 cycles on success1, float64: the port's row
    against the JAX script's arithmetic over its ``run_experiment_batch``."""
    R, T, budget, name = 2, 4, 64, "success1"
    sc = jsc.get_scenario(name)
    _, jrows = jrunner.run_experiment_batch(
        SolverParams(), NoiseParams(), jsc.plan_for(name), np.array(sc.start), T, sc,
        n_runs=R, seed=0, dtype=jnp.float64, algorithm="nrb_rrt",
        nrb_params=dataclasses.replace(jnrb.NRBParams(), n_iters=budget))
    want = dict(scenario=name, n_iters=budget, n_runs=R,
                collision_runs=sum(1 for r in jrows if r["collisions"] > 0),
                min_obstacle_distance=min(r["distance_to_obstacles_min"] for r in jrows),
                velocity_mean=float(np.mean([r["velocity_mean"] for r in jrows])))
    (got,) = tnrb.rows((budget,), (name,), R, T, dtype=torch.float64, device=DEV,
                       noise_draws=draws_runs(0, T, R))
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=REL)
        else:
            assert got[k] == v, k
    assert tnrb.table_line(got) == (
        f"| {name} | {budget} | {want['collision_runs']}/{R} | "
        f"{want['min_obstacle_distance']:.3f} | {want['velocity_mean']:.3f} |")
    assert tnrb.HEADER.splitlines()[0] == (
        "| scenario | n_iters | collision_runs | min_obstacle_distance | velocity_mean |")


# ------------------------------------------------------------ production sweeps
CLI_FLAGS = {
    "r4_n50": [],
    "r5_refratio": ["--sigmas", "0.375,0.5", "--algorithms", "cilqr,cilqr_base"],
    "r5_theta02": ["--sigmas", "0.375,0.5", "--algorithms", "cilqr,cilqr_base",
                   "--sigma-theta-ratio", "0.2", "--free-prior"],
    "r5_rot25": ["--sigmas", "0.375,0.5", "--algorithms", "cilqr,cilqr_base",
                 "--sigma-theta-ratio", "0.2", "--rotate", "25"],
}


@pytest.mark.parametrize("grid", list(tps.GRIDS))
def test_production_grid_calls_sweep_as_the_cli(grid, monkeypatch, tmp_path):
    """``run_grid`` hands ``run_sigma_sweep`` what the CLI's ``sweep`` hands
    it with the published grid's flags, and the JAX noise block."""
    calls = []

    def recorder(sigmas, **kw):
        calls.append(dict(kw, sigmas=[float(s) for s in sigmas]))
        return [{"sigma_xy": 0.0, "algorithm": "cilqr"}]

    monkeypatch.setattr(tsweep, "run_sigma_sweep", recorder)
    monkeypatch.setattr(tsweep, "format_table", lambda rows: "")
    town = (torch.zeros((8, 8)), interop.grid_geom_from_numpy(
        jgrid.make_geom([0.0, 0.0], 1.0, 8, 8, dtype=jnp.float32), dtype=torch.float32,
        device=DEV))
    monkeypatch.setattr(tsweep, "synthetic_town_prior", lambda dtype, device: town)
    tps.run_grid(grid, 2, 4, device=DEV, town=town)
    tmain.main(["sweep", "--runs", "2", "--cycles", "4", "--device", DEV,
                "--out", str(tmp_path)] + CLI_FLAGS[grid])
    ours, cli = calls
    draws = ours.pop("noise_draws")
    assert np.array_equal(draws.numpy(), np.load(tscripts.NOISE_FILE)[:4, :2])
    assert ours.pop("dtype") == torch.float32
    assert cli.pop("seed") == 0
    if cli["global_map"] is None:  # run_sigma_sweep makes the town prior itself
        cli["global_map"], cli["global_geom"] = town
    assert cli.keys() == ours.keys()
    for k, v in ours.items():
        w = cli[k]
        if k == "global_map":
            assert torch.equal(v, w)
        elif k == "global_geom":
            assert all(torch.equal(a, b) for a, b in zip(v, w))
        elif k == "plan" and v is not None:
            assert np.array_equal(v, w)
        elif k in ("scenario", "device"):
            assert repr(v) == repr(w) or str(v) == str(w), k
        else:
            assert v == w, k
    assert ours["sigmas"] == list(tps.GRIDS[grid]["sigmas"])


def test_production_compare_counts_differing_worlds():
    rows = [{"sigma_xy": 0.5, "algorithm": "cilqr", "collision_runs": 3, "collided_mask": "10110"},
            {"sigma_xy": 0.5, "algorithm": "cilqr_base", "collision_runs": 0,
             "collided_mask": "00000"}]
    ref = [{"sigma_xy": 0.5, "algorithm": "cilqr_base", "collision_runs": 5,
            "collided_mask": "11111"},
           {"sigma_xy": 0.5, "algorithm": "cilqr", "collision_runs": 2, "collided_mask": "10010"}]
    got = tps.compare(rows, ref)
    assert [(c["jax"], c["port"], c["worlds"], c["within"]) for c in got] == [
        (2, 3, [2], True), (5, 0, [0, 1, 2, 3, 4], False)]
    table = tps.comparison_table("g", got).splitlines()
    assert table[2] == "| g | 0.5 | cilqr | 2 | 3 | 2 | within |"
    assert table[3].endswith("| 0 1 2 3 4 | OUTSIDE |")


def test_production_sweeps_command_line(monkeypatch, tmp_path, capsys):
    """``production_sweeps.main`` at the published size: each grid's rows
    written as ``sweep.json`` / ``sweep.md`` and compared with its JAX rows
    (here the JAX rows themselves stand in for a run: no world differs)."""
    ran = []

    def reference_rows(name, **kw):
        ran.append((name, kw["use_kernels"], kw["device"]))
        return json.loads((tps.ROOT / tps.GRIDS[name]["reference"]).read_text())

    monkeypatch.setattr(tps, "run_grid", reference_rows)
    assert tps.main(["--grids", "r5_refratio,r5_rot25", "--no-kernels", "--out", str(tmp_path),
                     "--device", DEV]) == 0
    assert ran == [("r5_refratio", False, DEV), ("r5_rot25", False, DEV)]
    out = capsys.readouterr().out
    for name in ("r5_refratio", "r5_rot25"):
        rows = json.loads((tmp_path / name / "sweep.json").read_text())
        assert rows == json.loads(tsweep.rows_to_json(reference_rows(name, use_kernels=False,
                                                                     device=DEV)))
        assert (tmp_path / name / "sweep.md").read_text() == tsweep.format_table(rows) + "\n"
        assert out.count(f"| {name} | ") == 4 and "OUTSIDE" not in out
    with pytest.raises(SystemExit):
        tps.main(["--runs", "2"])


def ordered_bits(a: np.ndarray) -> np.ndarray:
    """float32 values as integers in the order of the reals: neighbours in
    float32 are neighbours here (a difference of K is K ulps apart)."""
    i = a.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


@pytest.mark.parametrize("ulps", [0, 1, -2, 3])
def test_production_nudge_moves_every_draw_by_k_ulps(ulps, monkeypatch):
    """``run_grid(nudge_ulps=K)`` hands the sweep the committed block with
    every draw moved by exactly K float32 ulps (K=0: the block itself)."""
    seen = []
    monkeypatch.setattr(tsweep, "run_sigma_sweep",
                        lambda sigmas, **kw: seen.append(kw["noise_draws"]) or [])
    tps.run_grid("r5_theta02", 4, 6, device=DEV, nudge_ulps=ulps)
    block = np.load(tscripts.NOISE_FILE)[:6, :4]
    got = seen[0].numpy()
    assert got.dtype == np.float32 and got.shape == block.shape
    if ulps == 0:
        assert np.array_equal(got, block)
    assert np.array_equal(ordered_bits(got) - ordered_bits(block), np.full(block.shape, ulps))
    assert np.array_equal(tps.nudged(torch.tensor([1.0], dtype=torch.float64), -1).numpy(),
                          [np.nextafter(1.0, 0.0)])


def test_production_float64_cell_matches_jax(monkeypatch):
    """The float64 route, 5 runs x 20 cycles of the ``r5_theta02`` grid's
    `cilqr` at sigma 0.1 (a window of radius 12 where the grid's sigmas need
    35): the port's oracle costmap with K1 and K3 on their plain versions
    (``route.plain()``), fed JAX's float64 draws of seed 0, against the JAX
    package's ``run_sigma_sweep`` in float64 on its XLA path."""
    for mod in (jsweep, tsweep):
        monkeypatch.setattr(mod, "round", lambda x, ndigits=None: x, raising=False)
    R, T, sigma = 5, 20, 0.1
    draws = draws_runs(0, T, R)
    monkeypatch.setattr(tps, "jax_noise", lambda n_cycles, n_runs, dtype, device: (
        torch.as_tensor(draws[:n_cycles, :n_runs], dtype=dtype, device=device)))
    opened = []
    real_plain = tps.route.plain

    @tps.contextlib.contextmanager
    def recording_plain():
        with real_plain():
            opened.append(tps.route.plain_on_card())
            yield

    monkeypatch.setattr(tps.route, "plain", recording_plain)
    (got,) = tps.run_grid("r5_theta02", R, T, sigmas=(sigma,), algorithms=("cilqr",),
                          use_kernels=False, dtype=torch.float64, device=DEV)
    assert opened == [True] and not tps.route.plain_on_card()
    jp = dataclasses.replace(SolverParams(), horizon=40, w_uncertainty=5.0)
    (want,) = jsweep.run_sigma_sweep(
        [sigma], ["cilqr"], p=jp, global_map=jnp.zeros((512, 512), jnp.float64),
        global_geom=jgrid.make_geom([115.0, -285.0], 0.5, 512, 512, dtype=jnp.float64),
        n_runs=R, n_cycles=T, seed=0, sigma_theta_ratio=0.2, use_pallas=False, dtype=jnp.float64)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=REL, err_msg=k)
        else:
            assert got[k] == v, k
    with pytest.raises(ValueError, match="use_kernels=False"):
        tps.run_grid("r5_theta02", R, T, dtype=torch.float64, device="cuda")


def test_production_sweeps_subset_and_nudge_options(monkeypatch, tmp_path):
    """``--algorithms``, ``--sigmas``, ``--dtype`` and ``--nudge-ulps`` reach
    ``run_grid``; each run writes its comparison table; float64 on the card
    needs ``--no-kernels`` (``run_grid`` refuses it)."""
    ran = []

    def reference_rows(name, **kw):
        ran.append(kw)
        rows = json.loads((tps.ROOT / tps.GRIDS[name]["reference"]).read_text())
        return [r for r in rows if r["algorithm"] in kw["algorithms"]
                and r["sigma_xy"] in kw["sigmas"]]

    monkeypatch.setattr(tps, "run_grid", reference_rows)
    assert tps.main(["--grids", "r5_theta02", "--algorithms", "cilqr", "--sigmas", "0.5",
                     "--nudge-ulps", "-2", "--dtype", "float64", "--no-kernels",
                     "--device", DEV, "--out", str(tmp_path)]) == 0
    (kw,) = ran
    assert (kw["algorithms"], kw["sigmas"], kw["nudge_ulps"], kw["dtype"], kw["use_kernels"]) == (
        ("cilqr",), (0.5,), -2, torch.float64, False)
    table = (tmp_path / "r5_theta02" / "compare.md").read_text().splitlines()
    assert len(table) == 3 and table[2].startswith("| r5_theta02 | 0.5 | cilqr | 11 | 11 | - |")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="use_kernels=False"):
        tps.main(["--grids", "r5_theta02", "--dtype", "float64", "--device", "cuda"])


def test_production_theta02_bar_is_its_measured_nudge_spread():
    """Only ``r5_theta02`` carries a bar of its own: the JAX paths' 4 plus
    the largest spread of its aware cells' counts over the committed kernel
    route runs (the published noise and the block nudged by -2, -1, +1, +2
    ulps); ``compare`` and the table take it."""
    assert {n: g.get("spread") for n, g in tps.GRIDS.items()} == {
        "r4_n50": None, "r5_refratio": None, "r5_theta02": 7, "r5_rot25": None}
    docs = tps.ROOT / "docs" / "sweep_torch_h100"
    runs = [docs / "r5_theta02"] + [docs / "r5_theta02_diag" / f"r5_theta02_nudge_{k}"
                                     for k in (-2, -1, 1, 2)]
    counts: dict = {}
    for run in runs:
        for r in json.loads((run / "sweep.json").read_text()):
            if r["algorithm"] == "cilqr":
                counts.setdefault(r["sigma_xy"], []).append(r["collision_runs"])
    assert sorted(counts) == [0.375, 0.5] and all(len(c) == 5 for c in counts.values())
    spread = max(max(c) - min(c) for c in counts.values())
    assert tps.GRIDS["r5_theta02"]["spread"] == tps.SPREAD + spread
    rows = [{"sigma_xy": 0.5, "algorithm": "cilqr", "collision_runs": 17, "collided_mask": "1"}]
    ref = [{"sigma_xy": 0.5, "algorithm": "cilqr", "collision_runs": 11, "collided_mask": "0"}]
    assert [c["within"] for c in tps.compare(rows, ref)] == [False]
    cells = tps.compare(rows, ref, spread=7)
    assert [c["within"] for c in cells] == [True]
    assert "| within 7 of 50 |" in tps.comparison_table("r5_theta02", cells, 7).splitlines()[0]
