"""The Frenet lattice planner as a closed-loop campaign on the port's graphed
path (``models/frenet.run_steps``, ``sim/plant.closed_loop_full_stack_batched``
with the plan step of ``sim/runner.make_plan_step("frenet_propagation")``).

Each planning cycle is one ``solver.run`` stage (a CUDA graph on the card)
between the world's graph and the advance's, and no cycle reads the card.
Here, on the CPU, in float64 on seeded random worlds: ``plan_steps`` in
propagation mode against the benchmark's plain reference
(``benchmarks/reference/frenet.py``) at B=8 on the full lattice, with one
map per lane and one shared map; the swapped full-stack loop with its
stages replayed eagerly under a four-stream planner equal to ``solver.GRAPHS
= False`` bit for bit, its records finite and the plant stepped on the
planner's controls; the stage's key; the span and the counters.  The
``cuda`` test holds the graphed loop to the eager one on the card, bit for
bit, with the feasible count equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.reference import cilqr as ref
from benchmarks.reference import frenet as ref_fr
from cilqr_tpu_torch.models import dynamics, frenet, solver
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.models.obstacles import make_static_obstacles
from cilqr_tpu_torch.models.reference_path import pad_global_plan
from cilqr_tpu_torch.ops import gridmap
from cilqr_tpu_torch.sim import plant, runner
from cilqr_tpu_torch.utils import profiling
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams
from tests import test_torch_graph_ops as ops
from tests.test_torch_graph_ops import replays  # noqa: F401  (the fixture)

DEV = "cpu"  # the port allocates on the card unless told otherwise
ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmarks" / "configs" / "frenet_propagation_town02_n40.json")
                    .read_text())
TIE = 1e-9  # float64: the two sides round apart by ~1e-15


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float64, device=DEV)


def random_world(seed: int, B: int, shared: bool) -> dict:
    """The deployment's solver and lattice on a gently curving route, one or
    two obstacles near it, B egos around it, and smooth occupancy maps (a
    few Gaussian blobs up to 100) on 152x104 grids at 0.2 m: one per lane
    in its own frame, or one shared."""
    rng = np.random.default_rng(seed)
    p = dataclasses.replace(SolverParams(), **CONFIG["solver"])
    pr = ref.Params.from_config(CONFIG["solver"])
    s = np.arange(0.0, 150.0, 1.0)
    route = np.stack([60.0 + s, -306.74 + 1.5 * np.sin(0.02 * s + rng.uniform(0, 3))], axis=1)
    M = int(rng.integers(1, 3))
    xs = rng.uniform(85.0, 110.0, M)
    obs = np.stack([xs, np.interp(xs, route[:, 0], route[:, 1]) + rng.uniform(-1.0, 1.0, M),
                    rng.uniform(-0.2, 0.2, M), np.full(M, 3.63), np.full(M, 1.84), np.zeros(M)],
                   axis=1)
    ex = rng.uniform(70.0, 100.0, B)
    egos = np.stack([ex, np.interp(ex, route[:, 0], route[:, 1]) + rng.normal(0, 0.5, B),
                     rng.uniform(2.0, 7.0, B), rng.normal(0, 0.05, B)], axis=1)
    rows, cols, res = CONFIG["costmap"]["rows"], CONFIG["costmap"]["cols"], 0.2
    n_maps = 1 if shared else B
    xs_c = (rows * res / 2 - res / 2) - res * np.arange(rows)
    ys_c = (cols * res / 2 - res / 2) - res * np.arange(cols)
    values = np.zeros((n_maps, rows, cols))
    for k in range(n_maps):
        for _ in range(4):
            cx, cy = rng.uniform(-10, 25), rng.uniform(-8, 8)
            w = rng.uniform(0.5, 3.0)
            values[k] += rng.uniform(30, 100) * np.exp(
                -((xs_c[:, None] - cx) ** 2 + (ys_c[None, :] - cy) ** 2) / (2 * w * w))
    values = np.clip(values, 0.0, 100.0)
    center = rng.uniform([8.0, -1.0], [12.0, 1.0], (n_maps, 2))
    origin = egos[:n_maps, :2] + rng.normal(0, 0.3, (n_maps, 2))
    yaw = egos[:n_maps, 3] + rng.normal(0, 0.05, n_maps)
    plan, n = pad_global_plan(p, route, dtype=torch.float64, device=DEV)
    ob = make_static_obstacles(p, obs[:, :2], obs[:, 3:5], obs[:, 2], dtype=torch.float64,
                               device=DEV)
    if shared:
        um = unc_mod.make_uncertainty_map(values[0], center[0], res, origin[0], yaw[0],
                                          dtype=torch.float64, device=DEV)
    else:
        geom = gridmap.GridGeom(t64(center), t64(np.full(B, res)),
                                t64([rows * res, cols * res]).expand(B, 2))
        um = unc_mod.UncertaintyMap(t64(values), geom, t64(origin), t64(yaw))
    lane = lambda a: t64(a).expand(B, *np.shape(a)[1:]) if shared else t64(a)
    maps = ref_fr.Maps(lane(values), lane(center), res, lane(origin), lane(yaw).reshape(B))
    return dict(p=p, pr=pr, route=t64(route), plan=plan, n=n, obs=t64(obs), ob=ob, um=um,
                maps=maps, egos=t64(egos), kappa=frenet.curvature_bound(p, torch.float64, DEV))


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane_maps", "shared_map"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_steps_equal_the_reference(seed, shared):
    """B=8 on the full lattice in float64: where the reference's two best
    feasible costs differ by more than 1e-9 relative, the same candidate;
    none feasible on both sides alike (the brake); the X of the program's
    candidate within 1e-9 of the reference's X of that candidate (its brake
    where none is feasible), the controls likewise; the program's J the
    reference's J of its candidate."""
    w = random_world(seed, 8, shared)
    fp = frenet.FrenetParams(**CONFIG["frenet"])
    got = frenet.plan_steps(w["p"], fp, w["plan"], w["n"], w["egos"], w["ob"], w["um"],
                            kappa_max=w["kappa"])
    want = ref_fr.cycle(w["pr"], ref_fr.Lattice.from_config(CONFIG["frenet"]), w["route"],
                        w["obs"], w["egos"], w["maps"])
    ok = got.lamb > 0
    assert torch.equal(ok, want.best >= 0)
    feasible = want.slack <= 0
    assert 0 < int(feasible.sum()) < feasible.numel()  # the rules bind
    rows = torch.arange(8)
    k = got.iterations.long()
    for i in range(8):
        J = want.J[i][feasible[i]].sort().values
        if len(J) > 1 and float(J[1] - J[0]) > TIE * abs(float(J[0])):
            assert int(k[i]) == int(want.best[i]), i
    X = torch.where(ok[:, None, None], want.X_all[rows, k], want.X)
    assert float((got.X - X).abs().max()) < TIE
    assert float((got.U - ref_fr.controls(w["pr"], X)).abs().max()) < TIE
    J = want.J[rows, k]
    assert float(((got.J - J).abs() / J.abs().clamp(min=1.0))[ok].max()) < TIE


def test_the_map_shapes_the_choice():
    """Propagation mode on the random worlds' maps picks other candidates
    than origin mode (the same lattice without the map) on some lanes, and
    the reference agrees lane for lane."""
    moved = 0
    for seed in range(2):
        w = random_world(seed, 8, shared=False)
        fp = frenet.FrenetParams(**CONFIG["frenet"])
        picks = {m: frenet.plan_steps(w["p"], dataclasses.replace(fp, mode=m), w["plan"], w["n"],
                                      w["egos"], w["ob"], w["um"],
                                      kappa_max=w["kappa"]).iterations
                 for m in ("propagation", "origin")}
        lat = ref_fr.Lattice.from_config(CONFIG["frenet"])
        best = {m: ref_fr.cycle(w["pr"], lat._replace(mode=m), w["route"], w["obs"], w["egos"],
                                w["maps"]).best for m in ("propagation", "origin")}
        moved += int((picks["propagation"] != picks["origin"]).sum())
        assert torch.equal(picks["propagation"] != picks["origin"],
                           best["propagation"] != best["origin"])
    assert moved > 0


def small(B: int, seed: int) -> dict:
    """The graph tests' small world (N=10, a 64x48 costmap over a 40x40
    global map), its egos 12 m further from the obstacle (at 3 m it
    blocks every candidate), for the Frenet plan step."""
    w = ops.world(torch.float32, B, seed=seed)
    w["egos"] = w["egos"] - torch.tensor([12.0, 0.0, 0.0, 0.0])
    noise = NoiseParams(0.05, 0.04, 0.005)
    w["noise"] = noise
    w["draws"] = ops.t(np.random.default_rng(seed + 1).normal(size=(3, B, 3)), torch.float32)
    return w


@contextlib.contextmanager
def recorded_plans():
    """Inside: every ``frenet.run_steps`` call's (egos, result)."""
    calls, run_steps = [], frenet.run_steps

    def wrapped(p, fp, plan_xy, plan_n, egos, *rest, **kw):
        res = run_steps(p, fp, plan_xy, plan_n, egos, *rest, **kw)
        calls.append((egos, res))
        return res

    frenet.run_steps = wrapped
    try:
        yield calls
    finally:
        frenet.run_steps = run_steps


def full_stack(w: dict, x0s, cycles: int = 3):
    step = runner.make_plan_step("frenet_propagation", w["p"], w["noise"], w["plan"], w["n"],
                                 w["obstacles"])
    with recorded_plans() as calls:
        out = plant.closed_loop_full_stack_batched(
            w["p"], w["cp"], w["noise"], w["gm"], w["gg"], w["plan"], w["n"], x0s, None, cycles,
            w["obstacles"], *w["obs"], global_res=1.0, noise_draws=w["draws"][:cycles],
            plan_step_batched=step)
    return out, [c[1] for c in calls]


def test_swapped_full_stack_loop_gives_the_eager_bits(replays, monkeypatch):
    """B=4 x 3 cycles: the loop with the Frenet plan step, its stages
    replayed eagerly under a four-stream planner, equal bit for bit to
    ``solver.GRAPHS = False`` on every record and every plan; three
    captures (the world, the lattice, the advance), three replays a cycle;
    the records finite; each cycle's plan the planner's on the noisy pose,
    and the next true state the plant's step on its first control; a
    second call on new starts replays without a capture."""
    w = small(4, 60)
    for k in range(2):
        x0s = w["egos"] + 0.2 * k
        got, want = ops.graphed_and_eager(lambda: full_stack(w, x0s), monkeypatch)
        assert ops.same(got, want), k
    assert ops.PlannedReplays.captures == 3
    assert len(ops.PlannedReplays.planners) == 2 * 3 * 3
    (final, rec), plans = got
    assert all(bool(torch.isfinite(v.float()).all()) for v in rec.values())
    for c, res in enumerate(plans):
        assert torch.equal(rec["iterations"][c], res.iterations)
        assert torch.equal(rec["J"][c], res.J)
        nxt = rec["start_pos"][c + 1] if c + 1 < 3 else final
        assert torch.equal(nxt, dynamics.step(w["p"], rec["start_pos"][c], res.U[:, 0]))


def test_stage_key_is_stable_and_distinct_per_mode():
    """The lattice's stage keys a capture by its module-level function, the
    parameters (the mode with them) and the shapes: two calls on new egos
    share the key, each mode has its own, and so does another batch."""
    w = small(4, 61)
    p = w["p"]
    kappa = frenet.curvature_bound(p, torch.float32, DEV)

    def key(mode, egos):
        fp = frenet.FrenetParams(mode=mode)
        st = frenet.stage(p, fp, w["plan"], w["n"], egos, w["obstacles"],
                          w["unc"] if mode == "propagation" else None,
                          torch.tensor([0.1, 0.1, 0.01]), kappa)
        assert st.fn is frenet._stage and hash(fp) == hash(frenet.FrenetParams(mode=mode))
        return solver._key(p, *solver._stage_args(st))

    first = key("propagation", w["egos"])
    assert key("propagation", w["egos"] + 1.0) == first
    keys = {key(m, w["egos"]) for m in frenet.MODES}
    assert len(keys) == 3
    assert key("propagation", w["egos"][:3]) != first


def test_spans_of_the_staged_loop(replays):
    """Under tracing, the loop's stages staged: one ``frenet.plan`` span a
    cycle, holding the stage's copy in, replay and copy out; after the
    cycles the host's wait for the counters kept on the card, before the
    records; ``PLANS`` and ``CANDIDATES`` counted on the host."""
    w = small(4, 62)
    with profiling.tracing():
        full_stack(w, w["egos"])
    found = profiling.spans()
    (entry,) = [s for s in found if s.parent is None]
    assert [s.name for s in found if s.parent == entry.id] == (
        ["full_stack.cycle"] * 3 + ["full_stack.counters", "full_stack.records"])
    plans = [s for s in found if s.name == "frenet.plan"]
    assert len(plans) == 3
    for s in plans:
        assert [c.name for c in found if c.parent == s.id] == ["run.copy_in", "run.replay",
                                                              "run.copy_out"]
    assert next(s for s in found if s.name == "full_stack.counters").wait
    c = profiling.counters()
    assert c["frenet.PLANS"] == 3
    assert c["frenet.CANDIDATES"] == 3 * 4 * frenet.FrenetParams().n_candidates


def test_feasible_count_is_the_masks_sum(monkeypatch):
    """``FEASIBLE`` over a traced call (the loop run eagerly, as on the CPU:
    the total is a CPU tensor) equals the sum of the lattice's per-lane
    feasible counts, read once, at the host's wait after the cycles; a
    warm-up (``graphs.building``) counts nothing."""
    from cilqr_tpu_torch.utils import graphs

    w = small(4, 62)
    masks, count = [], frenet._FEASIBLE.add

    def spy(feasible):
        masks.append(feasible.clone())
        count(feasible)

    monkeypatch.setattr(frenet._FEASIBLE, "add", spy)
    with profiling.tracing():
        full_stack(w, w["egos"])
    total = int(frenet._FEASIBLE.totals[torch.device(DEV)])
    with graphs.building():
        full_stack(w, w["egos"], 1)
    assert len(masks) == 3 + 1
    assert profiling.counters()["frenet.FEASIBLE"] == sum(int(m.sum()) for m in masks[:3]) > 0
    assert int(frenet._FEASIBLE.totals[torch.device(DEV)]) == total
    assert (frenet._FEASIBLE.start, frenet._FEASIBLE.read) in profiling.DEVICE_COUNTERS


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_graphed_lattice_equals_eager_on_the_card(monkeypatch):
    """The swapped full-stack loop at B=64 x 2 cycles on the card in
    float32: graphed (three graphs a cycle) equal to ``solver.GRAPHS =
    False`` bit for bit on every record and plan, the feasible pairs
    counted alike."""
    from cilqr_tpu_torch.utils import graphs

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    w = small(64, 63)
    w = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in w.items()}
    moved = lambda tree: type(tree)(*(x.to(dev) for x in tree))
    w["obstacles"], w["gg"] = moved(w["obstacles"]), moved(w["gg"])
    w["unc"] = unc_mod.UncertaintyMap(w["unc"].values.to(dev), moved(w["unc"].geom),
                                      w["unc"].origin_xy.to(dev), w["unc"].origin_yaw.to(dev))
    w["obs"] = tuple(x.to(dev) for x in w["obs"])
    out, feasible = {}, {}
    for graphed in (True, False):
        monkeypatch.setattr(solver, "GRAPHS", graphed)
        with profiling.tracing():
            out[graphed] = full_stack(w, w["egos"], 2)
        torch.cuda.synchronize()
        feasible[graphed] = profiling.counters()["frenet.FEASIBLE"]
    assert ops.same(out[True], out[False])
    assert feasible[True] == feasible[False] > 0
    assert math.isfinite(float(out[True][0][0].sum()))
