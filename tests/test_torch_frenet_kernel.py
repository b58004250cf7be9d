"""The Frenet lattice as one CUDA kernel (``cilqr_tpu_torch/ops/frenet_cuda.py``,
op ``cilqr_torch::frenet_lattice``, kernel ``csrc/frenet.cu``; its plain
version ``models/frenet.lattice_plain``).

Here, on the CPU, in each of the three modes with one map per lane and one
shared map: the op's CPU implementation equal, bit for bit, to the plain
version; ``opcheck`` and the fake's shapes and dtypes; ``plan_steps``
reaching the op once a call.  Then the kernel's entry point called only
inside the op, the ctypes mirror of its config, the launch function's
refusals, the bound model, and the band of feasible counts that the card's
checks hold the kernel to (``chip_smoke.hold_lattice``).  The ``cuda`` tests
hold the kernel to its plain version on the card, cycle by cycle, at B=256
on the benchmark cell's world and on its 5 m lane (where the map's
threshold binds), in each mode with each map form, find no tensor of the
lattice's (B, K, N+1) size formed by ``plan_steps``, and count one launch
per ``run_steps`` call, graphed and eager.
"""

from __future__ import annotations

import dataclasses
import json
import re

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import chip_smoke
from cilqr_tpu_torch.models import frenet, solver
from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.ops import frenet_cuda, gridmap, riccati_cuda, route
from cilqr_tpu_torch.utils import graphs, roofline
from tests.test_torch_frenet_campaign import CONFIG, random_world
from tests.test_torch_graph_loops import PORT, calls_by_function
from tests.test_torch_graph_ops import Recorder

DEV = "cpu"  # the port allocates on the card unless told otherwise
CASES = [(m, shared) for m in frenet.MODES for shared in (False, True)]
IDS = [f"{m}-{'shared_map' if shared else 'per_lane_maps'}" for m, shared in CASES]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as32(tree):
    """Every floating tensor of a nest of tensors and named tuples in float32."""
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        return type(tree)(*(as32(t) for t in tree))
    return tree


def case(mode: str, shared: bool, seed: int = 3, B: int = 6):
    """(p, fp, the lattice's arguments after (p, fp)) on a random world of
    the benchmark's deployment in float32."""
    w = random_world(seed, B, shared)
    p = w["p"]
    fp = dataclasses.replace(frenet.FrenetParams(**CONFIG["frenet"]), mode=mode)
    egos = w["egos"].float()
    plan = rp.get_local_plan(p, w["plan"].float(), w["n"], egos)
    args = frenet.lattice_inputs(p, fp, plan, egos, as32(w["ob"]), as32(w["um"]),
                                 torch.tensor([0.1, 0.12, 0.01]),
                                 kappa_max=frenet.curvature_bound(p, torch.float32, DEV))
    return p, fp, args


def op_args(p, fp, args) -> tuple:
    start, ref, axes, kappa, obs, umap = args
    return (riccati_cuda.params_arg(p), frenet_cuda.frenet_arg(fp), start, list(ref), list(axes),
            kappa, list(obs), list(umap))


@pytest.mark.parametrize("mode, shared", CASES, ids=IDS)
def test_the_op_is_the_plain_version_on_the_cpu(mode, shared):
    """The op's CPU implementation returns the plain version's outputs bit
    for bit: the winner's trajectory, its index (int32), its cost, any
    feasible (bool), the feasible count (int32); the map is read in
    propagation mode alone."""
    p, fp, args = case(mode, shared)
    got = torch.ops.cilqr_torch.frenet_lattice(*op_args(p, fp, args))
    want = frenet.lattice_plain(p, fp, *args)
    assert [(t.dtype, tuple(t.shape)) for t in got] == [
        (torch.float32, (6, 41, 4)), (torch.int32, (6,)), (torch.float32, (6,)),
        (torch.bool, (6,)), (torch.int32, (6,))]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(args[5]) == (mode == "propagation")
    assert 0 < int(got[4].sum()) < 6 * fp.n_candidates  # the rules bind


@pytest.mark.parametrize("mode, shared", CASES, ids=IDS)
def test_the_fake_gives_the_shapes(mode, shared):
    """``torch.library.opcheck`` on the op (schema, fake, dispatch), and
    under a fake mode its outputs' shapes and dtypes are the real ones."""
    p, fp, args = case(mode, shared, B=3)
    real = torch.ops.cilqr_torch.frenet_lattice(*op_args(p, fp, args))
    torch.library.opcheck(torch.ops.cilqr_torch.frenet_lattice.default, op_args(p, fp, args),
                          test_utils=("test_schema", "test_faketensor"))
    with FakeTensorMode(allow_non_fake_inputs=True) as m:
        fake = lambda t: m.from_tensor(t)
        a = op_args(p, fp, args)
        got = torch.ops.cilqr_torch.frenet_lattice(
            a[0], a[1], fake(a[2]), [fake(t) for t in a[3]], [fake(t) for t in a[4]],
            fake(a[5]), [fake(t) for t in a[6]], [fake(t) for t in a[7]])
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in real]


@pytest.mark.parametrize("mode, shared", CASES, ids=IDS)
def test_plan_steps_reaches_the_op_once(mode, shared):
    """``plan_steps`` evaluates and chooses through the op, once a call,
    and its result is the op's (the winner's index, cost and whether any
    candidate was feasible; the trajectory where one was), whose per-lane
    counts it adds to ``FEASIBLE``'s total."""
    w = random_world(4, 5, shared)
    fp = dataclasses.replace(frenet.FrenetParams(**CONFIG["frenet"]), mode=mode)
    kappa = frenet.curvature_bound(w["p"], torch.float64, DEV)
    sig = torch.tensor([0.1, 0.12, 0.01], dtype=torch.float64)
    total = frenet._FEASIBLE.total(torch.device(DEV))
    before = int(total)
    with Recorder() as rec:
        res = frenet.plan_steps(w["p"], fp, w["plan"], w["n"], w["egos"], w["ob"], w["um"], sig,
                                kappa_max=kappa)
    assert rec.names.count("cilqr_torch::frenet_lattice") == 1
    plan = rp.get_local_plan(w["p"], w["plan"], w["n"], w["egos"])
    X, best, J, ok, n = frenet.lattice_plain(w["p"], fp, *frenet.lattice_inputs(
        w["p"], fp, plan, w["egos"], w["ob"], w["um"], sig, kappa_max=kappa))
    assert torch.equal(res.iterations, best) and torch.equal(res.J, J)
    assert torch.equal(res.lamb > 0, ok) and torch.equal(res.X[ok], X[ok])
    assert int(total) - before == int(n.sum())


def test_the_kernel_launches_only_inside_its_op():
    """By the source: the entry point ``lib.cilqr_frenet_lattice`` is
    called once, in the op's CUDA implementation; the op from ``_op``
    alone, which the launch function and the CPU route call; the launch
    function from ``lattice`` alone, which ``plan_steps`` calls; no other
    file of the port, nor ``chip_smoke.py``, names the entry point or the
    op's implementation or calls the launch function."""
    calls = calls_by_function(PORT / "ops" / "frenet_cuda.py")
    assert calls["lib.cilqr_frenet_lattice"] == ["_lattice_kernel"]
    assert calls["torch.ops.cilqr_torch.frenet_lattice"] == ["_op"]
    assert sorted(calls["_op"]) == ["_launch", "lattice"]
    assert calls["_launch"] == ["lattice"]
    for f in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]:
        if f.name == "frenet_cuda.py":
            continue
        text = f.read_text()
        assert not re.search(r"\b_lattice_kernel\b|cilqr_frenet_lattice\(", text), f
        assert "frenet_cuda._launch" not in calls_by_function(f), f
    assert calls_by_function(PORT / "models" / "frenet.py")["frenet_cuda.lattice"] == [
        "plan_steps"]
    op = torch.ops.cilqr_torch.frenet_lattice.default
    assert all(a.alias_info is None for a in op._schema.arguments)
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key)
    assert (frenet_cuda, "LAUNCHES") in graphs.COUNTERS


def test_the_config_mirror_matches_the_kernel_struct():
    """``frenet_cuda._FrenetConfig`` lists the fields of ``FrenetConfig`` in
    ``csrc/frenet.cu`` in order, with their C types (the card checks only
    the size)."""
    import ctypes

    src = (PORT / "csrc" / "frenet.cu").read_text()
    body = re.search(r"struct FrenetConfig \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if line:
            ctype, names = re.match(r"(int|float)\s+(.*)", line).groups()
            fields += [(n.strip(), ctype) for n in names.split(",")]
    c_name = {ctypes.c_int: "int", ctypes.c_float: "float"}
    assert [(n, c_name[t]) for n, t in frenet_cuda._FrenetConfig._fields_] == fields
    cfg = frenet_cuda._config(solver_params(), frenet.FrenetParams(), 8192, (9, 4, 5), 200, 8,
                              (152, 104), frenet_cuda.MAP_LANE)
    assert (cfg.threads, cfg.map, cfg.n_lat, cfg.n_T, cfg.n_v, cfg.H, cfg.W) == (
        192, 2, 9, 4, 5, 152, 104)
    assert cfg.mean_factor == pytest.approx(1 / 41, rel=1e-7)
    assert cfg.tiny_dx == 2.0 ** -75


def solver_params():
    from cilqr_tpu_torch.utils.params import SolverParams

    return dataclasses.replace(SolverParams(), **CONFIG["solver"])


def test_the_launch_refuses_what_the_kernel_cannot_take():
    """The launch function takes CUDA tensors (float32 on the card) and at
    most ``MAX_OBSTACLES`` slots; a block takes K rounded up to whole
    warps, at most ``MAX_THREADS`` threads."""
    p, fp, args = case("propagation", False, B=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frenet_cuda._launch(p, fp, *args)
    assert [frenet_cuda.threads_per_block(k) for k in (1, 32, 33, 180, 256, 1000)] == [
        32, 32, 64, 192, 256, 256]


def test_the_bound_of_the_cells_shape():
    """The bound model at the campaign's shape (B=8192, the 9 x 4 x 5
    lattice, N=40, S=200, one live slot, one 152x104 map per lane):
    operations bind, ~0.26 ms; the 20 longitudinal profiles' work is counted
    once a lane, not once a candidate."""
    b = roofline.frenet_bound(8192, (9, 4, 5), 40, 200, 1, (152, 104))
    assert b["bound_by"] == "operations" and 0.24 < b["bound_ms"] < 0.29
    assert roofline.frenet_bound(8192, (9, 4, 5), 40, 200, 0)["bound_ms"] < b["bound_ms"]
    lateral = roofline.frenet_bound(8192, (18, 4, 5), 40, 200, 1, (152, 104))["bound_ms"]
    profiles = roofline.frenet_bound(8192, (9, 8, 5), 40, 200, 1, (152, 104))["bound_ms"]
    assert profiles > lateral > b["bound_ms"]


@pytest.mark.parametrize("mode", frenet.MODES)
def test_the_band_brackets_the_plain_count(mode):
    """``chip_smoke.lattice_band``: the plain count with every bound moved
    by 1e-5 either way brackets the count itself; moved by 50% it changes
    the count (each rule it moves binds on these worlds)."""
    p, fp, args = case(mode, False, B=6)
    n = frenet.lattice_plain(p, fp, *args)[4]
    lo = chip_smoke.lattice_band(p, fp, args, 1.0 - chip_smoke.LATTICE_TOL)
    hi = chip_smoke.lattice_band(p, fp, args, 1.0 + chip_smoke.LATTICE_TOL)
    assert bool(((lo <= n) & (n <= hi)).all())
    assert int(chip_smoke.lattice_band(p, fp, args, 0.5).sum()) < int(n.sum())
    assert int(chip_smoke.lattice_band(p, fp, args, 1.5).sum()) > int(n.sum())


# ------------------------------------------------------------- on the card
SPEC = json.loads((PORT.parent / "BENCHMARK.json").read_text())
CELL = "campaign.frenet_prop_b8192"
CARD_B, CARD_CYCLES = 256, 2


def card_inputs(lane_width):
    """``plan_steps``' arguments of each cycle of one closed loop of the
    benchmark cell's traffic at B=256 on the card, run eagerly, the cell's
    lane ``lane_width`` m wide where given."""
    import copy

    from benchmarks import run as R

    wl, config, cell, traffic = R.load_cell(SPEC, CELL, PORT.parent)
    if lane_width is not None:
        config = copy.deepcopy(config)
        config["world"]["town"]["lane_width"] = lane_width
    run = R.Run(wl, config, dict(cell, batch=CARD_B, cycles=CARD_CYCLES, check_lanes=8,
                                 check_calls=1), 2 ** 31 + 7, 0.2, False,
                device=torch.device("cuda", 0))
    cam = traffic.Campaign(run)
    cam.reseed(run.seed)
    calls, plan_steps, graphed = [], frenet.plan_steps, solver.GRAPHS

    def recorded(*args, **kw):
        calls.append((args, kw))
        return plan_steps(*args, **kw)

    frenet.plan_steps, solver.GRAPHS = recorded, False
    try:
        cam.call(0)
        torch.cuda.synchronize()
    finally:
        frenet.plan_steps, solver.GRAPHS = plan_steps, graphed
    assert len(calls) == CARD_CYCLES
    return cam.p, cam.fp, calls


@pytest.fixture(scope="module", params=[None, 5.0], ids=["cell_world", "five_m_lane"])
def card_world(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return card_inputs(request.param)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("mode, shared", CASES, ids=IDS)
def test_kernel_holds_to_the_plain_version_on_the_card(card_world, mode, shared):
    """Each cycle's inputs at B=256, the kernel against its plain version on
    the card (``route.plain()``) by ``chip_smoke.hold_lattice``: per lane the
    feasible count within the plain count's band (bounds moved by 1e-5),
    any feasible equal, the winner the same or within 1e-4 relative of the
    plain version's least cost, the same winner's cost within 1e-5
    relative and its trajectory within 1e-4; the map the lane's own or the
    first lane's, shared."""
    p, fp_cell, calls = card_world
    fp = dataclasses.replace(fp_cell, mode=mode)
    inputs = []
    for args, kw in calls:
        _, _, xy, n, egos, obstacles, um, sigmas = args
        if shared:
            um = unc_mod.UncertaintyMap(um.values[0], gridmap.GridGeom(
                um.geom.center[0], um.geom.resolution[0], um.geom.length[0]),
                um.origin_xy[0], um.origin_yaw[0])
        plan = rp.get_local_plan(p, xy, n, egos)
        inputs.append(frenet.lattice_inputs(p, fp, plan, egos, obstacles, um, sigmas,
                                            kappa_max=kw["kappa_max"]))
    before = frenet_cuda.LAUNCHES
    st = chip_smoke.hold_lattice(f"{mode}, {'shared' if shared else 'per lane'}", p, fp, inputs)
    assert frenet_cuda.LAUNCHES - before == CARD_CYCLES
    assert st["lanes"] == CARD_CYCLES * CARD_B


class LargestOutput(TorchDispatchMode):
    """Records the most elements of any tensor an op dispatched under it
    returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_no_candidate_tensor_on_the_card(card_world):
    """On the card ``plan_steps`` forms no tensor of the lattice's (B, K,
    N+1) size or larger: every op of the stage (the plan fit, the lattice's
    inputs, the op, the brake) returns fewer elements; the plain version
    does form them."""
    p, fp, calls = card_world
    args, kw = calls[0]
    B, K, N = args[4].shape[0], fp.n_candidates, p.horizon
    with LargestOutput() as mode:
        frenet.plan_steps(*args, **kw)
    assert 0 < mode.largest < B * K * (N + 1)
    with route.plain(), LargestOutput() as plain:
        frenet.plan_steps(*args, **kw)
    assert plain.largest >= B * K * (N + 1)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_one_launch_per_run_steps_call(monkeypatch):
    """The swapped full-stack loop at B=64 x 3 cycles on the card: the
    lattice kernel launches once per ``run_steps`` call, graphed (by
    replay) and eager."""
    from tests.test_torch_frenet_campaign import full_stack, small

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    w = small(64, 64)
    w = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in w.items()}
    moved = lambda tree: type(tree)(*(x.to(dev) for x in tree))
    w["obstacles"], w["gg"] = moved(w["obstacles"]), moved(w["gg"])
    w["obs"] = tuple(x.to(dev) for x in w["obs"])
    for graphed in (True, True, False):
        monkeypatch.setattr(solver, "GRAPHS", graphed)
        before, plans = frenet_cuda.LAUNCHES, frenet.PLANS
        full_stack(w, w["egos"], 3)
        torch.cuda.synchronize()
        assert frenet_cuda.LAUNCHES - before == frenet.PLANS - plans == 3
