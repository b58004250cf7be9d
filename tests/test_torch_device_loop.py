"""The graphed LM loops as one device-side while loop (``solver.DEVICE_LOOP``).

The JAX package runs each LM loop as a ``jax.lax.while_loop`` whose condition
XLA evaluates on the chip.  On the card the port replays the start graph and
then launches one loop graph (``graphs.Loop``): a WHILE node around the step
graph, whose condition ``lm_continue_kernel`` (``csrc/loop.cu``) computes on
the card, v = any(~done) & (steps < max_iterations), steps += v.  Here, on
the CPU, the condition is its plain version (``loop_cuda.lm_continue_plain``)
and a ``graphs.Loop`` on a CPU done mask is the loop graph's plain version:
the host replays the step while the plain condition holds.  With the
captures replaced by eager replays, the plain, hybrid (K3) and two-phase
(K2) loops give the eager loop's bits and the host-polled replay's, in
float32 and float64, with steps == the largest iteration count; the launch
counters advance by the start's launches plus steps times the step's; the
key holds ``DEVICE_LOOP`` and the route; eviction frees the loop
graph.  The ``cuda`` tests hold the kernel to its plain version, the device
loop to the host-polled replay and to eager, and check that the start
replay and the loop launch read nothing on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from cilqr_tpu_torch.models import solver, solver_batched
from cilqr_tpu_torch.models import uncertainty as unc_mod
from cilqr_tpu_torch.models.reference_path import get_local_plan
from cilqr_tpu_torch.ops import lm_cuda, loop_cuda, riccati_cuda, uncertainty_cuda
from cilqr_tpu_torch.parallel import monte_carlo as mc
from cilqr_tpu_torch.sim.example_scenario import example_scenario
from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams
from tests.test_torch_graph_loops import PlannedEagerly, k2_op, k3_op

DEV = "cpu"  # the port allocates on the card unless told otherwise
DTYPES = (torch.float32, torch.float64)
MAX_IT = 20  # SolverParams().max_iterations
MODES = {"device": (True, True), "host": (True, False), "eager": (False, True)}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs (six test workers share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def done_mask(kind: str, B: int, device=DEV) -> torch.Tensor:
    """Every lane stopped ("all"), none ("none"), or all but one ("one");
    B=0: the unbatched solve's mask, of shape ()."""
    done = torch.full((B,) if B else (), kind != "none", dtype=torch.bool, device=device)
    if kind == "one":
        done.view(-1)[B // 2] = False
    return done


CONDITION_CASES = [(B, kind, s) for B in (1, 7, 1025) for kind in ("all", "none", "one")
                   for s in (0, MAX_IT - 1, MAX_IT)] + [
    (0, kind, s) for kind in ("all", "none") for s in (0, MAX_IT)]


def expected(done: torch.Tensor, s: int) -> bool:
    return bool(((~done).any() & (torch.tensor([s]) < MAX_IT)).all())


@pytest.mark.parametrize("B,kind,s", CONDITION_CASES)
def test_condition_plain_version(B, kind, s):
    """v = any(~done) & (steps < max_iterations), int32 (1,); steps advance
    by v exactly; the wrapper takes the plain version for a CPU mask."""
    done = done_mask(kind, B)
    want = expected(done, s)
    for fn in (loop_cuda.lm_continue_plain, loop_cuda.lm_continue):
        steps = torch.tensor([s], dtype=torch.int32)
        before = loop_cuda.LAUNCHES
        v = fn(done, steps, MAX_IT)
        assert v.dtype == torch.int32 and v.shape == (1,)
        assert int(v) == want and int(steps) == s + want
        assert loop_cuda.LAUNCHES == before  # nothing launched on the CPU


# ------------------------------------------------------------ the loops, CPU
@pytest.fixture
def captures(monkeypatch):
    """The captures replaced by ``PlannedEagerly`` (each replay keeps its
    plan in ``planners``), a cache of this test's own, ``GRAPHS`` and
    ``DEVICE_LOOP`` restored afterwards."""
    monkeypatch.setattr(graphs, "side_stream", lambda device: graphs.contextlib.nullcontext())
    monkeypatch.setattr(graphs, "capture", PlannedEagerly)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(solver, "GRAPHS", solver.GRAPHS)
    monkeypatch.setattr(solver, "DEVICE_LOOP", solver.DEVICE_LOOP)
    monkeypatch.setattr(PlannedEagerly, "planners", [])


def world(p, dtype, B: int, seed: int, device=DEV):
    """The example world with B egos ``ego + N(0, 0.3)`` (B=0: the
    unbatched ego) and one random map per scenario."""
    plan, n, ego, U0, obstacles, unc = example_scenario(p, dtype, device=device)
    rng = np.random.default_rng(seed)
    egos = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (max(B, 1), 4)),
                        dtype=dtype, device=device)
    H, W = unc.values.shape
    maps = mc.per_scenario_map(torch.tensor(rng.uniform(0.0, 100.0, (max(B, 1), H, W)),
                                            dtype=dtype, device=device),
                               unc.geom, unc.origin_xy, unc.origin_yaw)
    if B == 0:
        return plan, n, egos[0], U0, obstacles, unc, maps
    return plan, n, egos, U0.expand(B, p.horizon, 2).contiguous(), obstacles, unc, maps


def loop_call(kind: str, p, w, graphed: bool, k3=k3_op):
    """The solve of ``kind``: "plain" (``run_step``, the plan fit in the
    start graph), "hybrid" (the map sampler and K3's op, ``k3``),
    "two_phase" (the plain derivatives and K2's op).  ``graphed``: through
    ``_replay`` (on the CPU the graph paths are called directly), else the
    eager loop."""
    plan, n, egos, U, obstacles, unc, maps = w
    if kind == "plain":
        if graphed:
            return lambda: solver._run_step_graphed(p, plan, n, egos, U, obstacles, unc)
        return lambda: solver.run_step(p, plan, n, egos, U, obstacles, unc)
    plans = get_local_plan(p, plan, n, egos)
    if kind == "hybrid":
        it = lm_cuda.hybrid_iteration(p, plans, obstacles, solver_batched.map_sampler(p, maps),
                                      k3)
    else:
        it = solver_batched.two_phase_iteration(plans, obstacles, unc)
    if graphed:
        return lambda: solver._optimize_graphed(p, plans, egos, U, iteration=it)
    return lambda: solver.optimize(p, plans, egos, U, iteration=it)


def iterations(out) -> torch.Tensor:
    return out.iterations if hasattr(out, "iterations") else out[2]


def same(a, b) -> bool:
    """Every tensor of two nests equal, bit for bit (and the nests alike)."""
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                            for x, y in zip(la, lb))


def entries(loop: bool) -> list:
    """The captures of ``solver.CAPTURED`` with (True) or without a loop."""
    return [g for g in solver.CAPTURED.values() if (g.loop is not None) == loop]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["plain", "hybrid", "two_phase"])
def test_device_loop_gives_the_eager_and_host_polled_bits(kind, dtype, captures, monkeypatch):
    """The loop graph's plain version (a ``graphs.Loop`` on a CPU mask),
    the host-polled replay and the eager loop give the same bits on every
    output; the loop ran steps == the largest iteration count step
    replays, as the host-polled replay did; a second call on new egos
    replays the same captures."""
    if kind == "two_phase":
        monkeypatch.setattr(riccati_cuda, "backward_forward_batched", k2_op)
    p = dataclasses.replace(SolverParams(), horizon=12)
    for call_no, seed in enumerate((3, 4)):
        w = world(p, dtype, 0 if kind == "plain" else 5, seed)
        out, replays = {}, {}
        for mode, (graphed, device_loop) in MODES.items():
            solver.GRAPHS, solver.DEVICE_LOOP = graphed, device_loop
            before = len(PlannedEagerly.planners)
            out[mode] = loop_call(kind, p, w, mode != "eager")()
            replays[mode] = len(PlannedEagerly.planners) - before
        assert same(out["device"], out["eager"]) and same(out["host"], out["eager"]), call_no
        n_it = int(iterations(out["device"]).max())
        assert n_it >= 1
        (loop_entry,), (host_entry,) = entries(True), entries(False)
        assert isinstance(loop_entry.loop, graphs.Loop) and loop_entry.loop.stats is None
        assert int(loop_entry.loop.steps) == n_it
        # the start replay, then one step replay per iteration, both ways
        assert replays["device"] == replays["host"] == 1 + n_it
        assert len(solver.CAPTURED) == 2


@pytest.mark.parametrize("kind", ["hybrid", "two_phase"])
def test_launch_counters_advance_by_start_plus_steps(kind, captures, monkeypatch):
    """A stand-in for each kernel counting as the kernel does: a solve on
    the device loop advances each counter by the start graph's launches
    plus steps times the step graph's, as the host-polled replay and the
    eager loop count."""
    p = dataclasses.replace(SolverParams(), horizon=10)
    w = world(p, torch.float64, 4, seed=11)
    k3 = k3_op
    if kind == "hybrid":
        def k3(*args):
            lm_cuda.ITER_LAUNCHES += 1
            return k3_op(*args)
    else:
        def counted(*args):
            riccati_cuda.LAUNCHES += 1
            return k2_op(*args)

        monkeypatch.setattr(riccati_cuda, "backward_forward_batched", counted)
    got = {}
    for mode, (graphed, device_loop) in MODES.items():
        solver.GRAPHS, solver.DEVICE_LOOP = graphed, device_loop
        for module, name in graphs.COUNTERS:
            monkeypatch.setattr(module, name, 0)
        out = loop_call(kind, p, w, mode != "eager", k3)()
        got[mode] = graphs._counts()
    (entry,) = entries(True)
    start, step = entry.graphs
    n = int(entry.loop.steps)
    assert n == int(out[2].max()) > 1
    want = tuple(a + n * b for a, b in zip(start.launches, step.launches))
    assert tuple(got["device"]) == want == tuple(got["host"]) == tuple(got["eager"])
    assert sum(step.launches) == 1


class CountedStep:
    """A step graph as a ``Loop`` reads it: its recorded launches."""

    def __init__(self, launches: tuple):
        self.launches = launches

    def replay(self):
        graphs.count_launches(self.launches)


def card_loop(monkeypatch, freed: list, launches: tuple) -> graphs.Loop:
    """A ``Loop`` as on the card, with stand-in handles: ``loop_cuda.destroy``
    records what it is given in ``freed``."""
    monkeypatch.setattr(loop_cuda, "destroy", lambda *handles: freed.append(handles))
    loop = graphs.Loop(CountedStep(launches), torch.zeros(3, dtype=torch.bool), MAX_IT)
    loop._handles = ("graph", "exec")
    return loop


def test_loop_count_on_the_card_adds_steps_times_the_step(monkeypatch):
    """On the card ``count()`` reads ``steps`` once and adds steps times the
    step graph's launches to the counters, and steps + 1 runs of the
    condition to ``loop_cuda.LAUNCHES``."""
    for module, name in graphs.COUNTERS:
        monkeypatch.setattr(module, name, 0)
    monkeypatch.setattr(loop_cuda, "LAUNCHES", 0)
    launches = tuple(range(1, len(graphs.COUNTERS) + 1))
    loop = card_loop(monkeypatch, [], launches)
    for s, total in ((7, 7), (0, 7), (20, 27)):
        loop.steps.fill_(s)
        assert loop.count() == s
        assert tuple(graphs._counts()) == tuple(total * c for c in launches)
    assert loop_cuda.LAUNCHES == 8 + 1 + 21


def test_graph_cache_eviction_frees_the_loop_graph(monkeypatch):
    """An evicted capture takes its loop graph with it (``loop_cuda.destroy``
    on its handles), as ``clear`` does; a held loop is not freed."""
    freed: list = []
    cache = graphs.GraphCache(kept=1)
    make = lambda inputs: ((), [inputs[0]], None, card_loop(monkeypatch, freed, ()))
    cache.load("a", [torch.zeros(2)], make)
    assert freed == []
    cache.load("b", [torch.zeros(2)], make)
    assert freed == [("graph", "exec")]
    held = cache["b"].loop
    cache.clear()
    assert len(freed) == 1
    del held
    assert len(freed) == 2


def test_key_holds_device_loop_and_the_route(captures):
    """The capture's key holds ``DEVICE_LOOP`` before the route,
    ``route.plain_on_card()`` (the key's last two entries): the device loop
    and the host-polled replay capture once each and replay their own on
    every later call; the entry of the device loop holds a ``Loop``, the
    other none."""
    p = dataclasses.replace(SolverParams(), horizon=8, max_iterations=3)
    w = world(p, torch.float32, 3, seed=13)
    call = loop_call("hybrid", p, w, True)
    keys = []
    for device_loop in (True, False, True, False):
        solver.DEVICE_LOOP = device_loop
        before = set(solver.CAPTURED)
        call()
        keys.append([k for k in solver.CAPTURED if k not in before])
    assert [len(k) for k in keys] == [1, 1, 0, 0]
    (loop_key,), (host_key,) = keys[:2]
    assert loop_key[-2:] == (True, False) and host_key[-2:] == (False, False)
    assert loop_key[:-2] == host_key[:-2]
    assert isinstance(solver.CAPTURED[loop_key].loop, graphs.Loop)
    assert solver.CAPTURED[host_key].loop is None


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_condition_kernel_equals_its_plain_version_on_the_card():
    """``lm_continue_kernel`` on every case of the plain version's test and
    at the loops' batch sizes: v and the advanced steps equal, one launch
    counted per call."""
    dev = torch.device("cuda", 0)
    cases = CONDITION_CASES + [(B, kind, s) for B in (64, 4096, 8192, 32768)
                               for kind in ("none", "one") for s in (0, MAX_IT)]
    for B, kind, s in cases:
        done = done_mask(kind, B, dev)
        steps = torch.tensor([s], dtype=torch.int32, device=dev)
        plain_steps = steps.cpu()
        before = loop_cuda.LAUNCHES
        v = loop_cuda.lm_continue(done, steps, MAX_IT)
        want = loop_cuda.lm_continue_plain(done.cpu(), plain_steps, MAX_IT)
        torch.cuda.synchronize()
        assert torch.equal(v.cpu(), want) and torch.equal(steps.cpu(), plain_steps), (B, kind, s)
        assert loop_cuda.LAUNCHES == before + 1


def card_paths(dev: torch.device) -> dict:
    """The graphed LM loops at small sizes on ``dev``: the plain solve
    (``run_step``) unbatched and at B=64, "seq" and "pscan"; the hybrid loop
    (``monte_carlo(impl="fast")`` at B=256); the two-phase loop
    (``batched_optimize`` at B=64)."""
    p = dataclasses.replace(SolverParams(), horizon=50)
    paths = {}
    for impl in ("seq", "pscan"):
        pi = dataclasses.replace(p, backward_impl=impl)
        for B in (0, 64):
            plan, n, egos, U, obstacles, unc, _ = world(pi, torch.float32, B, 30 + B, dev)
            paths[f"plain {impl} B={max(B, 1)}"] = (
                lambda pi=pi, a=(plan, n, egos, U, obstacles, unc): solver.run_step(pi, *a))
    plan, n, egos, U, obstacles, unc, _ = world(p, torch.float32, 64, 40, dev)
    plans = get_local_plan(p, plan, n, egos)
    paths["two_phase B=64"] = lambda: solver_batched.batched_optimize(p, plans, egos, U,
                                                                      obstacles, unc)
    cp = CostmapParams()
    cpm = dataclasses.replace(cp, window_radius=1)
    hi = (0.16, 0.16, 0.017)
    gen = torch.Generator(device=dev).manual_seed(41)
    s = mc.sample_scenarios(gen, 256, egos[0], sigma_hi=hi, device=dev)
    band = uncertainty_cuda.make_band_plan(cpm, cp.rows, cp.cols, (2.0, 0.0), hi)
    umap = unc_mod.make_uncertainty_map(np.random.default_rng(42).uniform(0, 100, (152, 104)),
                                        [2.0, 0.0], 0.2, egos[0, :2], 0.05, device=dev)
    paths["monte_carlo B=256"] = lambda: mc.monte_carlo(
        p, cpm, umap.values, umap.geom, umap.origin_xy, umap.origin_yaw, plan, n, s, obstacles,
        sigma_hi=hi, impl="fast", band_plan=band)
    return paths


def three_ways(dev: torch.device, current: int) -> None:
    """Every path of ``card_paths`` on ``dev`` with card ``current`` set,
    on the device loop, the host-polled replay and eagerly: every output
    equal bit for bit, the kernels' launch counts equal, the loop's steps
    equal to the largest iteration count of its solve, and the condition
    counted steps + 1 times per solve; a second device-loop call replays."""
    with torch.cuda.device(current):
        for label, call in card_paths(dev).items():
            out, counts, loop_runs = {}, {}, 0
            for mode, (graphed, device_loop) in MODES.items():
                solver.GRAPHS, solver.DEVICE_LOOP = graphed, device_loop
                solver.CAPTURED.clear()
                for module, name in graphs.COUNTERS:
                    setattr(module, name, 0)
                before = loop_cuda.LAUNCHES
                out[mode] = call()
                torch.cuda.synchronize(dev)
                counts[mode] = graphs._counts()
                if mode == "device":
                    loop_runs = loop_cuda.LAUNCHES - before
                    (entry,) = entries(True)
                    n_it = int(iterations(out[mode]).max())
                    assert int(entry.loop.steps) == n_it, label
                    assert loop_runs == n_it + 1, label
                    assert entry.loop.stats.nodes > 5 and entry.loop.stats.instantiate_s > 0
                    assert same(call(), out[mode]), label
                    assert [e is entry for e in entries(True)] == [True], label
            for mode in ("device", "host"):
                assert same(out[mode], out["eager"]), (label, mode)
            assert counts["device"] == counts["host"] == counts["eager"], (label, counts)
            assert torch.cuda.current_device() == current


@pytest.fixture
def card_loops(monkeypatch):
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(solver, "GRAPHS", True)
    monkeypatch.setattr(solver, "DEVICE_LOOP", True)
    monkeypatch.setattr(solver, "STREAMS", solver.STREAMS)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_device_loop_equals_host_polled_and_eager_on_the_card(card_loops):
    three_ways(torch.device("cuda", 0), 0)


@pytest.mark.cuda
@pytest.mark.skipif("torch.cuda.device_count() < 2", reason="needs two CUDA devices")
def test_device_loop_on_a_card_that_is_not_current(card_loops):
    three_ways(torch.device("cuda", torch.cuda.device_count() - 1), 0)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_start_replay_and_loop_launch_read_nothing_on_the_host(card_loops, monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` a replayed plain
    solve (``run_step``, everything up to the step count's read, which is
    held back here) and each loop's start replay plus loop launch raise
    nothing; the one read afterwards gives the counts and the bits of the
    eager loop."""
    dev = torch.device("cuda", 0)
    paths = card_paths(dev)
    held: list = []
    count = graphs.Loop.count
    for label, call in paths.items():
        solver.GRAPHS = True
        call()  # captures
        torch.cuda.synchronize()
        monkeypatch.setattr(graphs.Loop, "count", lambda loop: held.append(loop))
        torch.cuda.set_sync_debug_mode("error")
        try:
            if label.startswith("plain"):
                got = call()
            else:
                for entry in solver.CAPTURED.values():
                    if entry.loop is not None:
                        entry.graphs[0].replay()
                        entry.loop.launch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            monkeypatch.setattr(graphs.Loop, "count", count)
        torch.cuda.synchronize()
        if label.startswith("plain"):
            (loop,) = held
            assert loop.count() == int(got.iterations.max())
            solver.GRAPHS = False
            assert same(got, call()), label
        held.clear()
