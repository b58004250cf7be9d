"""The port's observability layer (``cilqr_tpu_torch.utils.profiling``)
against ``cilqr_tpu.utils.profiling``: the same phase timer and summary on
CPU tensors, a ``torch.profiler`` trace in place of the ``jax.profiler``
one."""

import json
import time

import numpy as np
import pytest
import torch

from cilqr_tpu.utils import profiling as jprofiling
from cilqr_tpu_torch.utils import profiling

DEV = "cpu"  # the port allocates on the card unless told otherwise


def test_phase_timer():
    t = profiling.PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        time.sleep(0.01)
    t.record("b", 0.5)
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["mean_ms"] >= 9.0
    assert s["b"]["total_ms"] == 500.0
    assert "a" in t.dump()


def test_timed_blocks_async_dispatch():
    t = profiling.PhaseTimer()
    x = torch.ones((256, 256), device=DEV)
    out = t.timed("matmul", lambda: x @ x)
    assert out.shape == (256, 256)
    assert t.summary()["matmul"]["count"] == 1


def test_summary_and_dump_equal_the_jax_timer(tmp_path):
    """The same record calls give the JAX PhaseTimer's summary, number for
    number, and the same dump."""
    calls = [("solve", 0.0123), ("solve", 0.25), ("costmap", 1e-4), ("solve", 3.5),
             ("costmap", 0.002)]
    got, want = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for name, seconds in calls:
        got.record(name, seconds)
        want.record(name, seconds)
    assert got.summary() == want.summary()
    assert got.dump(str(tmp_path / "port.json")) == want.dump(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_block_until_ready_walks_nests_of_cpu_tensors():
    tree = {"a": torch.ones(3, device=DEV), "b": (torch.zeros(2, device=DEV), [1.0, "x"])}
    assert profiling.block_until_ready(tree) is tree


def test_trace_writes_the_annotated_region(tmp_path):
    """The Chrome trace holds the annotated range and the program's span
    around it, on one clock: the span's row encloses the range."""
    x = torch.ones((64, 64), device=DEV)
    with profiling.trace(str(tmp_path)):
        with profiling.span("cilqr_program_span"):
            with profiling.annotate("cilqr_annotated_region"):
                (x @ x).sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    region = [e for e in events if e.get("name") == "cilqr_annotated_region"]
    spans = [e for e in events if e.get("name") == "cilqr_program_span"]
    assert len(region) >= 1 and len(spans) == 1
    r, s = region[0], spans[0]
    assert s["cat"] == "cilqr_span" and s["args"]["parent"] is None
    assert s["ts"] - 50 <= r["ts"] <= r["ts"] + r["dur"] <= s["ts"] + s["dur"] + 50
    assert any(e.get("ph") == "M" and e["tid"] == s["tid"] for e in events)


# ------------------------------------------------------------------- spans
@pytest.fixture
def fresh():
    """The tracer's record dropped before and after the test."""
    profiling.reset()
    yield
    profiling.reset()


def test_an_off_span_reads_no_clock_and_makes_no_event(fresh, monkeypatch):
    """Tracing off: every span site returns the one shared null context,
    reads no clock, makes no CUDA event and records nothing."""
    def boom(*a, **k):
        raise AssertionError("a clock or an event was touched with tracing off")

    monkeypatch.setattr(profiling, "_clock", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    sites = [profiling.span("a"), profiling.span("b", device=torch.device("cuda", 0)),
             profiling.span("c", device=torch.device("cpu"), wait=True)]
    assert all(s is sites[0] for s in sites)
    with sites[1] as loop:
        with sites[2]:
            pass
        loop.attach(7)
    assert profiling.spans() == [] and profiling.counters() == {}


@pytest.fixture(params=["profiler", "tracing"])
def traced(request, fresh):
    """Tracing on: under a CPU-activity ``torch.profiler`` session, or inside
    ``profiling.tracing()`` without one."""
    from torch.profiler import ProfilerActivity, profile

    if request.param == "profiler":
        return lambda: profile(activities=[ProfilerActivity.CPU])
    return profiling.tracing


def test_spans_nest_with_their_parent_and_call(traced):
    """Two entry calls, each with nested spans: every span names its parent
    and its call (the entry's id); the host intervals nest; the step count
    attached to a span is kept; a CPU device span has no device interval."""
    with traced():
        for _ in range(2):
            with profiling.span("entry"):
                with profiling.span("inner", device=torch.device(DEV)) as loop:
                    with profiling.span("leaf", wait=True):
                        pass
                    loop.attach(5)
                with profiling.span("after"):
                    pass
    got = profiling.spans()
    assert [s.name for s in got] == ["entry", "inner", "leaf", "after"] * 2
    assert [s.id for s in got] == list(range(1, 9))
    for k in range(2):
        e, i, leaf, a = got[4 * k:4 * k + 4]
        assert e.parent is None and e.call == e.id
        assert (i.parent, leaf.parent, a.parent) == (e.id, i.id, e.id)
        assert {i.call, leaf.call, a.call} == {e.id}
        assert e.start_ns <= i.start_ns <= leaf.start_ns <= leaf.end_ns <= i.end_ns
        assert i.end_ns <= a.start_ns <= a.end_ns <= e.end_ns
        assert (i.steps, e.steps, leaf.wait, i.wait) == (5, None, True, False)
        assert i.device_start_ns is None and i.device_end_ns is None
    assert got[4].call != got[0].call


def test_a_profiler_range_lies_inside_its_span_on_the_trace_clock(fresh):
    """The spans' host clock is the profiler's: a ``record_function`` range
    opened inside a span lies within the span's interval on the trace's
    ``start_ns`` clock, to within 50 us (after the first range, which opens
    slowly)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((32, 32), device=DEV)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(6):
            with profiling.span(f"span{k}"):
                with torch.profiler.record_function(f"range{k}"):
                    (x @ x).sum()
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("range")}
    slack = 50_000
    for s in profiling.spans()[1:]:
        r = ranges[s.name.replace("span", "range")]
        assert s.start_ns - slack <= r.start_ns() <= r.end_ns() <= s.end_ns + slack, s.name


def test_counters_give_the_change_over_the_traced_calls(fresh, monkeypatch):
    """The launch counters and the captures' counts, changed inside entry
    calls only, by what changed inside them; a change outside a traced call
    is not counted."""
    from cilqr_tpu_torch.ops import lm_cuda, loop_cuda
    from cilqr_tpu_torch.utils import graphs

    for mod, name in ((lm_cuda, "LAUNCHES"), (loop_cuda, "LAUNCHES"), (graphs, "CAPTURES"),
                      (graphs, "CAPTURE_S")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    with profiling.tracing():
        with profiling.span("entry"):
            lm_cuda.LAUNCHES += 2
            with profiling.span("inner"):
                loop_cuda.LAUNCHES += 21
        lm_cuda.LAUNCHES += 100  # between the traced calls
        graphs.CAPTURES += 1
        with profiling.span("entry"):
            lm_cuda.LAUNCHES += 3
            graphs.CAPTURE_S += 0.25
    c = profiling.counters()
    assert c["lm_cuda.LAUNCHES"] == 5 and c["loop_cuda.LAUNCHES"] == 21
    assert c["graphs.CAPTURES"] == 0 and c["graphs.CAPTURE_S"] == 0.25
    assert c["lm_cuda.ITER_LAUNCHES"] == 0 and c["graphs.EVICTIONS"] == 0
    assert {f"{m.__name__.rsplit('.', 1)[-1]}.{n}" for m, n in graphs.COUNTERS} <= set(c)


def test_host_counters_are_read_from_their_registry(fresh, monkeypatch):
    """A host counter that a module enters in ``HOST_COUNTERS`` is read
    like the launch counters, by its change inside the traced calls; CCNMPC
    enters its rounds and tightenings so, and the tracer imports no model."""
    import inspect
    import types

    from cilqr_tpu_torch.models import ccnmpc

    mod = types.ModuleType("cilqr_tpu_torch.models.a_planner")
    mod.STEPS = 0
    monkeypatch.setattr(profiling, "HOST_COUNTERS", profiling.HOST_COUNTERS + [(mod, "STEPS")])
    with profiling.tracing():
        with profiling.span("entry"):
            mod.STEPS += 4
        mod.STEPS += 10  # between the traced calls
    c = profiling.counters()
    assert c["a_planner.STEPS"] == 4
    assert c["ccnmpc.ROUNDS"] == 0 and c["ccnmpc.TIGHTENED"] == 0
    assert {(ccnmpc, "ROUNDS"), (ccnmpc, "TIGHTENED")} <= set(profiling.HOST_COUNTERS)
    assert "cilqr_tpu_torch.models" not in inspect.getsource(profiling)


def test_graph_cache_counts_captures_and_evictions(fresh, monkeypatch):
    """A miss is one capture, with its seconds and (tracing on) its span; a
    hit none; a miss beyond ``kept`` one eviction."""
    from cilqr_tpu_torch.utils import graphs

    for name in ("CAPTURES", "CAPTURE_S", "EVICTIONS"):
        monkeypatch.setattr(graphs, name, getattr(graphs, name))
    made = []

    def make(inputs):
        time.sleep(0.002)
        made.append(inputs)
        return (), inputs[0] * 2, None

    cache = graphs.GraphCache(kept=2)
    x = torch.ones(3, device=DEV)
    before = (graphs.CAPTURES, graphs.CAPTURE_S, graphs.EVICTIONS)
    with profiling.tracing():
        cache.load("a", [x], make)
        assert (graphs.CAPTURES - before[0], graphs.EVICTIONS - before[2]) == (1, 0)
        assert graphs.CAPTURE_S - before[1] >= 0.002
        entry = cache.load("a", [2 * x], make)
        assert graphs.CAPTURES - before[0] == 1 and len(made) == 1
        assert torch.equal(entry.inputs[0], 2 * x)
        cache.load("b", [x], make)
        assert (graphs.CAPTURES - before[0], graphs.EVICTIONS - before[2]) == (2, 0)
        cache.load("c", [x], make)
        assert (graphs.CAPTURES - before[0], graphs.EVICTIONS - before[2]) == (3, 1)
        assert list(cache) == ["b", "c"]
    assert [s.name for s in profiling.spans()] == ["capture"] * 3


# ------------------------------------------- the span sites of the program
@pytest.fixture
def staged(fresh, monkeypatch):
    """The graph paths staged on the CPU (``test_torch_graph_ops.replays``:
    the captures replaced by eager replays) on one PyTorch thread."""
    from tests import test_torch_graph_ops as ops

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(ops.graphs, "replayable", lambda x: not ops.graphs._BUILDS)
    monkeypatch.setattr(ops.graphs, "side_stream",
                        lambda device: ops.graphs.contextlib.nullcontext())
    monkeypatch.setattr(ops.graphs, "capture", ops.PlannedReplays)
    monkeypatch.setattr(ops.solver, "CAPTURED", ops.graphs.GraphCache())
    monkeypatch.setattr(ops.solver, "GRAPHS", True)
    monkeypatch.setattr(ops.solver, "DEVICE_LOOP", True)
    monkeypatch.setattr(ops.PlannedReplays, "planners", [])
    monkeypatch.setattr(ops.PlannedReplays, "captures", 0)
    yield ops
    torch.set_num_threads(n)


def children(found: list, parent) -> list:
    return [s.name for s in found if s.parent == parent.id]


REPLAY = ["replay.copy_in", "replay.start", "replay.loop", "replay.copy_out", "replay.count"]


def check_replay(found: list, copy_in, captured: bool, steps: int) -> None:
    """A ``solver._replay``'s spans, from its copy in: the capture inside
    the copy in on a miss, the loop's steps, the host's wait flagged."""
    i = found.index(copy_in)
    names = [s.name for s in found[i:i + 6] if s.name != "capture"]
    assert names[:5] == REPLAY
    assert children(found, copy_in) == (["capture"] if captured else [])
    loop = next(s for s in found[i:] if s.name == "replay.loop")
    count = next(s for s in found[i:] if s.name == "replay.count")
    assert loop.steps == steps and count.wait and not loop.wait
    assert loop.parent == copy_in.parent == count.parent


def test_monte_carlo_spans_its_stages(staged):
    """``monte_carlo(impl="fast")``: one entry span per call, the replay's
    stages under it, the loop's span carrying the steps it ran (the
    largest iteration count); the first call captures, the second replays;
    the counters' change over the calls: the captures, and the condition's
    runs, which the CPU loop does not count."""
    ops = staged
    w = ops.world(torch.float32, 4, seed=50)
    cp = ops.dataclasses.replace(w["cp"], rows=16, cols=12, window_radius=2)
    prior = ops.t(np.random.default_rng(51).uniform(0, 100, (16, 12)), torch.float32)
    geom = ops.gridmap.make_geom([3.0, 0.0], 0.5, 16, 12, dtype=torch.float32, device=DEV)
    hi = (0.1, 0.1, 0.01)
    band = ops.uncertainty_cuda.make_band_plan(cp, 16, 12, (3.0, 0.0), hi)
    out = []
    with profiling.tracing():
        for k in range(2):
            gen = torch.Generator(device=DEV).manual_seed(52 + k)
            s = ops.mc.sample_scenarios(gen, 4, w["egos"][0], sigma_hi=hi, dtype=torch.float32,
                                        device=DEV)
            out.append(ops.mc.monte_carlo(w["p"], cp, prior, geom, w["unc"].origin_xy,
                                          w["unc"].origin_yaw, w["plan"], w["n"], s,
                                          w["obstacles"], sigma_hi=hi, impl="fast",
                                          band_plan=band, center=(3.0, 0.0)))
    found = profiling.spans()
    entries = [s for s in found if s.parent is None]
    assert [s.name for s in entries] == ["entry.monte_carlo"] * 2
    for k, e in enumerate(entries):
        assert children(found, e) == REPLAY
        copy_in = next(s for s in found if s.parent == e.id)
        check_replay(found, copy_in, k == 0, int(out[k].iterations.max()))
        assert all(s.call == e.id for s in found if s.start_ns >= e.start_ns
                   and s.end_ns <= e.end_ns)
    c = profiling.counters()
    assert c["graphs.CAPTURES"] == 1 and c["graphs.CAPTURE_S"] > 0
    assert c["loop_cuda.LAUNCHES"] == 0


def test_full_stack_spans_each_cycle(staged):
    """``closed_loop_full_stack_batched``: the entry span, one span per
    cycle holding the solve's replay and the dynamics step's ``solver.run``
    (copy in, replay, copy out), then the records' stack."""
    ops = staged
    w = ops.world(torch.float32, 3, seed=40)
    draws = ops.t(np.random.default_rng(41).normal(size=(3, 3, 3)), torch.float32)
    with profiling.tracing():
        _, rec = ops.plant.closed_loop_full_stack_batched(
            w["p"], w["cp"], ops.NoiseParams(0.05, 0.04, 0.005), w["gm"], w["gg"], w["plan"],
            w["n"], w["egos"], None, 3, w["obstacles"], *w["obs"], global_res=1.0,
            noise_draws=draws)
    found = profiling.spans()
    (entry,) = [s for s in found if s.parent is None]
    assert entry.name == "entry.full_stack"
    assert children(found, entry) == ["full_stack.cycle"] * 3 + ["full_stack.records"]
    for k, cycle in enumerate(s for s in found if s.name == "full_stack.cycle"):
        assert children(found, cycle) == REPLAY + ["run.copy_in", "run.replay", "run.copy_out"]
        copy_in = next(s for s in found if s.parent == cycle.id)
        check_replay(found, copy_in, k == 0, int(rec["iterations"][k].max()))
    assert {s.call for s in found} == {entry.id}


def test_fleet_solve_spans_its_graph(staged):
    """``run_steps_batched(impl="mega")``: the entry span and ``solver.run``'s
    copy in (the capture in it on the first call), replay and copy out."""
    ops = staged
    w = ops.world(torch.float32, 3, seed=21)
    with profiling.tracing():
        for k in range(2):
            ops.solver_batched.run_steps_batched(w["p"], w["plan"], w["n"], w["egos"] + 0.05 * k,
                                                 w["U"], w["obstacles"], w["unc"])
    found = profiling.spans()
    entries = [s for s in found if s.parent is None]
    assert [s.name for s in entries] == ["entry.run_steps_batched"] * 2
    for k, e in enumerate(entries):
        assert children(found, e) == ["run.copy_in", "run.replay", "run.copy_out"]
        copy_in = next(s for s in found if s.parent == e.id)
        assert children(found, copy_in) == (["capture"] if k == 0 else [])
