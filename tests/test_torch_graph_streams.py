"""The plain LM loop's graphs captured on several streams (``utils/graphs.py``).

``graphs.StreamPlanner`` places each op of a captured function on one of
several streams and orders it after the ops it depends on.  On the CPU the
planner runs without streams (it plans, the ops run as they are): its plan
for one ``lm_step`` at N=50, B=1 orders every pair of ops that touch one
storage where one of them writes (read after write, write after read,
write after write), by stream order or a chain of waits, as this file
derives them from the plan; a storage used on another stream than its own
is let go only once its own stream is ordered after those uses; with as
many streams as the data is wide the plan's longest chain is the data's; a
tensor read on one stream and then
overwritten on another is ordered; and ``solver``'s graph paths, with the
capture replaced by eager replays under the planner, give the eager loop's
bits, ``run_step``'s fitted plan included.  The card's checks are the
``cuda`` tests of ``test_torch_graph.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cilqr_tpu_torch.models import solver
from cilqr_tpu_torch.sim.example_scenario import example_scenario
from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.params import SolverParams

DEV = "cpu"  # the port allocates on the card unless told otherwise
DTYPES = (torch.float32, torch.float64)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs (six test workers share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def world(p, dtype, B: int, seed: int = 2):
    """The benchmark's world at B of its egos ``ego + N(0, 0.3)`` (B=1:
    unbatched, as the benchmark's single solve)."""
    plan, n, ego, U0, obstacles, unc = example_scenario(p, dtype, device=DEV)
    rng = np.random.default_rng(seed)
    egos = torch.tensor(ego.numpy()[None, :] + rng.normal(0, 0.3, (B, 4)), dtype=dtype)
    if B == 1:
        return plan, n, egos[0], U0, obstacles, unc
    return plan, n, egos, U0.expand(B, p.horizon, 2).contiguous(), obstacles, unc


def planned_step(p, dtype, n_streams: int) -> graphs.StreamPlanner:
    """The plan of what the step graph captures: one ``lm_step`` written
    back into the state."""
    plan, n, ego, U0, obstacles, unc = world(p, dtype, 1)
    lp = solver.get_local_plan(p, plan, n, ego)
    state = solver.start_state(p, ego, U0)
    step = solver.plain_iteration(p, lp, obstacles, unc)
    lamb_inv = solver.damping_inverse(p, dtype, DEV)
    solver.lm_step(p, step, lamb_inv, *state)  # builds the cached constants, as the warm-up
    planner = graphs.StreamPlanner(n_streams)
    with planner:
        solver._assign(state, solver.lm_step(p, step, lamb_inv, *state))
    return planner


def happens_before(ops) -> list:
    """Per op, the last place on each stream that it is ordered after:
    its stream's earlier ops, and through each wait the waited op's."""
    n = max(o.stream for o in ops) + 1
    tail = [[-1] * n for _ in range(n)]
    hb = []
    for o in ops:
        clock = tail[o.stream]
        for w in o.waits:
            clock = [max(a, b) for a, b in zip(clock, hb[w])]
        clock[o.stream] = o.seq
        tail[o.stream] = clock
        hb.append(clock)
    return hb


def conflicts(ops) -> list:
    """Every pair (a, b), a before b, of ops touching one storage where
    either writes."""
    seen: dict = {}
    pairs = []
    for b, o in enumerate(ops):
        for key in set(o.reads) | set(o.writes):
            writes = key in o.writes
            for a, a_writes in seen.get(key, ()):
                if writes or a_writes:
                    pairs.append((a, b))
            seen.setdefault(key, []).append((b, writes))
    return pairs


def dag_chain(ops) -> int:
    """The longest chain of ``conflicts``, in ops."""
    longest = [1] * len(ops)
    for a, b in sorted(conflicts(ops), key=lambda ab: ab[1]):
        longest[b] = max(longest[b], longest[a] + 1)
    return max(longest)


@pytest.mark.parametrize("impl", ["seq", "pscan"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_orders_every_dependency(dtype, impl):
    """N=50, B=1: every read after write, write after read and write after
    write pair of the step on ``solver.STREAMS`` streams is ordered by
    stream order or a chain of waits; every stream is used, and the plan is
    shorter than one stream's."""
    p = dataclasses.replace(SolverParams(), horizon=50, backward_impl=impl)
    planner = planned_step(p, dtype, solver.STREAMS)
    ops = planner.ops
    hb = happens_before(ops)
    pairs = conflicts(ops)
    crossing = [(a, b) for a, b in pairs if ops[a].stream != ops[b].stream]
    assert len(crossing) > 1000
    assert all(hb[b][ops[a].stream] >= ops[a].seq for a, b in pairs)
    assert {o.stream for o in ops} == set(range(solver.STREAMS))
    stats = planner.stats
    assert stats.ops == len(ops) and stats.streams == solver.STREAMS
    assert stats.dag_chain == dag_chain(ops)
    # a list schedule's bound: every unit of time either fills the streams or
    # runs an op of the longest chain
    assert stats.dag_chain < stats.plan_chain <= stats.ops / stats.streams + stats.dag_chain
    assert stats.plan_chain < 0.5 * stats.ops


@pytest.mark.parametrize("impl", ["seq", "pscan"])
def test_plan_lets_memory_go_only_after_its_foreign_uses(impl):
    """A storage made on one stream and used on another is let go (may be
    freed, and its block handed again to its own stream) only once its own
    stream is ordered after every such use; most are let go long before
    the end, so the capture's memory stays near one stream's."""
    p = dataclasses.replace(SolverParams(), horizon=50, backward_impl=impl)
    planner = planned_step(p, torch.float32, solver.STREAMS)
    ops = planner.ops
    hb = happens_before(ops)
    assert len(planner.released) > 10 * len(planner.kept) > 0
    for key, home, i in planner.released:
        assert ops[i].stream == home
        uses = [o for o in ops[:i + 1] if key in o.reads or key in o.writes]
        assert any(o.stream != home for o in uses)
        assert all(hb[i][o.stream] >= o.seq for o in uses)


@pytest.mark.parametrize("impl", ["seq", "pscan"])
def test_plan_chain_is_the_dag_chain_with_streams_enough(impl):
    """With as many streams as the step is wide, the plan adds no link to
    the data's: its longest chain is the DAG's, the fork and the join aside
    (they are not ops)."""
    p = dataclasses.replace(SolverParams(), horizon=50, backward_impl=impl)
    stats = planned_step(p, torch.float32, 64).stats
    assert stats.plan_chain == stats.dag_chain
    assert stats.dag_chain == dag_chain(planned_step(p, torch.float32, 1).ops)


class Placed(graphs.StreamPlanner):
    """A planner whose ops go on the streams given, in order."""

    def __init__(self, n: int, placement: list):
        super().__init__(n)
        self.placement = iter(placement)

    def _place(self, deps, ready):
        return next(self.placement)


def test_copy_after_a_read_on_another_stream_waits_for_it():
    """``t`` written on stream 0, read on stream 1, then overwritten by
    ``copy_`` on stream 2: the copy waits for the read (write after read)
    and the write (write after write); the read waits for the write."""
    x = torch.arange(6.0)
    y = torch.full((6,), 7.0)
    planner = Placed(3, [0, 1, 2])
    with planner:
        t = x.sin()
        r = t * 2.0
        t.copy_(y)
    write, read, copy = planner.ops
    assert (write.stream, read.stream, copy.stream) == (0, 1, 2)
    assert read.waits == (0,) and set(copy.waits) == {1}  # the read's wait covers the write
    hb = happens_before(planner.ops)
    assert hb[2][0] >= write.seq and hb[2][1] >= read.seq
    assert torch.equal(r, x.sin() * 2.0) and torch.equal(t, y)
    assert planner.stats.waits == 2


def test_views_and_in_place_writes_track_the_base():
    """A view takes no stream and shares its base's storage: an in-place
    write through a slice orders after the base's reader."""
    x = torch.arange(8.0)
    planner = Placed(2, [0, 1, 0])
    with planner:
        a = x * 3.0          # stream 0
        s = a.sum()          # stream 1: reads a
        a[2:5].fill_(0.0)    # stream 0: writes a through a view, after the sum
    mul, total, fill = planner.ops
    assert [o.name for o in planner.ops] == ["mul.Tensor", "sum.default", "fill_.Scalar"]
    assert fill.waits == (1,) and fill.writes == mul.writes
    assert float(s) == float((x * 3.0).sum())


class PlannedEagerly:
    """Stands in for ``graphs.capture`` on the CPU: each replay runs the
    captured function again under a stream planner without streams (so
    under its dispatch mode), as a replay runs the captured kernels, and
    writes what it returns into the capture's outputs (``out``)."""

    captures = 0

    def __init__(self, fn, device, streams=1):
        type(self).captures += 1
        self.fn, self.streams = fn, streams
        self.out = fn()

    def replay(self):
        with graphs.StreamPlanner(self.streams):
            graphs.copy_outputs(self.out, self.fn())


@pytest.mark.parametrize("impl", ["seq", "pscan"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_run_step_graph_path_gives_the_eager_bits(dtype, impl, monkeypatch):
    """``solver._run_step_graphed`` (the plan fit in the start graph) and
    ``_optimize_graphed`` with the capture replaced by planned eager
    replays: every field equal to the eager ``run_step`` / ``optimize``,
    ``ref_x`` and ``ref_y`` included, unbatched and at B=4; new egos replay
    without a capture."""
    monkeypatch.setattr(graphs, "side_stream", lambda device: graphs.contextlib.nullcontext())
    monkeypatch.setattr(graphs, "capture", PlannedEagerly)
    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    p = dataclasses.replace(SolverParams(), horizon=12, backward_impl=impl)
    for B in (1, 4):
        plan, n, egos, U0, obstacles, unc = world(p, dtype, B, seed=6)
        for shift in (0.0, 0.5):  # the second call: new egos, the same captures
            e = egos + shift
            before = PlannedEagerly.captures
            got = solver._run_step_graphed(p, plan, n, e, U0, obstacles, unc)
            want = solver.run_step(p, plan, n, e, U0, obstacles, unc)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            lp = solver.get_local_plan(p, plan, n, e)
            got = solver._optimize_graphed(p, lp, e, U0, obstacles, unc)
            assert all(torch.equal(a, b) for a, b in zip(got, solver.optimize(
                p, lp, e, U0, obstacles, unc)))
            assert PlannedEagerly.captures - before == (4 if shift == 0.0 else 0)
