"""CUDA graphs of PyTorch code, captured once per key and replayed.

A loop of small kernels costs the host ~15-25 us per PyTorch op; replayed
as a CUDA graph the same kernels run on the same inputs (the same bits)
with one launch from the host.  ``models.solver`` (its LM loops: the plain
iteration, the hybrid one with the map sampler and K3, the two-phase one
with K2; and the stages around them, ``solver.run`` / ``solver.solve``: the
mega solve with K1, the closed loops' cycles with K4 and K5) and
``models.nrb_rrt`` (the planner) capture their work this way,
each in a ``GraphCache`` of its own.  A capture fails on any host-to-device
copy or host synchronisation inside it, so the constants a captured
function reads are made in its warm-up, before the capture.  Warm-up and
capture run on the inputs' device, whichever device is current: a sharded
solve calls the same function on each card in turn.

Captured on one stream, a graph runs its kernels one after another.  With
``streams > 1`` the capture follows the data: ``StreamPlanner`` puts each
op on one of several streams and orders it after the ops it depends on
(read after write, write after read, write after write, by storage) with
events, which the capture turns into the graph's edges.  The kernels and
their inputs are the same, so are the bits; independent kernels overlap.
The port's own kernels K1-K5 are ``torch.library`` ops
(``cilqr_torch::lm_opt``, ``riccati``, ``lm_iter``, ``propagate``,
``sample``), so the planner sees them as it sees PyTorch's.

A captured function may return tensors: the graph's outputs (``out``),
memory of the graph's own that every replay writes again, which another
graph may read in place.  A stage met while a capture or its warm-up is
under way (``building``) runs eagerly, so the capture holds its kernels.

A replay launches from the host nothing that a launch counter sees, so a
``Graph`` keeps what its capture added to each counter in ``COUNTERS``
(taking it back: the capture ran nothing) and adds it again on each
``replay()``.

A ``Loop`` runs a step graph while a condition computed on the card holds,
as ``jax.lax.while_loop`` runs its body: one launch of a graph whose WHILE
node holds the step graph (``ops/loop_cuda``), no host read between the
iterations.  It reads the number of steps it ran once, afterwards, to
count the launches.

A ``GraphCache`` miss (the warm-up, the captures, their instantiation and
a ``Loop``'s build) is counted, with its seconds, in ``CAPTURES`` and
``CAPTURE_S``, whether or not tracing is on, and each capture dropped to
make room in ``EVICTIONS``; ``utils.profiling`` spans the miss.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections.abc import Mapping
from typing import Any, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from cilqr_tpu_torch.ops import loop_cuda
from cilqr_tpu_torch.utils import profiling

aten = torch.ops.aten
#: the launch counters (module, attribute) of the kernels a graph may hold:
#: ``ops/lm_cuda``, ``riccati_cuda``, ``uncertainty_cuda``, ``sample_cuda``,
#: ``costmap_cuda`` and ``cost_cuda`` enter theirs on import
COUNTERS: list = []
_BUILDS = 0  # warm-ups and captures under way (``building``)
CAPTURES = 0     # ``GraphCache`` misses: captures made
CAPTURE_S = 0.0  # the seconds they took
EVICTIONS = 0    # captures dropped to make room for another
# ops that launch no kernel besides the views (``is_view``): a view its schema
# does not declare, and allocations (the first op to write the memory orders it)
_NO_KERNEL = {aten._unsafe_view, aten.empty, aten.empty_like, aten.empty_strided,
              aten.new_empty, aten.new_empty_strided}


@contextlib.contextmanager
def side_stream(device: torch.device):
    """Run the block on ``device``, on a side stream ordered after and
    before its current one: where a function is warmed up before its
    capture (PyTorch's recipe for ``torch.cuda.graph``)."""
    with torch.cuda.device(device):
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            yield
        main.wait_stream(side)


@contextlib.contextmanager
def building():
    """Marks a warm-up or a capture: inside, ``replayable`` is false."""
    global _BUILDS
    _BUILDS += 1
    try:
        yield
    finally:
        _BUILDS -= 1


def replayable(t: torch.Tensor) -> bool:
    """Whether a stage on t may replay a graph of its own: t lies on the
    card and no capture or warm-up is under way (inside one the stage runs
    eagerly, and that capture holds its kernels)."""
    return t.is_cuda and not _BUILDS


def copy_outputs(static, new) -> None:
    """Copies the tensors of ``new`` into those of ``static`` (the same
    nest): what a replay does to a graph's outputs, for a stand-in of
    ``capture`` that runs the function again."""
    for s, t in zip(tree_flatten(static)[0], tree_flatten(new)[0]):
        if isinstance(s, torch.Tensor) and s is not t:
            s.copy_(t)


class PlannedOp(NamedTuple):
    """One op that runs a kernel, as ``StreamPlanner`` placed it."""

    name: str
    stream: int
    seq: int            # its place on its stream
    reads: tuple        # keys of the storages of its tensor inputs
    writes: tuple       # keys of the storages it writes (written inputs, new outputs)
    waits: tuple        # indices of the ops its stream waited for before it


class PlanStats(NamedTuple):
    ops: int            # ops that run a kernel
    dag_chain: int      # longest chain of data dependencies, in ops
    plan_chain: int     # longest chain of the plan (dependencies and stream order)
    streams: int
    waits: int          # cross-stream waits (graph edges beyond stream order)


class StreamPlanner(TorchDispatchMode):
    """Places every op run under it on one of ``n`` streams.

    Dependencies are tracked by storage (a view shares its base's): an op
    waits for the last writer of what it reads, and an op that writes waits
    for the last writer and every reader since.  Ops that make views or
    only allocate take no stream.  An op continues the stream whose last op
    it depends on, else takes the stream where it can start first (each op
    counted as one unit of time).  A stream waits for an op of another
    stream only when no earlier wait already orders it (vector clocks).

    Memory: PyTorch's allocator hands a freed block again only to its own
    stream, which is safe while every use of the block lies on that stream.
    A storage that an op of another stream uses is kept (``kept``) until
    its own stream has waited for every such use; only then may it be
    freed.  A storage key carries a generation, so that memory reused by a
    new tensor is another key.

    ``streams``: the CUDA streams (the first the current one, where the
    others fork from and join back), or None to plan only (the ops run as
    they are, on the CPU in the tests).  ``released`` lists each storage
    let go as (key, its stream, the op after which it went)."""

    def __init__(self, n: int, streams=None):
        super().__init__()
        if n < 1 or (streams is not None and len(streams) != n):
            raise ValueError(f"{n} streams asked for, {streams} given")
        self.n, self.streams = n, streams
        self.ops: list[PlannedOp] = []
        self.kept: dict = {}          # storage -> a tensor on it, used on a foreign stream
        self.released: list = []
        self._events: list = []       # fork, joins
        self._op_event: list = []     # op -> the event recorded after it (CUDA)
        self._gen: dict = {}          # (device, address) -> generation of the storage there
        self._home: dict = {}         # storage made here -> the stream it was allocated on
        self._foreign: dict = {}      # kept storage -> {stream: last seq using it}
        self._writer: dict = {}       # storage -> index of its last writer
        self._readers: dict = {}      # storage -> readers since that write
        self._clock = [[-1] * n for _ in range(n)]  # stream -> last seq of each stream it follows
        self._op_clock: list = []     # op -> its stream's clock after it
        self._last = [None] * n       # stream -> index of its last op
        self._free = [0] * n          # stream -> unit time its last op ends
        self._end: list = []          # op -> unit time it ends
        self._dag_end: list = []      # op -> longest dependency chain ending with it

    def __enter__(self):
        if self.streams is not None:
            fork = torch.cuda.Event()
            fork.record(self.streams[0])
            for s in self.streams[1:]:
                s.wait_event(fork)
            self._events.append(fork)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self.streams is not None:
            for s in self.streams[1:]:
                join = torch.cuda.Event()
                join.record(s)
                self.streams[0].wait_event(join)
                self._events.append(join)
        return out

    def release(self) -> None:
        """Drop the tensors and events still kept (after the capture has
        ended)."""
        self.kept.clear()
        self._events.clear()
        self._op_event.clear()

    @property
    def stats(self) -> PlanStats:
        return PlanStats(len(self.ops), max(self._dag_end, default=0), max(self._end, default=0),
                         self.n, sum(len(o.waits) for o in self.ops))

    def _key(self, t: torch.Tensor, new: bool = False):
        """(device, address, generation) of t's storage; ``new``: t's storage
        was just allocated, at an address a dead storage may have had."""
        st = t.untyped_storage()
        if not st.nbytes():
            return None
        where = (t.device, st.data_ptr())
        if new:
            self._gen[where] = self._gen.get(where, -1) + 1
        return where + (self._gen.get(where, 0),)

    def _made(self, outs: list, ins: list, stream: int) -> set:
        """Keys of the storages among ``outs`` allocated by this op, none of
        the inputs' (an in-place op returns an input, a view shares one)."""
        old = {(t.device, t.untyped_storage().data_ptr()) for t in ins}
        made = set()
        for t in outs:
            if (t.device, t.untyped_storage().data_ptr()) not in old:
                k = self._key(t, new=True)
                if k is not None:
                    made.add(k)
                    self._home[k] = stream
        return made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        written = set()
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written.update(self._key(t) for t in tree_flatten(v)[0]
                               if isinstance(t, torch.Tensor))
        by_key = {self._key(t): t for t in ins}
        by_key.pop(None, None)
        reads = set(by_key)
        written.discard(None)
        if not written and (func.is_view or func.overloadpacket in _NO_KERNEL):
            out = func(*args, **kwargs)
            # allocations run on the current stream, the first
            self._made([t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)], ins, 0)
            return out

        deps = {self._writer[k] for k in reads | written if k in self._writer}
        for k in written:
            deps.update(self._readers.get(k, ()))
        ready = max((self._end[d] for d in deps), default=0)
        s = self._place(deps, ready)
        waits = []
        for d in sorted(deps, reverse=True):
            t, seq = self.ops[d].stream, self.ops[d].seq
            if self._clock[s][t] < seq:
                waits.append(d)
                self._clock[s] = [max(a, b) for a, b in zip(self._clock[s], self._op_clock[d])]
                if self.streams is not None:
                    self.streams[s].wait_event(self._op_event[d])
        if self.streams is not None:
            with torch.cuda.stream(self.streams[s]):
                out = func(*args, **kwargs)
            self._op_event.append(torch.cuda.Event())
            self._op_event[-1].record(self.streams[s])
        else:
            out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        new = self._made(outs, ins, s)
        i = len(self.ops)
        seq = self._clock[s][s] + 1
        self._clock[s][s] = seq
        self._op_clock.append(tuple(self._clock[s]))
        start = max(ready, self._free[s])
        self._free[s] = start + 1
        self._end.append(start + 1)
        self._dag_end.append(1 + max((self._dag_end[d] for d in deps), default=0))
        self._last[s] = i
        self.ops.append(PlannedOp(func.__name__, s, seq, tuple(reads), tuple(written | new),
                                  tuple(waits)))
        for k in reads - written:
            self._readers.setdefault(k, []).append(i)
        for k in written | new:
            self._writer[k] = i
            self._readers[k] = []
        for k in reads | written:
            if self._home.get(k, s) != s:
                self.kept.setdefault(k, by_key[k])
                self._foreign.setdefault(k, {})[s] = seq
        if waits:
            self._let_go(s, i)
        return out

    def _let_go(self, s: int, i: int) -> None:
        """Drop the kept storages of stream s whose every use on another
        stream its clock now covers: a block freed there goes back to s
        only, where each later op comes after those uses."""
        clock = self._clock[s]
        for k in [k for k in self.kept if self._home[k] == s
                  and all(clock[t] >= q for t, q in self._foreign[k].items())]:
            del self.kept[k], self._foreign[k]
            self.released.append((k, s, i))

    def _place(self, deps: set, ready: int) -> int:
        """The stream of an op ready at unit time ``ready``: the stream of
        a dependency that is that stream's last op, else the stream where
        it starts first (of those, the one free latest: the others stay
        free for ops that are ready sooner)."""
        cont = [s for s in range(self.n) if self._last[s] is not None and self._last[s] in deps]
        if cont:
            return max(cont, key=lambda s: self._end[self._last[s]])
        return min(range(self.n), key=lambda s: (max(ready, self._free[s]), -self._free[s], s))


def _counts() -> list:
    return [getattr(module, name) for module, name in COUNTERS]


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (a warm-up, a capture) leave the launch
    counters as they were."""
    before = _counts()
    try:
        yield
    finally:
        for (module, name), n in zip(COUNTERS, before):
            setattr(module, name, n)


def record_launches(fn) -> tuple:
    """Runs fn() (a capture records it); returns what it added to each
    counter of ``COUNTERS``, which it takes back."""
    before = _counts()
    with uncounted():
        fn()
        return tuple(a - b for a, b in zip(_counts(), before))


def count_launches(launches: tuple) -> None:
    """Adds ``record_launches``' counts to the counters (a replay)."""
    for (module, name), n in zip(COUNTERS, launches):
        if n:
            setattr(module, name, getattr(module, name) + n)


class Graph(torch.cuda.CUDAGraph):
    """A CUDA graph whose ``replay()`` also adds to the launch counters what
    its capture recorded (``launches``); ``out``: what the captured function
    returned, which each replay writes again."""

    launches: tuple = ()
    out: Any = None

    def replay(self):
        super().replay()
        count_launches(self.launches)


def capture(fn, device: torch.device, streams: int = 1) -> Graph:
    """fn() captured as a CUDA graph on ``device``; ``replay()`` runs its
    kernels again on the memory they were captured on, and ``out`` is what
    fn() returned.  With ``streams >
    1`` the ops run under a ``StreamPlanner`` of that many streams, and the
    graph's ``stats`` (``PlanStats``; None on one stream) describe its plan.
    ``pool_bytes`` is the memory the graph's pool took; ``launches`` what
    fn() added to each counter of ``COUNTERS``, which the capture takes back
    and each replay adds.  The graph is instantiated and also kept as
    captured (``raw_cuda_graph()``, which a ``Loop`` copies).  A failed
    capture raises."""
    graph = Graph(keep_graph=True)
    with torch.cuda.device(device):
        # a capture stream of the device's own (torch.cuda.graph's default
        # one belongs to whichever device was current at its first use)
        stream = torch.cuda.Stream()
        planner = None if streams == 1 else StreamPlanner(
            streams, [stream] + [torch.cuda.Stream() for _ in range(streams - 1)])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as torch.cuda.graph does before it captures
        reserved = torch.cuda.memory_reserved(device)
        out = []
        try:
            with building(), torch.cuda.graph(graph, stream=stream), \
                    planner or contextlib.nullcontext():
                graph.launches = record_launches(lambda: out.append(fn()))
        finally:
            if planner is not None:
                planner.release()
        graph.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        graph.instantiate()
    graph.out = out[0]
    graph.stats = planner and planner.stats
    return graph


class Loop:
    """``while v: step.replay()`` with v = ``loop_cuda.lm_continue`` on
    ``done`` and a step count ``steps`` of its own (each launch resets it):
    the loop of ``jax.lax.while_loop``, ``max_iterations`` steps at most.
    On the card one launch of the loop graph (``loop_cuda.loop_graph``
    around the step graph's ``raw_cuda_graph()``) runs it all, and the host
    reads nothing in between; for a ``done`` on the CPU, ``launch()`` is the
    plain version: the host replays ``step`` while ``lm_continue_plain``
    holds.  ``count()`` reads ``steps`` (on the card the one host read) and
    on the card adds ``steps`` times the step graph's ``launches`` to the
    counters (the plain version's replays have added them) and the
    condition's runs (steps + 1) to ``loop_cuda.LAUNCHES``.  It holds the
    step graph and ``steps``, so the memory the loop graph reads stays
    valid; the loop graph goes with the last reference (``GraphCache``
    eviction)."""

    def __init__(self, step, done: torch.Tensor, max_iterations: int):
        self.step, self.done, self.max_iterations = step, done, max_iterations
        self.steps = torch.zeros(1, dtype=torch.int32, device=done.device)
        self.stats = None  # ``loop_cuda.LoopStats`` on the card
        self._handles = None
        if done.is_cuda:
            graph, exec_, self.stats = loop_cuda.loop_graph(
                step.raw_cuda_graph(), done, self.steps, max_iterations)
            self._handles = (graph, exec_)

    def launch(self) -> None:
        """The loop, enqueued on the current stream (the plain version runs
        it)."""
        if self._handles is None:
            self.steps.zero_()
            while bool(loop_cuda.lm_continue_plain(self.done, self.steps, self.max_iterations)):
                self.step.replay()
            return
        loop_cuda.launch(self._handles[1], self.done.device)

    def count(self) -> int:
        """The steps the last launch ran, counted (see the class)."""
        n = int(self.steps)
        if self._handles is not None:
            count_launches(tuple(n * c for c in self.step.launches))
            loop_cuda.LAUNCHES += n + 1
        return n

    def __del__(self):
        # at the interpreter's exit the process's graphs go with its context
        if self._handles is not None and not sys.is_finalizing():
            loop_cuda.destroy(*self._handles)
            self._handles = None


class Captured(NamedTuple):
    """One entry of a ``GraphCache``: the graphs read ``inputs`` and write
    ``out``; ``loop``, where there is one, runs the step graph of an LM loop
    (``graphs[1]``) on the card."""

    inputs: list   # static copies of the tensors of the call
    graphs: tuple  # the CUDA graphs
    out: Any       # the tensors the graphs write
    held: Any      # what else they read (kept alive with them)
    loop: Any = None  # a ``Loop``


class GraphCache(Mapping):
    """Captures by key, at most ``kept`` of them: the oldest goes first, and
    with it the memory pool its graphs hold (``clear`` drops them all)."""

    def __init__(self, kept: int = 8):
        self.kept = kept
        self._entries: dict = {}

    def __getitem__(self, key) -> Captured:
        return self._entries[key]

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def load(self, key, args: list, make) -> Captured:
        """The capture of ``key`` with the tensors ``args`` copied into its
        inputs.  On a miss ``make(inputs) -> (graphs, out, held)`` or
        ``(graphs, out, held, loop)`` captures it on ``inputs``, clones of
        ``args`` (counted: ``CAPTURES``, ``CAPTURE_S``, ``EVICTIONS``)."""
        global CAPTURES, CAPTURE_S, EVICTIONS
        entry = self._entries.get(key)
        if entry is None:
            while len(self._entries) >= self.kept:
                self._entries.pop(next(iter(self._entries)))
                EVICTIONS += 1
            t0 = time.perf_counter()
            with profiling.span("capture"):
                inputs = [a.clone() for a in args]
                entry = self._entries[key] = Captured(inputs, *make(inputs))
            CAPTURES += 1
            CAPTURE_S += time.perf_counter() - t0
        for s, a in zip(entry.inputs, args):
            s.copy_(a)
        return entry
