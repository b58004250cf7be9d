"""CUDA graphs of plain PyTorch code, captured once per key and replayed.

A loop of small kernels costs the host ~15-25 us per PyTorch op; replayed
as a CUDA graph the same kernels run on the same inputs (the same bits)
with one launch from the host.  ``models.solver`` (the plain LM loop) and
``models.nrb_rrt`` (the planner) capture their work this way, each in a
``GraphCache`` of its own.  A capture fails on any host-to-device copy or
host synchronisation inside it, so the constants a captured function reads
are made in its warm-up, before the capture.  Warm-up and capture run on
the inputs' device, whichever device is current: a sharded solve calls
the same function on each card in turn.

Captured on one stream, a graph runs its kernels one after another.  With
``streams > 1`` the capture follows the data: ``StreamPlanner`` puts each
op on one of several streams and orders it after the ops it depends on
(read after write, write after read, write after write, by storage) with
events, which the capture turns into the graph's edges.  The kernels and
their inputs are the same, so are the bits; independent kernels overlap.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Any, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten
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


def capture(fn, device: torch.device, streams: int = 1) -> torch.cuda.CUDAGraph:
    """fn() captured as a CUDA graph on ``device``; ``replay()`` runs its
    kernels again on the memory they were captured on.  With ``streams >
    1`` the ops run under a ``StreamPlanner`` of that many streams, and the
    graph's ``stats`` (``PlanStats``; None on one stream) describe its plan.
    ``pool_bytes`` is the memory the graph's pool took.  A failed capture
    raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        # a capture stream of the device's own (torch.cuda.graph's default
        # one belongs to whichever device was current at its first use)
        stream = torch.cuda.Stream()
        planner = None if streams == 1 else StreamPlanner(
            streams, [stream] + [torch.cuda.Stream() for _ in range(streams - 1)])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as torch.cuda.graph does before it captures
        reserved = torch.cuda.memory_reserved(device)
        try:
            with torch.cuda.graph(graph, stream=stream), planner or contextlib.nullcontext():
                fn()
        finally:
            if planner is not None:
                planner.release()
        graph.pool_bytes = torch.cuda.memory_reserved(device) - reserved
    graph.stats = planner and planner.stats
    return graph


class Captured(NamedTuple):
    """One entry of a ``GraphCache``: the graphs read ``inputs`` and write
    ``out``."""

    inputs: list   # static copies of the tensors of the call
    graphs: tuple  # the CUDA graphs
    out: Any       # the tensors the graphs write
    held: Any      # what else they read (kept alive with them)


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
        inputs.  On a miss ``make(inputs) -> (graphs, out, held)`` captures
        it on ``inputs``, clones of ``args``."""
        entry = self._entries.get(key)
        if entry is None:
            while len(self._entries) >= self.kept:
                self._entries.pop(next(iter(self._entries)))
            inputs = [a.clone() for a in args]
            entry = self._entries[key] = Captured(inputs, *make(inputs))
        for s, a in zip(entry.inputs, args):
            s.copy_(a)
        return entry
