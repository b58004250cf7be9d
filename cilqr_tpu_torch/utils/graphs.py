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
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Any, NamedTuple

import torch


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


def capture(fn, device: torch.device) -> torch.cuda.CUDAGraph:
    """fn() captured as a CUDA graph on ``device``; ``replay()`` runs its
    kernels again on the memory they were captured on.  A failed capture
    raises."""
    graph = torch.cuda.CUDAGraph()
    # a capture stream of the device's own (torch.cuda.graph's default one
    # belongs to whichever device was current at its first use)
    with torch.cuda.device(device), torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        fn()
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
