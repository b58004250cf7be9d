"""What the traffic modules share: the lanes and calls a check samples from the
seed, the inputs of the traced calls drawn before the window, the warm-up on
another draw stream, and the count of failed answers."""

from __future__ import annotations

import numpy as np
import torch


def lanes(seed: int, batch: int, count: int, device) -> torch.Tensor:
    """``count`` distinct lanes of ``batch``, drawn from the seed, sorted."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.sort(rng.choice(batch, count, replace=False))).to(device)


class Reservoir:
    """A uniform sample of ``size`` of a window's calls, drawn from the seed
    as the calls come (Algorithm R): a run keeps the answers of a fixed
    number of calls, however many calls its window holds."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([seed, 1])
        self.size, self.items = size, []

    def offer(self, k: int, part) -> None:
        """Call ``k``'s kept parts: ``part()``, made only if the call is drawn."""
        if k < self.size:
            self.items.append(part())
            return
        j = int(self.rng.integers(0, k + 1))
        if j < self.size:
            self.items[j] = part()

    def joined(self) -> list:
        """Each part concatenated over the kept calls."""
        return [torch.cat(p) for p in zip(*self.items)]


class Traffic:
    """The per-seed state of a traffic module: ``reseed(seed)`` starts the
    draws of ``seed``; the inputs of the first ``trace_calls`` calls are
    drawn at once, before the window, so that a traced window holds the
    program's work alone.  A subclass sets ``cell``, ``dev``, ``B`` and
    defines ``draw()``."""

    def reseed(self, seed: int) -> None:
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.lanes = lanes(seed, self.B, self.cell["check_lanes"], self.dev)
        self.kept = Reservoir(seed, self.cell["check_calls"])
        self.failed = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.traced = []
        self.pre = [self.draw() for _ in range(self.cell["trace_calls"])]

    def inputs(self, k: int):
        return self.pre[k] if k < len(self.pre) else self.draw()


def warm_up(state, seed: int, calls: int) -> None:
    """``calls`` calls on the draws of another seed (the first captures the
    graphs, the next replay them), then the draws of ``seed`` from their
    start."""
    state.reseed(seed ^ 0x5EED)
    for k in range(calls):
        state.keep(k, state.call(k))
    if state.dev.type == "cuda":
        torch.cuda.synchronize(state.dev)
    state.reseed(seed)


def failed(*outputs) -> torch.Tensor:
    """Lanes (leading axis) with a non-finite value in any of ``outputs``."""
    ok = torch.stack([torch.isfinite(t).flatten(1).all(1) for t in outputs]).all(0)
    return (~ok).sum()
