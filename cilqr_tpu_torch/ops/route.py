"""On the card: each hand-written kernel, or its plain version.

Every kernel wrapper under ``ops/`` launches its kernel on CUDA tensors.
Inside ``plain()`` it runs its plain PyTorch version on the card instead,
on the same arguments.  The comparisons that hold a kernel to its plain
version on the card (``chip_smoke.py``, the ``cuda`` tests) open such a
block, as do the float64 grids of ``scripts/production_sweeps`` (the
kernels take float32 only); the program's own paths never open one.  The
CUDA graphs of ``models.solver`` hold ``plain_on_card()`` in their key and
run their stages eagerly inside a block, so a graph captured on the
kernels is never replayed on the plain versions, nor the reverse.  Blocks
nest.  On the CPU the wrappers run the plain versions whether or not a
block is open.
"""

from __future__ import annotations

import contextlib

_DEPTH = 0  # plain() blocks open


@contextlib.contextmanager
def plain():
    """Inside: every kernel wrapper runs its plain version on the card."""
    global _DEPTH
    _DEPTH += 1
    try:
        yield
    finally:
        _DEPTH -= 1


def plain_on_card() -> bool:
    """Whether a ``plain()`` block is open."""
    return _DEPTH > 0
