"""Where the port's constructors put their tensors.

The port runs on the card: a constructor whose ``device`` argument is left
unset allocates on ``cuda``.  A caller who wants the CPU says so
(``device="cpu"``), as the CPU tests do.  Nothing here asks whether a card
is present and nothing falls back: without one, PyTorch's own allocation
fails with PyTorch's own error.  Functions that take tensors follow their
tensors' device and do not come through here.
"""

from __future__ import annotations

import functools

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given."""
    return torch.device("cuda" if device is None else device)


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once and
    shared: read it, never write it.  Code that a CUDA graph captures reads
    its constants so (a copy from the host cannot be captured: the warm-up
    before the capture makes them)."""
    return torch.tensor(values, dtype=dtype, device=device)
