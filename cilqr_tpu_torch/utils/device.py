"""Where the port's constructors put their tensors.

The port runs on the card: a constructor whose ``device`` argument is left
unset allocates on ``cuda``.  A caller who wants the CPU says so
(``device="cpu"``), as the CPU tests do.  Nothing here asks whether a card
is present and nothing falls back: without one, PyTorch's own allocation
fails with PyTorch's own error.  Functions that take tensors follow their
tensors' device and do not come through here.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given."""
    return torch.device("cuda" if device is None else device)
