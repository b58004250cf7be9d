"""Global <-> vehicle frame path transforms.

Port of ``cilqr_tpu/utils/frames.py``; reference semantics
``ilqr_uncertainty_node.cpp:286-313`` (``pathInGlobal2Vechicle`` /
``pathInVechicle2Global``).

NOTE (reference quirk): the C++ pair is *not* a mutually-inverse rotation —
both directions use ``sin*dx - cos*dy`` / ``x*sin - y*cos`` for the y
component, i.e. each applies a reflection across the heading axis (the pair
composes to identity only because the reflection is involutive).  The
faithful functions reproduce that; the ``*_rot`` variants are the proper
rotations.  path_xy (..., 2), ego_state (4,); functions of tensors, they
follow their tensors' device.
"""

from __future__ import annotations

import torch


def _split(ego_state: torch.Tensor):
    return ego_state[0], ego_state[1], torch.cos(ego_state[3]), torch.sin(ego_state[3])


def global_to_vehicle(path_xy: torch.Tensor, ego_state: torch.Tensor) -> torch.Tensor:
    """Faithful pathInGlobal2Vechicle (ilqr_uncertainty_node.cpp:286-299):
    x' = dx cos + dy sin;  y' = dx sin - dy cos  (reflected!)."""
    ex, ey, c, s = _split(ego_state)
    dx, dy = path_xy[..., 0] - ex, path_xy[..., 1] - ey
    return torch.stack([dx * c + dy * s, dx * s - dy * c], dim=-1)


def vehicle_to_global(path_xy: torch.Tensor, ego_state: torch.Tensor) -> torch.Tensor:
    """Faithful pathInVechicle2Global (ilqr_uncertainty_node.cpp:301-313):
    x = ex + x' cos + y' sin;  y = ey + x' sin - y' cos  (reflected!)."""
    ex, ey, c, s = _split(ego_state)
    px, py = path_xy[..., 0], path_xy[..., 1]
    return torch.stack([ex + px * c + py * s, ey + px * s - py * c], dim=-1)


def global_to_vehicle_rot(path_xy: torch.Tensor, ego_state: torch.Tensor) -> torch.Tensor:
    """Proper rotation into the vehicle frame (no reflection)."""
    ex, ey, c, s = _split(ego_state)
    dx, dy = path_xy[..., 0] - ex, path_xy[..., 1] - ey
    return torch.stack([dx * c + dy * s, -dx * s + dy * c], dim=-1)


def vehicle_to_global_rot(path_xy: torch.Tensor, ego_state: torch.Tensor) -> torch.Tensor:
    """Proper rotation back to the global frame (inverse of the above)."""
    ex, ey, c, s = _split(ego_state)
    px, py = path_xy[..., 0], path_xy[..., 1]
    return torch.stack([ex + px * c - py * s, ey + px * s + py * c], dim=-1)
