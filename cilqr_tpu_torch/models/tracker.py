"""Constant-velocity bounding-box Kalman tracker.

Reference semantics: the OpenCV KalmanFilter wired into the costmap node
(``local_costmap.cpp:138-159`` setup, ``bboxCallback`` :328-394): 6 states
[cx, cy, w, h, vx, vy], 4 measurements [cx, cy, w, h], a transition adding
the velocity to the position, Q = 1e-5 I, R = 1e-1 I, P0 = I.  The port of
``cilqr_tpu/models/tracker.py``; the state may carry leading scenario dims
(one filter per scenario).  The 6x6 products are ``torch.matmul`` /
``torch.linalg.solve_ex`` in full float32 precision (PyTorch's default; TF32
stays off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cilqr_tpu_torch.utils.device import resolve


class KFState(NamedTuple):
    x: torch.Tensor  # (..., 6) [cx, cy, w, h, vx, vy]
    P: torch.Tensor  # (..., 6, 6)


def _matrices(like: torch.Tensor):
    kw = dict(dtype=like.dtype, device=like.device)
    # transition (local_costmap.cpp:145-152): x, y integrate vx, vy; w, h constant
    F = torch.eye(6, **kw)
    F[0, 4].fill_(1.0)  # fills: a copy from the host cannot be captured
    F[1, 5].fill_(1.0)
    H = torch.zeros((4, 6), **kw)
    H[:4, :4] = torch.eye(4, **kw)
    Q = 1e-5 * torch.eye(6, **kw)
    R = 1e-1 * torch.eye(4, **kw)
    return F, H, Q, R


def init(dtype=torch.float32, x0=None, batch=(), device=None) -> KFState:
    """A fresh filter (P = I), or ``batch`` of them: x (*batch, 6)."""
    device = resolve(device)
    batch = tuple(batch)
    if x0 is None:
        x = torch.zeros(batch + (6,), dtype=dtype, device=device)
    else:
        x = torch.as_tensor(x0, dtype=dtype, device=device).expand(batch + (6,)).clone()
    P = torch.eye(6, dtype=dtype, device=device).expand(batch + (6, 6)).clone()
    return KFState(x, P)


def predict(s: KFState) -> KFState:
    F, _, Q, _ = _matrices(s.x)
    return KFState((F @ s.x[..., None])[..., 0], F @ s.P @ F.T + Q)


def correct(s: KFState, z: torch.Tensor) -> KFState:
    _, H, _, R = _matrices(s.x)
    y = z - (H @ s.x[..., None])[..., 0]
    S = H @ s.P @ H.T + R
    PHt = s.P @ H.T
    # K = P H^T S^-1 without forming the inverse
    # solve_ex: the solve without its error check, which would wait for the
    # card (S is positive definite)
    K = torch.linalg.solve_ex(S.transpose(-1, -2), PHt.transpose(-1, -2)).result
    K = K.transpose(-1, -2)
    x = s.x + (K @ y[..., None])[..., 0]
    P = (torch.eye(6, dtype=s.x.dtype, device=s.x.device) - K @ H) @ s.P
    return KFState(x, P)


def step(s: KFState, z: torch.Tensor, valid: torch.Tensor):
    """predict + correct if valid, else coast -> (new state, smoothed box
    (..., 4) [cx, cy, w, h]).

    ``valid`` is the bbox sanity gate: on an out-of-range measurement the
    reference clears the rasterized layer and leaves the filter untouched
    (local_costmap.cpp:331-336), so the track coasts and the returned box
    is zero (nothing to rasterize)."""
    sc = correct(predict(s), z)
    x = torch.where(valid[..., None], sc.x, s.x)
    P = torch.where(valid[..., None, None], sc.P, s.P)
    box = torch.where(valid[..., None], x[..., :4], torch.zeros_like(x[..., :4]))
    return KFState(x, P), box


def track(zs: torch.Tensor, valids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Run the tracker over a (T, 4) measurement stream, on its device:
    (T, 4) smoothed boxes."""
    zs = zs.to(dtype)
    x0 = torch.cat([zs[0], torch.zeros(2, dtype=dtype, device=zs.device)])
    s = init(dtype=dtype, x0=x0, device=zs.device)
    boxes = []
    for z, v in zip(zs, valids):
        s, box = step(s, z, v)
        boxes.append(box)
    return torch.stack(boxes)
