"""Visualization utilities (matplotlib, headless).

Port of ``cilqr_tpu/utils/viz.py``: the reference's plotting surface, the
safety-ellipse figure (``ilqr/src/visulization.py:1-34``: vehicle rectangle
vs the rotated-ellipse safety set) and the planner-path / experiment plot
that the RViz markers and ``plot_positions_with_obstacles``
(dataprocess.py:41-69) provided.  matplotlib is imported when a plot is
drawn, not with the module: where it is not installed, a plot raises
``ModuleNotFoundError`` and nothing else is affected.  Records may hold
tensors on any device.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def plot_safety_ellipse(p, obstacle_length=3.63, obstacle_width=1.84,
                        obstacle_speed=0.0, obstacle_yaw=0.0, path=None):
    """Vehicle rectangle vs the barrier ellipse (visulization.py:1-34 +
    Obstacle.cpp:42-43 axis formulas)."""
    plt = _mpl()
    a = obstacle_length / 2 + abs(obstacle_speed * np.cos(obstacle_yaw)) * p.t_safe \
        + p.s_safe_a + p.ego_rad
    b = obstacle_width / 2 + abs(obstacle_speed * np.sin(obstacle_yaw)) * p.t_safe \
        + p.s_safe_b + p.ego_rad + 1.0
    th = np.linspace(0, 2 * np.pi, 200)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(a * np.cos(th), b * np.sin(th), label=f"safety ellipse a={a:.2f} b={b:.2f}")
    hl, hw = obstacle_length / 2, obstacle_width / 2
    ax.plot([-hl, hl, hl, -hl, -hl], [-hw, -hw, hw, hw, -hw], "r-", label="obstacle")
    ax.set_aspect("equal")
    ax.legend()
    ax.grid(True)
    if path:
        fig.savefig(path, dpi=100)
    plt.close(fig)
    return a, b


def plot_run(record, obstacles_xyyaw=None, obstacle_size=(3.63, 1.84), path=None):
    """Ego trace + planned trajectories + obstacle rectangles
    (the RViz /ILQR_Path markers + dataprocess scatter, headless)."""
    plt = _mpl()
    get = record.__getitem__ if isinstance(record, dict) else lambda k: getattr(record, k)
    sp, X = _np(get("start_pos")), _np(get("X"))
    fig, ax = plt.subplots(figsize=(8, 5))
    for t in range(0, X.shape[0], max(1, X.shape[0] // 10)):
        ax.plot(X[t, :, 0], X[t, :, 1], color="0.8", lw=0.8)
    ax.plot(sp[:, 0], sp[:, 1], "b.-", label="driven")
    if obstacles_xyyaw is not None:
        L, W = obstacle_size
        for x, y, yaw in _np(obstacles_xyyaw):
            c, s = np.cos(yaw), np.sin(yaw)
            cor = np.array([[-L/2, -W/2], [L/2, -W/2], [L/2, W/2], [-L/2, W/2], [-L/2, -W/2]])
            gx = cor[:, 0] * c - cor[:, 1] * s + x
            gy = cor[:, 0] * s + cor[:, 1] * c + y
            ax.plot(gx, gy, "r-")
    ax.set_aspect("equal")
    ax.legend()
    ax.grid(True)
    if path:
        fig.savefig(path, dpi=100)
    plt.close(fig)
