"""Scripted experiment scenarios — the CARLA spawn tables, CARLA-free.

A copy of ``cilqr_tpu/sim/scenarios.py`` (NumPy only), kept equal to it by
``tests/test_torch_experiment.py``; the port imports nothing of the JAX
package.

Obstacle poses come from the reference's two sources, reconciled to the
planner's map frame: y is negated relative to the CARLA spawn tables while
the yaw values are carried over unchanged (in radians) — exactly the
``dataprocess.py:290-304`` obstacle table vs the spawns at
``vehiclepub/scripts/main.py:142-171``:

  * ``long``:      9 obstacles along the Town02 loop (main.py:142-157)
  * ``compare``:   1 obstacle (main.py:158-159)
  * ``success1-3``: 3-obstacle slalom variants (main.py:160-171)

Obstacle footprint 3.63 x 1.84 m (the Nissan blueprint's bbox recorded in
``dataprocess.py:290-304``).  The four spatial evaluation windows mirror
``dataprocess.py:311-322``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

OBSTACLE_LENGTH = 3.63
OBSTACLE_WIDTH = 1.84

# (x, y, yaw) in the planner map frame (y = -y_carla, yaw = -yaw_carla)
_SCENARIOS: Dict[str, List[Tuple[float, float, float]]] = {
    "long": [
        (123.32, -306.74, 0.0),
        (103.32, -306.74, 0.0),
        (193.9, -230.74, -np.pi / 2.0),
        (190.5, -190.74, np.pi * 4.0 / 3.0),
        (189.6, -210.74, np.pi / 2.0),
        (189.2, -111.6, np.pi * 230.0 / 180.0),
        (123.4, -105.0, np.pi),
        (103.4, -105.0, np.pi),
        (83.4, -105.0, np.pi),
    ],
    "compare": [
        (72.32, -306.74, 0.0),
    ],
    "success1": [
        (93.32, -305.74, 0.0),
        (108.32, -303.74, 0.0),
        (123.32, -305.74, 0.0),
    ],
    "success2": [
        (88.32, -305.74, 0.0),
        (108.32, -303.74, 0.0),
        (128.32, -305.74, 0.0),
    ],
    "success3": [
        (93.32, -305.99, 0.0),
        (108.32, -303.49, 0.0),
        (123.32, -305.99, 0.0),
    ],
}

# Evaluation windows ((start_xy), (end_xy)) — dataprocess.py:311-322
EVAL_WINDOWS = {
    1: ((113.0, -310.0), (133.0, -300.0)),
    2: ((179.0, -240.0), (203.0, -180.0)),
    3: ((179.0, -121.0), (199.0, -101.0)),
    4: ((73.0, -115.0), (133.0, -95.0)),
}


#: Per-scenario ego spawn [x, y, v, yaw] — the "change start position" step
#: of the reference bring-up (CILQR/src/README.md; the ros-bridge spawn is
#: edited per scenario).  The compare obstacle sits at x=72.32, so its run
#: starts further back; everything else starts at the lane head.
_STARTS: Dict[str, Tuple[float, float, float, float]] = {
    "long": (60.0, -306.74, 4.0, 0.0),
    "compare": (50.0, -306.74, 4.0, 0.0),
    "success1": (70.0, -306.74, 4.0, 0.0),
    "success2": (70.0, -306.74, 4.0, 0.0),
    "success3": (70.0, -306.74, 4.0, 0.0),
}


def _no_walls() -> np.ndarray:
    return np.zeros((0, 3), dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Obstacle table + optional SAT-only walls.

    ``walls_xyyaw`` are physical barriers the *planner's ellipse-barrier
    channel never sees*: they enter the SAT collision ground truth and the
    costmap bbox rasterization (like CARLA scenery hit by the collision
    sensor, vehiclepub/scripts/main.py:65-75), so only costmap-consuming
    algorithm variants (`cilqr`, `frenet_propagation`) can perceive them.
    This is the information asymmetry the reference's CILQR vs CILQR_Base
    ablation measures (batch_dataprocess.py:459-475): the uncertainty map
    is the base planner's ONLY missing sensor.
    """

    name: str
    obstacles_xyyaw: np.ndarray  # (M, 3)
    obstacle_size: Tuple[float, float] = (OBSTACLE_LENGTH, OBSTACLE_WIDTH)
    start: Tuple[float, float, float, float] = (70.0, -306.74, 4.0, 0.0)
    walls_xyyaw: np.ndarray = dataclasses.field(default_factory=_no_walls)
    wall_size: Tuple[float, float] = (90.0, 0.4)
    #: drivable lateral band (wall inner faces) relative to the reference
    #: line — lane-boundary knowledge every planner has from the route/map
    #: (rotation-invariant, carried through ``rotate_scenario``).  Sampling
    #: planners restrict lateral targets to it minus the ego half-width
    #: (``runner.nrb_params_for_scenario``); None = unbounded.
    lat_band: Tuple[float, float] = None

    @property
    def n_obstacles(self) -> int:
        return self.obstacles_xyyaw.shape[0]

    @property
    def n_walls(self) -> int:
        return self.walls_xyyaw.shape[0]


def make_gauntlet(
    wall_faces=(-2.1, 5.0),
    offsets=(3.3, 3.3),
    xs=(100.0, 125.0),
    y_center: float = -306.74,
    x_span=(65.0, 155.0),
    wall_thickness: float = 2.0,
) -> Scenario:
    """The sigma-sweep scenario: squeeze past parked cars along a wall the
    base planner cannot see.

    An asymmetric corridor — the lane runs ``|wall_faces[0]|`` from the
    lower wall's inner face — with cars parked on the wide side, forcing
    the ego to squeeze between each car's ellipse barrier and the near
    wall.  The walls are SAT+costmap-only (see Scenario docstring): the
    uncertainty-aware planner perceives the near wall through the
    propagated costmap (smear reach grows with chi * sigma, i.e. with the
    localization noise), the blind baseline dodges the cars straight into
    it.  The dodge direction is unambiguous (the wide-side gap between car
    and far wall is narrower than the ego), so outcome differences isolate
    the uncertainty term rather than side-commitment luck.
    """
    cars = np.asarray(
        [(x, y_center + off, 0.0) for x, off in zip(xs, offsets)], np.float64
    )
    x_mid = 0.5 * (x_span[0] + x_span[1])
    walls = np.asarray(
        [(x_mid, y_center + wall_faces[0] - wall_thickness / 2.0, 0.0),
         (x_mid, y_center + wall_faces[1] + wall_thickness / 2.0, 0.0)],
        np.float64,
    )
    return Scenario(
        "gauntlet",
        cars,
        start=(70.0, y_center, 4.0, 0.0),
        walls_xyyaw=walls,
        wall_size=(x_span[1] - x_span[0], wall_thickness),
        lat_band=(float(wall_faces[0]), float(wall_faces[1])),
    )


def rotate_scenario(
    sc: Scenario, plan: np.ndarray, angle: float,
    origin: Tuple[float, float] = None,
) -> Tuple[Scenario, np.ndarray]:
    """Rigidly rotate a scenario and its global route by ``angle`` about
    ``origin`` (default: the scenario start position).

    Used to prove uncertainty-term separations are NOT axis-aligned
    artifacts: the gauntlet sweep rerun on a rotated corridor (the
    synthetic-h301 rotated-corridor class, utils/maps.make_synthetic_site)
    must show the same collision/clearance split.  All poses — obstacles,
    walls, ego spawn, route waypoints — rotate together; wall OBB yaws pick
    up the rotation so SAT collision and the OBB wall-clearance metric stay
    exact.
    """
    if origin is None:
        origin = (sc.start[0], sc.start[1])
    o = np.asarray(origin, np.float64)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])

    def rot_poses(xyyaw: np.ndarray) -> np.ndarray:
        if xyyaw.shape[0] == 0:
            return xyyaw
        out = xyyaw.copy()
        out[:, :2] = (xyyaw[:, :2] - o) @ R.T + o
        out[:, 2] = xyyaw[:, 2] + angle
        return out

    start_xy = (np.asarray(sc.start[:2]) - o) @ R.T + o
    rotated = dataclasses.replace(
        sc,
        name=f"{sc.name}_rot{angle:.2f}",
        obstacles_xyyaw=rot_poses(np.asarray(sc.obstacles_xyyaw, np.float64)),
        walls_xyyaw=rot_poses(np.asarray(sc.walls_xyyaw, np.float64)),
        start=(float(start_xy[0]), float(start_xy[1]), sc.start[2],
               sc.start[3] + angle),
    )
    plan_rot = (np.asarray(plan, np.float64) - o) @ R.T + o
    return rotated, plan_rot


def get_scenario(name: str) -> Scenario:
    if name == "gauntlet":
        return make_gauntlet()
    if name not in _SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(_SCENARIOS) + ['gauntlet']}")
    return Scenario(
        name,
        np.asarray(_SCENARIOS[name], dtype=np.float64),
        start=_STARTS.get(name, (70.0, -306.74, 4.0, 0.0)),
    )


def plan_for(name: str, spacing: float = 1.0) -> np.ndarray:
    """The global route a scenario is driven on: the Town02 loop for
    ``long``, the straight south leg for everything else."""
    if name == "long":
        return town02_loop_plan(spacing)
    return straight_lane_plan(spacing=spacing)


def scenario_names() -> List[str]:
    return sorted(_SCENARIOS) + ["gauntlet"]


def straight_lane_plan(x0=60.0, y=-306.74, length=150.0, spacing=1.0) -> np.ndarray:
    """(n, 2) straight global plan along the ``long``/``compare`` first leg."""
    n = int(length / spacing) + 1
    xs = x0 + spacing * np.arange(n)
    return np.stack([xs, np.full(n, y)], axis=1)


def town02_loop_plan(spacing: float = 1.0) -> np.ndarray:
    """(n, 2) route through the full ``long`` scenario corridor.

    The reference gets this route from the CARLA ros-bridge waypoint
    publisher on Town02 (`/carla/ego_vehicle/waypoints`,
    ilqr_uncertainty_node.cpp:14); CARLA-free, we synthesize the same
    C-shaped circuit the `long` spawn table traces
    (vehiclepub/scripts/main.py:142-157, poses y-negated like _SCENARIOS):
    east along y=-306.74 (x 60->184), north along x~190 (y -300->-112),
    then west along y=-105 (x 183->70), with quarter-circle corners.
    """
    r = 6.0  # corner radius [m]
    y_s, x_e, y_n = -306.74, 190.14, -105.0

    def arc(cx, cy, a0, a1, n):
        a = np.linspace(a0, a1, n)
        return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)

    n_arc = max(int(r * np.pi / 2.0 / spacing) + 1, 4)
    # leg 1: east along the south road
    x1 = np.arange(60.0, x_e - r, spacing)
    leg1 = np.stack([x1, np.full_like(x1, y_s)], axis=1)
    # corner 1: south-east, turning from +x heading to +y heading
    c1 = arc(x_e - r, y_s + r, -np.pi / 2.0, 0.0, n_arc)
    # leg 2: north along the east road
    y2 = np.arange(y_s + r, y_n - r, spacing)
    leg2 = np.stack([np.full_like(y2, x_e), y2], axis=1)
    # corner 2: north-east, turning from +y heading to -x heading
    c2 = arc(x_e - r, y_n - r, 0.0, np.pi / 2.0, n_arc)
    # leg 3: west along the north road
    x3 = np.arange(x_e - r, 70.0, -spacing)
    leg3 = np.stack([x3, np.full_like(x3, y_n)], axis=1)
    return np.concatenate([leg1, c1[1:], leg2[1:], c2[1:], leg3[1:]], axis=0)
