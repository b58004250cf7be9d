"""Configuration dataclasses of the PyTorch port.

The port's own copy of ``cilqr_tpu/utils/params.py``: the same three frozen
dataclasses with the same fields, defaults and properties, so a parameter
set carries across unchanged (``utils.interop.*_params_from_reference``).
The port imports nothing of the JAX package, so it does not share the
module.  Fields that only the JAX package acts on (``scan_unroll``) are
kept for that reason.

One frozen, hashable dataclass replaces the reference's three uncoordinated
config layers (hardcoded ``Parameters`` defaults at
``CILQR/src/ilqr/include/ilqr/Parameters.cpp:3-75``, rosparam overrides at
``ilqr_uncertainty_node.cpp:29-34`` and dynamic_reconfigure at
``map_engine/cfg/map_engine.cfg:8-15``).  The kernels take the numeric
weights as launch constants (``ops/lm_cuda._config``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """CILQR solver configuration.

    Defaults mirror ``Parameters::Parameters()`` exactly
    (``CILQR/src/ilqr/include/ilqr/Parameters.cpp:3-75``) plus the launch-file
    overrides applied by the planner node
    (``ilqr/launch/Experiment.launch:7-12``: safe_length=1.1, safe_width=0.9
    are *not* folded in here; they default to 0 as in the C++ ctor).
    """

    # planning parameters (Parameters.cpp:6-8)
    num_of_local_wpts: int = 20
    poly_order: int = 5
    desired_speed: float = 5.0

    # iLQR parameters (Parameters.cpp:11-16)
    timestep: float = 0.1
    horizon: int = 40
    tolerance: float = 1e-4
    max_iterations: int = 20
    num_states: int = 4
    num_ctrls: int = 2

    # cost weights (Parameters.cpp:19-26)
    w_acc: float = 1.0
    w_yawrate: float = 4.0
    w_pos: float = 0.65
    w_vel: float = 3.0
    w_obstacle: float = 1.0
    w_uncertainty: float = 1.0

    # exponential-barrier gains q1*exp(q2*c) (Parameters.cpp:29-42)
    q1_acc: float = 1.0
    q2_acc: float = 1.0
    q1_yawrate: float = 1.0
    q2_yawrate: float = 1.0
    q1_front: float = 2.75
    q2_front: float = 2.75
    q1_rear: float = 2.5
    q2_rear: float = 2.5
    q1_uncertainty: float = 2.5
    q2_uncertainty: float = 2.5

    # control limits (Parameters.cpp:45-49)
    acc_max: float = 2.0
    acc_min: float = -5.5
    steer_angle_min: float = -0.75
    steer_angle_max: float = 0.75

    # ego vehicle (Parameters.cpp:53-60)
    wheelbase: float = 2.94
    speed_max: float = 30.0
    steer_control_max: float = 1.0
    steer_control_min: float = -1.0
    throttle_control_max: float = 1.0
    throttle_control_min: float = -1.0

    # obstacle safety set (Parameters.cpp:63-74)
    t_safe: float = 0.1
    s_safe_a: float = 0.0
    s_safe_b: float = 0.0
    ego_rad: float = 1.35
    ego_front: float = 1.47 + 0.925
    ego_rear: float = 1.47 + 0.925
    length: float = 4.79
    width: float = 2.16
    safe_length: float = 0.0
    safe_width: float = 0.0

    # LM schedule (iLQR.cpp:17-18)
    lamb_factor: float = 10.0
    lamb_max: float = 10000.0
    lamb_init: float = 1.0

    # --- static shape knobs (no reference analog: the reference used
    # dynamic Eigen shapes; the padded shapes are kept so that states and
    # plans have the JAX package's layout) ---
    max_global_plan_points: int = 512   # padded global-plan length
    max_obstacles: int = 8              # padded obstacle count
    closest_point_samples_per_wpt: int = 10  # Constraints.cpp:28 densification
    # Fit the local plan in a chord-aligned frame instead of the reference's
    # global y(x) basis (LocalPlanner.cpp:101-117), which is rank-deficient
    # on north/south roads.  Required for routes with vertical legs (e.g.
    # the `long` scenario loop); off by default for reference parity.
    chord_frame_fit: bool = False
    # Exact end-of-plan window shrink (LocalPlanner.cpp:51-58): weight the
    # repeated tail rows out of the polyfit instead of letting them
    # over-weight the final waypoint.  Off by default (benign divergence
    # only in the final metres of the route).
    exact_end_shrink: bool = False
    # Unroll factor of the JAX package's Riccati/rollout scans.  The port
    # has no scan to unroll and ignores it; the field stays so a parameter
    # set carries across unchanged.
    scan_unroll: int = 1
    # Backward-pass implementation: "seq" = reference-faithful sequential
    # recursion (iLQR.cpp:133-191); "pscan" = the JAX package's O(log N)-depth
    # associative-scan Riccati for B=1 latency (``ops.riccati_pscan``; the
    # kernels K1, K2 and K3 and their plain versions always run "seq")
    backward_impl: str = "seq"

    @property
    def n_closest_samples(self) -> int:
        """Densified sample count of find_closest_point (Constraints.cpp:28)."""
        return self.num_of_local_wpts * self.closest_point_samples_per_wpt

    @property
    def yawrate_gain(self) -> float:
        """tan(steer_max)/wheelbase — state-dependent yaw-rate bound slope
        (Model.cpp:20, Constraints.cpp:119-121)."""
        return math.tan(self.steer_angle_max) / self.wheelbase


@dataclasses.dataclass(frozen=True)
class CostmapParams:
    """Local uncertainty-costmap engine configuration.

    Mirrors ``map_engine/cfg/map_engine.cfg:8-15`` defaults and the fixed
    geometry in ``map_engine/src/local_costmap.cpp``.  The reference resizes
    the vehicle map every tick from the corridor bbox
    (``local_costmap.cpp:712-805``); here, as in the JAX package, the cell
    grid (rows x cols) is static and only the map origin/orientation move.
    """

    # dynamic_reconfigure defaults (map_engine.cfg:8-15)
    sigma_x: float = 0.005
    sigma_y: float = 0.005
    sigma_theta: float = 0.0125
    x_length: float = 30.0
    y_length: float = 20.0
    x_position: float = 15.0
    y_position: float = 0.0
    resolution: float = 0.2

    # fixed global map geometry (local_costmap.cpp:119)
    global_len_x: float = 301.2
    global_len_y: float = 301.2
    global_pos_x: float = 93.14
    global_pos_y: float = -205.96

    # corridor sizing (local_costmap.cpp:45,739-754)
    look_ahead_waypoints: int = 40
    corridor_left: float = 8.0
    corridor_right: float = 4.0

    # obstacle rasterization (local_costmap.cpp:875-880)
    bbox_inflation: float = 0.2
    obstacle_raster_radius: float = 100.0

    # 95% confidence chi value (local_costmap.cpp:410, ARBIT.cuh:87)
    chisquare_val: float = 2.4477

    # --- static-shape knobs ---
    rows: int = 152     # ceil(x_length / resolution), rounded up to a multiple of 8
    cols: int = 104     # ceil(y_length / resolution)
    # Fixed half-window (cells) replacing the data-dependent EllipseIterator
    # footprint (EllipseIterator.cpp:92-107): must cover
    # chi * max(sigma_i) / resolution for worst-case cell coordinates.
    window_radius: int = 12

    @property
    def window(self) -> int:
        return 2 * self.window_radius + 1


@dataclasses.dataclass(frozen=True)
class NoiseParams:
    """Localization-noise injection (a *feature* of the reference experiment:
    ``ilqr_uncertainty_node.cpp:82-110`` draws N(0, sigma) on x/y/theta each
    planning cycle; launch overrides at Experiment.launch:7-9)."""

    sigma_x: float = 0.16
    sigma_y: float = 0.16
    sigma_theta: float = 0.017


DEFAULT_PARAMS = SolverParams()
DEFAULT_COSTMAP = CostmapParams()
DEFAULT_NOISE = NoiseParams()
