"""Speed of light on one NVIDIA H100: the least time the card could take
for a kernel's work, and what binds it.

The port's counterpart of ``cilqr_tpu/utils/roofline.py`` (a TPU v5e VPU
model).  The bound of a function is the larger of two times: the bytes it
must move (each input read once, each output written once) over the
memory rate, and the float32 operations it does on these inputs over the
peak rate outside the tensor cores.  Where the work depends on the data (an
LM loop that stops early, an ellipse's cells), the caller counts what its
run's data needs.  ``chip_smoke.py`` prints each kernel's bound from here,
and ``cilqr_tpu_torch.benchmark`` its ``mega_pct_of_sol`` field.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit)
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the peak rate, and which."""
    by_bytes, by_ops = n_bytes / MEM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Float operations of the solver's algorithm per horizon step (adds,
# multiplies, compares, and one each for exp, division, square root, sine
# and cosine), counted from the plain version's dense arithmetic:
RICCATI_STEP_OPS = 646  # Jacobians 20; Q_x 32, Q_u 16, V_xx fx 112, Q_xx 128, Q_ux 56,
                        # Q_uu 88; the eigen-clamp inverse 40; k 8, K 32; V_x 26, V_xx 88
ROLLOUT_STEP_OPS = 45   # K dx 16, the sum 4, one dynamics step with its clamps 25


def cost_step_ops(S: int, M: int, unc_ops: int) -> int:
    """The cost derivatives' and J's operations per horizon step: the
    closest-point tournament over S samples (5 each) and its 3-candidate
    refine (26), the tracking and control terms with four barriers (80), M
    obstacles of two discs (70 each), the uncertainty term (50 from the map,
    20 from given planes, 0 without), J (10)."""
    return 5 * S + 26 + 80 + 70 * M + unc_ops + 10


def lm_step_ops(S: int, M: int, unc_ops: int) -> int:
    """One LM iteration's operations per horizon step: the cost derivatives
    and J (``cost_step_ops``), the Riccati step and the rollout step."""
    return cost_step_ops(S, M, unc_ops) + RICCATI_STEP_OPS + ROLLOUT_STEP_OPS


# The Frenet lattice's float operations (csrc/frenet.cu), counted as above
# from the plain version's arithmetic, each where the function needs it
# once.  The longitudinal quartic depends on a candidate's (T, V) alone, so
# its work is counted once per lane and profile (n_T * n_v of them): the
# coefficients and the longitudinal jerk cost 42; at each of its points the
# quartic and its two rules 36, the knot interval 8 and four interpolations
# 24 on one knot search, the tangent's normalisation and heading 8.  Per
# candidate point: the lateral quintic 16, the global point, speed and yaw
# 11, the speed rule 2, the unwrap's test and sum 4, the curvature rule 7;
# with obstacles the heading's cosine and sine and the two circle centres
# 13, then two ellipse tests per live slot 32; the map's sample 43, its
# threshold and sum 5.  Per candidate: the quintic's coefficients 28, the
# lateral jerk cost 28, the cost's sum and map term 6, the verdict, count
# and selection 6.
FRENET_PROFILE_OPS = 42
FRENET_PROFILE_POINT_OPS = 76
FRENET_POINT_OPS = 40
FRENET_OBSTACLE_OPS = 13
FRENET_SLOT_OPS = 32
FRENET_MAP_OPS = 48
FRENET_CANDIDATE_OPS = 68


def frenet_bound(B: int, axes: tuple, N: int, S: int, live: int, map_hw=None) -> dict:
    """The lattice kernel's bound at B lanes of the lattice's axes (n_lat,
    n_T, n_v) over N+1 points, S reference samples, ``live`` live obstacle
    slots and one (H, W) map per lane (None: no map).  Every operation is
    explicitly rounded, so none fuses into an FMA: each takes an issue slot
    of its own, and they run at half the FMA-counted peak (FP32_OPS_PER_S /
    2, one operation per float32 lane and clock).  Bytes: the lanes' start
    terms, reference lines and maps read once, the winners' trajectories
    and the per-lane outputs written once."""
    n_lat, n_T, n_v = axes
    profiles, K, n1 = n_T * n_v, n_lat * n_T * n_v, N + 1
    search = 2 * (math.ceil(math.log2(S)) + 1)
    point = (FRENET_POINT_OPS + (FRENET_OBSTACLE_OPS + FRENET_SLOT_OPS * live if live else 0)
             + (FRENET_MAP_OPS if map_hw else 0))
    n_ops = B * (profiles * (FRENET_PROFILE_OPS + n1 * (FRENET_PROFILE_POINT_OPS + search))
                 + K * (n1 * point + FRENET_CANDIDATE_OPS))
    map_bytes = 0 if not map_hw else 4 * map_hw[0] * map_hw[1] * B
    n_bytes = B * (16 + 4 * 5 * S + 16 * n1 + 13) + map_bytes + 4 * 6 * n1 * live
    return bound(n_bytes, 2 * n_ops)


class IterationCost(NamedTuple):
    """One LM iteration of one scenario: its operations and bytes, the
    bound in seconds and what binds it ("bytes" or "operations")."""

    n_ops: float
    n_bytes: float
    t_sol: float
    bound: str


def mega_iteration_cost(p, S: int, M: int, unc_ops: int) -> IterationCost:
    """One LM iteration of one scenario over the horizon, as the fused
    solve (kernel K1) does it: ``horizon * lm_step_ops(S, M, unc_ops)``
    operations; its bytes are the scenario's trajectory, X (N+1, 4) and U
    (N, 2) in float32, read and written once.  The JAX model's counterpart
    (``KernelCost.t_sol`` / ``.bound``)."""
    N = p.horizon
    n_ops = float(N * lm_step_ops(S, M, unc_ops))
    n_bytes = float(4 * ((N + 1) * 4 + N * 2) * 2)
    b = bound(n_bytes, n_ops)
    return IterationCost(n_ops, n_bytes, b["bound_ms"] / 1e3, b["bound_by"])


# A cell's covariance fields from the scenario table, as the function needs
# them (cell_fields without the plain version's `0.0 * Cx` broadcast terms).
# Default rho formula: Cx 2, Cy 2, g1 = -Cy 1, t = g1 g2 1, sx 4 and sy 4 (a
# square, two more operations and the root), rho 4 (one division), psd and
# its select 3.  Faithful formula: g1 and g2 3 each and -s 1, t 7.
FIELD_OPS = {False: 21, True: 33}


def k4_bound(cp, prior_t: torch.Tensor, fields, fused: bool = False, faithful: bool = False) -> dict:
    """Bound of one propagation: the prior and the four fields in (fused:
    the prior and 12 floats per scenario; the fields are computed,
    FIELD_OPS[faithful] per cell), the maps out; per cell 15 operations of
    set-up and 11 (the ellipse test 6, the weight and its accumulation 5) per
    offset inside its own 95% ellipse, whose cell count pi chi^2 sx sy
    sqrt(1 - rho^2) / res^2 comes from this run's fields.  The offsets that a
    cell's scan visits outside the ellipse are the implementation's, not work
    the function needs."""
    sx_f, sy_f, rho_f, _ = fields
    inside = float((math.pi * cp.chisquare_val ** 2 / cp.resolution ** 2 * sx_f.double()
                    * sy_f.double() * torch.sqrt(1.0 - rho_f.double() ** 2)).sum())
    ops = (15 + (FIELD_OPS[faithful] if fused else 0)) * sx_f.numel() + 11 * inside
    given = sx_f.shape[0] * 12 * 4 if fused else nbytes(*fields)
    return bound(nbytes(prior_t) + given + sx_f.numel() * 4, ops)
