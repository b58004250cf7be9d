"""The yardstick's speed of light on one NVIDIA H100: published peaks and
the operation and byte counts of the port's kernels, frozen here so that a
change to the program cannot move them.

Counted from the algorithm's dense arithmetic, as ``utils/roofline.py`` of
the port counts it: adds, multiplies, compares, and one operation each for
exp, division, square root, sine and cosine.  A bound is the larger of
bytes over the memory rate and float32 operations over the peak rate
outside the tensor cores; where the work depends on the data (an LM loop
that stops early, an ellipse's cells) the count is what this run's data
needs.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / MEM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


RICCATI_STEP_OPS = 646  # Jacobians 20; Q_x 32, Q_u 16, V_xx fx 112, Q_xx 128, Q_ux 56,
                        # Q_uu 88; the eigen-clamp inverse 40; k 8, K 32; V_x 26, V_xx 88
ROLLOUT_STEP_OPS = 45   # K dx 16, the sum 4, one dynamics step with its clamps 25


def lm_step_ops(S: int, M: int, unc_ops: int) -> int:
    """One LM iteration's operations per horizon step: the closest-point
    tournament over S samples (5 each) and its 3-candidate refine (26), the
    tracking and control terms with four barriers (80), M obstacles of two
    discs (70 each), the uncertainty term (``unc_ops``: 50 from a map), J
    (10), the Riccati step and the rollout step."""
    return 5 * S + 26 + 80 + 70 * M + unc_ops + 10 + RICCATI_STEP_OPS + ROLLOUT_STEP_OPS


def lm_iteration(horizon: int, S: int, M: int, unc_ops: int = 50) -> tuple:
    """(operations, bytes) of one LM iteration of one scenario as kernel K1
    does it: ``horizon * lm_step_ops`` operations; the trajectory X (N+1, 4)
    and U (N, 2) in float32 read and written once."""
    n_ops = float(horizon * lm_step_ops(S, M, unc_ops))
    n_bytes = float(4 * ((horizon + 1) * 4 + horizon * 2) * 2)
    return n_ops, n_bytes


def k1_bound_s(horizon: int, S: int, M: int, iterations_total: float) -> float:
    """Least time of a K1 launch whose lanes ran ``iterations_total`` LM
    iterations in all."""
    n_ops, n_bytes = lm_iteration(horizon, S, M)
    return bound_s(n_bytes * iterations_total, n_ops * iterations_total)


# A cell's covariance fields from the 12 floats of its scenario: Cx 2, Cy 2,
# g1 = -Cy 1, t = g1 g2 1, sx 4, sy 4, rho 4, psd and its select 3.
FIELD_OPS = 21


def k4_work(sx, sy, rho, res: float, chi: float) -> tuple:
    """(operations, bytes) of one fused propagation over the maps whose
    fields are (sx, sy, rho), each (B, rows, cols), without the prior's bytes:
    12 floats per scenario in and the maps out; per cell 15 operations of
    set-up and FIELD_OPS for its fields, and 11 (the ellipse test 6, the
    weight and its sum 5) per cell inside its own 95% ellipse, of which there
    are pi chi^2 sx sy sqrt(1 - rho^2) / res^2.  A launch's bound is
    ``bound_s(prior bytes + bytes, operations)``."""
    inside = float((math.pi * chi ** 2 / res ** 2 * sx.double() * sy.double()
                    * (1.0 - rho.double() ** 2).clamp(min=0.0).sqrt()).sum())
    cells = sx.numel()
    return (15 + FIELD_OPS) * cells + 11 * inside, sx.shape[0] * 12 * 4 + cells * 4
