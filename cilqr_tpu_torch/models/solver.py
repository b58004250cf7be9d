"""CILQR solver core — the port of ``cilqr_tpu/models/solver.py``.

Reference semantics: ``iLQR.cpp``.  Every documented quirk of the C++
solver is kept (docs/ARCHITECTURE.md §3):

* Jacobians at the successor states X[1:] with accelerations from U
  (iLQR.cpp:102-106).
* V_x/V_xx seeded from the running cost at step N-1, which enters the
  recursion again at j = N-1 (iLQR.cpp:108-113,133).
* Q_uu regularized by eigenvalue clamp + lambda shift (iLQR.cpp:155-175),
  the closed-form 2x2 path of ``ops.eig2x2``.
* V_x = Q_x - K^T Q_uu k and V_xx = Q_xx - K^T Q_uu K (iLQR.cpp:180-181).
* A single rollout U + k + K (X_new - X), no alpha line search
  (iLQR.cpp:68-86).
* J on the pre-update trajectory, without barrier terms (iLQR.cpp:217).
* lambda starts at lamb_init, /lamb_factor on accept (as the JAX package
  computes it: times the rounded 1/lamb_factor, see ``optimize``), x on
  reject, abort above lamb_max; accept + |dJ| < tol terminates
  (iLQR.cpp:211-239).

Functions take a leading batch dimension where the JAX code used ``vmap``;
the LM loop keeps per-lane masks so each lane stops on its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from cilqr_tpu_torch.utils.params import SolverParams
from cilqr_tpu_torch.utils import graphs
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.models import costs as costs_mod
from cilqr_tpu_torch.models import dynamics
from cilqr_tpu_torch.models.reference_path import LocalPlan, get_local_plan
from cilqr_tpu_torch.ops import riccati_pscan
from cilqr_tpu_torch.ops.eig2x2 import regularized_inverse

#: run the plain LM loop as CUDA graphs on the card (False: eagerly, as on the CPU)
GRAPHS = True
#: streams the graphs are captured on (``graphs.capture``): the iteration's
#: independent kernels overlap in the replay; 1 captures on one stream
STREAMS = 4
#: the captures by parameters, device and shapes (``graphs.GraphCache``)
CAPTURED = graphs.GraphCache(kept=8)


class SolveResult(NamedTuple):
    X: torch.Tensor           # (..., N+1, 4) optimal state trajectory
    U: torch.Tensor           # (..., N, 2) optimal control sequence
    ref_x: torch.Tensor       # (..., num_of_local_wpts) local plan x
    ref_y: torch.Tensor       # (..., num_of_local_wpts) local plan fitted y
    iterations: torch.Tensor  # (...) int32 LM iterations executed
    J: torch.Tensor           # (...) final acceptance cost
    lamb: torch.Tensor        # (...) final LM damping


def initial_controls(p: SolverParams, dtype=torch.float32, device=None) -> torch.Tensor:
    """Cold-start guess (iLQR.cpp:9-15): a = 0.5; yaw-rate 0 for the first
    N/2 steps, then 0.1."""
    device = resolve(device)
    N = p.horizon
    acc = torch.full((N,), 0.5, dtype=dtype, device=device)
    yr = torch.full((N,), 0.1, dtype=dtype, device=device)
    yr[: N // 2] = 0.0
    return torch.stack([acc, yr], dim=-1)


def backward_pass(p: SolverParams, plan: LocalPlan, X: torch.Tensor, U: torch.Tensor,
                  lamb: torch.Tensor, obstacles=None, unc_map=None):
    """Riccati/DDP backward recursion -> (k (..., N, 2), K (..., N, 2, 4)):
    the cost derivatives at (X, U), then ``backward_from_derivs``."""
    d = costs_mod.all_cost_derivs(p, plan, X, U, obstacles, unc_map)
    return backward_from_derivs(p, d, X, U, lamb)


def backward_from_derivs(p: SolverParams, d: costs_mod.CostDerivs, X: torch.Tensor,
                         U: torch.Tensor, lamb: torch.Tensor):
    """Riccati backward recursion from precomputed cost derivatives
    (iLQR.cpp:91-195) -> (k (..., N, 2), K (..., N, 2, 4)).

    ``p.backward_impl='pscan'`` takes the O(log N)-depth associative-scan
    pass (``ops.riccati_pscan``) for the B=1 latency case, as the JAX
    package's ``backward_from_derivs`` does; else ``backward_seq``."""
    if p.backward_impl == "pscan":
        return riccati_pscan.backward_pscan(p, d, X, U, lamb)
    return backward_seq(p, d, X, U, lamb)


def backward_seq(p: SolverParams, d: costs_mod.CostDerivs, X: torch.Tensor, U: torch.Tensor,
                 lamb: torch.Tensor):
    """The sequential recursion of ``backward_from_derivs``, whatever
    ``p.backward_impl`` says: what the kernels K1, K2 and K3 compute, so
    their plain versions call it directly."""
    N = p.horizon
    fx, fu = dynamics.jacobians(p, X[..., 1:, 2], X[..., 1:, 3], U[..., 0])
    fxT = fx.transpose(-1, -2)
    fuT = fu.transpose(-1, -2)
    V_x = d.l_x[..., N - 1, :, None]
    V_xx = d.l_xx[..., N - 1, :, :]
    ks, Ks = [None] * N, [None] * N
    for j in reversed(range(N)):
        fx_j, fu_j = fx[..., j, :, :], fu[..., j, :, :]
        Q_x = d.l_x[..., j, :, None] + fxT[..., j, :, :] @ V_x
        Q_u = d.l_u[..., j, :, None] + fuT[..., j, :, :] @ V_x
        Q_xx = d.l_xx[..., j, :, :] + fxT[..., j, :, :] @ V_xx @ fx_j
        Q_ux = fuT[..., j, :, :] @ V_xx @ fx_j  # l_ux == 0 (Constraints.cpp:501-506)
        Q_uu = d.l_uu[..., j, :, :] + fuT[..., j, :, :] @ V_xx @ fu_j

        Q_uu_inv = regularized_inverse(Q_uu, lamb)
        k_j = -Q_uu_inv @ Q_u
        K_j = -Q_uu_inv @ Q_ux
        K_jT = K_j.transpose(-1, -2)
        V_x = Q_x - K_jT @ (Q_uu @ k_j)
        V_xx = Q_xx - K_jT @ (Q_uu @ K_j)
        ks[j], Ks[j] = k_j[..., 0], K_j
    return torch.stack(ks, dim=-2), torch.stack(Ks, dim=-3)


def forward_pass(p: SolverParams, X: torch.Tensor, U: torch.Tensor, k: torch.Tensor,
                 K: torch.Tensor):
    """Closed-loop rollout U_new = U + k + K (X_new - X) (iLQR.cpp:68-86)."""
    x = X[..., 0, :]
    xs, us = [x], []
    for j in range(U.shape[-2]):
        dx = x - X[..., j, :]
        u = U[..., j, :] + k[..., j, :] + (K[..., j, :, :] @ dx[..., None])[..., 0]
        x = dynamics.step(p, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def plain_iteration(p: SolverParams, plan: LocalPlan, obstacles=None, unc_map=None):
    """The default LM iteration of ``optimize``, (X, U, lamb) -> (X_new,
    U_new, J): the cost derivatives and J at (X, U) on (plan, obstacles,
    unc_map), the backward recursion and the rollout, in plain PyTorch."""
    def iteration(X, U, lamb):
        d, J = costs_mod.all_cost_derivs_and_J(p, plan, X, U, obstacles, unc_map)
        k, K = backward_from_derivs(p, d, X, U, lamb)
        return (*forward_pass(p, X, U, k, K), J)
    return iteration


def start_state(p: SolverParams, x0: torch.Tensor, U_init: torch.Tensor) -> tuple:
    """The LM loop's state before its first iteration: (X, U, lamb, J_old,
    it, done), X the rollout of U_init from x0."""
    X = dynamics.rollout(p, x0, U_init)
    batch = U_init.shape[:-2]
    kw = dict(dtype=X.dtype, device=X.device)
    return (X, U_init, torch.full(batch, p.lamb_init, **kw),
            torch.full(batch, torch.finfo(X.dtype).max, **kw),
            torch.zeros(batch, dtype=torch.int32, device=X.device),
            torch.zeros(batch, dtype=torch.bool, device=X.device))


def damping_inverse(p: SolverParams, dtype, device) -> torch.Tensor:
    """1 / lamb_factor rounded to ``dtype``: the damping step of the
    reference as XLA compiles it.  XLA folds ``lamb / p.lamb_factor`` into a
    multiplication by the constant's reciprocal rounded to the working
    dtype (the HLO of ``jax.jit(lambda l: l / 10.0)`` is ``multiply(l,
    constant(0.1))``).  The abort test lamb_n > lamb_max sits exactly on 1e4
    after chains of x10 and x0.1, so the last bit decides whether a lane
    stops: an exact division ends on 9999.999 and runs one iteration more
    than the reference, which ends on 10000.001."""
    return torch.tensor(p.lamb_factor, dtype=dtype, device=device).reciprocal()


def lm_step(p: SolverParams, iteration, lamb_inv: torch.Tensor, X, U, lamb, J_old, it,
            done) -> tuple:
    """One LM iteration and the mask update (iLQR.cpp:211-239), a function
    of tensors only: (X, U, lamb, J_old, it, done) -> the same.  A lane with
    ``done`` set keeps its state bit for bit, so a step after every lane
    has stopped changes nothing."""
    X_new, U_new, J_new = iteration(X, U, lamb)
    accept = J_new < J_old
    take = (accept & ~done)[..., None, None]
    X = torch.where(take, X_new, X)
    U = torch.where(take, U_new, U)
    lamb_n = torch.where(accept, lamb * lamb_inv, lamb * p.lamb_factor)
    stop = torch.where(accept, (J_new - J_old).abs() < p.tolerance, lamb_n > p.lamb_max)
    J_old = torch.where(done, J_old, J_new)
    lamb = torch.where(done, lamb, lamb_n)
    it = torch.where(done, it, it + 1)
    return X, U, lamb, J_old, it, done | stop


def optimize(p: SolverParams, plan: LocalPlan, x0: torch.Tensor, U_init: torch.Tensor,
             obstacles=None, unc_map=None, iteration=None):
    """Levenberg-Marquardt solve (iLQR.cpp:201-245) from x0 (..., 4) and
    U_init (..., N, 2), with per-lane masks: a lane that has stopped keeps
    its state, so every lane gets the result it would get alone.

    iteration(X, U, lamb) -> (X_new, U_new, J) is one LM iteration:
    ``plain_iteration`` by default; the batched paths pass their kernels'
    iteration instead.  Each pass of the loop is ``lm_step``.  The loop ends
    when every lane has stopped, which reads the done mask on the host once
    per iteration.  On the card the default iteration runs as CUDA graphs
    (``GRAPHS``): the start and the step, captured once per parameters and
    shapes and replayed, the same kernels on the same inputs, so the same
    bits as the eager loop.  Returns (X, U, iterations, J, lamb)."""
    if iteration is None and x0.is_cuda and GRAPHS:
        return _optimize_graphed(p, plan, x0, U_init, obstacles, unc_map)
    if iteration is None:
        iteration = plain_iteration(p, plan, obstacles, unc_map)
    state = start_state(p, x0, U_init)
    lamb_inv = damping_inverse(p, state[0].dtype, x0.device)
    for _ in range(p.max_iterations):
        if bool(state[-1].all()):
            break
        state = lm_step(p, iteration, lamb_inv, *state)
    X, U, lamb, J, it, _ = state
    return X, U, it, J, lamb


def run_step(p: SolverParams, plan_xy: torch.Tensor, plan_n, ego_state: torch.Tensor,
             U_warm: torch.Tensor, obstacles=None, unc_map=None) -> SolveResult:
    """One receding-horizon planning cycle (iLQR.cpp:247-255).

    plan_xy: (P, 2) padded global plan; plan_n: valid count; ego_state
    (..., 4) with noise already injected; U_warm (..., N, 2) warm start.
    ``unc_map`` is one shared map or, for ego_state (B, 4), one map per
    scenario (values (B, H, W), geometry and frame leaves with leading B).
    On the card (``GRAPHS``) the plan fit runs inside the start graph.
    """
    if ego_state.is_cuda and GRAPHS:
        return _run_step_graphed(p, plan_xy, plan_n, ego_state, U_warm, obstacles, unc_map)
    plan = get_local_plan(p, plan_xy, plan_n, ego_state)
    X, U, it, J, lamb = optimize(p, plan, ego_state, U_warm, obstacles, unc_map)
    return SolveResult(X, U, plan.x_wpts, plan.y_fit, it, J, lamb)


def _optimize_graphed(p: SolverParams, plan: LocalPlan, x0, U_init, obstacles, unc_map):
    """``optimize`` with the plain iteration as CUDA graphs (``_replay``)."""
    (X, U, lamb, J, it, _), _ = _replay(p, x0, U_init, plan, None, obstacles, unc_map)
    return X, U, it, J, lamb


def _run_step_graphed(p: SolverParams, plan_xy, plan_n, ego_state, U_warm, obstacles, unc_map):
    """``run_step`` as CUDA graphs: the plan fit in the start graph."""
    (X, U, lamb, J, it, _), plan = _replay(p, ego_state, U_warm, None, (plan_xy, plan_n),
                                           obstacles, unc_map)
    return SolveResult(X, U, plan.x_wpts.clone(), plan.y_fit.clone(), it, J, lamb)


def _replay(p: SolverParams, x0, U_init, plan, fit, obstacles, unc_map) -> tuple:
    """The plain LM loop as CUDA graphs on the local ``plan``, or on the
    plan that ``fit`` = (plan_xy, plan_n) gives at x0: the inputs are copied
    into the capture's own, the start graph replayed once, then the step
    graph once per iteration until the done mask, read on the host after
    each replay, says every lane has stopped.  Returns copies of the state
    (X, U, lamb, J, it, done) and the capture's plan."""
    leaves, spec = tree_flatten((plan, fit, obstacles, unc_map))
    args = [x0, U_init] + [t for t in leaves if isinstance(t, torch.Tensor)]
    key = (p, x0.device, obstacles is None, unc_map is None,
           tuple((a.shape, a.dtype) for a in args), fit is None,
           tuple(t for t in leaves if not isinstance(t, torch.Tensor)), STREAMS)
    g = CAPTURED.load(key, args, lambda inputs: _capture(p, leaves, spec, inputs))
    start, step = g.graphs
    state, plan = g.out
    start.replay()
    for _ in range(p.max_iterations):
        if bool(state[-1].all()):
            break
        step.replay()
    return tuple(t.clone() for t in state), plan


def _assign(dst: tuple, src: tuple) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _capture(p: SolverParams, leaves: list, spec, inputs: list) -> tuple:
    """The start and the step captured on ``inputs`` (x0, U_init, then the
    tensors of (plan, fit, obstacles, unc_map) in the order of ``leaves``)
    on ``STREAMS`` streams, after one warm-up of each on a side stream
    (which also builds the constants: a copy from the host cannot be
    captured).  With ``fit`` the start graph fits the plan into buffers of
    its own, which the step graph reads.  Returns (graphs, (the state, the
    plan) they write, the constants they read).  A failed capture raises."""
    x0, U_init, *world = inputs
    world = iter(world)
    plan, fit, obstacles, unc_map = tree_unflatten(
        [next(world) if isinstance(t, torch.Tensor) else t for t in leaves], spec)
    dev = x0.device
    with graphs.side_stream(dev):
        if fit is not None:
            plan = LocalPlan(*(t.clone() for t in get_local_plan(p, *fit, x0)))
        state = tuple(t.clone() for t in start_state(p, x0, U_init))
        dtype = state[0].dtype
        held = (damping_inverse(p, dtype, dev), costs_mod.consts(p, dtype, dev),
                costs_mod.consts(p, U_init.dtype, dev))
        iteration = plain_iteration(p, plan, obstacles, unc_map)
        lm_step(p, iteration, held[0], *state)

    def begin():
        if fit is not None:
            _assign(plan, get_local_plan(p, *fit, x0))
        _assign(state, start_state(p, x0, U_init))

    start = graphs.capture(begin, dev, STREAMS)
    step = graphs.capture(lambda: _assign(state, lm_step(p, iteration, held[0], *state)), dev,
                          STREAMS)
    return (start, step), (state, plan), held
