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

from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from cilqr_tpu_torch.utils.params import SolverParams
from cilqr_tpu_torch.utils import graphs, profiling
from cilqr_tpu_torch.utils.device import resolve
from cilqr_tpu_torch.models import costs as costs_mod
from cilqr_tpu_torch.models import dynamics
from cilqr_tpu_torch.models.reference_path import LocalPlan, get_local_plan
from cilqr_tpu_torch.ops import riccati_pscan, route
from cilqr_tpu_torch.ops.eig2x2 import regularized_inverse

#: run the LM loops and the stages around them (``run``, ``solve``) as CUDA
#: graphs on the card (False: eagerly, as on the CPU)
GRAPHS = True
#: streams the graphs are captured on (``graphs.capture``): the iteration's
#: independent kernels overlap in the replay; 1 captures on one stream
STREAMS = 4
#: run a graphed LM loop on the card as one launch of a loop graph
#: (``graphs.Loop``: the condition evaluated on the card, as
#: ``jax.lax.while_loop`` evaluates it); False: the host reads the done mask
#: after each step replay
DEVICE_LOOP = True
#: the captures by parameters, device and shapes (``graphs.GraphCache``);
#: 16, so that a ``compare`` call's LM loops outlive its other planners'
#: stages (the NRB-RRT planner's among them)
CAPTURED = graphs.GraphCache(kept=16)


class Iteration(NamedTuple):
    """An LM iteration as ``optimize`` can replay it: ``build(p, plan,
    *world)`` -> the iteration (X, U, lamb) -> (X_new, U_new, J), or an
    object with an LM step of its own (``step``), which reads nothing but
    ``plan`` and ``world``.  ``world``'s leaves (through
    tuples, NamedTuples, lists) are tensors, which a capture copies, and
    hashable constants, which key it."""

    build: Callable
    world: tuple


class Stage(NamedTuple):
    """``fn(p, *args)`` as a CUDA graph can hold it (``run``, ``solve``):
    ``args``' leaves (through tuples, NamedTuples, lists, dicts) are
    tensors, which a capture copies, and hashable constants, which key it.
    The stages of the port put a per-scenario tensor first (its leading
    dimension is the batch)."""

    fn: Callable
    args: tuple


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
    it, done), X the rollout of U_init from x0.  Every tensor is dense and
    its own (U a copy of U_init): a step may update the state in place (the
    hybrid loop's step kernel, ``ops.lm_cuda.fused_step``)."""
    X = dynamics.rollout(p, x0, U_init).contiguous()
    batch = U_init.shape[:-2]
    kw = dict(dtype=X.dtype, device=X.device)
    return (X, U_init.clone(memory_format=torch.contiguous_format),
            torch.full(batch, p.lamb_init, **kw),
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


def step(p: SolverParams, iteration, lamb_inv: torch.Tensor, X, U, lamb, J_old, it,
         done) -> tuple:
    """One pass of the LM loop: the iteration's own step where it brings one
    (an ``lm_step(lamb_inv, X, U, lamb, J_old, it, done)`` attribute with
    ``lm_step``'s result: the hybrid iteration on a map sampler,
    ``ops.lm_cuda.HybridStep``, one kernel on the card), else ``lm_step``."""
    own = getattr(iteration, "lm_step", None)
    if own is None:
        return lm_step(p, iteration, lamb_inv, X, U, lamb, J_old, it, done)
    return own(lamb_inv, X, U, lamb, J_old, it, done)


def optimize(p: SolverParams, plan: LocalPlan, x0: torch.Tensor, U_init: torch.Tensor,
             obstacles=None, unc_map=None, iteration=None):
    """Levenberg-Marquardt solve (iLQR.cpp:201-245) from x0 (..., 4) and
    U_init (..., N, 2), with per-lane masks: a lane that has stopped keeps
    its state, so every lane gets the result it would get alone.

    ``iteration`` is one LM iteration: by default ``plain_iteration`` on
    (obstacles, unc_map); the batched paths pass theirs as an ``Iteration``
    (the hybrid one with its own step, the two-phase one with K2), which replaces
    obstacles and unc_map; a bare callable (X, U, lamb) -> (X_new, U_new, J)
    runs eagerly.  Each pass of the loop is ``step`` (``lm_step``, or the
    iteration's own).  The loop ends when
    every lane has stopped, which reads the done mask on the host once per
    iteration.  On the card an ``Iteration`` runs as CUDA graphs
    (``GRAPHS``): the start and the step, captured once per parameters,
    iteration, route (``ops.route``) and shapes and replayed, the same
    kernels on the same inputs, so the same bits as the eager loop; the
    loop over the step runs on the card (``DEVICE_LOOP``).  Returns (X, U,
    iterations, J, lamb)."""
    if iteration is None:
        iteration = Iteration(plain_iteration, (obstacles, unc_map))
    if isinstance(iteration, Iteration):
        if x0.is_cuda and GRAPHS:
            return _optimize_graphed(p, plan, x0, U_init, iteration=iteration)
        iteration = iteration.build(p, plan, *iteration.world)
    state = start_state(p, x0, U_init)
    lamb_inv = damping_inverse(p, state[0].dtype, x0.device)
    for _ in range(p.max_iterations):
        if bool(state[-1].all()):
            break
        state = step(p, iteration, lamb_inv, *state)
    profiling.device_counters()
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


def _staged(args: list) -> bool:
    """Whether a stage on the tensors ``args`` replays as CUDA graphs: on the
    card with ``GRAPHS``, outside another capture (inside one it runs
    eagerly, and that capture holds its kernels), on the kernels (inside
    ``route.plain()`` the plain versions run eagerly, their LM loops
    replaying the plain loop's graphs)."""
    return GRAPHS and graphs.replayable(args[0]) and not route.plain_on_card()


def run(p: SolverParams, stage: Stage):
    """``stage.fn(p, *stage.args)``.  On the card (``_staged``) one CUDA
    graph, captured once per key (parameters, device, the stage's structure
    and constants, its tensors' shapes, ``STREAMS``) and replayed on copies
    of the stage's tensors; its outputs are copied out.  The same kernels on
    the same inputs: the eager call's bits.  Spans (``utils.profiling``):
    the copy in, the replay on the card, the copy out."""
    leaves, spec, args = _stage_args(stage)
    if not _staged(args):
        return stage.fn(p, *stage.args)
    with profiling.span("run.copy_in"):
        g = CAPTURED.load(_key(p, leaves, spec, args), args,
                          lambda inputs: _capture_run(p, leaves, spec, inputs))
    with profiling.span("run.replay", device=args[0].device):
        g.graphs[0].replay()
    with profiling.span("run.copy_out"):
        return _copied(g.out)


def solve(p: SolverParams, before: Stage) -> tuple:
    """An LM solve with what comes before it: ``before.fn(p, *before.args)``
    -> (x0, U_init, plan, iteration (an ``Iteration``), carry), then the LM
    loop of the iteration on ``plan`` from (x0, U_init).  Returns ((X, U,
    iterations, J, lamb), carry).  On the card (``_staged``) the start graph
    runs ``before`` and the loop's start, and the step graph reads what it
    wrote in place (``_replay``); else ``before`` runs eagerly and the loop
    is ``optimize``'s."""
    leaves, spec, args = _stage_args(before)
    if _staged(args):
        (X, U, lamb, J, it, _), carry = _replay(p, leaves, spec, args)
        return (X, U, it, J, lamb), carry
    x0, U_init, plan, iteration, carry = before.fn(p, *before.args)
    return optimize(p, plan, x0, U_init, iteration=iteration), carry


def _given(p: SolverParams, x0, U_init, plan, iteration) -> tuple:
    """The stage before ``optimize``'s loop: its inputs as they are."""
    return x0, U_init, plan, iteration, ()


def _fitted(p: SolverParams, x0, U_init, plan_xy, plan_n, iteration) -> tuple:
    """The stage before ``run_step``'s loop: the plan fit at x0."""
    plan = get_local_plan(p, plan_xy, plan_n, x0)
    return x0, U_init, plan, iteration, (plan.x_wpts, plan.y_fit)


def _stage_args(stage: Stage) -> tuple:
    """(the stage's leaves, its structure, its tensors)."""
    leaves, spec = tree_flatten(stage)
    return leaves, spec, [t for t in leaves if isinstance(t, torch.Tensor)]


def _optimize_graphed(p: SolverParams, plan: LocalPlan, x0, U_init, obstacles=None,
                      unc_map=None, iteration=None):
    """``optimize`` as CUDA graphs (``_replay``), on ``iteration`` (an
    ``Iteration``; None: the plain one on (obstacles, unc_map))."""
    it = iteration or Iteration(plain_iteration, (obstacles, unc_map))
    (X, U, lamb, J, n, _), _ = _replay(p, *_stage_args(Stage(_given, (x0, U_init, plan, it))))
    return X, U, n, J, lamb


def _run_step_graphed(p: SolverParams, plan_xy, plan_n, ego_state, U_warm, obstacles, unc_map):
    """``run_step`` as CUDA graphs: the plan fit in the start graph."""
    it = Iteration(plain_iteration, (obstacles, unc_map))
    (X, U, lamb, J, n, _), (x_wpts, y_fit) = _replay(
        p, *_stage_args(Stage(_fitted, (ego_state, U_warm, plan_xy, plan_n, it))))
    return SolveResult(X, U, x_wpts, y_fit, n, J, lamb)


def _key(p: SolverParams, leaves: list, spec, args: list) -> tuple:
    """A capture's key: the parameters, the device, the stage's structure,
    its tensors' shapes and dtypes, its constants (its function among them),
    ``STREAMS``, ``DEVICE_LOOP`` and ``route.plain_on_card()`` (a graph
    captured on the kernels is never replayed on the plain versions, nor
    the reverse).  Every tensor must lie on the device (a tensor elsewhere
    would be read once, when captured)."""
    dev = args[0].device
    if any(a.device != dev for a in args):
        raise ValueError(f"a graphed stage takes its tensors on one device, got "
                         f"{sorted({str(a.device) for a in args})}")
    return (p, dev, spec, tuple((a.shape, a.dtype) for a in args),
            tuple(t for t in leaves if not isinstance(t, torch.Tensor)), STREAMS,
            DEVICE_LOOP, route.plain_on_card())


def _copied(out):
    """A graph's outputs copied out of its memory (the next replay
    overwrites them)."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)


def _replay(p: SolverParams, leaves: list, spec, args: list) -> tuple:
    """The LM loop after the stage ``tree_unflatten(leaves, spec)`` (its
    tensors ``args``) as CUDA graphs: the inputs copied into the capture's
    own, the start graph (the stage and the loop's start) replayed once,
    then the loop graph launched once (``DEVICE_LOOP``: it replays the step
    until every lane has stopped or ``max_iterations`` steps have run, and
    the host reads the step count once, after the copies out are enqueued),
    or the step graph replayed once per iteration until the done mask, read
    on the host after each replay, says every lane has stopped.  Returns
    copies of the state (X, U, lamb, J, it, done) and of the stage's
    carry.  Spans (``utils.profiling``): the copy in, the start replay and
    the loop on the card, the copies out, and the host's wait for the step
    count, which the loop's span keeps."""
    dev = args[0].device
    with profiling.span("replay.copy_in"):
        g = CAPTURED.load(_key(p, leaves, spec, args), args,
                          lambda inputs: _capture(p, leaves, spec, inputs))
    start, step_graph = g.graphs
    state, carry = g.out
    with profiling.span("replay.start", device=dev):
        start.replay()
    if g.loop is not None:
        with profiling.span("replay.loop", device=dev) as loop:
            g.loop.launch()
        with profiling.span("replay.copy_out"):
            out = tuple(t.clone() for t in state), _copied(carry)
        with profiling.span("replay.count", wait=True):
            loop.attach(g.loop.count())
            profiling.device_counters()
        return out
    for _ in range(p.max_iterations):
        if bool(state[-1].all()):
            break
        step_graph.replay()
    profiling.device_counters()
    return tuple(t.clone() for t in state), _copied(carry)


def _assign(dst: tuple, src: tuple) -> None:
    """dst's tensors take src's values (a step that updated the state in
    place returns the same tensors: nothing to copy)."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def _unflatten(leaves: list, spec, inputs: list):
    """The stage of ``leaves`` with its tensors replaced by ``inputs``."""
    given = iter(inputs)
    return tree_unflatten([next(given) if isinstance(t, torch.Tensor) else t for t in leaves],
                          spec)


def _capture_run(p: SolverParams, leaves: list, spec, inputs: list) -> tuple:
    """``run``'s graph captured on ``inputs`` on ``STREAMS`` streams, after
    one warm-up on a side stream (which builds the constants: a copy from
    the host cannot be captured; its launches count for nothing).  Returns
    (graphs, their outputs, None)."""
    stage = _unflatten(leaves, spec, inputs)
    dev = inputs[0].device
    with graphs.building(), graphs.side_stream(dev), graphs.uncounted():
        stage.fn(p, *stage.args)
    graph = graphs.capture(lambda: stage.fn(p, *stage.args), dev, STREAMS)
    return (graph,), graph.out, None


def _capture(p: SolverParams, leaves: list, spec, inputs: list) -> tuple:
    """The start and the step captured on ``inputs`` (the tensors of the
    stage, in the order of ``leaves``) on ``STREAMS`` streams, after one
    warm-up of each on a side stream (which also builds the constants: a
    copy from the host cannot be captured; its launches count for nothing).
    The start graph runs the stage and writes the loop's start state into
    buffers of its own; the step graph reads the plan and the iteration's
    tensors where the start graph wrote them, in place.  Returns (graphs,
    (the state, the stage's carry) they write, the constants they read) and,
    with ``DEVICE_LOOP``, the ``graphs.Loop`` of the step on the done mask.
    A failed capture raises."""
    before = _unflatten(leaves, spec, inputs)
    dev = inputs[0].device
    with graphs.building(), graphs.side_stream(dev), graphs.uncounted():
        x0, U_init, plan, described, _ = before.fn(p, *before.args)
        state = tuple(t.clone() for t in start_state(p, x0, U_init))
        dtype = state[0].dtype
        held = (damping_inverse(p, dtype, dev), costs_mod.consts(p, dtype, dev),
                costs_mod.consts(p, U_init.dtype, dev))
        step(p, described.build(p, plan, *described.world), held[0], *state)

    def begin():
        x0, U_init, plan, described, carry = before.fn(p, *before.args)
        _assign(state, start_state(p, x0, U_init))
        return plan, described, carry

    start = graphs.capture(begin, dev, STREAMS)
    plan, described, carry = start.out
    iteration = described.build(p, plan, *described.world)
    step_graph = graphs.capture(lambda: _assign(state, step(p, iteration, held[0], *state)), dev,
                                STREAMS)
    loop = graphs.Loop(step_graph, state[-1], p.max_iterations) if DEVICE_LOOP else None
    return (start, step_graph), (state, carry), held, loop
