"""The LM solve per scenario in CUDA: kernels K1 (whole loop) and K3 (one
iteration).

Port of ``cilqr_tpu/ops/lm_pallas.py``.  K1 (``_opt_kernel`` via
``fused_optimize``, the in-kernel-loop form with a shared world)
regenerates each scenario's closest-point sample table from its fit
payload, then runs every LM iteration (derivatives, J, backward Riccati,
rollout, accept/reject, lambda, stop) per thread.  K3 (``_iter_kernel`` via
``fused_iteration``) runs one iteration on a given trajectory; with
``unc_sampler`` (one uncertainty map per scenario, the Monte-Carlo and
full-stack form) ``fused_optimize`` drives it from the host LM loop
(``solver.optimize``), sampling each scenario's map at the current
trajectory before every launch.  Both are in ``csrc/lm.cu``.

Shared-world payloads are prepared once per solve: the obstacle quadratic
forms (``prep_obstacles``), the map and its frame scalars (``prep_unc_map``;
the kernel reads the four corners of the (H, W) map directly).  The initial
rollout of U_init from x0 runs inside the kernel (the JAX code does it
outside, with ``dynamics.rollout``; the plain version here still does).

``fused_optimize`` and ``fused_iteration`` take their plain versions
(``fused_optimize_plain``, ``fused_iteration_plain``) for tensors on the
CPU; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cilqr_tpu.utils.params import SolverParams
from cilqr_tpu_torch.models import costs, solver
from cilqr_tpu_torch.ops import riccati_cuda

LAUNCHES = 0  # K1 launches made by fused_optimize
ITER_LAUNCHES = 0  # K3 launches made by fused_iteration


class WorldPrep(NamedTuple):
    """Once-per-solve kernel payload for the shared world.

    obs:    (M*6, N) rows [g11, g12, g22, px, py, mask] per (obstacle m,
            step j): the global-frame safety-ellipse quadratic form
            G = R(th)^T diag(a^-2, b^-2) R(th) (Obstacle.cpp:44-63), its
            center and the padding mask.
    values: (H, W) uncertainty map.
    scl:    (16,) map-frame scalars [origin_x, origin_y, cos_yaw, sin_yaw,
            first_x, first_y, 1/res, lo_x, hi_x, lo_y, hi_y, 0...].
    has_obs / has_unc: whether the kernel evaluates each term.
    obstacles / unc_map: the world as given (the plain versions use it).
    """

    obs: torch.Tensor
    values: torch.Tensor
    scl: torch.Tensor
    has_obs: bool
    has_unc: bool
    obstacles: object
    unc_map: object


def prep_obstacles(p: SolverParams, obs, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-(m, j) global-frame ellipse quadratic forms, (M*6, N)."""
    N = p.horizon
    if obs is None:
        return torch.zeros((6, N), dtype=dtype, device=device)
    dims = obs.dims[:, :N].to(dtype)
    pos = obs.pos[:, :N].to(dtype)
    M = dims.shape[0]
    ov, oth = pos[..., 2], pos[..., 3]
    a = dims[..., 0] / 2.0 + (ov * torch.cos(oth)).abs() * p.t_safe + p.s_safe_a + p.ego_rad
    b = dims[..., 1] / 2.0 + (ov * torch.sin(oth)).abs() * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
    ia2 = 1.0 / (a * a)
    ib2 = 1.0 / (b * b)
    co, so = torch.cos(oth), torch.sin(oth)
    g11 = co * co * ia2 + so * so * ib2
    g12 = co * so * (ia2 - ib2)
    g22 = so * so * ia2 + co * co * ib2
    mask = obs.mask.to(dtype)[:, None].expand(M, N)
    payload = torch.stack([g11, g12, g22, pos[..., 0], pos[..., 1], mask], dim=1)
    return payload.reshape(M * 6, N)


def prep_unc_map(m, dtype=torch.float32, device=None):
    """(values (H, W), scl (16,)) for the in-kernel sampler.  Without a map
    the box has lo > hi, so `inside` is never true."""
    if m is None:
        scl = torch.zeros(16, dtype=dtype, device=device)
        scl[7], scl[8] = 1.0, -1.0
        return torch.zeros((2, 2), dtype=dtype, device=device), scl
    g = m.geom
    first = g.center + 0.5 * g.length - 0.5 * g.resolution
    lo = g.center - 0.5 * g.length
    hi = g.center + 0.5 * g.length
    z = torch.zeros((), dtype=g.center.dtype, device=g.center.device)
    scl = torch.stack([
        m.origin_xy[0], m.origin_xy[1], torch.cos(m.origin_yaw), torch.sin(m.origin_yaw),
        first[0], first[1], 1.0 / g.resolution,
        lo[0], hi[0], lo[1], hi[1], z, z, z, z, z,
    ]).to(dtype)
    return m.values.to(dtype), scl


def prep_world(p: SolverParams, obstacles, unc_map, dtype=torch.float32, device=None) -> WorldPrep:
    obs = prep_obstacles(p, obstacles, dtype, device)
    values, scl = prep_unc_map(unc_map, dtype, device)
    return WorldPrep(obs, values, scl, obstacles is not None, unc_map is not None,
                     obstacles, unc_map)


def _fit_payload(plans) -> torch.Tensor:
    """(B, poly_order+11) payload: coeffs, x_mid, x_scale, samp_frame.  The
    kernel regenerates the sample table from it."""
    return torch.cat(
        [plans.coeffs, plans.x_mid[:, None], plans.x_scale[:, None], plans.samp_frame],
        dim=-1,
    )


def fused_iteration_plain(p: SolverParams, world: WorldPrep, plans, X, U, lamb, uext=None):
    """Plain version of K3: ``costs.all_cost_derivs_and_J`` at (X, U) (the
    uncertainty sample from ``uext`` (B, N, 3) when given), then the
    backward recursion and the rollout.  Returns (X_new, U_new, J, k, K)."""
    d, J = costs.all_cost_derivs_and_J(p, plans, X, U, world.obstacles, world.unc_map,
                                       unc_planes=uext)
    k, K = solver.backward_from_derivs(p, d, X, U, lamb)
    X_new, U_new = solver.forward_pass(p, X, U, k, K)
    return X_new, U_new, J, k, K


def _hybrid_iteration(p: SolverParams, world: WorldPrep, plans, unc_sampler, step):
    """(X, U, lamb) -> (X_new, U_new, J) of step(...) on the planes
    unc_sampler(X[:, :N]) (B, N, 3)."""
    def iteration(X, U, lamb):
        return step(p, world, plans, X, U, lamb, unc_sampler(X[:, :p.horizon]))[:3]

    return iteration


def _check_sampler(unc_sampler, unc_map) -> None:
    if unc_sampler is not None and unc_map is not None:
        raise ValueError("unc_sampler and unc_map are mutually exclusive")


def fused_optimize_plain(p: SolverParams, plans, x0s, U_init, obstacles=None, unc_map=None,
                         unc_sampler=None):
    """Plain version of ``fused_optimize``: ``solver.optimize``, the batched
    LM loop with per-lane masks, on the plain iteration (with
    ``unc_sampler``: on ``fused_iteration_plain`` fed by the sampler).
    Returns (X, U, iterations, J, lamb)."""
    _check_sampler(unc_sampler, unc_map)
    if unc_sampler is None:
        return solver.optimize(p, plans, x0s, U_init, obstacles, unc_map)
    world = prep_world(p, obstacles, None, x0s.dtype, x0s.device)
    return solver.optimize(p, plans, x0s, U_init, iteration=_hybrid_iteration(
        p, world, plans, unc_sampler, fused_iteration_plain))


class _LMConfig(ctypes.Structure):
    """Mirror of ``LMConfig`` in csrc/lm.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "N", "S", "M", "H", "W", "ncoef", "max_iterations", "has_obs", "has_unc",
    )] + [(n, ctypes.c_float) for n in (
        "dt", "acc_min", "acc_max", "tan_lo", "tan_hi", "speed_max",
        "two_wpos", "two_wvel", "wpos", "wvel", "wacc", "wyr", "two_wacc", "two_wyr", "vdes",
        "q1a", "q2a", "q2a_sq", "q1y", "q2y", "q2y_sq",
        "q1f", "q2f", "s1f", "s2f", "q1r", "q2r", "s1r", "s2r",
        "q1u", "q2u", "s1u", "s2u",
        "efront", "erear",
        "lamb_init", "lamb_factor", "lamb_max", "tol",
    )]


def _config(p: SolverParams, B: int, M: int, H: int, W: int, has_obs: bool,
            has_unc: bool) -> _LMConfig:
    """Kernel constants; products of parameters are formed in double and
    rounded once, as the JAX kernel folds its Python-float constants."""
    return _LMConfig(
        B=B, N=p.horizon, S=p.n_closest_samples, M=M, H=H, W=W,
        ncoef=p.poly_order + 1, max_iterations=p.max_iterations,
        has_obs=int(has_obs), has_unc=int(has_unc),
        **riccati_cuda.dyn_constants(p),
        two_wpos=2.0 * p.w_pos, two_wvel=2.0 * p.w_vel, wpos=p.w_pos, wvel=p.w_vel,
        wacc=p.w_acc, wyr=p.w_yawrate, two_wacc=2.0 * p.w_acc, two_wyr=2.0 * p.w_yawrate,
        vdes=p.desired_speed,
        q1a=p.q1_acc, q2a=p.q2_acc, q2a_sq=p.q2_acc * p.q2_acc,
        q1y=p.q1_yawrate, q2y=p.q2_yawrate, q2y_sq=p.q2_yawrate * p.q2_yawrate,
        q1f=p.q1_front, q2f=p.q2_front, s1f=p.w_obstacle * p.q2_front,
        s2f=p.w_obstacle * p.q2_front * p.q2_front,
        q1r=p.q1_rear, q2r=p.q2_rear, s1r=p.w_obstacle * p.q2_rear,
        s2r=p.w_obstacle * p.q2_rear * p.q2_rear,
        q1u=p.q1_uncertainty, q2u=p.q2_uncertainty, s1u=p.w_uncertainty * p.q2_uncertainty,
        s2u=p.w_uncertainty * p.q2_uncertainty * p.q2_uncertainty,
        efront=p.ego_front, erear=p.ego_rear,
        lamb_init=p.lamb_init, lamb_factor=p.lamb_factor, lamb_max=p.lamb_max,
        tol=p.tolerance,
    )


def _check_world(world: WorldPrep, N: int) -> tuple:
    """(M, H, W) of a world payload, after checking it for the kernels."""
    M = world.obs.shape[0] // 6
    H, W = world.values.shape
    if world.has_obs:
        riccati_cuda.check_cuda_f32("obstacle payload", world.obs, (M * 6, N))
    if world.has_unc:
        riccati_cuda.check_cuda_f32("uncertainty map", world.values, (H, W))
        if H < 2 or W < 2:
            raise ValueError(f"uncertainty map must be at least 2x2, got {(H, W)}")
    return M, H, W


def _load(build):
    lib = build.load_library()
    if lib.cilqr_lm_config_size() != ctypes.sizeof(_LMConfig):
        raise RuntimeError("LMConfig layout differs between Python and CUDA")
    return lib


def _launch(p: SolverParams, plans, x0s, U_init, obstacles, unc_map):
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    N, S = p.horizon, p.n_closest_samples
    B = x0s.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    fit = _fit_payload(plans)
    for name, t, shape in (
        ("x0s", x0s, (B, 4)), ("U_init", U_init, (B, N, 2)),
        ("fit payload", fit, (B, p.poly_order + 11)),
    ):
        riccati_cuda.check_cuda_f32(name, t, shape)
    dev = x0s.device
    world = prep_world(p, obstacles, unc_map, torch.float32, dev)
    M, H, W = _check_world(world, N)
    lib = _load(build)
    fit_t = fit.t().contiguous()  # (C, B)
    x0_t = x0s.t().contiguous()   # (4, B)
    U0s = riccati_cuda.to_scenario_minor(U_init)
    obs = world.obs.contiguous()
    values = world.values.contiguous()
    scl = world.scl.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    X = torch.empty((N + 1, 4, B), **f32)
    U = torch.empty((N, 2, B), **f32)
    J = torch.empty((B,), **f32)
    lamb = torch.empty((B,), **f32)
    it = torch.empty((B,), dtype=torch.int32, device=dev)
    sxy = torch.empty((S, 3, B), **f32)
    Xp = torch.empty((N + 1, 4, B), **f32)
    Up = torch.empty((N, 2, B), **f32)
    k = torch.empty((N, 2, B), **f32)
    K = torch.empty((N, 8, B), **f32)
    cfg = _config(p, B, M, H, W, world.has_obs, world.has_unc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cilqr_lm_opt(
        ctypes.byref(cfg), *(t.data_ptr() for t in (
            fit_t, x0_t, U0s, obs, values, scl, X, U, J, lamb, it, sxy, Xp, Up, k, K)),
        stream)
    build.check(lib, rc, "LM kernel launch")
    LAUNCHES += 1
    return (riccati_cuda.from_scenario_minor(X, (4,)),
            riccati_cuda.from_scenario_minor(U, (2,)), it, J, lamb)


def _launch_iteration(p: SolverParams, world: WorldPrep, plans, X, U, lamb, uext):
    global ITER_LAUNCHES
    from cilqr_tpu_torch.utils import build

    N, S = p.horizon, p.n_closest_samples
    B = X.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    if world.has_unc:
        raise ValueError("K3 takes its uncertainty sample from uext; the world must hold no map")
    fit = _fit_payload(plans)
    sxy = torch.stack([plans.sample_xl, plans.sample_yl, plans.sample_r], dim=-1)
    for name, t, shape in (
        ("X", X, (B, N + 1, 4)), ("U", U, (B, N, 2)), ("lamb", lamb, (B,)),
        ("fit payload", fit, (B, p.poly_order + 11)), ("sample table", sxy, (B, S, 3)),
        ("uext", uext, (B, N, 3)),
    ):
        riccati_cuda.check_cuda_f32(name, t, shape)
    M, H, W = _check_world(world, N)
    lib = _load(build)
    ins = [fit.t().contiguous(), riccati_cuda.to_scenario_minor(sxy),
           riccati_cuda.to_scenario_minor(X), riccati_cuda.to_scenario_minor(U),
           lamb.contiguous(), riccati_cuda.to_scenario_minor(uext), world.obs.contiguous()]
    f32 = dict(dtype=torch.float32, device=X.device)
    outs = [torch.empty((N + 1, 4, B), **f32), torch.empty((N, 2, B), **f32),
            torch.empty((B,), **f32), torch.empty((N, 2, B), **f32),
            torch.empty((N, 8, B), **f32)]
    cfg = _config(p, B, M, H, W, world.has_obs, False)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.cilqr_lm_iter(ctypes.byref(cfg), *(t.data_ptr() for t in ins + outs), stream)
    build.check(lib, rc, "LM iteration kernel launch")
    ITER_LAUNCHES += 1
    Xn, Un, J, k, K = outs
    return (riccati_cuda.from_scenario_minor(Xn, (4,)), riccati_cuda.from_scenario_minor(Un, (2,)),
            J, riccati_cuda.from_scenario_minor(k, (2,)),
            riccati_cuda.from_scenario_minor(K, (2, 4)))


def fused_iteration(p: SolverParams, world: WorldPrep, plans, X, U, lamb, uext):
    """One LM iteration per scenario (``lm_pallas.fused_iteration`` with
    external planes): J of (X (B, N+1, 4), U (B, N, 2)) and the proposal
    after the backward pass at lamb (B,) and the rollout.  ``world`` from
    ``prep_world``, holding no map; ``uext`` (B, N, 3) the [e, gx, gy]
    uncertainty planes.  Returns (X_new, U_new, J) and, after them, the
    gains of the backward pass (k (B, N, 2), K (B, N, 2, 4))."""
    if X.device.type == "cpu":
        return fused_iteration_plain(p, world, plans, X, U, lamb, uext)
    return _launch_iteration(p, world, plans, X, U, lamb, uext)


def fused_optimize(p: SolverParams, plans, x0s, U_init, obstacles=None, unc_map=None,
                   unc_sampler=None):
    """The LM loop (iLQR.cpp:211-239, per-lane masks) over a (B, ...) batch.
    Same signature and result as ``solver_batched.batched_optimize``:
    (X, U, iterations, J, lamb).

    Without ``unc_sampler``: the world is shared and K1 runs the whole loop.
    With it (per-scenario uncertainty maps): a callable (B, N, >=2) states ->
    (B, N, 3) planes [e, gx, gy]; the host loop ``solver.optimize`` calls it
    on each iteration's trajectory and launches K3 on its planes, once per
    iteration.  ``unc_sampler`` and ``unc_map`` are mutually exclusive."""
    _check_sampler(unc_sampler, unc_map)
    if unc_sampler is not None:
        world = prep_world(p, obstacles, None, torch.float32, x0s.device)
        return solver.optimize(p, plans, x0s, U_init, iteration=_hybrid_iteration(
            p, world, plans, unc_sampler, fused_iteration))
    if x0s.device.type == "cpu":
        return fused_optimize_plain(p, plans, x0s, U_init, obstacles, unc_map)
    return _launch(p, plans, x0s, U_init, obstacles, unc_map)
