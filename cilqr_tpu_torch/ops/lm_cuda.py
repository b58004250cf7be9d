"""The LM solve per scenario in CUDA: kernels K1 (whole loop), K3 (one
iteration) and the hybrid loop's step kernel (one LM step over the lanes
still running).

Port of ``cilqr_tpu/ops/lm_pallas.py``.  K1 (``_opt_kernel`` via
``fused_optimize``, the in-kernel-loop form with a shared world)
regenerates each scenario's closest-point sample table from its fit
payload, then runs every LM iteration (derivatives, J, backward Riccati,
rollout, accept/reject, lambda, stop) in a group of G lanes.  K3
(``_iter_kernel`` via ``fused_iteration``) runs one iteration on a given
trajectory; with ``unc_sampler`` (one uncertainty map per scenario, the
Monte-Carlo and full-stack form) ``fused_optimize`` hands ``solver.optimize``
the hybrid iteration, which samples each scenario's map at the current
trajectory before every launch: on the card the LM loop replays it as CUDA
graphs.  Both are in ``csrc/lm.cu``; a block is one warp of T = 32 / G
scenarios whose sample tables it keeps in shared memory, and
``launch_shape`` picks G from the batch size.

Shared-world payloads are prepared once per solve: the obstacle quadratic
forms (``prep_obstacles``), the map and its frame scalars (``prep_unc_map``;
the kernel reads the four corners of the (H, W) map directly) and, for the
hybrid loop, K3's scenario-minor sample table and fit payload
(``prep_iteration``).  The initial rollout of U_init from x0 runs inside
the kernel (the JAX code does it outside, with ``dynamics.rollout``; the
plain version here still does).

``fused_optimize`` and ``fused_iteration`` take their plain versions
(``fused_optimize_plain``, ``fused_iteration_plain``) for tensors on the
CPU; for CUDA tensors they launch the kernel or raise.  K1 is launched only
by the op ``cilqr_torch::lm_opt`` (``_lm_opt``), K3 only by
``cilqr_torch::lm_iter`` (``_lm_iter``): tensors in, new tensors out, their
CPU implementations the plain versions, so a stream planner and a CUDA
graph see each launch as one op.  ``fused_optimize`` reaches K1's op
through ``_launch`` on the card and directly on the CPU.

The hybrid loop on a ``MapSampler`` brings its own LM step
(``HybridStep.lm_step``, which ``solver.step`` runs in place of
``solver.lm_step``): ``fused_step``, on the card one launch of the op
``cilqr_torch::lm_step``, which runs a one-block pass that lists the lanes
still running (``lm_lanes_kernel``) and the step kernel over them
(``lm_step_kernel``: each lane's own map sampled in the kernel, K3's
iteration, and ``lm_step``'s accept / damping / stop update on the loop's
state in place).  Its plain version, ``fused_step_plain``, is ``lm_step`` on
the hybrid iteration of ``fused_iteration_plain`` and the sampler.  The list
pass sums its counts on the card; the host reads that sum only while
tracing (``LANES_RUN``, through ``profiling.device_counters``).  A bare
sampler keeps ``lm_step`` around K3.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys
from typing import NamedTuple

import torch

from cilqr_tpu_torch.utils import build, graphs, profiling
from cilqr_tpu_torch.utils.params import SolverParams
from cilqr_tpu_torch.models import costs, solver
from cilqr_tpu_torch.models import uncertainty as uncertainty_mod
from cilqr_tpu_torch.models.obstacles import Obstacles
from cilqr_tpu_torch.models.reference_path import LocalPlan
from cilqr_tpu_torch.ops import riccati_cuda, route
from cilqr_tpu_torch.ops import gridmap as gridmap_mod
from cilqr_tpu_torch.ops.gridmap import GridGeom
from cilqr_tpu_torch.utils.device import resolve

LAUNCHES = 0  # K1 launches made by fused_optimize
ITER_LAUNCHES = 0  # K3 launches made by fused_iteration
LANE_LAUNCHES = 0  # lane-list passes (lm_lanes_kernel), one before each step kernel
STEP_LAUNCHES = 0  # step-kernel launches (lm_step_kernel) made by fused_step
graphs.COUNTERS.extend([(sys.modules[__name__], n) for n in (
    "LAUNCHES", "ITER_LAUNCHES", "LANE_LAUNCHES", "STEP_LAUNCHES")])
#: lane-steps the step kernel ran in the traced calls (a lane still running
#: counts once per step): the list passes sum their counts on each card
#: (``_LANES``), read while tracing (``profiling.device_counters``), after
#: the host has waited for the card
LANES_RUN = 0
_LANES = profiling.DeviceCounter(sys.modules[__name__], "LANES_RUN")

GROUP_SIZES = (1, 8, 32)           # lanes per scenario the kernels are built for
MAX_SHARED_BYTES = 232448           # what one block may opt in to on an H100
TABLE_BYTES_PER_SAMPLE = 8          # [sxl, syl] in float32; the kernels recompute r


class IterationInputs(NamedTuple):
    """K3's inputs that stay the same over a solve, in the kernel's layout.

    table: (S, 2, B) the local sample table [sxl, syl], scenario-minor (the
           kernel recomputes r = sxl^2 + syl^2 as ``_local_channels`` does).
    fit:   (poly_order+11, B) the fit payload, scenario-minor.
    plans: the plans they were made from.
    """

    table: torch.Tensor
    fit: torch.Tensor
    plans: object


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
    iteration: ``prep_iteration`` of the plans this world is solved with
            (``fused_iteration`` raises on any other plans), or None:
            ``fused_iteration`` then prepares them on every call.
    """

    obs: torch.Tensor
    values: torch.Tensor
    scl: torch.Tensor
    has_obs: bool
    has_unc: bool
    obstacles: object
    unc_map: object
    iteration: IterationInputs | None = None


def prep_obstacles(p: SolverParams, obs, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-(m, j) global-frame ellipse quadratic forms, (M*6, N), on the
    obstacles' device (without obstacles: on ``device``)."""
    N = p.horizon
    if obs is None:
        return torch.zeros((6, N), dtype=dtype, device=resolve(device))
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
    the box has lo > hi, so `inside` is never true.  On the map's device
    (without a map: on ``device``)."""
    if m is None:
        device = resolve(device)
        scl = torch.zeros(16, dtype=dtype, device=device)
        scl[7].fill_(1.0)  # fills: a copy from the host cannot be captured
        scl[8].fill_(-1.0)
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


def prep_iteration(plans) -> IterationInputs:
    """The sample table and the fit payload of ``plans`` as K3 reads them."""
    table = torch.stack([plans.sample_xl, plans.sample_yl], dim=-1)
    return IterationInputs(riccati_cuda.to_scenario_minor(table),
                           _fit_payload(plans).t().contiguous(), plans)


def split_tournament(d: torch.Tensor, G: int) -> torch.Tensor:
    """Plain version of the kernels' split tournament over distances d
    (..., S): lane g of G scans samples g, g+G, ... in ascending order and
    keeps its first minimum (strict <); a butterfly then merges the lanes'
    (d, j) pairs, the smaller d winning and, on equal d, the smaller j.
    Returns j (...), the first minimum of the whole row for any S."""
    S = d.shape[-1]
    inf = torch.full(d.shape[:-1], float("inf"), dtype=d.dtype, device=d.device)
    none = torch.full(d.shape[:-1], torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=d.device)
    best, arg = [], []
    for g in range(G):
        bd, bj = inf, none
        for s in range(g, S, G):
            better = d[..., s] < bd
            bd = torch.where(better, d[..., s], bd)
            bj = torch.where(better, torch.full_like(bj, s), bj)
        best.append(bd)
        arg.append(bj)
    off = G // 2
    while off > 0:
        merged = []
        for g in range(G):
            od, oj = best[g ^ off], arg[g ^ off]
            take = (od < best[g]) | ((od == best[g]) & (oj < arg[g]))
            merged.append((torch.where(take, od, best[g]), torch.where(take, oj, arg[g])))
        best, arg = [m[0] for m in merged], [m[1] for m in merged]
        off //= 2
    return torch.where(arg[0] < S, arg[0], torch.zeros_like(arg[0]))


def table_bytes(T: int, S: int) -> int:
    """Shared memory of a block that holds T scenarios' sample tables."""
    return T * S * TABLE_BYTES_PER_SAMPLE


# (G, the smallest B from which G lanes per scenario are used), largest B
# first, from K1's times on one H100 (chip_smoke.py times every G at B =
# 1024, 8192 and 32768; PERF.md has them): the whole warp while every
# scenario's group is resident at once (132 SMs x 16 warps), 8 lanes up to
# twice that many scenarios per lane slot, and one lane where B fills the
# card anyway: there more lanes only repeat the work outside the tournament.
_GROUP_FROM_B = ((1, 16384), (8, 2048), (32, 1))


def _check_group(G: int, S: int) -> int:
    """T = 32 / G, the scenarios of a block (one warp) at G lanes per
    scenario; raises if G is no group size or the block's tables do not fit
    in shared memory."""
    if G not in GROUP_SIZES:
        raise ValueError(f"G = {G} lanes per scenario: the kernels are built for {GROUP_SIZES}")
    T = 32 // G
    if table_bytes(T, S) > MAX_SHARED_BYTES:
        raise ValueError(f"{T} tables of S={S} samples take {table_bytes(T, S)} bytes of "
                         f"shared memory, more than the {MAX_SHARED_BYTES} a block can hold")
    return T


def launch_shape(B: int, S: int) -> tuple:
    """(T, G) for a batch of B scenarios with S table samples: G lanes per
    scenario and T = 32 / G scenarios per block (one warp).  One lane where
    B fills the card by itself, more as B shrinks, the whole warp for a few
    scenarios; the next larger G while the block's tables (T x S x 8 bytes)
    exceed its shared memory.  Raises if one scenario's table does not fit."""
    if B < 1:
        raise ValueError("empty batch")
    by_batch = next(g for g, min_b in _GROUP_FROM_B if B >= min_b)
    for G in GROUP_SIZES:
        if G >= by_batch and table_bytes(32 // G, S) <= MAX_SHARED_BYTES:
            return 32 // G, G
    raise ValueError(f"a sample table of S={S} samples takes {table_bytes(1, S)} bytes, "
                     f"more than the {MAX_SHARED_BYTES} of shared memory a block can hold")


def fused_iteration_plain(p: SolverParams, world: WorldPrep, plans, X, U, lamb, uext=None):
    """Plain version of K3: ``costs.all_cost_derivs_and_J`` at (X, U) (the
    uncertainty sample from ``uext`` (B, N, 3) when given), then the
    sequential backward recursion (``solver.backward_seq``, whatever
    ``p.backward_impl`` says, as the kernel) and the rollout.  Returns
    (X_new, U_new, J, k, K)."""
    d, J = costs.all_cost_derivs_and_J(p, plans, X, U, world.obstacles, world.unc_map,
                                       unc_planes=uext)
    k, K = solver.backward_seq(p, d, X, U, lamb)
    X_new, U_new = solver.forward_pass(p, X, U, k, K)
    return X_new, U_new, J, k, K


class MapSampler(NamedTuple):
    """(B, N, >=2) states -> (B, N, 3) planes [e, gx, gy] of one map per
    scenario (``uncertainty.uncertainty_sample_batched``).  Its fields are
    all it reads, so the hybrid loop's CUDA graphs take copies of them; a
    sampler given as a bare callable runs the loop eagerly.  Its kernels run
    inside a profiler range of the function's name."""

    p: SolverParams
    unc_map: object

    def __call__(self, Xb):
        with torch.profiler.record_function("uncertainty_sample_batched"):
            return torch.stack(
                uncertainty_mod.uncertainty_sample_batched(self.p, self.unc_map, Xb), dim=-1)


def prep_lane_maps(m) -> torch.Tensor:
    """(B, 16) geometry rows of one map per scenario, as the step kernel's
    sampler reads them: [origin_x, origin_y, cos yaw, sin yaw, first_x,
    first_y, res, lo_x, hi_x, lo_y, hi_y, -1/res, 0, 0, 0, 0], each by the
    PyTorch expression of ``uncertainty.uncertainty_sample_batched`` and
    ``gridmap.sample_bilinear_with_grad_batched``, so the kernel starts from
    the plain sampler's bits."""
    g = m.geom
    B = m.values.shape[0]
    res = g.resolution.reshape(B, 1)
    first = g.center + 0.5 * g.length - 0.5 * res
    lo = g.center - 0.5 * g.length
    hi = g.center + 0.5 * g.length
    cy, sy = torch.cos(m.origin_yaw).reshape(B), torch.sin(m.origin_yaw).reshape(B)
    z = torch.zeros_like(cy)
    return torch.stack([m.origin_xy[:, 0], m.origin_xy[:, 1], cy, sy, first[:, 0], first[:, 1],
                        res[:, 0], lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1], (-1.0 / res)[:, 0],
                        z, z, z, z], dim=1).contiguous()


def _hybrid(p: SolverParams, plans, step, world: WorldPrep, prepared, unc_sampler):
    """The hybrid iteration (X, U, lamb) -> (X_new, U_new, J): step(...) on
    the planes unc_sampler(X[:, :N]) (B, N, 3).  ``prepared``: (table, fit)
    of ``prep_iteration(plans)`` and, for the step kernel, the map's
    ``prep_lane_maps`` rows; or None.  With ``step`` = ``fused_iteration``
    and a ``MapSampler``, a ``HybridStep``, which brings its own LM step.
    The ``build`` of ``hybrid_iteration``'s ``solver.Iteration``."""
    if prepared is not None:
        world = world._replace(iteration=IterationInputs(*prepared[:2], plans))
    if step is fused_iteration and isinstance(unc_sampler, MapSampler):
        return HybridStep(p, world, plans, unc_sampler, prepared and prepared[2])

    def iteration(X, U, lamb):
        return step(p, world, plans, X, U, lamb, unc_sampler(X[:, :p.horizon]))[:3]

    return iteration


def hybrid_iteration(p: SolverParams, plans, obstacles, unc_sampler, step) -> solver.Iteration:
    """The hybrid LM iteration of ``fused_optimize`` (``step`` =
    ``fused_iteration``) or of its plain version (``fused_iteration_plain``)
    as ``solver.optimize`` takes it: replayed as CUDA graphs on the card
    when ``unc_sampler`` is a ``MapSampler`` (with ``fused_iteration``, its
    step is the step kernel's, ``HybridStep``); any other sampler gives the
    bare iteration, which runs eagerly, ``solver.lm_step`` around K3.  The
    kernels' inputs that stay the same over the solve are prepared here once
    (on the card)."""
    world = prep_world(p, obstacles, None, torch.float32, plans.coeffs.device)
    prepared = None
    if plans.coeffs.is_cuda:
        prep = prep_iteration(plans)
        prepared = (prep.table, prep.fit)
        if step is fused_iteration and isinstance(unc_sampler, MapSampler):
            prepared += (prep_lane_maps(unc_sampler.unc_map),)
    it = solver.Iteration(_hybrid, (step, world, prepared, unc_sampler))
    return it if isinstance(unc_sampler, MapSampler) else it.build(p, plans, *it.world)


class HybridStep(NamedTuple):
    """The hybrid iteration of ``fused_iteration`` on a ``MapSampler`` as its
    own LM step: ``lm_step(lamb_inv, *state)`` is ``fused_step``, which
    ``solver.step`` runs in place of ``solver.lm_step``.  ``geo``: the map's
    ``prep_lane_maps`` rows (None off the card)."""

    p: SolverParams
    world: WorldPrep
    plans: object
    sampler: MapSampler
    geo: object

    def lm_step(self, lamb_inv, X, U, lamb, J_old, it, done) -> tuple:
        return fused_step(self.p, self.world, self.plans, self.sampler, self.geo, lamb_inv, X, U,
                          lamb, J_old, it, done)


def fused_step_plain(p: SolverParams, world: WorldPrep, plans, sampler, lamb_inv, X, U, lamb,
                     J_old, it, done) -> tuple:
    """Plain version of the step kernel: ``solver.lm_step`` on the hybrid
    iteration of ``fused_iteration_plain`` fed by ``sampler``.  Returns the
    new state (X, U, lamb, J_old, it, done)."""
    iteration = _hybrid(p, plans, fused_iteration_plain, world, None, sampler)
    return solver.lm_step(p, iteration, lamb_inv, X, U, lamb, J_old, it, done)


def running_lanes_plain(done: torch.Tensor) -> tuple:
    """Plain version of the list pass: (lanes (B,) int32 whose first count
    entries are the lanes b with ~done[b] in lane order, -1 after them;
    count (1,) int32)."""
    run = torch.nonzero(~done).reshape(-1).to(torch.int32)
    lanes = torch.full(done.shape, -1, dtype=torch.int32, device=done.device)
    lanes[:run.numel()] = run
    return lanes, torch.tensor([run.numel()], dtype=torch.int32, device=done.device)


def running_lanes(done: torch.Tensor) -> tuple:
    """The list pass alone, as the step op runs it before the step kernel:
    on the card one launch of ``lm_lanes_kernel`` (entries past the count
    left as they were, here -1), for CPU tensors ``running_lanes_plain``.
    It adds nothing to the lane total."""
    global LANE_LAUNCHES
    if not done.is_cuda or route.plain_on_card():
        return running_lanes_plain(done)
    _check_mask("done", done, (done.numel(),), torch.bool, done.device)
    lanes = torch.full(done.shape, -1, dtype=torch.int32, device=done.device)
    count = torch.empty(1, dtype=torch.int32, device=done.device)
    lib = _load(build)
    with torch.cuda.device(done.device):
        rc = lib.cilqr_lm_lanes(done.data_ptr(), done.numel(), lanes.data_ptr(), count.data_ptr(),
                                None, torch.cuda.current_stream(done.device).cuda_stream)
    build.check(lib, rc, "lane list launch")
    LANE_LAUNCHES += 1
    return lanes, count


def lane_cells_plain(m, X: torch.Tensor) -> torch.Tensor:
    """The corner cell i0 * W + j0 that ``uncertainty_sample_batched``
    interpolates from at each state of X (B, N, >=2) on one map per
    scenario: (B, N) int64."""
    B, H, W = m.values.shape
    cy = torch.cos(m.origin_yaw).reshape(B, 1)
    sy = torch.sin(m.origin_yaw).reshape(B, 1)
    local = uncertainty_mod._to_map_frame(m, X, cy, sy)
    res = m.geom.resolution.reshape(B, 1)
    first = m.geom.center + 0.5 * m.geom.length - 0.5 * res
    ci = (first[:, None, :] - local) / res[:, :, None]
    i0, j0, _, _ = gridmap_mod._corner_index(ci[..., 0], ci[..., 1], H, W)
    return i0 * W + j0


def lane_sample(p: SolverParams, m, X: torch.Tensor) -> tuple:
    """The step kernel's sampler alone on the card, at each lane's states
    X[:, :N] (X (B, N+1, 4) float32) on its own map of ``m`` (one per
    scenario): (planes (B, N, 3) [e, gx, gy], cells (B, N) int32 i0 * W +
    j0), for the checks against ``MapSampler`` and ``lane_cells_plain``."""
    B, H, W = m.values.shape
    N = p.horizon
    riccati_cuda.check_cuda_f32("X", X, (B, N + 1, 4))
    riccati_cuda.check_cuda_f32("uncertainty maps", m.values, (B, H, W))
    geo = prep_lane_maps(m)
    planes = torch.empty((B, N, 3), dtype=torch.float32, device=X.device)
    cells = torch.empty((B, N), dtype=torch.int32, device=X.device)
    cfg = _config(p, B, 1, H, W, False, True)
    lib = _load(build)
    with torch.cuda.device(X.device):
        rc = lib.cilqr_lm_sample(ctypes.byref(cfg), m.values.contiguous().data_ptr(),
                                 geo.data_ptr(), X.contiguous().data_ptr(), planes.data_ptr(),
                                 cells.data_ptr(), torch.cuda.current_stream(X.device).cuda_stream)
    build.check(lib, rc, "lane sampler launch")
    return planes, cells


def _check_sampler(unc_sampler, unc_map) -> None:
    if unc_sampler is not None and unc_map is not None:
        raise ValueError("unc_sampler and unc_map are mutually exclusive")


def fused_optimize_plain(p: SolverParams, plans, x0s, U_init, obstacles=None, unc_map=None,
                         unc_sampler=None):
    """Plain version of ``fused_optimize``: ``solver.optimize``, the batched
    LM loop with per-lane masks, on the plain iteration with the sequential
    backward recursion, as the kernel (with ``unc_sampler``: on
    ``fused_iteration_plain`` fed by the sampler).
    Returns (X, U, iterations, J, lamb)."""
    _check_sampler(unc_sampler, unc_map)
    if unc_sampler is None:
        return solver.optimize(dataclasses.replace(p, backward_impl="seq"), plans, x0s, U_init,
                               obstacles, unc_map)
    return solver.optimize(p, plans, x0s, U_init, iteration=hybrid_iteration(
        p, plans, obstacles, unc_sampler, fused_iteration_plain))


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
        "lamb_init", "lamb_factor", "lamb_inv", "lamb_max", "tol",
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
        lamb_init=p.lamb_init, lamb_factor=p.lamb_factor,
        lamb_inv=float(torch.tensor(p.lamb_factor, dtype=torch.float32).reciprocal()),
        lamb_max=p.lamb_max, tol=p.tolerance,
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


KERNELS = ("lm_iter", "lm_opt", "lm_step")  # K3, K1, the step kernel: cilqr_lm_resources' ids


def kernel_resources(kernel: str, G: int, S: int) -> dict:
    """What the compiler and the current card give ``kernel`` (of
    ``KERNELS``) at G lanes per scenario: registers and local-memory bytes
    per thread, shared memory per block, resident blocks per SM, and the
    card's SMs."""
    _check_group(G, S)
    return _resources(KERNELS.index(kernel), G, S, torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _resources(kernel_id: int, G: int, S: int, device_index: int) -> dict:
    lib = _load(build)
    out = (ctypes.c_int * 5)()
    build.check(lib, lib.cilqr_lm_resources(kernel_id, G, S, out), "LM kernel resources")
    return dict(registers=out[0], local_bytes=out[1], shared_bytes=out[2], blocks_per_sm=out[3],
                sms=out[4])


def _unc_map_args(m) -> list:
    """An uncertainty map as the op's tensor list (empty: no map)."""
    return [] if m is None else [m.values, *m.geom, m.origin_xy, m.origin_yaw]


def _unc_map_of(ts: list):
    """The inverse of ``_unc_map_args``."""
    return uncertainty_mod.UncertaintyMap(ts[0], GridGeom(*ts[1:4]), ts[4], ts[5]) if ts else None


@torch.library.custom_op(
    "cilqr_torch::lm_opt", mutates_args=(), device_types="cpu",
    schema="(str params, Tensor fit, Tensor x0s, Tensor U_init, Tensor obs, Tensor values, "
           "Tensor scl, bool has_obs, bool has_unc, int G, int blocks, Tensor[] plans, "
           "Tensor[] obstacles, Tensor[] unc_map) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _lm_opt(params, fit, x0s, U_init, obs, values, scl, has_obs, has_unc, G, blocks, plans,
            obstacles, unc_map):
    """K1 as an op -> (X, U, iterations, J, lamb).  On the CPU the plain
    version, which reads the plans, obstacles and map (their fields in
    order; none: empty) where the kernel reads their payloads (``fit``,
    ``obs``, ``values``, ``scl``); on the card the kernel
    (``_lm_opt_kernel``)."""
    return fused_optimize_plain(riccati_cuda.params_of(params), LocalPlan(*plans), x0s, U_init,
                                Obstacles(*obstacles) if obstacles else None,
                                _unc_map_of(unc_map))


@_lm_opt.register_fake
def _lm_opt_fake(params, fit, x0s, U_init, obs, values, scl, has_obs, has_unc, G, blocks, plans,
                 obstacles, unc_map):
    B, N = U_init.shape[0], U_init.shape[1]
    return (x0s.new_empty((B, N + 1, 4)), U_init.new_empty((B, N, 2)),
            x0s.new_empty((B,), dtype=torch.int32), x0s.new_empty((B,)), x0s.new_empty((B,)))


@_lm_opt.register_kernel("cuda")
def _lm_opt_kernel(params, fit, x0s, U_init, obs, values, scl, has_obs, has_unc, G, blocks,
                   plans, obstacles, unc_map):
    """The op on the card: one launch of ``lm_opt_kernel<G>`` on the current
    stream, ``blocks`` persistent groups taking scenarios from a counter
    that the op zeroes before the launch (in a CUDA graph: on every
    replay)."""
    global LAUNCHES
    p = riccati_cuda.params_of(params)
    N = p.horizon
    B = x0s.shape[0]
    H, W = values.shape
    Q = blocks * (32 // G)
    dev = x0s.device
    lib = _load(build)
    ins = [fit, x0s.contiguous(), U_init.contiguous(), obs.contiguous(), values.contiguous(),
           scl.contiguous(), torch.zeros(1, dtype=torch.int32, device=dev)]
    f32 = dict(dtype=torch.float32, device=dev)
    X = torch.empty((B, N + 1, 4), **f32)
    U = torch.empty((B, N, 2), **f32)
    J = torch.empty((B,), **f32)
    lamb = torch.empty((B,), **f32)
    it = torch.empty((B,), dtype=torch.int32, device=dev)
    scratch = [torch.empty(shape_, **f32) for shape_ in (
        (N + 1, 4, Q), (N + 1, 4, Q), (N, 2, Q), (N, 2, Q), (N, 2, Q), (N, 8, Q))]
    cfg = _config(p, B, obs.shape[0] // 6, H, W, has_obs, has_unc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the card of the tensors, whichever is current
        rc = lib.cilqr_lm_opt(
            ctypes.byref(cfg), *(t.data_ptr() for t in ins + [X, U, J, lamb, it] + scratch),
            blocks, G, stream)
    build.check(lib, rc, "LM kernel launch")
    LAUNCHES += 1
    return X, U, it, J, lamb


def opt_op(p: SolverParams, plans, x0s, U_init, world: WorldPrep, G: int, blocks: int):
    """K1's op on these arguments (``world`` from ``prep_world``), the fit
    payload made scenario-minor."""
    return torch.ops.cilqr_torch.lm_opt(
        riccati_cuda.params_arg(p), _fit_payload(plans).t().contiguous(), x0s, U_init, world.obs,
        world.values, world.scl, world.has_obs, world.has_unc, G, blocks, list(plans),
        [] if world.obstacles is None else list(world.obstacles), _unc_map_args(world.unc_map))


def _launch(p: SolverParams, plans, x0s, U_init, obstacles, unc_map, G=None):
    """K1 on batch-major CUDA tensors, checked, then through its op (inside
    ``route.plain()`` its plain version)."""
    if route.plain_on_card():
        return fused_optimize_plain(p, plans, x0s, U_init, obstacles, unc_map)
    N, S = p.horizon, p.n_closest_samples
    B = x0s.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    # G: another group size than launch_shape's (the card's comparisons)
    T, G = launch_shape(B, S) if G is None else (_check_group(G, S), G)
    for name, t, shape_ in (
        ("x0s", x0s, (B, 4)), ("U_init", U_init, (B, N, 2)),
        ("fit payload", _fit_payload(plans), (B, p.poly_order + 11)),
    ):
        riccati_cuda.check_cuda_f32(name, t, shape_)
    dev = x0s.device
    world = prep_world(p, obstacles, unc_map, torch.float32, dev)
    _check_world(world, N)
    # as many blocks as the card holds at once: each group of lanes takes
    # scenarios from a counter until none is left
    with torch.cuda.device(dev):
        res = kernel_resources("lm_opt", G, S)
    blocks = min(-(-B // T), res["sms"] * res["blocks_per_sm"])
    return opt_op(p, plans, x0s, U_init, world, G, blocks)


@torch.library.custom_op(
    "cilqr_torch::lm_iter", mutates_args=(), device_types="cpu",
    schema="(str params, Tensor fit, Tensor table, Tensor X, Tensor U, Tensor lamb, "
           "Tensor uext, Tensor obs, bool has_obs, int G, Tensor[] plans, "
           "Tensor[] obstacles) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _lm_iter(params, fit, table, X, U, lamb, uext, obs, has_obs, G, plans, obstacles):
    """K3 as an op -> (X_new, U_new, J, k, K), batch-major.  On the CPU the
    plain version, which reads the plans and obstacles (their fields in
    order; no obstacles: empty) where the kernel reads their payloads
    (``fit``, ``table``, ``obs``); on the card the kernel
    (``_lm_iter_kernel``)."""
    world = WorldPrep(obs, None, None, has_obs, False, Obstacles(*obstacles) if obstacles else None,
                      None)
    return fused_iteration_plain(riccati_cuda.params_of(params), world, LocalPlan(*plans), X, U,
                                 lamb, uext)


@_lm_iter.register_kernel("cuda")
def _lm_iter_kernel(params, fit, table, X, U, lamb, uext, obs, has_obs, G, plans, obstacles):
    """The op on the card: one launch of ``lm_iter_kernel<G>`` on the
    current stream."""
    global ITER_LAUNCHES
    p = riccati_cuda.params_of(params)
    N = p.horizon
    B = X.shape[0]
    lib = _load(build)
    ins = [fit, table, riccati_cuda.to_scenario_minor(X), riccati_cuda.to_scenario_minor(U),
           lamb.contiguous(), riccati_cuda.to_scenario_minor(uext), obs.contiguous()]
    f32 = dict(dtype=torch.float32, device=X.device)
    outs = [torch.empty((N + 1, 4, B), **f32), torch.empty((N, 2, B), **f32),
            torch.empty((B,), **f32), torch.empty((N, 2, B), **f32),
            torch.empty((N, 8, B), **f32)]
    # a world without a map holds a 2 x 2 one (``prep_unc_map``), unread
    cfg = _config(p, B, obs.shape[0] // 6, 2, 2, has_obs, False)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_lm_iter(ctypes.byref(cfg), *(t.data_ptr() for t in ins + outs), G, stream)
    build.check(lib, rc, "LM iteration kernel launch")
    ITER_LAUNCHES += 1
    Xn, Un, J, k, K = outs
    return (riccati_cuda.from_scenario_minor(Xn, (4,)), riccati_cuda.from_scenario_minor(Un, (2,)),
            J, riccati_cuda.from_scenario_minor(k, (2,)),
            riccati_cuda.from_scenario_minor(K, (2, 4)))


def iteration_op(p: SolverParams, world: WorldPrep, plans, X, U, lamb, uext, G: int):
    """K3's op on these arguments (``world.iteration``, when set, must be
    ``prep_iteration(plans)``)."""
    prep = world.iteration or prep_iteration(plans)
    obstacles = [] if world.obstacles is None else list(world.obstacles)
    return torch.ops.cilqr_torch.lm_iter(riccati_cuda.params_arg(p), prep.fit, prep.table, X, U,
                                         lamb, uext, world.obs, world.has_obs, G, list(plans),
                                         obstacles)


def _launch_iteration(p: SolverParams, world: WorldPrep, plans, X, U, lamb, uext, G=None):
    """K3 on batch-major tensors, checked, then through its op (inside
    ``route.plain()`` its plain version)."""
    if route.plain_on_card():
        return fused_iteration_plain(p, world, plans, X, U, lamb, uext)
    N, S = p.horizon, p.n_closest_samples
    B = X.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    if world.has_unc:
        raise ValueError("K3 takes its uncertainty sample from uext; the world must hold no map")
    if G is None:
        G = launch_shape(B, S)[1]
    else:  # another group size than launch_shape's (the card's comparisons)
        _check_group(G, S)
    prep = world.iteration or prep_iteration(plans)
    if prep.plans is not plans:
        raise ValueError("world.iteration was prepared from other plans than these")
    for name, t, shape_ in (
        ("X", X, (B, N + 1, 4)), ("U", U, (B, N, 2)), ("lamb", lamb, (B,)),
        ("fit payload", prep.fit, (p.poly_order + 11, B)), ("sample table", prep.table, (S, 2, B)),
        ("uext", uext, (B, N, 3)),
    ):
        riccati_cuda.check_cuda_f32(name, t, shape_)
    _check_world(world, N)
    return iteration_op(p, world._replace(iteration=prep), plans, X, U, lamb, uext, G)


def fused_iteration(p: SolverParams, world: WorldPrep, plans, X, U, lamb, uext):
    """One LM iteration per scenario (``lm_pallas.fused_iteration`` with
    external planes): J of (X (B, N+1, 4), U (B, N, 2)) and the proposal
    after the backward pass at lamb (B,) and the rollout.  ``world`` from
    ``prep_world``, holding no map; ``uext`` (B, N, 3) the [e, gx, gy]
    uncertainty planes.  ``world.iteration``, when set, must be
    ``prep_iteration`` of these very plans (the hybrid loop builds it once
    per solve); other plans raise.
    Returns (X_new, U_new, J) and, after them, the gains of the backward
    pass (k (B, N, 2), K (B, N, 2, 4))."""
    if X.device.type == "cpu":
        return fused_iteration_plain(p, world, plans, X, U, lamb, uext)
    return _launch_iteration(p, world, plans, X, U, lamb, uext)


@torch.library.custom_op(
    "cilqr_torch::lm_step", mutates_args=("X", "U", "lamb", "J_old", "it", "done", "total"),
    device_types="cpu",
    schema="(str params, Tensor fit, Tensor table, Tensor maps, Tensor geo, Tensor obs, "
           "bool has_obs, int G, Tensor[] plans, Tensor[] obstacles, Tensor[] unc_map, "
           "Tensor(a!) X, Tensor(b!) U, Tensor(c!) lamb, Tensor(d!) J_old, Tensor(e!) it, "
           "Tensor(f!) done, Tensor(g!) total) -> ()")
def _lm_step(params, fit, table, maps, geo, obs, has_obs, G, plans, obstacles, unc_map, X, U,
             lamb, J_old, it, done, total):
    """The step kernel as an op: one hybrid LM step on the loop's state (X,
    U, lamb, J_old, it, done) in place, the lanes it runs added to
    ``total``.  On the CPU the plain version, which reads the plans,
    obstacles and the sampler's map (their fields in order; no obstacles:
    empty) where the kernel reads their payloads (``fit``, ``table``,
    ``obs``, ``maps``, ``geo``); on the card the list pass and the kernel
    (``_lm_step_kernel``)."""
    p = riccati_cuda.params_of(params)
    world = WorldPrep(obs, None, None, has_obs, False, Obstacles(*obstacles) if obstacles else None,
                      None)
    total.add_((~done).sum())
    new = fused_step_plain(p, world, LocalPlan(*plans), MapSampler(p, _unc_map_of(unc_map)),
                           solver.damping_inverse(p, X.dtype, X.device), X, U, lamb, J_old, it,
                           done)
    for dst, src in zip((X, U, lamb, J_old, it, done), new):
        dst.copy_(src)


@_lm_step.register_fake
def _lm_step_fake(params, fit, table, maps, geo, obs, has_obs, G, plans, obstacles, unc_map, X, U,
                  lamb, J_old, it, done, total):
    return None


@_lm_step.register_kernel("cuda")
def _lm_step_kernel(params, fit, table, maps, geo, obs, has_obs, G, plans, obstacles, unc_map, X,
                    U, lamb, J_old, it, done, total):
    """The op on the card, on the current stream: ``lm_lanes_kernel`` (one
    block) lists the lanes still running, then ``lm_step_kernel<G>`` runs
    one step over them.  The proposal and the gains go to per-slot scratch
    of the op's own.  In a warm-up (``graphs.warming_up``), whose work is
    thrown away, the list pass adds nothing to ``total``."""
    global LANE_LAUNCHES, STEP_LAUNCHES
    p = riccati_cuda.params_of(params)
    N = p.horizon
    B, H, W = maps.shape
    dev = X.device
    lib = _load(build)
    lanes = torch.empty((B,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = [torch.empty(shape_, **f32) for shape_ in ((B, N + 1, 4), (B, N, 2), (B, N, 2),
                                                          (B, N, 8))]
    cfg = _config(p, B, obs.shape[0] // 6, H, W, has_obs, True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the card of the tensors, whichever is current
        rc = lib.cilqr_lm_lanes(done.data_ptr(), B, lanes.data_ptr(), count.data_ptr(),
                                None if graphs.warming_up() else total.data_ptr(), stream)
        build.check(lib, rc, "lane list launch")
        LANE_LAUNCHES += 1
        rc = lib.cilqr_lm_step(
            ctypes.byref(cfg), *(t.data_ptr() for t in (fit, table, maps, geo, obs, lanes, count,
                                                          X, U, lamb, J_old, it, done, *scratch)),
            G, stream)
    build.check(lib, rc, "LM step kernel launch")
    STEP_LAUNCHES += 1


def _check_mask(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    """Raise unless t is a contiguous tensor of ``dtype`` and ``shape`` on
    ``device`` (the step kernel reads it, or writes it in place, as one
    dense block)."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the step kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor of shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}{'' if t.is_contiguous() else ' (not contiguous)'}")


def _launch_step(p: SolverParams, world: WorldPrep, plans, sampler, geo, lamb_inv, X, U, lamb,
                 J_old, it, done, G=None) -> tuple:
    """The step kernel on the loop's state, checked, then through its op
    (inside ``route.plain()`` its plain version).  ``world.iteration`` must
    be ``prep_iteration(plans)``, ``geo`` the sampler's map's
    ``prep_lane_maps``.  Returns the state, updated in place."""
    if route.plain_on_card():
        return fused_step_plain(p, world, plans, sampler, lamb_inv, X, U, lamb, J_old, it, done)
    N, S = p.horizon, p.n_closest_samples
    B = X.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    if G is None:
        G = launch_shape(B, S)[1]
    else:  # another group size than launch_shape's (the card's comparisons)
        _check_group(G, S)
    prep = world.iteration
    if prep is None or prep.plans is not plans:
        raise ValueError("the step kernel reads prep_iteration of these plans (world.iteration)")
    if world.has_unc:
        raise ValueError("the step kernel samples the sampler's maps; the world must hold no map")
    if not X.is_cuda:
        raise ValueError(f"X: expected a CUDA tensor, got device {X.device}")
    m = sampler.unc_map
    maps = m.values.contiguous()
    if maps.ndim != 3 or maps.shape[0] != B or min(maps.shape[1:]) < 2:
        raise ValueError(f"uncertainty maps: one map of at least 2 x 2 per lane, got "
                         f"{tuple(maps.shape)} for {B} lanes")
    dev = X.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    for name, t, shape_, dtype in (
        ("X", X, (B, N + 1, 4), f32), ("U", U, (B, N, 2), f32), ("lamb", lamb, (B,), f32),
        ("J_old", J_old, (B,), f32), ("it", it, (B,), i32), ("done", done, (B,), b8),
        ("uncertainty maps", maps, maps.shape, f32), ("geometry rows", geo, (B, 16), f32),
        ("fit payload", prep.fit, (p.poly_order + 11, B), f32),
        ("sample table", prep.table, (S, 2, B), f32),
    ):
        _check_mask(name, t, shape_, dtype, dev)
    _check_world(world, N)
    obstacles = [] if world.obstacles is None else list(world.obstacles)
    torch.ops.cilqr_torch.lm_step(riccati_cuda.params_arg(p), prep.fit, prep.table, maps, geo,
                                  world.obs, world.has_obs, G, list(plans), obstacles,
                                  _unc_map_args(m), X, U, lamb, J_old, it, done,
                                  _LANES.total(dev))
    return X, U, lamb, J_old, it, done


def fused_step(p: SolverParams, world: WorldPrep, plans, sampler, geo, lamb_inv, X, U, lamb,
               J_old, it, done) -> tuple:
    """One LM step of the hybrid loop (``solver.lm_step`` on the hybrid
    iteration of the sampler's planes): on the card the step kernel over
    the lanes still running, on the state in place; for CPU tensors
    ``fused_step_plain``.  Returns the new state (X, U, lamb, J_old, it,
    done)."""
    if X.device.type == "cpu":
        return fused_step_plain(p, world, plans, sampler, lamb_inv, X, U, lamb, J_old, it, done)
    return _launch_step(p, world, plans, sampler, geo, lamb_inv, X, U, lamb, J_old, it, done)


def fused_optimize(p: SolverParams, plans, x0s, U_init, obstacles=None, unc_map=None,
                   unc_sampler=None):
    """The LM loop (iLQR.cpp:211-239, per-lane masks) over a (B, ...) batch.
    Same signature and result as ``solver_batched.batched_optimize``:
    (X, U, iterations, J, lamb).

    Without ``unc_sampler``: the world is shared and K1 runs the whole loop.
    With it (per-scenario uncertainty maps): a callable (B, N, >=2) states ->
    (B, N, 3) planes [e, gx, gy], ``MapSampler`` on the paths
    (``hybrid_iteration``).  With a ``MapSampler`` each LM step on the card
    is the step kernel over the lanes still running, which samples each
    lane's map itself, replayed as a CUDA graph (``solver.GRAPHS``); a bare
    sampler's planes feed K3 in ``solver.lm_step``, eagerly.
    ``unc_sampler`` and ``unc_map`` are mutually exclusive."""
    _check_sampler(unc_sampler, unc_map)
    if unc_sampler is not None:
        return solver.optimize(p, plans, x0s, U_init, iteration=hybrid_iteration(
            p, plans, obstacles, unc_sampler, fused_iteration))
    if x0s.device.type == "cpu":
        # the op's CPU implementation, the plain version, reads no G or
        # block count
        return opt_op(p, plans, x0s, U_init,
                      prep_world(p, obstacles, unc_map, torch.float32, x0s.device), 1, 1)
    return _launch(p, plans, x0s, U_init, obstacles, unc_map)
