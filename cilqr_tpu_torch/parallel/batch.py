"""Scenario batching and sharding over a mesh of devices.

Port of ``cilqr_tpu/parallel/batch.py``.  The scaling axis is scenarios:
the whole solve is a pure function of each scenario's inputs, so

  * one device    = the batched functions on a leading (B, ...) axis (the
    counterpart of the JAX package's ``vmap``);
  * a mesh        = an ordered list of ``torch.device``: a sharded call
    splits the leading batch axis into equal contiguous blocks (shard i owns
    rows [i*b, (i+1)*b)), runs each block on its device with every other
    input replicated there, concatenates the per-scenario results in shard
    order on the mesh's first device, and reduces the metric sums over the
    shards (the counterpart of ``shard_map`` + ``psum``);
  * processes     = ``torch.distributed``: each process drives its own part
    of the global mesh on its own rows (``parallel.multihost``); only the
    metric sums cross processes, by ``all_reduce`` (SUM for the sums, MAX for
    the max) when a process group is initialised.

A mesh may repeat a device: 8 entries of ``cpu`` (as the JAX tests' forced
8 host devices) or 4 of ``cuda:0`` form a mesh of virtual shards, which
checks the sharding semantics on one device.  The host drives the shards
one after another, so virtual shards on one card cost their launches each
and buy no speed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from cilqr_tpu_torch.models import solver, solver_batched
from cilqr_tpu_torch.sim import plant
from cilqr_tpu_torch.utils import prng
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams

BATCH_AXIS = "scenarios"


class BatchMetrics(NamedTuple):
    """Global (cross-shard, cross-process) reductions of per-scenario results."""

    mean_J: torch.Tensor
    max_J: torch.Tensor
    mean_iterations: torch.Tensor
    # stopped early on |dJ| < tol (excludes lambda-abort lanes; a lane whose
    # tolerance stop lands exactly on the max_iterations-th iteration is
    # indistinguishable from exhaustion and counts as unconverged)
    converged_frac: torch.Tensor


class ProcessBlock(NamedTuple):
    """This process's rows of a global scenario batch: rows
    [offset, offset + len(local)) (``multihost.put_global`` /
    ``multihost.scatter_local``).  Sharded calls take it where they take a
    batched tensor and work on ``local``."""

    local: torch.Tensor
    offset: int


def make_mesh(devices=None) -> list:
    """1-D scenario mesh: every CUDA device (``cuda:0`` alone on one card),
    or the given devices in order, repeats allowed."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass the devices, e.g. ['cpu'] * 8")
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: empty device list")
    return mesh


def to_device(tree, device):
    """A nest of NamedTuples / tuples / lists / dicts with tensor leaves on
    ``device`` (other leaves as they are; no copy where a tensor is there
    already)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def local_rows(x) -> torch.Tensor:
    return x.local if isinstance(x, ProcessBlock) else x


def shard_blocks(mesh: list, *batched) -> tuple:
    """(rows per shard b, per shard the list of its row blocks of each
    batched tensor) for the mesh; raises ValueError if the mesh does not
    divide the batch."""
    B, n = batched[0].shape[0], len(mesh)
    if B % n:
        raise ValueError(f"batch {B} not divisible by mesh size {n}")
    b = B // n
    return b, [[t[i * b:(i + 1) * b] for t in batched] for i in range(n)]


def concat_shards(parts: list, device, dim: int = 0):
    """Per-shard results (tensors, NamedTuples or dicts of tensors)
    concatenated in shard order on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in parts], dim=dim)
    if isinstance(first, dict):
        return {k: concat_shards([p[k] for p in parts], device, dim) for k in first}
    return type(first)(*(concat_shards(list(f), device, dim) for f in zip(*parts)))


def process_rank() -> int:
    """This process's rank in the process group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def first_shard(x, b: int) -> int:
    """The global index of the first shard of ``x``'s rows, ``b`` rows per
    shard: a ``ProcessBlock``'s offset // b, 0 for a tensor (the whole
    batch).  Raises ValueError for an offset off the shard grid, or for a
    tensor when the process group has more than one rank (the processes
    would draw the same streams)."""
    if isinstance(x, ProcessBlock):
        if x.offset % b:
            raise ValueError(f"block offset {x.offset} is not a multiple of {b} rows per shard")
        return x.offset // b
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError("under a process group of several ranks pass this process's rows as a "
                         "ProcessBlock (multihost.put_global / scatter_local)")
    return 0


def _all_reduce(sums: torch.Tensor, mx: Optional[torch.Tensor] = None) -> tuple:
    """``sums`` summed and ``mx`` maxed across processes when a process
    group is initialised (as given otherwise)."""
    if dist.is_available() and dist.is_initialized():
        sums = sums.clone()
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        if mx is not None:
            mx = mx.reshape(1).clone()
            dist.all_reduce(mx, op=dist.ReduceOp.MAX)
            mx = mx[0]
    return sums, mx


def metric_sums(p: SolverParams, res: solver.SolveResult) -> tuple:
    """(sums [J, iterations, converged, count], max J) of one block."""
    J = res.J
    # early stop + lambda still in range <=> tolerance convergence; a
    # lambda-abort lane (iLQR.cpp:233-236) ends with lamb > lamb_max
    conv = ((res.iterations < p.max_iterations) & (res.lamb <= p.lamb_max)).to(J.dtype)
    sums = torch.stack([J.sum(), res.iterations.to(J.dtype).sum(), conv.sum(),
                        J.new_tensor(float(J.shape[0]))])
    return sums, J.max()


def reduce_metrics(parts: list, device) -> BatchMetrics:
    """BatchMetrics from per-shard ``metric_sums``: summed (max) over the
    shards on ``device``, then across processes."""
    sums = torch.stack([s.to(device) for s, _ in parts]).sum(dim=0)
    mx = torch.stack([m.to(device) for _, m in parts]).amax()
    sums, mx = _all_reduce(sums, mx)
    n = sums[3]
    return BatchMetrics(sums[0] / n, mx, sums[1] / n, sums[2] / n)


def _metrics_local(p: SolverParams, res: solver.SolveResult, axis: Optional[str] = None) -> BatchMetrics:
    """BatchMetrics of one block's result; with ``axis`` also reduced across
    processes (the JAX ``psum`` over the mesh axis)."""
    sums, mx = metric_sums(p, res)
    if axis is not None:
        sums, mx = _all_reduce(sums, mx)
    n = sums[3]
    return BatchMetrics(sums[0] / n, mx, sums[1] / n, sums[2] / n)


def batched_solve(p: SolverParams, plan_xy, plan_n, egos, U_warm, obstacles=None, unc_map=None):
    """``solver.run_step`` over the scenario axis of (egos (B, 4),
    U_warm (B, N, 2)); plan, obstacles and uncertainty map shared across
    the batch (one world, many sampled initial states)."""
    return solver.run_step(p, plan_xy, plan_n, egos, U_warm, obstacles, unc_map)


def solve_and_reduce(p: SolverParams, plan_xy, plan_n, egos, U_warm, obstacles=None,
                     unc_map=None, axis: Optional[str] = None):
    res = batched_solve(p, plan_xy, plan_n, egos, U_warm, obstacles, unc_map)
    return res, _metrics_local(p, res, axis)


def make_sharded_solver(p: SolverParams, mesh: list, obstacles=None, unc_map=None,
                        fused: bool = False):
    """A scenario-sharded solver over the mesh: egos and U_warm split on
    their leading axis, everything else replicated, metrics reduced over
    the shards and the processes.

    ``fused=True`` runs each shard through ``run_steps_batched(impl="mega")``
    (kernel K1 on the card); the default is the plain batched
    ``solver.run_step`` (the JAX package's ``vmap`` route).

    Returns ``(fn, mesh)``: ``fn(plan_xy, plan_n, egos, U_warm) ->
    (SolveResult of this process's rows on mesh[0], BatchMetrics)``; egos
    and U_warm are tensors or ``ProcessBlock``s."""
    world = {dev: to_device((obstacles, unc_map), dev) for dev in set(mesh)}

    def fn(plan_xy, plan_n, egos, U_warm):
        _, blocks = shard_blocks(mesh, local_rows(egos), local_rows(U_warm))
        results, parts = [], []
        for dev, (e, u) in zip(mesh, blocks):
            ob, um = world[dev]
            args = (to_device(plan_xy, dev), to_device(plan_n, dev), e.to(dev), u.to(dev))
            if fused:
                res = solver_batched.run_steps_batched(p, *args, ob, um)
            else:
                res = batched_solve(p, *args, ob, um)
            results.append(res)
            parts.append(metric_sums(p, res))
        return concat_shards(results, mesh[0]), reduce_metrics(parts, mesh[0])

    return fn, mesh


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """The noise stream of global shard ``shard`` under ``seed``: a
    generator on ``device`` seeded by ``prng.stream_seed(seed, shard)`` (the
    counterpart of ``jax.random.fold_in(key, axis_index)``).  The unsharded
    per-chunk reference draws from the same generators."""
    return torch.Generator(device=device).manual_seed(prng.stream_seed(seed, shard))


def make_sharded_full_stack(p: SolverParams, cp, mesh: list, n_cycles: int, obstacles=None,
                            obs_xyyaw=None, obs_size=None, obs_mask=None, band_plan=None,
                            global_res=None, percept=None):
    """Scenario-sharded complete pipeline: ``plant.closed_loop_full_stack_batched``
    per shard (per cycle and scenario the costmap rebuild, K5 and K4 on the
    card, feeding the hybrid solve, K3, with the perception channel
    optionally on).  World inputs (global map, route, obstacles) are
    replicated; only the scenario axis is split.

    Returns ``(fn, mesh)``: ``fn(global_map, global_geom, plan_xy, plan_n,
    x0s, seed, noise_draws=None, camera_draws=None) -> (final states (B, 4),
    record of (T, B, ...) leaves with the scenarios on axis 1,
    (mean_J, collision_frac))``; the summary is reduced over the shards and
    processes.  Global shard i draws from ``shard_generator(seed, i)``
    (this process's first is ``first_shard(x0s, b)``), or takes its block of
    pre-drawn ``noise_draws`` (T, B, 3) / ``camera_draws`` (T, B, 4) (split
    on axis 1 as x0s on axis 0)."""
    world = {dev: to_device((obstacles, obs_xyyaw, obs_size, obs_mask, percept), dev)
             for dev in set(mesh)}

    def fn(global_map, global_geom, plan_xy, plan_n, x0s, seed: int, noise_draws=None,
           camera_draws=None):
        b, blocks = shard_blocks(mesh, local_rows(x0s))
        base = first_shard(x0s, b)
        finals, recs, parts = [], [], []
        for i, (dev, (x0,)) in enumerate(zip(mesh, blocks)):
            ob, oxy, osz, om, pc = world[dev]
            cut = lambda t: None if t is None else t[:, i * b:(i + 1) * b].to(dev)
            xf, rec = plant.closed_loop_full_stack_batched(
                p, cp, NoiseParams(), to_device(global_map, dev), to_device(global_geom, dev),
                to_device(plan_xy, dev), to_device(plan_n, dev), x0.to(dev),
                shard_generator(seed, base + i, dev), n_cycles, obstacles=ob, obs_xyyaw=oxy,
                obs_size=osz, obs_mask=om, band_plan=band_plan, global_res=global_res,
                percept=pc, noise_draws=cut(noise_draws), camera_draws=cut(camera_draws))
            J = rec["J"]
            parts.append(torch.stack([J[-1].sum(), rec["collided"].any(dim=0).to(J.dtype).sum(),
                                      J.new_tensor(float(x0.shape[0]))]))
            finals.append(xf)
            recs.append(rec)
        sums = torch.stack([s.to(mesh[0]) for s in parts]).sum(dim=0)
        sums, _ = _all_reduce(sums)
        return (concat_shards(finals, mesh[0]), concat_shards(recs, mesh[0], dim=1),
                (sums[0] / sums[2], sums[1] / sums[2]))

    return fn, mesh
