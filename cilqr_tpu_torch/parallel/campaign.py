"""Checkpointed Monte-Carlo campaigns: sigma sweeps at scale.

Port of ``cilqr_tpu/parallel/campaign.py``.  The reference's campaign is
manual (run CARLA N times while turning the sigma knobs, record each run,
batch-process the bags).  Here:

  * each **round** draws ``batch`` fresh (sigma, ego-noise) scenarios from
    its own generator (``round_samples``: seeded by (seed, round)),
    propagates each scenario's uncertainty costmap and solves the batch
    through the scenario-sharded Monte-Carlo (``monte_carlo.make_sharded_monte_carlo``);
  * the per-round metric sums accumulate in a small state that process 0
    checkpoints after every round (``utils.checkpoint``: atomic ``.npz`` +
    ``campaign.json``); a run interrupted after any round resumes at the
    next with the uninterrupted run's numbers;
  * each process streams its rows to its own experiment-log shard
    (``shard_<process>.log``, the native format of ``utils.explog``);
    ``merge_analysis`` folds the shards into one table, counting each solve
    once.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np
import torch

from cilqr_tpu_torch.parallel import monte_carlo as mc
from cilqr_tpu_torch.parallel import multihost
from cilqr_tpu_torch.utils import checkpoint as ckpt
from cilqr_tpu_torch.utils import prng
from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams


class CampaignState(NamedTuple):
    """Accumulated cross-round state (the checkpointed nest), host tensors."""

    rounds_done: torch.Tensor     # () int32
    n_solves: torch.Tensor        # ()
    sum_J: torch.Tensor           # ()
    max_J: torch.Tensor           # ()
    sum_iterations: torch.Tensor  # ()
    sum_converged: torch.Tensor   # ()


def _zero_state(dtype=torch.float32) -> CampaignState:
    z = torch.zeros((), dtype=dtype)
    return CampaignState(torch.zeros((), dtype=torch.int32), z, z, z - float("inf"), z, z)


def round_samples(seed: int, r: int, batch: int, base_ego, dtype=torch.float32,
                  device=None) -> mc.MCSample:
    """Round ``r``'s scenarios: ``sample_scenarios`` from a CPU generator
    seeded by ``prng.stream_seed(seed, r)`` (the same numbers on every
    process and device), returned on ``device``."""
    g = torch.Generator().manual_seed(prng.stream_seed(seed, r))
    return mc.sample_scenarios(g, batch, torch.as_tensor(base_ego), dtype=dtype, device=device)


def run_campaign(p: SolverParams, cp: CostmapParams, mesh: list, prior: torch.Tensor, geom,
                 origin_xy, origin_yaw, plan_xy: torch.Tensor, plan_n, base_ego, n_rounds: int,
                 batch: int, out_dir: str, seed: int = 0, obstacles=None, resume: bool = True,
                 log_rows: bool = True) -> dict:
    """Run (or resume) a checkpointed Monte-Carlo campaign on the mesh
    (this process's part of it).  Returns the final merged metrics dict.
    Deterministic in (seed, round): interrupting after any round and
    resuming yields the uninterrupted run's final state."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    proc, n_proc = multihost.process_index(), multihost.process_count()
    dtype = prior.dtype
    dev = mesh[0]

    mc_fn, _ = mc.make_sharded_monte_carlo(
        p, cp, mesh, obstacles=obstacles, map_shape=tuple(prior.shape),
        map_center=tuple(float(c) for c in geom.center.tolist()))
    origin_xy = torch.as_tensor(origin_xy, dtype=dtype, device=dev)
    origin_yaw = torch.as_tensor(origin_yaw, dtype=dtype, device=dev)

    state = _zero_state(dtype)
    start_round = 0
    if resume:
        last = ckpt.latest_step(str(out))
        if last is not None:
            state = ckpt.restore(str(out / f"ckpt_{last:06d}.npz"), state)
            start_round = int(state.rounds_done)

    log = None
    if log_rows:
        from cilqr_tpu_torch.utils import explog

        mode = "a" if (resume and start_round > 0) else "w"
        log = explog.ExperimentLog(str(out / f"shard_{proc:03d}.log"), mode)

    for r in range(start_round, n_rounds):
        samples = round_samples(seed, r, batch, base_ego, dtype, dev)
        # each process contributes its own slice of the (identically drawn)
        # global batch
        _, metrics = mc_fn(prior, geom, origin_xy, origin_yaw, plan_xy, plan_n,
                           multihost.put_global(samples.sigmas),
                           multihost.put_global(samples.egos))
        m = [t.cpu() for t in metrics]
        B = batch
        state = CampaignState(
            rounds_done=state.rounds_done + 1,
            n_solves=state.n_solves + B,
            sum_J=state.sum_J + m[0] * B,
            max_J=torch.maximum(state.max_J, m[1]),
            sum_iterations=state.sum_iterations + m[2] * B,
            sum_converged=state.sum_converged + m[3] * B,
        )

        if log is not None:
            # one record per round: the round's metric row (the X/U slots
            # carry the summary, not trajectories).  The logged batch is this
            # process's share of the global batch (the metrics are global),
            # so merge_analysis over the shards counts each solve once.
            log.append(start_time=float(r), start_pos=samples.egos[0],
                       planning_time=float(m[0]), X=np.asarray([[float(v) for v in m]]),
                       U=np.asarray([[float(B // n_proc), float(r)]]))
            log.flush()

        if proc == 0:
            ckpt.save(str(out / f"ckpt_{r:06d}.npz"), state)
            ckpt.save_metadata(str(out / "campaign.json"),
                               {"rounds_done": r + 1, "batch": batch, "seed": seed,
                                "n_rounds": n_rounds})

    if log is not None:
        log.close()
    return summarize(state)


def summarize(state: CampaignState) -> dict:
    n = max(float(state.n_solves), 1.0)
    return {
        "rounds": int(state.rounds_done),
        "solves": int(state.n_solves),
        "mean_J": float(state.sum_J) / n,
        "max_J": float(state.max_J),
        "mean_iterations": float(state.sum_iterations) / n,
        "converged_frac": float(state.sum_converged) / n,
    }


def merge_analysis(out_dir: str) -> dict:
    """Fold every process's explog shard into one campaign metrics table."""
    from cilqr_tpu_torch.utils import explog

    rows = []
    for shard in sorted(pathlib.Path(out_dir).glob("shard_*.log")):
        data = explog.read_experiment_log(str(shard))
        # per-round X: (1, 4) [mean_J, max_J, iters, conv]; U: (1, 2) [batch, round]
        for X, U in zip(data["X"], data["U"]):
            rows.append({
                "shard": shard.name,
                "round": int(U[0, 1]),
                "batch": int(U[0, 0]),
                "mean_J": float(X[0, 0]),
                "max_J": float(X[0, 1]),
                "mean_iterations": float(X[0, 2]),
                "converged_frac": float(X[0, 3]),
            })
    if not rows:
        return {"rounds": 0, "rows": []}
    w = np.asarray([r["batch"] for r in rows], np.float64)
    return {
        "rounds": len(rows),
        "solves": int(w.sum()),
        "mean_J": float(np.average([r["mean_J"] for r in rows], weights=w)),
        "max_J": float(np.max([r["max_J"] for r in rows])),
        "converged_frac": float(np.average([r["converged_frac"] for r in rows], weights=w)),
        "rows": rows,
    }
