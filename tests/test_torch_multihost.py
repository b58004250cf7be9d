"""A real 2-process ``torch.distributed`` run (gloo, ``device="cpu"``) of the
scale-out layer, mirroring tests/test_multihost.py: the one code path a
single process never runs (``parallel/multihost.py``: ``initialize``,
``scatter_local`` / ``put_global``, the cross-process ``all_reduce``).

Each worker (this file run as a script) makes the process group, drives its
part of the global mesh (2 virtual shards per process) on its own rows, and
writes what it holds; the tests hold that against the same calls in one
process, in this process:

  * the sharded solve: each process's rows equal the single-process solve's
    (float64, 1e-12), and the reduced metrics are the same on both
    processes and equal the single-process ones within 1e-9 relative (the
    sums are added in another order);
  * a 2-round checkpointed campaign: the same summary on both processes,
    equal to the single-process campaign within 1e-6 relative (float32 sums
    in another order), and per-process explog shards that merge without
    counting a solve twice; also with 4 shards per process (two hosts of
    four cards);
  * the sharded full stack with the perception channel: each global shard
    i draws from ``shard_generator(seed, i)``, so the run equals the 4
    per-chunk runs of one process (final states within 1e-5, the dryrun's
    bar; the summary within 1e-6 relative, float32 sums in another order).

The workers import nothing of JAX; a run takes a few seconds.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
DEV = "cpu"  # the port allocates on the card unless told otherwise
N_PROC = 2
SEED = 5


def make_params():
    import dataclasses

    from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams

    p = dataclasses.replace(SolverParams(), horizon=8, max_iterations=3,
                            max_global_plan_points=128, num_of_local_wpts=8)
    cp = dataclasses.replace(CostmapParams(), rows=16, cols=16, window_radius=4)
    return p, cp


def make_inputs(p, dtype):
    """The plan, 8 egos and their warm starts (tests/_multihost_worker.py's)."""
    from cilqr_tpu_torch.models import reference_path as trp, solver

    s = np.linspace(0.0, 60.0, 61)
    plan, n = trp.pad_global_plan(p, np.stack([90.0 + s, -306.0 + 0.02 * s], axis=1), dtype=dtype,
                                  device=DEV)
    base = np.array([100.0, -305.8, 4.0, 0.02])
    egos = torch.tensor(base[None, :] + np.random.default_rng(11).normal(0, 0.3, (8, 4)), dtype=dtype)
    U0 = solver.initial_controls(p, dtype=dtype, device=DEV).expand(8, p.horizon, 2).contiguous()
    return plan, n, egos, U0


def campaign_world(cp):
    from cilqr_tpu_torch.ops import gridmap

    prior = torch.tensor(np.random.default_rng(2).uniform(0, 100, (cp.rows, cp.cols)),
                         dtype=torch.float32)
    geom = gridmap.make_geom([5.0, 0.0], cp.resolution, cp.rows, cp.cols, torch.float32, DEV)
    ego = torch.tensor([100.0, -305.8, 4.0, 0.02])
    return prior, geom, ego


def run_campaign(mesh, out_dir):
    from cilqr_tpu_torch.parallel import campaign

    p, cp = make_params()
    plan, n, _, _ = make_inputs(p, torch.float32)
    prior, geom, ego = campaign_world(cp)
    return campaign.run_campaign(p, cp, mesh, prior, geom, ego[:2], ego[3], plan, n, ego,
                                 n_rounds=2, batch=16, out_dir=str(out_dir), seed=7, resume=False)


def full_stack_world(p):
    from cilqr_tpu_torch.ops import gridmap
    from cilqr_tpu_torch.sim import perception, scenarios
    from cilqr_tpu_torch.sim.runner import build_scenario_inputs

    sc = scenarios.get_scenario("success1")
    ob, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(p, sc, torch.float32, DEV)
    gmap = torch.zeros((32, 32))
    ggeom = gridmap.make_geom([100.0, -300.0], 2.0, 32, 32, torch.float32, DEV)
    percept = perception.PerceptionSim(0, torch.tensor([0.5, 0.0]), bbox_sigma=0.0)
    x0s = torch.tensor(np.asarray(sc.start)[None, :]
                       + np.random.default_rng(13).normal(0, 0.2, (8, 4)), dtype=torch.float32)
    kw = dict(obstacles=ob, obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
              percept=percept)
    return gmap, ggeom, x0s, kw


def worker(pid: int, nproc: int, port: str, out_dir: str, shards: int, mode: str) -> None:
    from cilqr_tpu_torch.parallel import batch as pbatch, multihost

    torch.set_num_threads(1)
    assert multihost.initialize(f"127.0.0.1:{port}", nproc, pid, device=DEV)
    assert multihost.process_count() == nproc and multihost.process_index() == pid
    mesh = multihost.global_mesh(shards, device=DEV)
    out = pathlib.Path(out_dir)
    if mode == "campaign":
        summary = run_campaign(mesh, out / "campaign")
        (out / f"campaign_{pid}.json").write_text(json.dumps(summary))
        multihost.shutdown()
        print(f"worker {pid} OK", flush=True)
        return

    # the sharded solve: this process contributes its half of the batch
    p, _ = make_params()
    plan, n, egos, U0 = make_inputs(p, torch.float64)
    b = egos.shape[0] // nproc
    lo = pid * b
    fn, _ = pbatch.make_sharded_solver(p, mesh)
    e_blk = multihost.scatter_local(egos[lo:lo + b])
    assert e_blk.offset == lo
    res, metrics = fn(plan, n, e_blk, multihost.scatter_local(U0[lo:lo + b]))
    np.savez(out / f"solve_{pid}.npz", J=res.J.numpy(), U=res.U.numpy(), lo=lo)
    (out / f"solve_{pid}.json").write_text(json.dumps(multihost.gather_metrics(metrics)))

    summary = run_campaign(mesh, out / "campaign")
    (out / f"campaign_{pid}.json").write_text(json.dumps(summary))

    # the sharded full stack: every process holds the same global x0s and
    # keeps its own block of them
    gmap, ggeom, x0s, kw = full_stack_world(p)
    plan32, n32, _, _ = make_inputs(p, torch.float32)
    fs_fn, _ = pbatch.make_sharded_full_stack(p, make_params()[1], mesh, 2, **kw)
    blk = multihost.put_global(x0s)
    xf, _, fsum = fs_fn(gmap, ggeom, plan32, n32, blk, SEED)
    np.savez(out / f"fullstack_{pid}.npz", xf=xf.numpy(), lo=blk.offset, mean_J=float(fsum[0]),
             collision_frac=float(fsum[1]))
    multihost.shutdown()
    print(f"worker {pid} OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out: pathlib.Path, shards: int, mode: str) -> pathlib.Path:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}" + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(pid), str(N_PROC), str(port), str(out),
                               str(shards), mode],
                              env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(N_PROC)]
    logs = []
    for pr in procs:
        try:
            stdout, _ = pr.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for pid, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{log}"
        assert f"worker {pid} OK" in log
    return out


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    """2 processes x 2 virtual shards: solve, campaign, full stack."""
    return _launch(tmp_path_factory.mktemp("mh"), 2, "all")


@pytest.fixture(scope="module")
def worker_outputs_2x4(tmp_path_factory):
    """2 processes x 4 virtual shards (two hosts of four cards): the
    campaign only."""
    return _launch(tmp_path_factory.mktemp("mh_2x4"), 4, "campaign")


def _check_campaign(out: pathlib.Path, shards_total: int, tmp_path):
    from cilqr_tpu_torch.parallel import batch as pbatch, campaign

    c0 = json.loads((out / "campaign_0.json").read_text())
    c1 = json.loads((out / "campaign_1.json").read_text())
    assert c0 == c1  # the reduced state is the same on every process
    assert c0["rounds"] == 2 and c0["solves"] == 32
    ref = run_campaign(pbatch.make_mesh([DEV] * shards_total), tmp_path / "ref")
    assert c0["solves"] == ref["solves"]
    for k in ("mean_J", "max_J", "mean_iterations", "converged_frac"):
        np.testing.assert_allclose(c0[k], ref[k], rtol=1e-6, err_msg=k)
    shards = sorted((out / "campaign").glob("shard_*.log"))
    assert [s.name for s in shards] == ["shard_000.log", "shard_001.log"]
    merged = campaign.merge_analysis(str(out / "campaign"))
    assert merged["rounds"] == 4  # rows: 2 processes x 2 rounds
    assert merged["solves"] == 32  # each solve counted once
    np.testing.assert_allclose(merged["mean_J"], ref["mean_J"], rtol=1e-6)
    assert sorted(f.name for f in (out / "campaign").glob("ckpt_*.npz")) == [
        "ckpt_000000.npz", "ckpt_000001.npz"]  # process 0 alone checkpoints


def test_two_process_solve_matches_single_process(worker_outputs):
    from cilqr_tpu_torch.parallel import batch as pbatch

    p, _ = make_params()
    plan, n, egos, U0 = make_inputs(p, torch.float64)
    res, metrics = pbatch.solve_and_reduce(p, plan, n, egos, U0)
    B = egos.shape[0]
    J = np.full((B,), np.nan)
    U = np.full((B, p.horizon, 2), np.nan)
    for pid in range(N_PROC):
        z = np.load(worker_outputs / f"solve_{pid}.npz")
        lo = int(z["lo"])
        J[lo:lo + z["J"].shape[0]] = z["J"]
        U[lo:lo + z["U"].shape[0]] = z["U"]
    assert np.isfinite(J).all()
    np.testing.assert_allclose(J, res.J.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(U, res.U.numpy(), rtol=1e-12, atol=1e-12)
    md0 = json.loads((worker_outputs / "solve_0.json").read_text())
    md1 = json.loads((worker_outputs / "solve_1.json").read_text())
    assert md0 == md1
    for k, v in md0.items():
        np.testing.assert_allclose(v, float(getattr(metrics, k)), rtol=1e-9, err_msg=k)


def test_two_process_campaign_matches_single_process(worker_outputs, tmp_path):
    _check_campaign(worker_outputs, 4, tmp_path)


def test_two_by_four_campaign_matches_single_process(worker_outputs_2x4, tmp_path):
    _check_campaign(worker_outputs_2x4, 8, tmp_path)


def test_two_process_full_stack_matches_single_process(worker_outputs):
    from cilqr_tpu_torch.parallel import batch as pbatch
    from cilqr_tpu_torch.sim import plant
    from cilqr_tpu_torch.utils.params import NoiseParams

    p, cp = make_params()
    plan, n, _, _ = make_inputs(p, torch.float32)
    gmap, ggeom, x0s, kw = full_stack_world(p)
    n_shards, B = 4, x0s.shape[0]
    bs = B // n_shards
    xf_ref, J_last = [], []
    for i in range(n_shards):
        xf_i, rec_i = plant.closed_loop_full_stack_batched(
            p, cp, NoiseParams(), gmap, ggeom, plan, n, x0s[i * bs:(i + 1) * bs],
            pbatch.shard_generator(SEED, i, DEV), 2, **kw)
        xf_ref.append(xf_i)
        J_last.append(rec_i["J"][-1])
    xf_ref = torch.cat(xf_ref).numpy()
    mean_J_ref = float(torch.cat(J_last).sum()) / B
    xf = np.full((B, 4), np.nan, np.float32)
    sums = []
    for pid in range(N_PROC):
        z = np.load(worker_outputs / f"fullstack_{pid}.npz")
        lo = int(z["lo"])
        xf[lo:lo + z["xf"].shape[0]] = z["xf"]
        sums.append((float(z["mean_J"]), float(z["collision_frac"])))
    assert np.isfinite(xf).all()
    np.testing.assert_allclose(xf, xf_ref, rtol=0, atol=1e-5)
    assert sums[0] == sums[1]  # the reduced summary is the same on every process
    np.testing.assert_allclose(sums[0][0], mean_J_ref, rtol=1e-6)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]),
           sys.argv[6])
