"""The checkpointed campaign (cilqr_tpu_torch/parallel/campaign) and its
checkpoint module (utils/checkpoint), mirroring tests/test_campaign.py and
the checkpoint cases of tests/test_utils.py, and held against the JAX
package.

The campaign runs on a mesh of 8 virtual ``cpu`` shards.  Resuming after an
interruption must give the uninterrupted run's numbers at the JAX test's
rtol of 1e-6.  Against JAX, both campaigns get the same scenarios per round
through the port's ``round_samples`` seam (JAX's
``sample_scenarios(fold_in(key(seed), r), ...)``), in float64: solves and
rounds equal, mean iterations and the converged share equal, mean and max J
within 1e-9 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import reference_path as jrp
from cilqr_tpu.ops import gridmap as jgrid
from cilqr_tpu.parallel import batch as jbatch, campaign as jcampaign, monte_carlo as jmc
from cilqr_tpu.utils import checkpoint as jckpt
from cilqr_tpu.utils.params import CostmapParams, SolverParams
from cilqr_tpu_torch.models import reference_path as trp
from cilqr_tpu_torch.ops import gridmap as tgrid
from cilqr_tpu_torch.parallel import batch as tbatch, campaign, monte_carlo as tmc
from cilqr_tpu_torch.utils import checkpoint, prng

DEV = "cpu"  # the port allocates on the card unless told otherwise
EGO = np.array([100.0, -305.6, 4.0, 0.05])


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs: the tier runs six workers at
    once, and these small eager loops only lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "U_warm": torch.ones((40, 2)) * 0.5,
        "key": np.arange(4, dtype=np.uint32),
        "step": 17,
        "nested": {"J": torch.tensor(3.5, dtype=torch.float64), "hist": [torch.arange(3), 2.0]},
        "state": campaign._zero_state(torch.float64),
    }
    p = tmp_path / "ckpt_000017.npz"
    checkpoint.save(str(p), tree)
    like = {
        "U_warm": torch.zeros((40, 2)),
        "key": np.zeros(4, dtype=np.uint32),
        "step": 0,
        "nested": {"J": torch.tensor(0.0, dtype=torch.float64), "hist": [torch.zeros(3, dtype=torch.int64), 0.0]},
        "state": campaign._zero_state(torch.float64),
    }
    back = checkpoint.restore(str(p), like)
    assert torch.equal(back["U_warm"], tree["U_warm"])
    np.testing.assert_array_equal(back["key"], tree["key"])
    assert isinstance(back["key"], np.ndarray) and int(back["step"]) == 17
    assert float(back["nested"]["J"]) == 3.5 and torch.equal(back["nested"]["hist"][0], torch.arange(3))
    assert isinstance(back["state"], campaign.CampaignState)
    assert back["state"].rounds_done.dtype == torch.int32
    assert float(back["state"].max_J) == float("-inf")
    assert not list(tmp_path.glob("*.tmp"))  # the atomic write left nothing behind


def test_checkpoint_structure_mismatch(tmp_path):
    p = tmp_path / "c.npz"
    checkpoint.save(str(p), {"a": np.zeros((3,)), "b": np.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(p), {"a": np.zeros((3,)), "c": np.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(p), (np.zeros((3,)), np.zeros(2)))


@pytest.mark.parametrize("like,match", [({"a": np.zeros((4,))}, "shape mismatch"),
                                        ({"a": np.zeros((3,), np.float32)}, "dtype mismatch"),
                                        ({"a": torch.zeros(3, dtype=torch.float32)}, "dtype mismatch")])
def test_checkpoint_shape_and_dtype_mismatch(tmp_path, like, match):
    p = tmp_path / "c.npz"
    checkpoint.save(str(p), {"a": np.zeros((3,))})
    with pytest.raises(ValueError, match=match):
        checkpoint.restore(str(p), like)


def test_latest_step_and_metadata(tmp_path):
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    assert checkpoint.latest_step(str(tmp_path)) is None
    for s in (3, 11, 7):
        checkpoint.save(str(tmp_path / f"ckpt_{s:06d}.npz"), {"x": np.zeros(1)})
    (tmp_path / "ckpt_notastep.npz").write_bytes(b"")
    assert checkpoint.latest_step(str(tmp_path)) == 11
    meta = {"step": 11, "scenario": "long"}
    checkpoint.save_metadata(str(tmp_path / "meta.json"), meta)
    assert checkpoint.load_metadata(str(tmp_path / "meta.json")) == meta
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same leaf_i layout: each package restores the other's file leaf
    for leaf (each checks only its own structure record)."""
    state_t = campaign.CampaignState(torch.tensor(3, dtype=torch.int32),
                                     *(torch.tensor(v, dtype=torch.float64)
                                       for v in (48.0, 9.5, 2.25, 31.0, 40.0)))
    checkpoint.save(str(tmp_path / "t.npz"), state_t)
    back_j = jckpt.restore(str(tmp_path / "t.npz"), jcampaign._zero_state(np.float64))
    assert [float(v) for v in back_j] == [float(v) for v in state_t]
    jckpt.save(str(tmp_path / "j.npz"), back_j)
    back_t = checkpoint.restore(str(tmp_path / "j.npz"), campaign._zero_state(torch.float64))
    assert all(torch.equal(a, b) for a, b in zip(back_t, state_t))


# ---------------------------------------------------------------- campaign
def _setup(global_plan, dtype=torch.float32):
    """tests/test_campaign.py's world: a 16x16 uniform prior, N=8."""
    p = dataclasses.replace(SolverParams(), horizon=8, max_iterations=3,
                            max_global_plan_points=128, num_of_local_wpts=8)
    cp = dataclasses.replace(CostmapParams(), rows=16, cols=16, window_radius=4)
    prior_np = np.random.default_rng(2).uniform(0, 100, (cp.rows, cp.cols))
    plan, n = trp.pad_global_plan(p, global_plan, dtype=dtype, device=DEV)
    geom = tgrid.make_geom([5.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype, DEV)
    return p, cp, prior_np, torch.tensor(prior_np, dtype=dtype), geom, plan, n


def _run(global_plan, out, n_rounds, resume, dtype=torch.float32):
    p, cp, _, prior, geom, plan, n = _setup(global_plan, dtype)
    ego = torch.tensor(EGO, dtype=dtype)
    return campaign.run_campaign(p, cp, tbatch.make_mesh([DEV] * 8), prior, geom, ego[:2], ego[3],
                                 plan, n, ego, n_rounds=n_rounds, batch=16, out_dir=str(out),
                                 seed=7, resume=resume)


def test_campaign_runs_and_merges(global_plan, tmp_path):
    out = _run(global_plan, tmp_path / "a", n_rounds=2, resume=False)
    assert out["rounds"] == 2 and out["solves"] == 32
    assert np.isfinite(out["mean_J"]) and 0.0 <= out["converged_frac"] <= 1.0
    merged = campaign.merge_analysis(str(tmp_path / "a"))
    assert merged["rounds"] == 2 and merged["solves"] == 32
    np.testing.assert_allclose(merged["mean_J"], out["mean_J"], rtol=1e-6)
    meta = json.loads((tmp_path / "a" / "campaign.json").read_text())
    assert meta == {"rounds_done": 2, "batch": 16, "seed": 7, "n_rounds": 2}
    assert sorted(f.name for f in (tmp_path / "a").glob("ckpt_*.npz")) == [
        "ckpt_000000.npz", "ckpt_000001.npz"]


def test_campaign_resume_is_deterministic(global_plan, tmp_path):
    full = _run(global_plan, tmp_path / "full", n_rounds=4, resume=False)
    _run(global_plan, tmp_path / "int", n_rounds=2, resume=False)
    resumed = _run(global_plan, tmp_path / "int", n_rounds=4, resume=True)
    assert resumed["rounds"] == 4 and resumed["solves"] == full["solves"]
    for k in ("mean_J", "max_J", "mean_iterations", "converged_frac"):
        np.testing.assert_allclose(resumed[k], full[k], rtol=1e-6, err_msg=k)
    # the resumed shard holds all 4 rounds (append mode)
    merged = campaign.merge_analysis(str(tmp_path / "int"))
    assert merged["rounds"] == 4
    assert sorted(r["round"] for r in merged["rows"]) == [0, 1, 2, 3]
    np.testing.assert_allclose(merged["mean_J"], full["mean_J"], rtol=1e-6)


def test_round_samples_are_the_rounds_own_stream():
    a = campaign.round_samples(7, 2, 16, EGO, torch.float64, DEV)
    b = campaign.round_samples(7, 2, 16, EGO, torch.float64, DEV)
    c = campaign.round_samples(7, 3, 16, EGO, torch.float64, DEV)
    assert torch.equal(a.egos, b.egos) and torch.equal(a.sigmas, b.sigmas)
    assert not torch.equal(a.sigmas, c.sigmas)
    g = torch.Generator().manual_seed(prng.stream_seed(7, 2))
    want = tmc.sample_scenarios(g, 16, torch.tensor(EGO), dtype=torch.float64, device=DEV)
    assert torch.equal(a.egos, want.egos)


def test_campaign_matches_jax_per_round(global_plan, tmp_path, monkeypatch):
    """Both campaigns, float64, 2 rounds of 16 on 8 shards, each round on
    JAX's draws for that round."""
    p, cp, prior_np, prior, geom, plan, n = _setup(global_plan, torch.float64)

    def jax_round(seed, r, batch, base_ego, dtype=torch.float32, device=None):
        s = jmc.sample_scenarios(jax.random.fold_in(jax.random.key(seed), r), batch,
                                 np.asarray(base_ego), dtype=jnp.float64)
        return tmc.MCSample(torch.tensor(np.asarray(s.sigmas)), torch.tensor(np.asarray(s.egos)))

    monkeypatch.setattr(campaign, "round_samples", jax_round)
    ego = torch.tensor(EGO)
    got = campaign.run_campaign(p, cp, tbatch.make_mesh([DEV] * 8), prior, geom, ego[:2], ego[3],
                                plan, n, ego, n_rounds=2, batch=16, out_dir=str(tmp_path / "t"),
                                seed=7)
    jplan, jn = jrp.pad_global_plan(p, global_plan, dtype=jnp.float64)
    jgeom = jgrid.make_geom([5.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float64)
    want = jcampaign.run_campaign(p, cp, jbatch.make_mesh(), jnp.asarray(prior_np), jgeom,
                                  EGO[:2], EGO[3], jplan, jn, EGO, n_rounds=2, batch=16,
                                  out_dir=str(tmp_path / "j"), seed=7)
    assert got["rounds"] == want["rounds"] == 2
    assert got["solves"] == want["solves"] == 32
    assert got["mean_iterations"] == want["mean_iterations"]
    assert got["converged_frac"] == want["converged_frac"]
    for k in ("mean_J", "max_J"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    mt = campaign.merge_analysis(str(tmp_path / "t"))
    mj = jcampaign.merge_analysis(str(tmp_path / "j"))
    assert [(r["round"], r["batch"]) for r in mt["rows"]] == [(r["round"], r["batch"]) for r in mj["rows"]]
    np.testing.assert_allclose(mt["mean_J"], mj["mean_J"], rtol=1e-9)
