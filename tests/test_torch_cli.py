"""The port's CLI (``python -m cilqr_tpu_torch``) against the JAX CLI.

Each subcommand runs on the CPU (``--device cpu``) at the smallest sizes and
must write what the JAX CLI writes.  The JAX CLI is then fed the port's own
results (its runner or sweep function replaced by one returning them), so
its JSON and files come from the same numbers: they must be equal, key for
key.  ``analyze`` reads the port's log in both packages.  Without
``--device`` the port allocates on the card: here that fails with
PyTorch's own CUDA error.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import cilqr_tpu.__main__ as jcli
from cilqr_tpu.sim import runner as jrunner, sweep as jsweep
from cilqr_tpu_torch.__main__ import main
from cilqr_tpu_torch.sim import runner as trunner, sweep as tsweep

DEV = "cpu"  # the port allocates on the card unless told otherwise
FIXTURE = str(pathlib.Path(__file__).parent / "data" / "mini_town.yaml")
SMALL = ["--horizon", "10", "--device", DEV]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs: the tier runs six workers at
    once, and these small eager loops only lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def out_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out)


def same_json(got, want, rel=1e-9):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same_json(got[k], want[k], rel)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=rel, atol=rel * 1e-3)
    else:
        assert got == want


def test_help_lists_the_subcommands(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    for cmd in ("run", "analyze", "compare", "sweep", "bench"):
        assert cmd in text


def test_run_with_map_then_analyze(tmp_path, capsys, monkeypatch):
    """`run --map` on the checked-in map_server fixture (3 cycles), then
    `analyze` on its log; the JAX CLI on the same record and the same log."""
    records = []
    real = trunner.run_experiment
    monkeypatch.setattr(trunner, "run_experiment",
                        lambda *a, **kw: records.append(real(*a, **kw)) or records[-1])
    argv = ["run", "--scenario", "compare", "--cycles", "3", "--x0", "60.0", "--map", FIXTURE]
    assert main(argv + SMALL + ["--out", str(tmp_path / "port")]) == 0
    got = out_json(capsys)
    for f in ("experiment.log", "metrics.csv", "run.png"):
        assert (tmp_path / "port" / f).exists(), f
    rec = records[0]
    assert rec["X"].shape == (3, 11, 4) and "costmap_time" in rec

    monkeypatch.setattr(jrunner, "run_experiment", lambda *a, **kw: rec)
    assert jcli.main(argv + ["--horizon", "10", "--out", str(tmp_path / "jax")]) == 0
    want = out_json(capsys)
    assert got.pop("out") == str(tmp_path / "port") and want.pop("out") == str(tmp_path / "jax")
    same_json(got, want)
    assert got["cycles"] == 3 and np.isfinite(got["final_x"])
    csv = [(tmp_path / d / "metrics.csv").read_text().splitlines() for d in ("port", "jax")]
    assert csv[0][0] == csv[1][0]  # the same columns

    log = str(tmp_path / "port" / "experiment.log")
    assert main(["analyze", log, "--scenario", "compare", "--device", DEV]) == 0
    got = out_json(capsys)
    assert jcli.main(["analyze", log, "--scenario", "compare"]) == 0
    same_json(got, out_json(capsys))
    assert np.isfinite(got["velocity_mean"])
    # a window with fewer than 3 cycles in it
    assert main(["analyze", log, "--scenario", "compare", "--window", "3", "--device", DEV]) == 1
    assert "error:" in capsys.readouterr().err


def test_compare_and_sweep(tmp_path, capsys, monkeypatch):
    """`compare` (blind, 2 runs x 3 cycles) and `sweep` (2 sigmas x 2 runs x
    3 cycles on the synthetic town) on their default algorithm axes, the JAX
    CLI's (all of ALGORITHMS; SWEEP_ALGORITHMS); the JAX CLI writes the same
    summary and the same files from the port's results."""
    results = []
    real = trunner.run_algorithm_comparison
    monkeypatch.setattr(trunner, "run_algorithm_comparison",
                        lambda *a, **kw: results.append(real(*a, **kw)) or results[-1])
    argv = ["compare", "--scenarios", "compare,gauntlet", "--runs", "2", "--cycles", "3"]
    assert main(argv + SMALL + ["--out", str(tmp_path / "cmp_port")]) == 0
    got = out_json(capsys)
    assert trunner.ALGORITHMS == jrunner.ALGORITHMS
    assert list(got) == [f"{sc}/{a}" for sc in ("compare", "gauntlet") for a in trunner.ALGORITHMS]
    replay = iter(results)
    monkeypatch.setattr(jrunner, "run_algorithm_comparison", lambda *a, **kw: next(replay))
    assert jcli.main(argv + ["--horizon", "10", "--out", str(tmp_path / "cmp_jax")]) == 0
    same_json(got, out_json(capsys))
    assert ((tmp_path / "cmp_port" / "comparison.csv").read_text()
            == (tmp_path / "cmp_jax" / "comparison.csv").read_text())

    rows = []
    real_sweep = tsweep.run_sigma_sweep
    monkeypatch.setattr(tsweep, "run_sigma_sweep",
                        lambda *a, **kw: rows.append(real_sweep(*a, **kw)) or rows[-1])
    argv = ["sweep", "--sigmas", "0.0,0.2", "--runs", "2", "--cycles", "3"]
    assert main(argv + SMALL + ["--out", str(tmp_path / "sw_port")]) == 0
    table = capsys.readouterr().out
    monkeypatch.setattr(jsweep, "run_sigma_sweep", lambda *a, **kw: rows[0])
    assert jcli.main(argv + ["--horizon", "10", "--out", str(tmp_path / "sw_jax")]) == 0
    assert capsys.readouterr().out == table
    for f in ("sweep.json", "sweep.md"):
        assert (tmp_path / "sw_port" / f).read_text() == (tmp_path / "sw_jax" / f).read_text()
    got = json.loads((tmp_path / "sw_port" / "sweep.json").read_text())
    assert tsweep.SWEEP_ALGORITHMS == jsweep.SWEEP_ALGORITHMS
    assert [(r["sigma_xy"], r["algorithm"]) for r in got] == [
        (s, a) for s in (0.0, 0.2) for a in tsweep.SWEEP_ALGORITHMS]
    assert all(np.isfinite(r["velocity_mean"]) and r["n_runs"] == 2 for r in got)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the failure without a card")
def test_run_without_device_fails_with_the_cuda_error(tmp_path):
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        main(["run", "--scenario", "compare", "--cycles", "3", "--horizon", "10",
              "--out", str(tmp_path)])
