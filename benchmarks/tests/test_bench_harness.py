"""CPU tests of the benchmark harness: what it imports, BENCHMARK.json
against the contract it is held to, the frozen roofline counts, and a cell
added as files only, run end to end through the real entry point.

Run: ``python -m pytest benchmarks/tests -q`` from the repository root.
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package_imported(path):
    """Whole top-level names: ``cilqr_tpu_torch`` is not ``cilqr_tpu``."""
    found = top_level_imports(path) & {"jax", "jaxlib", "flax", "cilqr_tpu", "oracle"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "cilqr_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "numpy"}, names


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import cilqr_tpu_torch.models\nfrom cilqr_tpu_torch import x\nimport jaxtyping\n")
    assert top_level_imports(f) == {"cilqr_tpu_torch", "jaxtyping"}


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert SPEC["command"][:3] == ["python3", "-m", "benchmarks.run"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[g]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmarks/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_workloads_have_files_and_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert (BENCH / "traffic" / f"{cell['kind']}.py").is_file()
        assert cell["limits"], "a cell needs its limits"
        reported = [m for m in SPEC["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        layer = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w["name"] in moved["workloads"]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_frozen_roofline_counts_by_hand():
    import torch

    from benchmarks import roofline

    # horizon 2, 4 samples, 1 obstacle: per step 5*4 + 26 + 80 + 70 + 50 + 10 + 646 + 45
    ops, n_bytes = roofline.lm_iteration(2, 4, 1)
    assert ops == 2 * 947
    assert n_bytes == 4 * (3 * 4 + 2 * 2) * 2
    assert roofline.k1_bound_s(2, 4, 1, 10.0) == max(10 * n_bytes / 3.35e12, 10 * ops / 67e12)
    sx = torch.full((1, 1, 1), 0.5, dtype=torch.float64)
    sy = torch.full((1, 1, 1), 0.25, dtype=torch.float64)
    rho = torch.full((1, 1, 1), 0.6, dtype=torch.float64)
    o, b = roofline.k4_work(sx, sy, rho, 0.2, 2.0)
    inside = math.pi * 4.0 / 0.04 * 0.125 * 0.8
    assert o == pytest.approx(36 + 11 * inside, rel=1e-12)
    assert b == 12 * 4 + 4


def test_frozen_roofline_equals_the_programs_count():
    from benchmarks import roofline
    from cilqr_tpu_torch.utils import roofline as program
    from cilqr_tpu_torch.utils.params import SolverParams

    p = SolverParams()
    cost = program.mega_iteration_cost(p, p.n_closest_samples, p.max_obstacles, 50)
    ops, n_bytes = roofline.lm_iteration(p.horizon, p.n_closest_samples, p.max_obstacles)
    assert (cost.n_ops, cost.n_bytes) == (ops, n_bytes)
    assert roofline.MEM_BYTES_PER_S == program.MEM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == program.FP32_OPS_PER_S


FAKE_CARD = """
import runpy, sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.max_memory_allocated = lambda *a, **k: 1234
torch.cuda.get_device_name = lambda *a, **k: "stand-in"
torch.cuda.synchronize = lambda *a, **k: None
torch.cuda.empty_cache = lambda *a, **k: None
sys.argv = ["benchmarks.run"] + sys.argv[1:]
runpy.run_module("benchmarks.run", run_name="__main__")
"""

DUMMY_TRAFFIC = '''
def setup(run):
    return {}


def window(run, state):
    from benchmarks.run import back_to_back
    back_to_back(run, lambda k: None, lambda k, out: None, 1)
    run.items = 3 * run.calls


def release(run, state):
    return state


def check(run, held):
    return [{"name": "gap", "value": 0.5, "limit": run.cell["limits"]["gap"]}]
'''


@pytest.fixture
def copy(tmp_path):
    """BENCHMARK.json and the benchmark's files alone, as the checker copies
    them, plus a stand-in for the card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "fake_card.py").write_text(FAKE_CARD)
    return tmp_path


def run_copy(copy, *args):
    return subprocess.run([sys.executable, "fake_card.py", *args], cwd=copy,
                          capture_output=True, text=True, timeout=300)


def test_a_cell_added_as_files_runs_without_edits(copy):
    """A new configuration, traffic module, cell and metric: new files and new
    entries in BENCHMARK.json, no edit to a file of the harness."""
    (copy / "benchmarks" / "traffic" / "dummy.py").write_text(DUMMY_TRAFFIC)
    (copy / "benchmarks" / "configs" / "dummy_conf.json").write_text(
        json.dumps({"name": "dummy_conf", "reduced": []}))
    (copy / "benchmarks" / "cells" / "dummy.cell.json").write_text(
        json.dumps({"kind": "dummy", "limits": {"gap": 1.0}}))
    (copy / "benchmarks" / "metrics" / "dummy_rate.py").write_text(
        "def read(run):\n    return run.items / (run.t1 - run.t0)\n")
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_conf", "source": "a test", "reduced": [],
                            "file": "benchmarks/configs/dummy_conf.json", "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_conf", "traffic": "dummy",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_rate", "unit": "items/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["dummy.cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    out = run_copy(copy, "--workload", "dummy.cell", "--seed", str(2 ** 31 + 7), "--seconds",
                   "0.2", "--trace", "0")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"dummy_rate", "setup_s"}
    assert line["metrics"]["dummy_rate"]["unit"] == "items/s"
    assert line["device"] == {"platform": "gpu", "kind": "stand-in", "count": 1,
                              "memory_peak_bytes": 1234}
    assert line["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
    assert out.stderr.strip().splitlines()[-1] == "check gap = 0.5 limit 1.0"


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_without_the_program_a_run_fails_and_prints_no_result(copy, workload):
    out = run_copy(copy, "--workload", workload, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
