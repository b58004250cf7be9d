"""The port's observability layer (``cilqr_tpu_torch.utils.profiling``)
against ``cilqr_tpu.utils.profiling``: the same phase timer and summary on
CPU tensors, a ``torch.profiler`` trace in place of the ``jax.profiler``
one."""

import json
import time

import torch

from cilqr_tpu.utils import profiling as jprofiling
from cilqr_tpu_torch.utils import profiling

DEV = "cpu"  # the port allocates on the card unless told otherwise


def test_phase_timer():
    t = profiling.PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        time.sleep(0.01)
    t.record("b", 0.5)
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["mean_ms"] >= 9.0
    assert s["b"]["total_ms"] == 500.0
    assert "a" in t.dump()


def test_timed_blocks_async_dispatch():
    t = profiling.PhaseTimer()
    x = torch.ones((256, 256), device=DEV)
    out = t.timed("matmul", lambda: x @ x)
    assert out.shape == (256, 256)
    assert t.summary()["matmul"]["count"] == 1


def test_summary_and_dump_equal_the_jax_timer(tmp_path):
    """The same record calls give the JAX PhaseTimer's summary, number for
    number, and the same dump."""
    calls = [("solve", 0.0123), ("solve", 0.25), ("costmap", 1e-4), ("solve", 3.5),
             ("costmap", 0.002)]
    got, want = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for name, seconds in calls:
        got.record(name, seconds)
        want.record(name, seconds)
    assert got.summary() == want.summary()
    assert got.dump(str(tmp_path / "port.json")) == want.dump(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_block_until_ready_walks_nests_of_cpu_tensors():
    tree = {"a": torch.ones(3, device=DEV), "b": (torch.zeros(2, device=DEV), [1.0, "x"])}
    assert profiling.block_until_ready(tree) is tree


def test_trace_writes_the_annotated_region(tmp_path):
    x = torch.ones((64, 64), device=DEV)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("cilqr_annotated_region"):
            (x @ x).sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "cilqr_annotated_region" for e in events)
