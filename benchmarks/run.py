"""The benchmark of the PyTorch and CUDA port ``cilqr_tpu_torch``.

    python -m benchmarks.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  ``BENCHMARK.json`` lists the cells (``workloads``) and the metrics;
everything that belongs to one of them sits in a file of its own, found by
name:

* ``benchmarks/cells/<workload>.json``: the cell's traffic, read by the
  traffic module ``benchmarks/traffic/<kind>.py`` that its ``kind`` names;
* the configuration's file (``configs[].file``): the deployment's sizes,
  the world and the solver settings;
* ``benchmarks/metrics/<metric>.py``: a reader, ``read(run) -> float |
  None``, of one metric; None leaves the metric out of the line.

One run: set-up (the card's kernels built or loaded, the world made, every
shape the cell uses warmed up), then the timed window of ``--seconds``,
then the check of what the window produced against the plain reference
(``benchmarks/reference``), after the peak memory is read.  The last line on
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines on standard error and the last key of that
object.  With ``--trace 1`` the first calls of the window run under the
device profiler and the line holds the per-layer metrics instead of the
end-to-end ones.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "cilqr_tpu", "oracle")


@dataclasses.dataclass
class Run:
    """What one run knows; the per-layer readers and the traffic modules share it."""

    workload: dict
    config: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    setup_s: float = math.nan
    t0: float = math.nan        # host clock at the first timed call's start
    t1: float = math.nan        # host clock at the synchronised end of the last
    calls: int = 0              # timed calls completed in the window
    items: int = 0              # solves or vehicle-cycles those calls did
    failed: int = 0             # of the items, those with a non-finite answer
    recorded: Optional[Any] = None  # trace.Trace of the traced calls
    spans: dict = dataclasses.field(default_factory=dict)     # name -> [seconds]
    counters: dict = dataclasses.field(default_factory=dict)  # name -> number


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports: the end-to-end ones, or with
    ``trace`` the per-layer ones, whose ``workloads`` (when given) name it."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str, root: Path = ROOT):
    """The ``read`` of ``benchmarks/metrics/<name>.py`` (a file, not a
    module: a metric's name may hold dots)."""
    path = root / "benchmarks" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(spec: dict, workload: str, root: Path = ROOT):
    """(workload entry, configuration, cell file, traffic module)."""
    wl = by_name(spec["workloads"], workload, "workload")
    cfg_entry = by_name(spec["configs"], wl["config"], "configuration")
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmarks" / "cells" / f"{workload}.json") as f:
        cell = json.load(f)
    traffic = importlib.import_module(f"benchmarks.traffic.{cell['kind']}")
    return wl, config, cell, traffic


def forbidden_loaded() -> bool:
    """Whether ``sys.modules`` holds a forbidden top-level name (compared
    whole); names it on standard error."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"forbidden modules loaded in the benchmark process: {found}", file=sys.stderr)
    return bool(found)


def since_process_start() -> float:
    """Seconds since this process was started (its start time in
    /proc/self/stat, 10 ms resolution), else since this module was first
    run."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - T_PROCESS


def back_to_back(run: Run, call, keep, trace_calls: int) -> None:
    """Issue timed calls ``out = call(k)``, k = 0, 1, ..., one after the
    other until ``run.seconds`` have passed on the host clock since the
    first, then wait for the card: ``run.t0``, ``run.t1`` and ``run.calls``.
    ``keep(k, out)`` is the harness's own work on a call's outputs (the
    sampled lanes, the count of failed answers).  With ``run.trace`` the
    first ``trace_calls`` calls run under the profiler and their ``keep``
    waits until it has stopped, so that the trace holds the program's work
    alone."""
    import torch

    from benchmarks import trace

    rec = trace.Recorder() if run.trace else None
    held = []

    def stop(calls):
        nonlocal rec
        rec.calls = calls
        rec.__exit__(None, None, None)
        run.recorded, rec = rec.result(), None
        for i, out in enumerate(held):
            keep(i, out)
        held.clear()

    # no collector pass inside the window: it stalls the host for tens of
    # ms; what a call keeps is bounded (``sampling.Reservoir``)
    gc.collect()
    gc.disable()
    run.setup_s = since_process_start()
    if rec is not None:
        rec.__enter__()
    run.t0 = time.perf_counter()
    k = 0
    returns = run.spans.setdefault("issue", [])
    last = run.t0
    while True:
        out = call(k)
        if rec is None:
            keep(k, out)
        else:
            held.append(out)
        k += 1
        if rec is not None and k == trace_calls:
            stop(k)
        now = time.perf_counter()
        returns.append(now - last)
        last = now
        if now - run.t0 >= run.seconds:
            break
    if rec is not None:
        stop(k)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.t1 = time.perf_counter()
    run.calls = k
    gc.enable()


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def judge(checks: list) -> bool:
    """Every number within its limit (a missing limit or number fails)."""
    return bool(checks) and all(
        c["value"] is not None and c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks)


def report_checks(checks: list) -> None:
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmarks.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    spec = load_spec()
    wl, config, cell, traffic = load_cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    run = Run(wl, config, cell, args.seed, args.seconds, bool(args.trace),
              device=torch.device("cuda", 0))
    state = traffic.setup(run)
    traffic.window(run, state)
    peak = torch.cuda.max_memory_allocated(run.device)
    if forbidden_loaded():
        return 3

    metrics = {}
    for m in metrics_of(spec, args.workload, run.trace):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    held = traffic.release(run, state)
    # the program's captured graphs and their memory pools go before the reference runs
    solver = sys.modules.get("cilqr_tpu_torch.models.solver")
    if solver is not None:
        solver.CAPTURED.clear()
    torch.cuda.empty_cache()
    checks = traffic.check(run, held)
    gaps = sorted(run.spans["issue"])
    print(f"calls {run.calls}; seconds between successive calls' returns: median "
          f"{gaps[len(gaps) // 2]!r}, max {gaps[-1]!r}", file=sys.stderr)
    report_checks(checks)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": wl["chips"],
              "memory_peak_bytes": int(peak)}
    limit = power_limit()
    if limit is not None:
        device["power_limit"] = limit
    line = {"correct": judge(checks), "attempted": run.items, "failed": run.failed,
            "metrics": metrics, "device": device}
    if run.trace and run.recorded is not None:
        from benchmarks import trace

        device["busy_s"] = run.recorded.busy_s
        device["window_s"] = run.recorded.window_s
        line["breakdown"] = trace.breakdown(run.recorded)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    if forbidden_loaded():  # again, after the readers, the trace and the check
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
