"""Tracing & phase timing — the port's observability layer.

Port of ``cilqr_tpu/utils/profiling.py``: structured phase timers in place
of the reference's ad-hoc instrumentation (std::chrono around run_step,
clock() phase timers in the costmap, the ``compute_time`` telemetry
topic), and a ``torch.profiler`` trace in place of the ``jax.profiler``
one.  ``PhaseTimer.timed`` waits for the card with
``torch.cuda.synchronize`` where ``jax.block_until_ready`` waited for the
TPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts (NamedTuples
    included)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait for every CUDA device that holds a tensor of ``tree``; nothing
    for CPU tensors.  Returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    >>> t = PhaseTimer()
    >>> with t.phase("solve"):
    ...     run()
    >>> t.summary()["solve"]["mean_ms"]

    Note: CUDA launches are asynchronous — wait for the card inside the
    phase (``block_until_ready``), or use ``timed``, for honest numbers.
    """

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._acc[name].append(seconds)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its outputs' devices, record the wall time,
        return the outputs."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        block_until_ready(out)
        self._acc[name].append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self._acc.items():
            n = len(v)
            mean = sum(v) / n
            out[k] = {
                "count": n,
                "total_ms": 1e3 * sum(v),
                "mean_ms": 1e3 * mean,
                "max_ms": 1e3 * max(v),
                "min_ms": 1e3 * min(v),
            }
        return out

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the host and the card (CPU and CUDA
    activities; the CPU alone where PyTorch has no CUDA), written on exit
    as a Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir`` (view it
    in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named range inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
