"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from cilqr_tpu_torch/csrc, holds each against its
plain PyTorch version on the card (the LM loops' condition ``lm_continue``
right after the build), then drives the port's paths and checks that each
went through its kernels:

  phases 1-7   the batched solve ``run_steps_batched(impl="mega")`` at
               B=32768, N=50 on the example world (kernels K1 and K2), and
               where a call's time goes; K1 and K3 at every lane-group size
               G, which must all give the same bits; beside K2's profile
               the two-phase step's derivatives kernel (``cost_cuda``) on
               phase 22's deployment at (8192, 40), one device kernel per
               call by the profiler, and its time there;
  phases 8-10  the Monte-Carlo path ``monte_carlo(impl="fast")`` at B=8192,
               N=50 on the full 152x104 costmap (kernels K4 and K3), and
               where its time goes; K4's own covariance fields must equal
               the PyTorch ones on every cell, and its fused form (fields
               computed in the kernel, what the paths launch) the
               fields-given form bit for bit;
  phases 11-13 the full-stack closed loop
               ``closed_loop_full_stack_batched`` at B=8192, N=50, 5 cycles:
               every cycle each scenario resamples a 256x256 global map into
               its own 152x104 vehicle frame with its obstacle overrides
               (kernel K5), propagates it (K4) and replans (K3); also
               ``closed_loop_batched`` (K1 per cycle) and a short run with
               the perception channel;
  phase 14     the op-throughput probe ``utils.opbench`` (kernel K6);
  phase 15     the experiment layer through ``python -m cilqr_tpu_torch``,
               in process: ``run --full-stack`` (60 cycles: K4 and K1 at
               B=1 per cycle), ``compare --full-stack`` on the CLI's whole
               algorithm axis (seven algorithms, 10 runs x 120 cycles on
               two scenarios: K5 and K4 every cycle; K3 for `cilqr`, K1 for
               `cilqr_base`, K2 for `ccnmpc`) and ``sweep`` on its six
               (sigmas 0 and 0.5, 50 runs x 40 cycles), with the first
               cycles of every algorithm held to the same loops on the plain
               versions and K5 held to its plain version on the 1506x1506
               synthetic town, and each algorithm's seconds, launches and
               device idle share;
  phase 16     the scale-out layer (``parallel.batch``, ``multihost``,
               ``campaign``, ``dryrun``): a one-rank NCCL process group, the
               sharded solve (K1 per shard) on 1 and 4 shards of the card at
               B=32768 and the sharded Monte-Carlo (K4, K3) at B=8192, each
               equal bit for bit to its unsharded call; the sharded full
               stack (K5, K4, K3) on 4 shards against the per-chunk runs; a
               campaign resumed after 2 of 4 rounds; the dry run; then
               ``backward_impl="pscan"`` against "seq" at B=1;
  phase 17     the benchmark driver, ``python -m cilqr_tpu_torch bench`` in
               process with its default knobs (main path B=32768, the
               Monte-Carlo path and the full stack at B=8192, the closed
               loop at B=32768): its one JSON line whole and finite, the
               launches each of its calls implies, its mean LM iterations
               against phase 5's; then once more with ``BENCH_TRACE`` on the
               headline alone, whose trace must name K1;
  phase 18     the plain LM loop as CUDA graphs (``solver.GRAPHS``):
               ``solver.run_step`` unbatched and at B=64, "seq" and "pscan",
               on the device loop (``solver.DEVICE_LOOP``: one launch of a
               loop graph, the condition on the card) against the
               host-polled step replays and eager, bit for bit, a call on
               new egos replaying without a capture, the unbatched solve
               free of host reads up to the loop's one read of its steps;
               ms per solve three ways, the worst case (every iteration)
               graphed and host-polled, ms and device kernels per replay of
               the step graph;
  phase 19     the JAX package's programs on the port
               (``cilqr_tpu_torch.scripts``), cut small: the wall-vs-car
               classification (K5, K4, K3), the NRB budget table and one
               cell of the rotated production grid (K5, K4, K3);
  phase 20     the hybrid (K3) and two-phase (K2) LM loops as CUDA graphs
               (``solver.GRAPHS``; phases 9-10, 13, 15-17 and 19 run them
               so): the Monte-Carlo path at B=8192, the full stack at
               B=8192 x 5 cycles, the two-phase solve at B=4096 and
               ``compare --full-stack`` on `cilqr` and `ccnmpc` (B=10),
               each on the device loop, host-polled and with
               ``solver.GRAPHS = False``: every solve's X, U, J, lambda and
               iterations equal bit for bit, the launch counts equal (a
               replay counts the K3 / K2 ops its capture recorded), each
               device loop's steps the largest iteration count; ms per call
               (seconds per command) three ways, the device's idle share,
               the benchmark's slope throughputs; per path one solve's step
               graph on 1 and 4 streams: ms and device kernels per replay,
               the plan, pool bytes, capture seconds, the loop graph's
               nodes;
  phase 21     the K1 solve and the closed loops' stages as CUDA graphs
               (``solver.run`` / ``solver.solve``; every phase runs them
               so): the mega solve at B=1 and B=32768 (one graph: the plan
               fit, the world's payload, K1), ``closed_loop_batched`` at
               B=32768 x 10 cycles (one graph per cycle), the Monte-Carlo
               path at B=8192 and the full stack at B=8192 x 5 cycles (the
               start graph holds the costmap build, K5 and K4, the noise
               and the hybrid loop's prologue), each graphed against
               ``solver.GRAPHS = False`` (Monte-Carlo and the full stack
               host-polled too): outputs equal bit for bit, the launch
               counts equal; ms per call each way, the device's idle
               share, device kernels per replay and pool bytes of each
               graph;
  phase 22     the CCNMPC campaign on the benchmark's deployment
               (``benchmarks/configs/ccnmpc_success1_n40.json``: N=40, the
               three success1 obstacles, two SQP rounds) at B=8192 x 3
               cycles: ``closed_loop_batched`` with the CCNMPC plan step,
               graphed (per round a start graph and the device loop)
               against ``solver.GRAPHS = False``, bit for bit; K2's
               launches and the two-phase step's derivatives kernel's
               (``cost_cuda``) each the sum of the rounds' largest iteration
               counts and the rounds 6, both ways; the derivatives kernel on
               one round's inputs at (8192, 40) against its plain version
               at phase 3's bars, one device kernel per call (the nodes of
               a graph of one call), its time alone and by events against
               its bound and the plain version's; K2
               on the kernel's derivatives against its plain versions at
               phase 3's bars; the two-phase solve with one uncertainty map
               per scenario (B=1024) graphed = eager, one launch of each
               kernel per step, its derivatives from the sampled planes
               against the plain version with the maps.

Every phase prints a line (the profiles one per batch size); any failure
raises, so the exit code is nonzero.  The last line is one JSON object:
{"ok": true, "device": {...}}.  Without a CUDA device it fails before
printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

# The bound of a kernel (utils/roofline.py): the larger of its bytes (each input
# read once, each output written once) over the H100's memory rate and its
# float32 operations over the rate outside the tensor cores.
from cilqr_tpu_torch.utils.roofline import (FP32_OPS_PER_S, RICCATI_STEP_OPS, ROLLOUT_STEP_OPS,
                                           bound, k4_bound, lm_step_ops, nbytes)
from cilqr_tpu_torch.ops import route

MAIN_B = 32768      # main-path batch (the benchmark's B)
HORIZON = 50
K2_CHECK_B = 4096
K1_CHECK_B = 1024
TIMED_CALLS = 5
NUDGES = 8          # 2-ulp perturbations of the egos that find chaotic lanes
MC_B = 8192         # Monte-Carlo batch (the JAX benchmark's B)
K4_CHECK_B = 256
K3_CHECK_B = 1024
LAUNCH_RULE_BATCHES = (1024, 8192, 32768)  # around the steps of lm_cuda.launch_shape
MC_REF_LANES = 64
SIGMA_HI = (0.16, 0.16, 0.017)  # the JAX benchmark's sampling bound
FS_B = 8192         # full-stack batch (the JAX benchmark's B)
FS_CYCLES = 5
FS_REF_LANES = 64
FS_NUDGES = 4
FS_CALM_IT_OFF = 12  # a calm lane's count may lie this far beyond its spread (counts are 1..20)
K5_CHECK_B = 256
K5_PLAIN_CHUNK = 1024  # the plain resample makes (chunk, 152, 104) int64 indices
LAYERS_REPS = 20    # back-to-back calls of the costmap layers kernel, timed
CL_CYCLES = 10      # closed_loop_batched: the JAX benchmark's 10 cycles at MAIN_B
CC_B = 8192         # the CCNMPC campaign (phase 22): the benchmark cell's batch and deployment
CC_CYCLES = 3
CC_CONFIG = pathlib.Path(__file__).resolve().parent / "benchmarks" / "configs" / \
    "ccnmpc_success1_n40.json"
K6_CHECK_ROUNDS = 8
PEAK_TFLOPS = FP32_OPS_PER_S / 1e12
NO_LIBRARY_CALL = None  # where no single PyTorch call computes a kernel's function


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int):
    """(mean milliseconds per call of fn() over reps calls by CUDA events,
    after one warm-up call; the last call's result)."""
    out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def cuda_ms(fn, reps: int) -> float:
    return timed(fn, reps)[0]


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``, from CUDA events around replays of one
    CUDA graph holding ``reps`` calls: the kernels alone, without the host's
    time between launches (for a kernel the profiler cannot see)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def graph_nodes(fn, dev: torch.device) -> tuple:
    """(nodes, kernel nodes) of one fn() captured as a CUDA graph
    (``graphs.capture``, after a warm-up call), read with libcuda's
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType``: the device work one call
    enqueues, whether or not the profiler sees it."""
    from cilqr_tpu_torch.utils import graphs

    fn()
    torch.cuda.synchronize()
    graph = graphs.capture(fn, dev)
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    require(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    require(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        require(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
                "cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return n.value, kernels


def kernel_profile(fn, reps: int, name: str) -> tuple:
    """(device ms per call of the kernels whose name holds ``name``, device
    ms per call of every other kernel or copy, device kernels and copies per
    call), from ``torch.profiler`` over reps calls after a warm-up call.
    The profiler must see the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    named = sum(e.time_range.elapsed_us() for e in events if name in e.name) / 1e3 / reps
    total = sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
    require(named > 0.0, f"the profiler saw no {name} device time")
    return named, total - named, len(events) / reps


def covered_us(spans) -> float:
    """The time at least one of the (start, end) spans covers."""
    covered, reach = 0.0, -math.inf
    for s, e in sorted(spans):
        covered += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    return covered


@contextlib.contextmanager
def host_polled():
    """Inside: the graphed LM loops replay their step graphs from the host
    (``solver.DEVICE_LOOP`` off).  ``torch.profiler`` does not see every
    kernel that runs inside a loop graph's WHILE node (the Monte-Carlo
    path's were all seen, the full stack's K3 not at all), so the profiles
    by kernel name run the loops host-polled: the same kernels on the same
    inputs."""
    from cilqr_tpu_torch.models import solver

    saved, solver.DEVICE_LOOP = solver.DEVICE_LOOP, False
    try:
        yield
    finally:
        solver.DEVICE_LOOP = saved


def profile_line(fn, reps: int, kernels: dict, annotation: str | None = None) -> str:
    """Device time per call by kernel (``torch.profiler``) and the call's
    time (CUDA events), both over the same reps calls after a warm-up call,
    the LM loops ``host_polled``.  The device is busy while at least one
    kernel runs (a graph captured on several streams overlaps them).
    ``kernels`` maps a label to a substring of a kernel's name;
    ``annotation`` names a ``record_function`` range whose kernels' device
    time is split out of the other kernels' (a replayed graph runs no
    range: see ``profile_lines``)."""
    with host_polled():
        return _profile_line(fn, reps, kernels, annotation)


def _profile_line(fn, reps: int, kernels: dict, annotation: str | None) -> str:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    named = dict.fromkeys(kernels, 0.0)
    other_ms = ann_ms = 0.0
    n_other = 0
    spans = []
    for evt in prof.events():
        user_range = getattr(evt, "is_user_annotation", False) or evt.name == annotation
        if evt.device_type == DeviceType.CUDA and not user_range:
            spans.append((evt.time_range.start, evt.time_range.end))
            ms = evt.time_range.elapsed_us() / 1e3 / reps
            label = next((k for k, key in kernels.items() if key in evt.name), None)
            if label is None:
                other_ms += ms
                n_other += 1
            else:
                named[label] += ms
        elif evt.device_type == DeviceType.CPU and evt.name == annotation:
            ann_ms += evt.device_time_total / 1e3 / reps
    busy = sum(named.values()) + other_ms
    covered = covered_us(spans) / 1e3 / reps
    parts = [f"call {call_ms:.3f} ms (CUDA events, under the profiler)",
             f"device busy {covered:.3f} ms = {100 * covered / call_ms:.1f}% of the call "
             f"(kernel time summed {busy:.3f} ms)"]
    for label, ms in named.items():
        require(ms > 0.0, f"the profiler saw no {label} device time")
        parts.append(f"{label} {ms:.3f} ms ({100 * ms / busy:.1f}% of device time)")
    if annotation is not None:
        require(ann_ms > 0.0, f"the profiler saw no device time under {annotation}")
        parts.append(f"{annotation} {ann_ms:.3f} ms ({100 * ann_ms / busy:.1f}%)")
        parts.append(f"the rest {other_ms - ann_ms:.3f} ms "
                     f"({100 * (other_ms - ann_ms) / busy:.1f}%)")
    parts.append(f"{n_other / reps:.0f} other kernels {other_ms:.3f} ms")
    return " | ".join(parts)


def profile_lines(fn, reps: int, kernels: dict, annotation: str | None = None) -> str:
    """``profile_line`` of fn() as it runs, its LM loops graphed (replayed
    host-polled), and with
    ``annotation`` once more with ``solver.GRAPHS`` off: the kernels of a
    replayed graph run outside any profiler range, so the range's share is
    read off the eager loop."""
    from cilqr_tpu_torch.models import solver

    line = profile_line(fn, reps, kernels)
    if annotation is None:
        return line
    try:
        solver.GRAPHS = False
        return f"{line} || the same, loops eager: {profile_line(fn, reps, kernels, annotation)}"
    finally:
        solver.GRAPHS = True


def ptxas_lines(log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v report: its name
    (integer or bool template argument from the mangled name), registers and
    spill bytes."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            base = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)", mangled)
            name = base.group(1) if base else mangled
            arg = re.search(r"IL[ib](\d+)E", mangled)
            name += f"<{arg.group(1)}>" if arg else ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} spill bytes (stores/loads)"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
    return out


def rollout_step_check(p, X, U, k, K, Xn, Un) -> list:
    """Each rollout step of a kernel, u = U + k + K (x - X), x' = step(x, u),
    held in float64 to that step computed from the kernel's own previous
    state and gains, at 1e-4 relative + 1e-5 absolute: [(name, max err)]."""
    from cilqr_tpu_torch.models import dynamics

    Xg, Ug = Xn.double(), Un.double()
    u_step = (U.double() + k.double()
              + (K.double() @ (Xg[:, :-1] - X[:, :-1].double())[..., None])[..., 0])
    x_step = torch.cat([X[:, :1].double(), dynamics.step(p, Xg[:, :-1], Ug)], dim=1)
    out = []
    for name, got, want in (("X_new", Xg, x_step), ("U_new", Ug, u_step)):
        err, excess = max_excess(got, want, rtol=1e-4, atol=1e-5)
        out.append((name, err))
        require(excess <= 0.0, f"{name}: a rollout step is off by {err:.3e}, beyond "
                "1e-4 rel + 1e-5 abs")
    return out


def k2_held(p, d, X, U, lamb) -> tuple:
    """K2, ``riccati_cuda``'s backward and backward + rollout calls (one
    launch each), on the derivatives ``d`` at (X, U, lamb), held to its plain
    versions (phase 3's bars): the gains within 1e-4 relative + 1e-5
    absolute of the float32 plain version; each rollout step at the same
    bar (``rollout_step_check``); the whole X_new and U_new no further from
    the float64 plain version than twice the float32 plain version, + 1e-6.
    Returns (the largest |kernel - plain|, the rollout checks' lines)."""
    from cilqr_tpu_torch.models import costs
    from cilqr_tpu_torch.ops import riccati_cuda

    before = riccati_cuda.LAUNCHES
    k_got, K_got = riccati_cuda.backward_batched(p, d, X, U, lamb)
    Xn_got, Un_got = riccati_cuda.backward_forward_batched(p, d, X, U, lamb)
    torch.cuda.synchronize()
    require(riccati_cuda.LAUNCHES == before + 2, "K2 launch counter did not move")
    k_want, K_want = riccati_cuda.backward_plain(p, d, X, U, lamb)
    Xn_want, Un_want = riccati_cuda.backward_forward_plain(p, d, X, U, lamb)
    # Gains: within 1e-4 relative + 1e-5 absolute of the float32 plain version
    # (the two differ only in operation order and FMA contraction).
    k2_err = 0.0
    for name, got, want in (("k", k_got, k_want), ("K", K_got, K_want)):
        err, excess = max_excess(got, want, rtol=1e-4, atol=1e-5)
        k2_err = max(k2_err, err)
        require(excess <= 0.0, f"K2 {name}: max |diff| {err:.3e} exceeds 1e-4 rel + 1e-5 abs")
    # Rollout, step by step at the same bar: each step of the kernel is held
    # to that step computed in float64 from the kernel's own previous state
    # and gains.  The whole trajectories of two float32 rollouts drift apart
    # by ~1e-4 in u (float32 positions near 300 m carry an ulp of 3e-5 m,
    # which the gains, |K| up to ~13, amplify along the horizon), so the
    # whole trajectory is held instead to the float64 plain version: at most
    # twice as far from it as the float32 plain version is.
    roll = [f"{name} per step {err:.3e}"
            for name, err in rollout_step_check(p, X, U, k_got, K_got, Xn_got, Un_got)]
    d64 = costs.CostDerivs(*(None if t is None else t.double() for t in d))
    Xn_64, Un_64 = riccati_cuda.backward_forward_plain(
        p, d64, X.double(), U.double(), lamb.double())
    for name, got, want, ref in (("X_new", Xn_got, Xn_want, Xn_64), ("U_new", Un_got, Un_want, Un_64)):
        k_dev = float((got.double() - ref).abs().max())
        p_dev = float((want.double() - ref).abs().max())
        k2_err = max(k2_err, float((got - want).abs().max()))
        roll.append(f"{name} whole: kernel-f64 {k_dev:.3e} plain32-f64 {p_dev:.3e}")
        require(k_dev <= 2.0 * p_dev + 1e-6, f"K2 {name}: kernel {k_dev:.3e} from float64, "
                f"float32 plain {p_dev:.3e}")
    return k2_err, roll


def max_excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """(max |got - want|, max of |got - want| - (atol + rtol |want|))."""
    diff = (got.double() - want.double()).abs()
    return float(diff.max()), float((diff - (atol + rtol * want.double().abs())).max())


def lane_deviation(got, want) -> dict:
    """Per-lane deviation of one solve result (X, U, it, J, lamb) from
    another, each as a share of its bar: head = max over the first 10 steps
    of U and X of |diff| / (1e-2 + 1e-2 |want|), jrel = |dJ| / (2e-2 |J|),
    fullu = max full-horizon |dU| / 0.5; fail = any of the three beyond 1."""
    X1, U1, _, J1, _ = (t.double() for t in got)
    X2, U2, _, J2, _ = (t.double() for t in want)
    bar = lambda a, b: ((a - b).abs() / (1e-2 + 1e-2 * b.abs())).amax(dim=(1, 2))
    head = torch.maximum(bar(U1[:, :10], U2[:, :10]), bar(X1[:, :10], X2[:, :10]))
    jrel = (J1 - J2).abs() / (2e-2 * J2.abs())
    fullu = (U1 - U2).abs().amax(dim=(1, 2)) / 0.5
    return dict(head=head, jrel=jrel, fullu=fullu,
                fail=(head > 1.0) | (jrel > 1.0) | (fullu >= 1.0))


def describe(dev: dict, lanes: torch.Tensor) -> str:
    q = lambda t: f"{float(t[lanes].max()):.2e}"
    return (f"max share of bar: head {q(dev['head'])}, J {q(dev['jrel'])}, full U {q(dev['fullu'])}, "
            f"lanes beyond {int(dev['fail'][lanes].sum())}")


def perturbed(egos: torch.Tensor, count: int) -> list:
    """count copies of egos, each component moved by 2 float32 ulps up or
    down (relative 2**-22), with signs from generator seeds 0..count-1."""
    out = []
    for seed in range(count):
        g = torch.Generator().manual_seed(seed)
        sign = torch.randint(0, 2, tuple(egos.shape), generator=g).to(egos) * 2 - 1
        out.append(egos * (1 + sign * 2.0 ** -22))
    return out


def nudged_results(run, egos: torch.Tensor, count: int) -> list:
    """The results (X, U, it, J, lamb) of run(egos') on ``perturbed(egos,
    count)``, all copies solved as one batch: one tuple per copy."""
    L = egos.shape[0]
    out = run(torch.cat(perturbed(egos, count)))
    return [tuple(t[i * L:(i + 1) * L] for t in out) for i in range(count)]


def check_lanes(label: str, got, want32, want64, nudged32, chaotic_it_off: int = 1,
                by_spread: bool = False, calm_it_off: int | None = None):
    """Hold a float32 solve result (X, U, it, J, lamb) per lane to a float32
    reference computed another way (want32) and to its float64 counterpart.

    The chaotic lanes are found without ``got``: those where the float32
    reference breaks the bars against want64, either as it is or on any of
    the inputs moved by 2 ulps (nudged32, the float32 reference's results on
    ``perturbed`` egos).  Every other (calm) lane must meet the bars against
    both references, with want32's iteration count; on the chaotic lanes the
    counts differ from want32's by at most ``chaotic_it_off``, plus, with
    ``by_spread``, that lane's spread: the largest distance of a nudged or
    float64 reference's count from want32's; or they equal the count of one
    of those references (a branch the reference itself takes under a 2-ulp
    nudge: a chaotic lane that either stops on the lambda cap or runs to
    max_iterations has its two branches two or more iterations apart).
    With ``calm_it_off`` a calm lane's count may differ by its spread plus
    that many, as long as nine in ten calm lanes have equal counts.  The closed loop needs it: its
    later cycles start warm, next to the optimum, where J_new - J_old is
    float32 noise, and the LM-iteration kernel's J differs from the plain
    version's by 5e-7 relative.  There the tests J_new < J_old (accept, and
    stop since |dJ| < 1e-4; or reject, multiply lambda by 10 and go on
    until lambda passes its cap) fall either way on a lane whose solution
    agrees well within the bars.  Where the plain version's own counts move
    under a 2-ulp nudge on more than one calm lane in ten (a cold first
    cycle, every lane from the initial controls: up to half of them;
    CCNMPC's two warm-started solves per cycle: 6-30%), the required share
    is the median of the nudged references' shares against want32: a rule
    that the plain version fails against its own nudges cannot hold a
    kernel.
    Returns (summary line, calm-lane mask, share of lanes with equal counts,
    max full-horizon |dU| against want32 on the calm lanes)."""
    chaotic = lane_deviation(want32, want64)["fail"]
    spread = (want64[2] - want32[2]).abs()
    for res in nudged32:
        chaotic = chaotic | lane_deviation(res, want64)["fail"]
        spread = torch.maximum(spread, (res[2] - want32[2]).abs())
    calm = ~chaotic
    allowed = chaotic_it_off + (spread if by_spread else 0)
    on_ref = torch.stack([want64[2].to(got[2].dtype)] + [res[2] for res in nudged32]).eq(
        got[2]).any(dim=0)
    dev32 = lane_deviation(got, want32)
    dev64 = lane_deviation(got, want64)
    same = got[2] == want32[2]
    it_share = float(same.float().mean())
    off = (got[2] - want32[2]).abs()
    it_off = int(off.max())
    ref_shares = [float((res[2] == want32[2])[calm].float().mean()) for res in nudged32]
    share_req = min(0.9, statistics.median(ref_shares))
    calm_rule = ("" if calm_it_off is None
                 else f", calm lanes held within their spread + {calm_it_off}, "
                      f"{100 * share_req:.0f}% equal required (nudged references: "
                      f"{[round(100 * v) for v in ref_shares]}%)")
    line = (f"chaotic lanes {int(chaotic.sum())} of {chaotic.numel()} | iterations equal on "
            f"{100 * it_share:.2f}% (max off {it_off}, calm lanes "
            f"{100 * float(same[calm].float().mean()):.2f}%{calm_rule}, chaotic lanes held within "
            f"{'their spread + ' if by_spread else ''}{chaotic_it_off} or on a reference's count "
            f"({int((chaotic & (off > allowed) & on_ref).sum())} by the latter), max spread "
            f"{int(spread.max())}) | calm lanes vs float32 plain: "
            f"{describe(dev32, calm)} | vs float64 plain: {describe(dev64, calm)}")
    calm_ok = same if calm_it_off is None else off <= spread + calm_it_off
    bad = (calm & ~calm_ok) | (chaotic & (off > allowed) & ~on_ref)
    if calm_it_off is not None:
        require(float(same[calm].float().mean()) >= share_req,
                f"{label}: fewer than {100 * share_req:.0f}% of the calm lanes have equal "
                f"iteration counts: {line}")
    lanes = [(int(i), int(off[i]), int(spread[i]), bool(chaotic[i]))
             for i in bad.nonzero().flatten()]
    require(not lanes, f"{label} iteration counts disagree: {line} | (lane, off, spread, "
            f"chaotic): {lanes}")
    require(not bool(dev32["fail"][calm].any()),
            f"{label}: a calm lane breaks the bars against the float32 plain version: {line}")
    require(not bool(dev64["fail"][calm].any()),
            f"{label}: a calm lane breaks the bars against the float64 plain version: {line}")
    return line, calm, it_share, float((got[1] - want32[1]).abs().amax(dim=(1, 2))[calm].max())


def iteration_spread(iterations: torch.Tensor, per_warp: int) -> tuple:
    """(histogram of LM iteration counts as {count: lanes}, the mean over
    warps of the slowest scenario's count over the warp's mean count, for
    warps of per_warp neighbouring scenarios): what a warp that ran until
    its slowest scenario stopped would spend over what its scenarios need."""
    it = iterations.long()
    hist = {int(c): int(n) for c, n in enumerate(torch.bincount(it)) if n}
    full = it[: it.numel() // per_warp * per_warp].reshape(-1, per_warp).double()
    return hist, float((full.amax(dim=1) / full.mean(dim=1)).mean())


def pick(r) -> tuple:
    """(X, U, iterations, J, lamb) of a SolveResult."""
    return (r.X, r.U, r.iterations, r.J, r.lamb)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# Phase 15, the experiment layer: the CLI's commands at the sizes of the
# reference's experiments
EXP_RUN_CYCLES = 60        # `run`'s default; horizon 40 is the CLI's default
EXP_COMPARE_RUNS, EXP_COMPARE_CYCLES = 10, 120
# the sweep's 160 cycles (the CLI's default) are cut to 40 so that the whole
# algorithm axis fits the script's time
EXP_SWEEP_RUNS, EXP_SWEEP_CYCLES = 50, 40
EXP_SIGMAS = (0.0, 0.5)


def exp_run_argv() -> list:
    return ["run", "--full-stack", "--scenario", "success1", "--cycles", str(EXP_RUN_CYCLES)]


EXP_SCENARIOS = ("compare", "gauntlet")


def exp_compare_argv() -> list:
    """The CLI's default algorithm axis (no --algorithms)."""
    return ["compare", "--full-stack", "--scenarios", ",".join(EXP_SCENARIOS), "--runs",
            str(EXP_COMPARE_RUNS), "--cycles", str(EXP_COMPARE_CYCLES)]


def exp_sweep_argv() -> list:
    return ["sweep", "--sigmas", ",".join(map(str, EXP_SIGMAS)), "--runs", str(EXP_SWEEP_RUNS),
            "--cycles", str(EXP_SWEEP_CYCLES)]


EXP_LANE_CYCLES = 5    # cycles of (b) and (c) held to the loop on the plain versions
# the sweep's `cilqr` and `frenet_propagation` are held on their first, cold
# cycle (their warm cycles are held in compare's): their references
# propagate each costmap over the sweep's widest window on the plain
# versions (`cilqr`'s float64 oracle build ~15 s per cycle, K4's plain
# version ~14 s)
EXP_SWEEP_SLOW_HELD = ("cilqr", "frenet_propagation")
EXP_SWEEP_SLOW_HELD_CYCLES = 1
EXP_RUN_HELD_EVERY = 2  # every 2nd of `run`'s K1 calls held to its plain version
EXP_PROFILE_CYCLES = 3
# the kernels each algorithm's planner launches (K4 and K5 come with the
# full-stack costmap build); the others launch none
EXP_PLANNER_KERNELS = {"cilqr": {"K3": "lm_iter_kernel"}, "cilqr_base": {"K1": "lm_opt_kernel"},
                       "ccnmpc": {"K2": "riccati_kernel"}}
EXP_BUILD_KERNELS = {"K4": "propagate_kernel", "K5": "sample_kernel"}
# planners that read no kernel's output but K4's map, which equals its plain
# version on every cell at these shapes (phase 12): their loops on the kernels
# and on the plain versions must agree bit for bit
EXP_EXACT = ("frenet_origin", "frenet_expansion", "frenet_propagation", "nrb_rrt")
K5_TOWN_B = 1024


@contextlib.contextmanager
def recording(module, name: str, store: list, keep=lambda out, args, kw: out):
    """Inside: ``module.name`` appends keep(its result, its positional
    arguments, its keyword arguments) to store on every call.  The wrapped
    function runs as it is: no launch is added."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        store.append(keep(out, args, kw))
        return out

    setattr(module, name, wrapped)
    try:
        yield store
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def per_call(module, name: str, read_counts, store: list, label):
    """Inside: every call of ``module.name`` appends (label(its arguments,
    its keywords) taken as the call starts, its seconds, the kernel launches
    it made, its result) to store; the device is idle when each call's clock
    starts and stops."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        tag = label(args, kw)
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds, after = time.perf_counter() - t0, read_counts()
        store.append((tag, seconds, {k: after[k] - before[k] for k in after}, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield store
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def steps_recorded(runner, out: list):
    """Inside: every planner step that ``runner.make_plan_step`` makes
    appends its result (X, U, iterations, J, lamb) to out."""
    make = runner.make_plan_step

    def wrapped_make(*args, **kw):
        step = make(*args, **kw)

        def recorded(*a, **k):
            res = step(*a, **k)
            out.append(pick(res))
            return res

        return recorded

    runner.make_plan_step = wrapped_make
    try:
        yield out
    finally:
        runner.make_plan_step = make


def by_algorithm(calls: list, algorithms) -> dict:
    """Per algorithm: (seconds, launches) summed over its calls of
    ``per_call`` (label (algorithm, ...))."""
    out = {}
    for a in algorithms:
        mine = [(s, n) for (label, s, n, _) in calls if label[0] == a]
        out[a] = (sum(s for s, _ in mine),
                  {k: sum(n[k] for _, n in mine) for k in mine[0][1]})
    return out


def expect_launches(label: str, algo: str, got: dict, cycles_built: int, lm_iter: int,
                    cycles_k1: int, k2: int) -> None:
    """An algorithm's launches in one command: the costmap layers kernel, K5
    and K4 once per cycle of its full-stack loops, K3 ``lm_iter`` times (`cilqr`), K1 once per cycle
    of its shared-world solves (`cilqr_base`), K2 and the two-phase step's
    derivatives kernel ``k2`` times each (`ccnmpc`: once per LM iteration of
    each two-phase solve), nothing else."""
    want = {"costmap": cycles_built, "sample": cycles_built, "uncertainty": cycles_built,
            "lm_iter": lm_iter if algo == "cilqr" else 0,
            "lm": cycles_k1 if algo == "cilqr_base" else 0,
            "riccati": k2 if algo == "ccnmpc" else 0, "cost": k2 if algo == "ccnmpc" else 0}
    require(got == want, f"{label} {algo}: launches {got}, expected {want}")
    if algo == "ccnmpc":
        require(k2 > 0, f"{label} ccnmpc launched no K2")


def cli_call(argv: list, dev: torch.device, out_dir=None) -> tuple:
    """(seconds, standard output) of one in-process call of the port's CLI
    (``python -m cilqr_tpu_torch``) on ``dev``, which is idle before the
    clock starts and after it stops."""
    from cilqr_tpu_torch import __main__ as cli

    buf = io.StringIO()
    argv = list(argv) + ["--device", str(dev)] + ([] if out_dir is None else
                                                  ["--out", str(out_dir)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(rc == 0, f"`{' '.join(argv)}` returned {rc}")
    return seconds, buf.getvalue()


def check_records(label: str, recs: list, lo: int, hi: int) -> None:
    """Every record finite, every iteration count (LM iterations; the
    Frenet lattice's selected candidate; NRB-RRT's node count) in [lo, hi]."""
    for rec in recs:
        for k, v in rec.items():
            require(bool(torch.isfinite(torch.as_tensor(v).double()).all()),
                    f"{label}: non-finite {k}")
        it = torch.as_tensor(rec["iterations"])
        require(lo <= int(it.min()) and int(it.max()) <= hi,
                f"{label}: iterations outside [{lo}, {hi}]")


def iteration_range(p, algo: str) -> tuple:
    """The range of ``algo``'s iterations record: LM iterations for the
    CILQR solves, the selected candidate for the Frenet lattice, the nodes
    grown for NRB-RRT."""
    from cilqr_tpu_torch.models import frenet, nrb_rrt

    if algo.startswith("frenet"):
        return 0, frenet.FrenetParams().n_candidates - 1
    if algo == "nrb_rrt":
        return 1, nrb_rrt.NRBParams().max_nodes
    return 1, p.max_iterations


def hold_loop(label: str, run, x0s: torch.Tensor, draws: torch.Tensor, counts) -> tuple:
    """The closed loop's per-lane rule (phases 13 and 15): run(x0s, draws,
    dtype, use_kernels) -> the per-cycle solve results (X, U, iterations, J,
    lamb); the kernel route against the same loop on the plain versions in
    float32, in float64 (plain stages, oracle costmap build) and on egos
    moved by 2 ulps; the float32 plain loop runs the egos and their nudged
    copies as one batch (the loops are launch-bound; the batch moves a
    lane's result by rounding at most, as the nudges do).  A lane
    found chaotic in one cycle has left its references for good and is left
    out of the later cycles; half the lanes must be calm after cycle 1.
    Returns (the kernel route's launches, its per-cycle results, the
    summary line)."""
    zero_counts, read_counts = counts
    L, cycles = x0s.shape[0], draws.shape[0]
    t0 = time.perf_counter()
    zero_counts()
    got = run(x0s, draws, torch.float32, True)
    torch.cuda.synchronize()
    launches = read_counts()
    with route.plain():
        plain = run(torch.cat([x0s] + perturbed(x0s, FS_NUDGES)),
                    draws.repeat(1, FS_NUDGES + 1, 1), torch.float32, True)
        want64 = run(x0s.double(), draws.double(), torch.float64, False)
    want32 = [tuple(v[:L] for v in cyc) for cyc in plain]
    nudged = [[tuple(v[(i + 1) * L:(i + 2) * L] for v in cyc) for cyc in plain]
              for i in range(FS_NUDGES)]
    require(read_counts() == launches, f"{label}: a plain-version loop launched a kernel")
    keep = torch.ones(L, dtype=torch.bool, device=x0s.device)
    lines = []
    for t in range(cycles):
        if int(keep.sum()) < 2:
            lines.append(f"cycle {t + 1}: fewer than 2 calm lanes left, not held")
            break
        sub = lambda r: tuple(v[keep] for v in r)
        line, calm, _, _ = check_lanes(
            f"{label}, cycle {t + 1}", sub(got[t]), sub(want32[t]), sub(want64[t]),
            [sub(nc[t]) for nc in nudged], chaotic_it_off=2, by_spread=True,
            calm_it_off=FS_CALM_IT_OFF)
        lines.append(f"cycle {t + 1} ({int(keep.sum())} lanes held): {line}")
        keep[keep.clone()] = calm
        if t == 0:
            require(int(keep.sum()) >= L // 2,
                    f"{label}: only {int(keep.sum())} of {L} lanes calm in cycle 1")
    return launches, got, (" || ".join(lines) + f" || {int(keep.sum())} of {L} lanes calm "
                           f"through {cycles} cycles ({time.perf_counter() - t0:.1f} s)")


def as_double(x):
    """x with every floating tensor in it (alone or in named tuples) in
    float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(as_double(v) for v in x))
    return x


def hold_calls(label: str, calls: list) -> str:
    """Each recorded ``run_steps_batched`` call of a loop on the kernels,
    (its arguments, its keywords, its result (X, U, iterations, J, lamb)),
    solved again on the same inputs on the plain versions: in float32 with
    the egos moved by 2 ulps in the same batch, and in float64.  The lanes
    of all calls are then held together by the closed loop's rule (warm
    starts sit at the optimum: ``check_lanes`` with ``calm_it_off``).
    Returns the summary line."""
    from cilqr_tpu_torch.models import solver_batched

    got, want32, want64, nudged = [], [], [], [[] for _ in range(FS_NUDGES)]
    with route.plain():
        for args, kw, res in calls:
            p, plan, n, egos, U_warm, *world = args
            L = egos.shape[0]
            plain = pick(solver_batched.run_steps_batched(
                p, plan, n, torch.cat([egos] + perturbed(egos, FS_NUDGES)),
                U_warm.repeat(FS_NUDGES + 1, 1, 1), *world, **kw))
            got.append(res)
            want32.append(tuple(v[:L] for v in plain))
            for i in range(FS_NUDGES):
                nudged[i].append(tuple(v[(i + 1) * L:(i + 2) * L] for v in plain))
            want64.append(pick(solver_batched.run_steps_batched(*map(as_double, args), **kw)))
    cat = lambda results: tuple(torch.cat(v) for v in zip(*results))
    line, *_ = check_lanes(label, cat(got), cat(want32), cat(want64), [cat(r) for r in nudged],
                           chaotic_it_off=2, by_spread=True, calm_it_off=FS_CALM_IT_OFF)
    return line


def experiment_layer(card: str, counts, dev: torch.device) -> tuple:
    """Phase 15: the experiment layer through the port's CLI, in process, on
    the card, in a temporary directory: (a) `run --full-stack` (K4 in its
    single-map form and K1 at B=1 per cycle), (b) `compare --full-stack` on
    two scenarios and the CLI's seven algorithms (per cycle K5 and K4; K3
    per LM iteration for `cilqr`, K1 for `cilqr_base`, K2 per LM iteration
    of each two-phase solve for `ccnmpc`; the Frenet lattice and NRB-RRT
    launch no kernel of their own), (c) `sweep` over two sigmas and six
    algorithms (`cilqr` and `frenet_propagation` on the full stack with K5
    and K4; the others on `closed_loop_batched`).  Launch counts as those
    routes say, per algorithm, records finite, the first cycles of every
    algorithm of (b) and (c) held to the same loops on the plain versions,
    K5 exact on the synthetic town at poses along and off the `long` route,
    the time of each command and algorithm, and a profile of 3 cycles of
    each.  Returns (the launch counts of each command, per command and
    algorithm its seconds, launches and vehicle-cycles/s)."""
    from cilqr_tpu_torch import CostmapParams, NoiseParams, SolverParams
    from cilqr_tpu_torch.models import ccnmpc, nrb_rrt, reference_path as rp, solver_batched
    from cilqr_tpu_torch.ops import costmap as costmap_mod, sample_cuda
    from cilqr_tpu_torch.sim import plant, runner, scenarios, sweep

    t_phase = time.perf_counter()
    zero_counts, read_counts = counts
    p = SolverParams()  # horizon 40, the CLI's default
    cp = CostmapParams()
    noise = NoiseParams()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="cilqr_exp_") as tmp_name:
        tmp = pathlib.Path(tmp_name)

        # (a) one vehicle, wall-clock planning times: K4 (single map) and K1
        # (B=1, on the 152 x 104 costmap) once per cycle and once more in the
        # warm-up call
        runs, k1_calls = [], []
        run_cycles = EXP_RUN_CYCLES
        zero_counts()
        with recording(runner, "run_experiment", runs), recording(
                solver_batched, "run_steps_batched", k1_calls,
                keep=lambda out, args, kw: (args, kw, pick(out))):
            run_s, run_out = cli_call(exp_run_argv(), dev, tmp / "run")
        launches["run"] = read_counts()
        require(launches["run"] == {"costmap": run_cycles + 1, "sample": 0,
                                    "uncertainty": run_cycles + 1, "lm_iter": 0,
                                    "lm": run_cycles + 1, "riccati": 0, "cost": 0},
                f"run --full-stack launches {launches['run']}, expected the costmap layers "
                f"kernel, K4 and K1 {run_cycles + 1} times")
        rec = runs[0]
        check_records("run", [rec], 1, p.max_iterations)
        summary = json.loads(run_out)
        for f in ("experiment.log", "metrics.csv"):
            require((tmp / "run" / f).exists(), f"run wrote no {f}")
        ms = lambda a, q: float(np.percentile(a, q)) * 1e3
        pt, ct = rec["planning_time"], rec["costmap_time"]
        an_s, an_out = cli_call(["analyze", str(tmp / "run" / "experiment.log"), "--scenario",
                                 "success1"], dev)
        row = json.loads(an_out)
        require(math.isfinite(row["velocity_mean"]) and math.isfinite(row["planning_time_max"]),
                "analyze: non-finite metrics")
        print(f"[15 run] `{' '.join(exp_run_argv())}`: launches {launches['run']} | planning ms "
              f"p50 {ms(pt, 50):.3f} p99 {ms(pt, 99):.3f} (CLI: {summary['planning_time_ms']}, "
              f"budget 100 ms) | costmap ms p50 {ms(ct, 50):.3f} p99 {ms(ct, 99):.3f} | "
              f"collisions {summary['collisions']}, final x {summary['final_x']:.2f}, mean "
              f"iterations {summary['mean_iterations']} | {run_s:.3f} s for the command | "
              f"analyze {an_s:.3f} s, velocity_mean {row['velocity_mean']:.3f} on {card}",
              flush=True)
        # every 2nd of the run's K1 calls (the warm-up and cycles 2, 4, ...)
        # against K1's plain version on its inputs
        t0 = time.perf_counter()
        maps = {tuple(args[6].values.shape) for args, _, _ in k1_calls}
        require(len(k1_calls) == run_cycles + 1 and maps == {(cp.rows, cp.cols)},
                f"run: {len(k1_calls)} planner calls on maps {maps}")
        k1_line = hold_calls("run K1", k1_calls[::EXP_RUN_HELD_EVERY])
        require(read_counts() == launches["run"], "run: a plain-version solve launched a kernel")
        print(f"[15 run K1] {len(k1_calls[::EXP_RUN_HELD_EVERY])} of the run's {len(k1_calls)} "
              f"K1 calls (B=1, map {cp.rows} x {cp.cols}) vs "
              f"fused_optimize_plain on the same inputs: {k1_line} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del k1_calls

        # (b) the 10-run batches, full stack, on the CLI's whole algorithm
        # axis: per scenario and algorithm one batched loop of B = runs, in
        # the order compare/cilqr, ..., compare/nrb_rrt, gauntlet/cilqr, ...
        # Each loop's seconds and launches are read around its call; the
        # two-phase solves (`ccnmpc`'s SQP rounds) are recorded, for K2's
        # expected count
        calls, solves = [], []
        cmp_cycles = EXP_COMPARE_CYCLES
        steps_of = lambda out, args, kw: out.iterations.amax()
        zero_counts()
        with per_call(runner, "run_experiment_batch", read_counts, calls,
                      lambda args, kw: (kw["algorithm"], args[5].name, len(solves))), \
                recording(ccnmpc, "solve_round", solves, keep=steps_of):
            cmp_s, cmp_out = cli_call(exp_compare_argv(), dev, tmp / "compare")
        launches["compare"] = read_counts()
        require(loop_kinds(EXP_COMPARE_RUNS) >= {"hybrid", "two_phase"},
                f"compare: the graphed loops are {loop_kinds()}")
        algos = runner.ALGORITHMS
        require([c[0][:2] for c in calls] == [(a, sc) for sc in EXP_SCENARIOS for a in algos],
                f"compare ran {[c[0][:2] for c in calls]}")
        ends = [c[0][2] for c in calls[1:]] + [len(solves)]
        k2_of = lambda i: sum(int(it) for it in solves[calls[i][0][2]:ends[i]])
        per_algo = by_algorithm(calls, algos)
        cmp_algo = {}
        for a in algos:
            mine = [i for i, c in enumerate(calls) if c[0][0] == a]
            recs = [calls[i][3][0]["record"] for i in mine]
            lm_iter = sum(int(r["iterations"].amax(dim=0).sum()) for r in recs)
            k2 = sum(k2_of(i) for i in mine)
            cycles = len(EXP_SCENARIOS) * cmp_cycles
            expect_launches("compare", a, per_algo[a][1], cycles, lm_iter, cycles, k2)
            check_records(f"compare {a}", recs, *iteration_range(p, a))
            secs = per_algo[a][0]
            cmp_algo[a] = dict(seconds=secs, launches=per_algo[a][1],
                               vehicle_cycles_per_s=EXP_COMPARE_RUNS * cycles / secs)
        require(sum(per_algo[a][1]["riccati"] for a in algos) == launches["compare"]["riccati"],
                "compare: K2 launched outside the loops")
        require((tmp / "compare" / "comparison.csv").exists(), "compare wrote no comparison.csv")
        cmp_summary = json.loads(cmp_out)
        cmp_vc = len(algos) * len(EXP_SCENARIOS) * EXP_COMPARE_RUNS * cmp_cycles
        print(f"[15 compare] `{' '.join(exp_compare_argv())}`: launches {launches['compare']} | "
              f"{cmp_s:.3f} s = {cmp_vc / cmp_s:.1f} vehicle-cycles/s ({cmp_vc} cycles) on "
              f"{card}", flush=True)
        for a, v in cmp_algo.items():
            rows = [(k, r) for k, r in cmp_summary.items() if k.endswith("/" + a)]
            print(f"[15 compare {a}] {v['seconds']:.3f} s for {len(EXP_SCENARIOS)} x "
                  f"{EXP_COMPARE_RUNS} runs x {cmp_cycles} cycles = "
                  f"{v['vehicle_cycles_per_s']:.1f} vehicle-cycles/s | launches {v['launches']}"
                  + (f" = {v['launches']['riccati'] / (len(EXP_SCENARIOS) * cmp_cycles):.2f} "
                     "K2 per cycle" if a == "ccnmpc" else "") + " | "
                  + " | ".join(f"{k}: {r['collision_runs']} collision runs, velocity "
                               f"{r['velocity_mean']}, min obstacle distance "
                               f"{r['min_obstacle_distance']}" for k, r in rows), flush=True)
        del calls, solves

        # (c) the sigma sweep on its six algorithms: cilqr and
        # frenet_propagation on the full stack, the others blind
        calls, solves = [], []
        sw_cycles = EXP_SWEEP_CYCLES
        zero_counts()
        with per_call(sweep, "run_cell", read_counts, calls,
                      lambda args, kw: (args[0], args[8], len(solves))), \
                recording(ccnmpc, "solve_round", solves, keep=steps_of):
            sw_s, sw_out = cli_call(exp_sweep_argv(), dev, tmp / "sweep")
        launches["sweep"] = read_counts()
        algos_sw = sweep.SWEEP_ALGORITHMS
        n_sig = len(EXP_SIGMAS)
        require(sorted(c[0][:2] for c in calls) == sorted(
            (a, s) for a in algos_sw for s in EXP_SIGMAS), f"sweep ran {[c[0] for c in calls]}")
        ends = [c[0][2] for c in calls[1:]] + [len(solves)]
        per_algo = by_algorithm(calls, algos_sw)
        sw_algo = {}
        for a in algos_sw:
            mine = [i for i, c in enumerate(calls) if c[0][0] == a]
            recs = [calls[i][3] for i in mine]
            lm_iter = sum(int(r["iterations"].amax(dim=0).sum()) for r in recs)
            k2 = sum(k2_of(i) for i in mine)
            built = n_sig * sw_cycles if a in sweep.MAP_CONSUMERS else 0
            expect_launches("sweep", a, per_algo[a][1], built, lm_iter, n_sig * sw_cycles, k2)
            check_records(f"sweep {a}", recs, *iteration_range(p, a))
            secs = per_algo[a][0]
            sw_algo[a] = dict(seconds=secs, launches=per_algo[a][1],
                              vehicle_cycles_per_s=EXP_SWEEP_RUNS * n_sig * sw_cycles / secs)
        rows = json.loads((tmp / "sweep" / "sweep.json").read_text())
        require(len(rows) == len(algos_sw) * n_sig and (tmp / "sweep" / "sweep.md").exists(),
                "sweep wrote the wrong rows")
        tests = []
        for s_ in EXP_SIGMAS:
            by = {r["algorithm"]: r for r in rows if r["sigma_xy"] == s_}
            t = sweep.paired_sign_test(by["cilqr"], by["cilqr_base"])
            tests.append(f"sigma {s_}: " + ", ".join(
                f"{a} {by[a]['collision_runs']}" for a in algos_sw)
                + f" collision runs of {EXP_SWEEP_RUNS} (cilqr vs cilqr_base: only cilqr "
                f"{t['only_a']}, only cilqr_base {t['only_b']}, sign test p = {t['p_value']:.3g})")
        sw_vc = len(algos_sw) * n_sig * EXP_SWEEP_RUNS * sw_cycles
        print(f"[15 sweep] `{' '.join(exp_sweep_argv())}`: launches {launches['sweep']} | "
              f"{sw_s:.3f} s = {sw_vc / sw_s:.1f} vehicle-cycles/s ({sw_vc} cycles) | "
              + " | ".join(tests) + f" on {card}", flush=True)
        for a, v in sw_algo.items():
            print(f"[15 sweep {a}] {v['seconds']:.3f} s for {n_sig} sigmas x {EXP_SWEEP_RUNS} "
                  f"runs x {sw_cycles} cycles = {v['vehicle_cycles_per_s']:.1f} vehicle-cycles/s "
                  f"| launches {v['launches']}", flush=True)
        print("[15 sweep table]\n" + sweep.format_table(rows), flush=True)
        del calls, solves

    # the first cycles of (b) and (c) against the same loops on the plain
    # versions (``route.plain()``), with the draws the commands
    # drew: by hold_loop's rule where the planner goes through a kernel or
    # reads K4's map, bit for bit where it reads neither
    town32 = sweep.synthetic_town_prior(torch.float32, dev)
    town64 = (town32[0].double(), type(town32[1])(*(t.double() for t in town32[1])))
    sc = scenarios.get_scenario("gauntlet")
    plan_np = scenarios.plan_for("gauntlet")

    def world(dtype):
        plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype, device=dev)
        return (town32 if dtype == torch.float32 else town64), plan, n

    def captured(fn):
        out = []
        with steps_recorded(runner, out):
            fn()
        return out

    def compare_loop(algo):
        nrb = runner.nrb_params_for_scenario(p, sc) if algo == "nrb_rrt" else None

        def run(x0s, draws, dtype, use_kernels):
            (gm, gg), plan, n = world(dtype)
            ob, obs_xyyaw, obs_size, obs_mask = runner.build_scenario_inputs(p, sc, dtype, dev)
            return captured(lambda: plant.closed_loop_full_stack_batched(
                p, cp, noise, gm, gg, plan, n, x0s, None, draws.shape[0], obstacles=ob,
                obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
                use_kernels=use_kernels, noise_draws=draws,
                plan_step_batched=runner.make_plan_step(algo, p, noise, plan, n, obstacles=ob,
                                                        nrb_params=nrb)))
        return run

    p_sw = dataclasses.replace(p, w_uncertainty=5.0)  # the sweep's default
    s_hi = max(EXP_SIGMAS)
    ratio = 0.017 / 0.16
    cp_max = sweep.matched_costmap_params(cp, s_hi, s_hi * ratio)
    band = sweep.sweep_band_plan(cp_max, *world(torch.float32)[1:])
    # the oracle build's one window must reach as far as the widest band:
    # the sweep's window (sized at the default map centre) is narrower than
    # the bands sized over the route's corridor centres
    cp_oracle = dataclasses.replace(cp_max, window_radius=max(R for (_, _, R) in band.bands))

    def sweep_loop(algo):
        def run(x0s, draws, dtype, use_kernels):
            (gm, gg), plan, n = world(dtype)
            return captured(lambda: sweep.run_cell(
                algo, p_sw, cp_max if use_kernels else cp_oracle, sc, plan, n, x0s, draws, s_hi,
                s_hi * ratio, gm, gg, use_kernels, band))
        return run

    x0 = torch.tensor(sc.start, dtype=torch.float32, device=dev)
    for label, runs_, cycles, loop, algos_ in (
            ("compare", EXP_COMPARE_RUNS, cmp_cycles, compare_loop, runner.ALGORITHMS),
            (f"sweep sigma {s_hi}", EXP_SWEEP_RUNS, sw_cycles, sweep_loop,
             sweep.SWEEP_ALGORITHMS)):
        # the commands' block: runner.noise_block from seed 0 on the card
        block = runner.noise_block((cycles, runs_, 3), seed=0, device=dev)
        x0s = x0.expand(runs_, 4).contiguous()
        for algo in algos_:
            slow = loop is sweep_loop and algo in EXP_SWEEP_SLOW_HELD
            held = EXP_SWEEP_SLOW_HELD_CYCLES if slow else EXP_LANE_CYCLES
            draws = block[:held]
            head = (f"[15 lanes] {label} (gauntlet) {algo}, {runs_} lanes, first {held} cycles "
                    "vs the loop on the plain versions")
            if algo in EXP_EXACT:
                t0 = time.perf_counter()
                zero_counts()
                got = loop(algo)(x0s, draws, torch.float32, True)
                torch.cuda.synchronize()
                got_launches = read_counts()
                with route.plain():
                    want = loop(algo)(x0s, draws, torch.float32, True)
                require(read_counts() == got_launches, f"{label} {algo}: a plain-version loop "
                        "launched a kernel")
                same = lambda a, b: len(a) == len(b) == held and all(
                    torch.equal(g, w) for gc, wc in zip(a, b) for g, w in zip(gc, wc))
                require(same(got, want), f"{label} {algo}: the planner's results differ from "
                        "the loop on the plain versions")
                eager = ""
                if algo == "nrb_rrt":
                    # the planner replays a CUDA graph: the loop run eagerly
                    nrb_rrt.GRAPHS = False
                    try:
                        require(same(got, loop(algo)(x0s, draws, torch.float32, True)),
                                f"{label} nrb_rrt: the graph's results differ from the eager run")
                    finally:
                        nrb_rrt.GRAPHS = True
                    eager = ", and to the loop run eagerly (no CUDA graph)"
                print(f"{head}: launches {got_launches} || every cycle's X, U, iterations, J and "
                      f"lamb equal bit for bit (the planner reads no kernel's output"
                      f"{' but K4' if algo == 'frenet_propagation' else ''}){eager} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                continue
            got_launches, _, line = hold_loop(f"{label} {algo}", loop(algo), x0s, draws,
                                              (zero_counts, read_counts))
            print(f"{head}: launches {got_launches} || {line}", flush=True)

    # K5 on the synthetic town (1506 x 1506 cells at 0.2 m, unknown cells at
    # 100): exact against its plain version at frames along the `long` route
    # and pushed off it, partly and wholly outside the map
    gm, gg = town32
    rng = np.random.default_rng(21)
    town_route = scenarios.town02_loop_plan()
    lp, nl = rp.pad_global_plan(p, town_route, device=dev)
    push = rng.choice([0.0, 60.0, 120.0, 250.0], (K5_TOWN_B, 2)) * rng.choice([-1.0, 1.0],
                                                                              (K5_TOWN_B, 2))
    xy = torch.tensor(town_route[rng.integers(0, len(town_route), K5_TOWN_B)] + push,
                      dtype=torch.float32, device=dev)
    yaw = torch.tensor(rng.uniform(-math.pi, math.pi, K5_TOWN_B), dtype=torch.float32, device=dev)
    center, _, _ = costmap_mod.corridor_geometry(cp, lp, nl, xy, yaw)
    geoms = costmap_mod.vehicle_geom(cp, center)
    bbox = torch.tensor(rng.choice([0.0, 50.0, 90.0, 95.0, 100.0], (K5_TOWN_B, cp.rows, cp.cols),
                                   p=[0.7, 0.1, 0.05, 0.05, 0.1]), dtype=torch.float32, device=dev)
    lo, hi = gg.center - 0.5 * gg.length, gg.center + 0.5 * gg.length
    outside = int((((xy < lo) | (xy > hi)).any(dim=1)).sum())
    got = sample_cuda.sample_prior_batched(geoms, cp.rows, cp.cols, gm, gg, xy, yaw)
    want = sample_cuda.sample_prior_batched_plain(geoms, cp.rows, cp.cols, gm, gg, xy, yaw)
    require(torch.equal(got, want), "K5 on the synthetic town: the resample differs from the "
            "plain version")
    got_v = sample_cuda.vehicle_map_batched(geoms, cp.rows, cp.cols, gm, gg, xy, yaw, bbox)
    want_v = sample_cuda.vehicle_map_batched_plain(geoms, cp.rows, cp.cols, gm, gg, xy, yaw, bbox)
    require(torch.equal(got_v, want_v), "K5 on the synthetic town: the vehicle map differs from "
            "the plain version")
    unknown = float((got == 100.0).double().mean())
    print(f"[15 K5 town] {tuple(gm.shape)} map at {float(gg.resolution):.1f} m, B={K5_TOWN_B} "
          f"frames along the long route, {outside} with the ego off the map: resample and vehicle "
          f"map equal to the plain versions on every cell | {100 * unknown:.1f}% of the cells "
          "read occupied or unknown (100)", flush=True)
    del got, want, got_v, want_v, bbox

    # where the time goes: 3 cycles of each command's loops (the maps made
    # beforehand), per algorithm: device time by kernel against the call's
    # time, and the device's idle share
    cm_kw = dict(costmap_params=cp, global_map=gm, global_geom=gg, device=dev)
    succ = scenarios.get_scenario("success1")
    profiles = [("run", lambda: runner.run_experiment(
        p, noise, scenarios.plan_for("success1"), np.array(succ.start), EXP_PROFILE_CYCLES,
        scenario=succ, **cm_kw), {"K1": "lm_opt_kernel", "K4": "propagate_kernel"}, None)]
    for a in runner.ALGORITHMS:
        profiles.append((f"compare {a}", lambda a=a: [runner.run_experiment_batch(
            p, noise, scenarios.plan_for(name), np.array(scenarios.get_scenario(name).start),
            EXP_PROFILE_CYCLES, scenarios.get_scenario(name), n_runs=EXP_COMPARE_RUNS,
            algorithm=a, **cm_kw) for name in EXP_SCENARIOS],
            {**EXP_BUILD_KERNELS, **EXP_PLANNER_KERNELS.get(a, {})},
            "uncertainty_sample_batched" if a == "cilqr" else None))
    for a in sweep.SWEEP_ALGORITHMS:
        profiles.append((f"sweep {a}", lambda a=a: sweep.run_sigma_sweep(
            list(EXP_SIGMAS), (a,), p=p_sw, n_runs=EXP_SWEEP_RUNS, n_cycles=EXP_PROFILE_CYCLES,
            global_map=gm, global_geom=gg, device=dev),
            {**(EXP_BUILD_KERNELS if a in sweep.MAP_CONSUMERS else {}),
             **EXP_PLANNER_KERNELS.get(a, {})},
            "uncertainty_sample_batched" if a == "cilqr" else None))
    for label, fn, kern, ann in profiles:
        print(f"[15 profile] {label}, {EXP_PROFILE_CYCLES} cycles: "
              + profile_lines(fn, reps=1, kernels=kern, annotation=ann), flush=True)
    print(f"[15 done] phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, {"compare": cmp_algo, "sweep": sw_algo}


# Phase 16, the scale-out layer and the parallel-prefix Riccati option
SO_SHARDS = (1, 4)        # a mesh of cuda:0 alone and of 4 virtual shards of it
SO_FS_SHARDS = 4
SO_SEED = 16              # the sharded full stack's noise seed
SO_ROUNDS = 4             # campaign rounds (then 2 + a resume to 4)
PSCAN_CALLS = 5           # warm B=1 solves timed one by one, the median kept


def same_bits(a, b) -> bool:
    """Every field of two SolveResults equal bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def metric_excess(got, want, rtol: float) -> float:
    """Largest relative difference of two BatchMetrics, over rtol (> 1 fails)."""
    return max(abs(float(g) - float(w)) / (rtol * max(abs(float(w)), 1e-30))
               for g, w in zip(got, want))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scale_out(card: str, counts, dev: torch.device) -> dict:
    """Phase 16: the port's scale-out layer on the card, then the pscan
    option at B=1.  (a) a one-rank NCCL process group, so that every metric
    reduction below runs ``all_reduce`` on the card; (b) the sharded solve
    (K1 per shard) at the main path's size, on 1 and 4 shards, equal bit for
    bit to ``run_steps_batched(impl="mega")``; (c) the sharded Monte-Carlo
    (K4 and K3 per shard) at the phase-10 size, equal bit for bit to
    ``monte_carlo(impl="fast")``; (d) the sharded full stack (K5, K4, K3 per
    shard and cycle) at the phase-13 size on 4 shards against the 4
    per-chunk runs on the shards' generators; (e) the checkpointed campaign,
    resumed after 2 of 4 rounds; (f) ``dryrun_multichip(4)``; (g)
    ``backward_impl="pscan"`` against "seq" at B=1.  Every check raises.
    Returns the launches per sharded call by kernel."""
    from cilqr_tpu_torch import CostmapParams, NoiseParams, SolverParams
    from cilqr_tpu_torch.models import solver, solver_batched
    from cilqr_tpu_torch.ops import costmap as costmap_mod, gridmap, uncertainty_cuda
    from cilqr_tpu_torch.parallel import batch as pbatch, campaign, dryrun, multihost
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim import plant
    from cilqr_tpu_torch.sim.example_scenario import example_scenario

    zero_counts, read_counts = counts
    t_phase = time.perf_counter()
    p = dataclasses.replace(SolverParams(), horizon=HORIZON)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, device=dev)
    rng = np.random.default_rng(3)
    egos = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (MAIN_B, 4)),
                        dtype=torch.float32, device=dev)
    U0s = U0.expand(MAIN_B, HORIZON, 2).contiguous()
    out = {}

    def counted(fn):
        zero_counts()
        r = fn()
        torch.cuda.synchronize()
        return r, read_counts()

    # (b) without the group first: the reference of (a)
    ref, ref_c = counted(lambda: solver_batched.run_steps_batched(
        p, plan, n, egos, U0s, obstacles, unc, impl="mega"))
    ref_m = pbatch._metrics_local(p, ref)
    solve1, _ = pbatch.make_sharded_solver(p, pbatch.make_mesh([dev]), obstacles, unc, fused=True)
    (_, m_alone) = solve1(plan, n, egos, U0s)

    # (a) a one-rank NCCL process group on the card
    port = free_port()
    require(multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=dev),
            "multihost.initialize made no process group")
    try:
        import torch.distributed as dist

        require(dist.get_backend() == "nccl" and multihost.process_count() == 1,
                f"process group {dist.get_backend()} of {multihost.process_count()}")
        (_, m_group) = solve1(plan, n, egos, U0s)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(m_group, m_alone)),
                f"metrics under the group {multihost.gather_metrics(m_group)} differ from "
                f"{multihost.gather_metrics(m_alone)} without it")
        print(f"[16a process group] {dist.get_backend()}, 1 rank on {dev} (tcp://127.0.0.1:{port}): the sharded "
              f"solve's metrics under the group equal those without it bit for bit: "
              f"{multihost.gather_metrics(m_group)}", flush=True)

        # (b) the sharded solve, K1 per shard
        base_ms = cuda_ms(lambda: solver_batched.run_steps_batched(
            p, plan, n, egos, U0s, obstacles, unc, impl="mega"), 3)
        parts = [f"unsharded run_steps_batched(impl='mega') {base_ms:.3f} ms/call, launches {ref_c}"]
        out["solve"] = {}
        for shards in SO_SHARDS:
            fn, mesh = pbatch.make_sharded_solver(p, pbatch.make_mesh([dev] * shards), obstacles,
                                                  unc, fused=True)
            (res, m), c = counted(lambda: fn(plan, n, egos, U0s))
            require(c == {**ref_c, "lm": shards},
                    f"sharded solve on {shards} shards launched {c}, expected K1 {shards} times")
            require(same_bits(res, ref), f"sharded solve on {shards} shards differs from the "
                    f"unsharded call: " + ", ".join(f"{f} max |d| {float((a.double() - w.double()).abs().max()):.3e}"
                                                    for f, a, w in zip(res._fields, res, ref)))
            ex = metric_excess(m, ref_m, 1e-6)
            require(ex <= 1.0, f"sharded metrics on {shards} shards beyond 1e-6 relative: {ex:.3f}")
            ms = cuda_ms(lambda: fn(plan, n, egos, U0s), 3)
            out["solve"][shards] = c["lm"]
            parts.append(f"{shards} shard(s) {ms:.3f} ms/call, K1 {c['lm']} launches per call, "
                         f"equal bit for bit, metrics within {ex * 1e-6:.1e} relative")
        print(f"[16b sharded solve] fused, B={MAIN_B} N={HORIZON}: " + " | ".join(parts)
              + f" on {card}", flush=True)
        print(f"[16b profile] {SO_SHARDS[-1]} shards: " + profile_line(
            lambda: fn(plan, n, egos, U0s), reps=2, kernels={"K1": "lm_opt"}), flush=True)
        del egos, U0s, ref, res

        # (c) the sharded Monte-Carlo: K4 once and K3 per LM iteration per shard
        cp = CostmapParams()
        center = (cp.x_position, cp.y_position)
        cpw = mc.ensure_window_covers(cp, cp.rows, cp.cols, center, SIGMA_HI)
        band_plan = uncertainty_cuda.make_band_plan(cpw, cp.rows, cp.cols, center, SIGMA_HI)
        prior = torch.tensor(np.random.default_rng(4).uniform(0.0, 100.0, (cp.rows, cp.cols)),
                             dtype=torch.float32, device=dev)
        geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols, torch.float32, dev)
        world = (prior, geom, ego[:2], ego[3], plan, n)
        samples = mc.sample_scenarios(torch.Generator().manual_seed(0), MC_B, ego.cpu(),
                                      sigma_hi=SIGMA_HI, device=dev)

        def mc_fast():
            return mc.monte_carlo(p, cpw, *world, samples, obstacles, sigma_hi=SIGMA_HI,
                                  impl="fast", band_plan=band_plan)

        mref, mref_c = counted(mc_fast)
        mref_m = pbatch._metrics_local(p, mref)
        base_ms = cuda_ms(mc_fast, 3)
        parts = [f"unsharded monte_carlo(impl='fast') {base_ms:.3f} ms/call, launches {mref_c}"]
        out["mc"] = {}
        for shards in SO_SHARDS:
            fn, _ = mc.make_sharded_monte_carlo(p, cp, pbatch.make_mesh([dev] * shards), obstacles,
                                                map_shape=(cp.rows, cp.cols), map_center=center,
                                                sigma_hi=SIGMA_HI, impl="fast")
            (res, m), c = counted(lambda: fn(*world, samples.sigmas, samples.egos))
            b = MC_B // shards
            k3 = sum(int(res.iterations[i * b:(i + 1) * b].max()) for i in range(shards))
            require(c == {"costmap": 0, "sample": 0, "uncertainty": shards, "lm_iter": k3,
                          "lm": 0, "riccati": 0, "cost": 0},
                    f"sharded MC on {shards} shards launched {c}, expected K4 {shards}, K3 {k3}")
            require(same_bits(res, mref), f"sharded MC on {shards} shards differs from the "
                    f"unsharded call: " + ", ".join(f"{f} max |d| {float((a.double() - w.double()).abs().max()):.3e}"
                                                    for f, a, w in zip(res._fields, res, mref)))
            ex = metric_excess(m, mref_m, 1e-6)
            require(ex <= 1.0, f"sharded MC metrics on {shards} shards beyond 1e-6 relative: {ex:.3f}")
            ms = cuda_ms(lambda: fn(*world, samples.sigmas, samples.egos), 3)
            out["mc"][shards] = {"uncertainty": c["uncertainty"], "lm_iter": c["lm_iter"]}
            parts.append(f"{shards} shard(s) {ms:.3f} ms/call, launches K4 {c['uncertainty']} K3 "
                         f"{c['lm_iter']} per call, equal bit for bit, metrics within "
                         f"{ex * 1e-6:.1e} relative")
        print(f"[16c sharded MC] B={MC_B} N={HORIZON}, {len(band_plan.bands)} bands: "
              + " | ".join(parts) + f" on {card}", flush=True)
        del mref, res

        # (d) the sharded full stack on 4 shards against the per-chunk runs
        cpf = CostmapParams()
        ggeom = gridmap.make_geom([110.0, -300.0], 0.5, 256, 256, torch.float32, dev)
        gmap = torch.tensor(np.random.default_rng(8).uniform(0.0, 100.0, (256, 256)),
                            dtype=torch.float32, device=dev)
        obs = dict(obstacles=obstacles,
                   obs_xyyaw=torch.tensor([[115.0, -305.0, 0.0], [130.0, -304.0, 0.2]], device=dev),
                   obs_size=torch.tensor([3.63, 1.84], device=dev),
                   obs_mask=torch.ones(2, device=dev))
        xr, yr = costmap_mod.corridor_center_bounds(cpf, plan, n)
        fs_band = uncertainty_cuda.make_band_plan_bounds(
            cpf, cpf.rows, cpf.cols, xr, yr, (cpf.sigma_x, cpf.sigma_y, cpf.sigma_theta))
        x0s = torch.tensor(ego.cpu().numpy()[None, :]
                           + np.random.default_rng(9).normal(0, 0.3, (FS_B, 4)),
                           dtype=torch.float32, device=dev)
        fs_fn, _ = pbatch.make_sharded_full_stack(p, cpf, pbatch.make_mesh([dev] * SO_FS_SHARDS),
                                                  FS_CYCLES, band_plan=fs_band, global_res=0.5,
                                                  **obs)
        (xf, rec, summary), c = counted(lambda: fs_fn(gmap, ggeom, plan, n, x0s, SO_SEED))
        b = FS_B // SO_FS_SHARDS
        k3 = sum(int(v) for i in range(SO_FS_SHARDS)
                 for v in rec["iterations"][:, i * b:(i + 1) * b].amax(dim=1))
        require(c == {"costmap": SO_FS_SHARDS * FS_CYCLES, "sample": SO_FS_SHARDS * FS_CYCLES,
                      "uncertainty": SO_FS_SHARDS * FS_CYCLES, "lm_iter": k3, "lm": 0,
                      "riccati": 0, "cost": 0},
                f"sharded full stack launched {c}, expected the costmap layers kernel, K5 and "
                f"K4 {SO_FS_SHARDS * FS_CYCLES}, "
                f"K3 {k3}")
        require(bool(torch.isfinite(xf).all()) and tuple(rec["J"].shape) == (FS_CYCLES, FS_B),
                "sharded full stack: non-finite states or record shape")

        def per_chunk():
            return [plant.closed_loop_full_stack_batched(
                p, cpf, NoiseParams(), gmap, ggeom, plan, n, x0s[i * b:(i + 1) * b],
                pbatch.shard_generator(SO_SEED, i, dev), FS_CYCLES, band_plan=fs_band,
                global_res=0.5, **obs) for i in range(SO_FS_SHARDS)]

        chunks = per_chunk()
        xf_ref = torch.cat([x for x, _ in chunks])
        j_sum = sum(float(r["J"][-1].double().sum()) for _, r in chunks)
        col_sum = sum(float(r["collided"].any(dim=0).double().sum()) for _, r in chunks)
        fs_diff = float((xf - xf_ref).abs().max())
        require(fs_diff <= 1e-5, f"sharded full stack vs the per-chunk runs: max |d| {fs_diff:.3e}")
        mean_J, col = float(summary[0]), float(summary[1])
        require(abs(mean_J - j_sum / FS_B) <= 1e-4 * max(1.0, abs(j_sum / FS_B))
                and abs(col - col_sum / FS_B) <= 1e-6,
                f"sharded full-stack summary ({mean_J}, {col}) vs ({j_sum / FS_B}, {col_sum / FS_B})")
        fs_ms = cuda_ms(lambda: fs_fn(gmap, ggeom, plan, n, x0s, SO_SEED), 1)
        chunk_ms = cuda_ms(per_chunk, 1)
        out["full_stack"] = {"sample": c["sample"], "uncertainty": c["uncertainty"],
                             "lm_iter": c["lm_iter"], "costmap": c["costmap"]}
        print(f"[16d sharded full stack] B={FS_B} N={HORIZON} {FS_CYCLES} cycles, random map, "
              f"{SO_FS_SHARDS} shards: {fs_ms:.3f} ms/call ({FS_CYCLES * FS_B / fs_ms * 1e3:.0f} "
              f"cycles/s), the 4 per-chunk runs {chunk_ms:.3f} ms | launches {c} per call | final "
              f"states vs the per-chunk runs max |d| {fs_diff:.1e} | summary mean_J {mean_J:.6g} "
              f"(per-chunk {j_sum / FS_B:.6g}), collision share {col:.6g} on {card}", flush=True)
        del xf, rec, chunks, xf_ref, gmap, x0s

        # (e) the campaign on the (c) world, one shard: 4 rounds, then 2 + a
        # resume to 4
        with tempfile.TemporaryDirectory() as tmp:
            run = lambda name, rounds, resume: campaign.run_campaign(
                p, cp, pbatch.make_mesh([dev]), prior, geom, ego[:2], ego[3], plan, n, ego.cpu(),
                n_rounds=rounds, batch=MC_B, out_dir=f"{tmp}/{name}", seed=7, obstacles=obstacles,
                resume=resume)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = run("full", SO_ROUNDS, False)
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3 / SO_ROUNDS
            run("int", SO_ROUNDS // 2, False)
            resumed = run("int", SO_ROUNDS, True)
            merged = campaign.merge_analysis(f"{tmp}/int")
        require(resumed["rounds"] == full["rounds"] == SO_ROUNDS
                and resumed["solves"] == full["solves"] == SO_ROUNDS * MC_B,
                f"campaign rounds/solves {resumed} vs {full}")
        for k in ("mean_J", "max_J", "mean_iterations", "converged_frac"):
            require(abs(resumed[k] - full[k]) <= 1e-6 * abs(full[k]),
                    f"campaign {k}: resumed {resumed[k]} vs uninterrupted {full[k]}")
        require(merged["rounds"] == SO_ROUNDS and merged["solves"] == SO_ROUNDS * MC_B
                and sorted(r["round"] for r in merged["rows"]) == list(range(SO_ROUNDS)),
                f"merge_analysis counted {merged['rounds']} rounds, {merged['solves']} solves")
        print(f"[16e campaign] {SO_ROUNDS} rounds of B={MC_B} on the (c) world: {round_ms:.3f} "
              f"ms/round (wall clock: the draws on the host, the sharded MC, the log and the "
              f"checkpoint) | resumed after {SO_ROUNDS // 2} = uninterrupted: "
              + ", ".join(f"{k} {full[k]:.6g}" for k in ("mean_J", "max_J", "mean_iterations",
                                                          "converged_frac"))
              + f" | merge_analysis: {merged['rounds']} rounds, {merged['solves']} solves on {card}",
              flush=True)
        del samples, prior
    finally:
        multihost.shutdown()

    # (f) the dry run on 4 virtual shards of the card
    t0 = time.perf_counter()
    dr = dryrun.dryrun_multichip(4, device=dev)
    require(dr["fs_max_abs_diff_vs_unsharded"] <= 1e-5, f"dryrun: {dr}")
    print(f"[16f dryrun] dryrun_multichip(4, device='{dev}') in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # (g) backward_impl="pscan" against "seq" at B=1 on the serving world
    pp = dataclasses.replace(p, backward_impl="pscan")
    def median_ms(params):
        # each warm call timed alone (timed's warm-up call before each)
        runs = [timed(lambda: solver.run_step(params, plan, n, ego, U0, obstacles, unc), 1)
                for _ in range(PSCAN_CALLS)]
        return statistics.median(ms for ms, _ in runs), runs[-1][1]

    ms_seq, r_seq = median_ms(p)
    ms_ps, r_ps = median_ms(pp)
    du = float((r_ps.U - r_seq.U).abs().max())
    x_err, x_excess = max_excess(r_ps.X, r_seq.X, rtol=5e-2, atol=5e-2)
    dJ = abs(float(r_ps.J) - float(r_seq.J))
    # the bars of tests/test_riccati_pscan.py::test_full_solve_with_pscan_backward
    require(bool(torch.isfinite(r_ps.X).all()) and int(r_ps.iterations) <= p.max_iterations
            and x_excess <= 0.0 and dJ < 5e-2 * max(1.0, float(r_seq.J)),
            f"pscan solve: iterations {int(r_ps.iterations)}, max |dX| {x_err:.3e}, |dJ| {dJ:.3e}")
    print(f"[16g pscan B=1] N={HORIZON}, solver.run_step, median of {PSCAN_CALLS} warm calls: "
          f"seq {ms_seq:.3f} ms ({int(r_seq.iterations)} LM iterations), pscan {ms_ps:.3f} ms "
          f"({int(r_ps.iterations)} LM iterations) | max |U_pscan - U_seq| {du:.3e}, max |dX| "
          f"{x_err:.3e}, J {float(r_ps.J):.6g} vs {float(r_seq.J):.6g} on {card}", flush=True)
    out["pscan"] = {"seq_ms": ms_seq, "pscan_ms": ms_ps}
    print(f"[16 done] phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# Phase 17, the benchmark driver (cilqr_tpu_torch.benchmark) at its defaults
BENCH_FIELDS = ("metric", "value", "value_spread", "unit", "path", "batch", "batched_step_ms",
                "device_p99_single_solve_ms", "p99_under_budget", "device_single_solve_ms",
                "device_single_solve_ms_pscan", "device_single_solve_ms_mega_b1",
                "mean_lm_iterations", "mega_pct_of_sol", "mega_sol_binding_resource", "device",
                "peak_memory_gb", "mc_scenarios_per_sec", "mc_scenarios_per_sec_spread",
                "mc_window_radius", "full_stack_cycles_per_sec",
                "full_stack_cycles_per_sec_spread", "closed_loop_cycles_per_sec",
                "closed_loop_cycles_per_sec_spread")
BENCH_MEAN_IT_OFF = 0.15  # two draws of B=32768 egos: each mean's standard error ~0.02


@contextlib.contextmanager
def bench_env(**knobs):
    """Inside: the BENCH_* environment holds ``knobs`` alone, every other
    knob at the benchmark's default."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in knobs.items()})
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


@contextlib.contextmanager
def outermost_calls(entries, read_counts, store: list):
    """Inside: every call of ``module.name``, for (module, name, keep) in
    entries, that no other of these calls encloses appends (name, the kernel
    launches it made, keep(its arguments, its result)) to store.  Nothing
    is synchronised: a wrapper counts its launch on the host as it launches."""
    depth = [0]
    saved = []
    for module, name, keep in entries:
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def wrapped(*args, _fn=fn, _name=name, _keep=keep, **kw):
            if depth[0]:
                return _fn(*args, **kw)
            before = read_counts()
            depth[0] += 1
            try:
                out = _fn(*args, **kw)
            finally:
                depth[0] -= 1
            after = read_counts()
            store.append((_name, {k: after[k] - before[k] for k in after}, _keep(args, out)))
            return out

        setattr(module, name, wrapped)
    try:
        yield store
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def bench_sections(calls: list, B: int) -> dict:
    """{section: (calls, launches by kernel)} of the benchmark's calls, each
    call held to the launches its section implies: a batched solve K1 once
    (the main path at B, the serving path at B=1); the unfused single solve
    none; a Monte-Carlo call K4 once and K3 once per LM iteration of its
    slowest lane; a full-stack call the costmap layers kernel, K5 and K4
    once per cycle and K3 once per
    LM iteration of each cycle's slowest lane; a closed-loop call K1 once
    per cycle."""
    from cilqr_tpu_torch import benchmark

    zero = {"costmap": 0, "sample": 0, "uncertainty": 0, "lm_iter": 0, "lm": 0, "riccati": 0,
            "cost": 0}
    sections = {}
    for name, got, kept in calls:
        if name == "run_steps_batched":
            section = {B: "main_path", 1: "mega_b1"}.get(kept, f"run_steps_batched at B={kept}")
            want = dict(zero, lm=1)
        elif name == "run_step":
            section, want = "single_solve", dict(zero)
        elif name == "monte_carlo":
            section, want = "mc", dict(zero, uncertainty=1, lm_iter=int(kept))
        elif name == "closed_loop_full_stack_batched":
            section, want = "full_stack", dict(zero, costmap=benchmark.FS_CYCLES,
                                               sample=benchmark.FS_CYCLES,
                                               uncertainty=benchmark.FS_CYCLES, lm_iter=int(kept))
        else:
            section, want = "closed_loop", dict(zero, lm=benchmark.CL_CYCLES)
        require(got == want, f"bench {section}: a call launched {got}, expected {want}")
        n, total = sections.get(section, (0, dict(zero)))
        sections[section] = (n + 1, {k: total[k] + got[k] for k in zero})
    return sections


def bench_run(dev: torch.device, counts, **knobs) -> tuple:
    """(the benchmark's JSON line, its sections (``bench_sections``), its
    seconds) of one in-process ``python -m cilqr_tpu_torch bench`` with
    ``knobs``; every launch it makes is one of its sections'."""
    from cilqr_tpu_torch import benchmark
    from cilqr_tpu_torch.models import solver, solver_batched
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim import plant

    zero_counts, read_counts = counts
    entries = [(solver, "run_step", lambda a, out: None),
               (solver_batched, "run_steps_batched", lambda a, out: a[3].shape[0]),
               (mc, "monte_carlo", lambda a, out: out.iterations.max()),
               (plant, "closed_loop_full_stack_batched",
                lambda a, out: out[1]["iterations"].amax(dim=1).sum()),
               (plant, "closed_loop_batched", lambda a, out: None)]
    calls = []
    with bench_env(**knobs), outermost_calls(entries, read_counts, calls):
        # the knobs as the benchmark reads them, with its defaults
        B, iters, passes = (int(os.environ.get(k, d)) for k, d in (
            ("BENCH_BATCH", "32768"), ("BENCH_ITERS", "10"), ("BENCH_PASSES", "5")))
        zero_counts()
        seconds, out = cli_call(["bench"], dev)
        totals = read_counts()
    lines = out.strip().splitlines()
    require(len(lines) == 1, f"bench printed {len(lines)} lines, expected one JSON line: {out[:2000]}")
    line = json.loads(lines[0])
    sections = bench_sections(calls, B)
    summed = {k: sum(l[k] for _, l in sections.values()) for k in totals}
    require(summed == totals, f"bench: launches {totals}, its calls' {summed}")
    W = benchmark.WARM_CALLS
    want_calls = {"single_solve": 2 * W + benchmark.SINGLE_REPS + benchmark.PSCAN_REPS,
                  "mega_b1": W + benchmark.MEGA_B1_REPS, "main_path": 1 + passes * iters}
    got_calls = {k: n for k, (n, _) in sections.items()}
    require(all(got_calls.get(k) == n for k, n in want_calls.items()),
            f"bench calls per section {got_calls}, expected {want_calls}")
    return line, sections, seconds


def finite_field(v) -> bool:
    """A JSON value with no NaN, infinity, null or empty string in it."""
    if isinstance(v, (bool, str)):
        return v != ""
    if isinstance(v, (int, float)):
        return math.isfinite(v)
    if isinstance(v, list):
        return len(v) > 0 and all(finite_field(x) for x in v)
    if isinstance(v, dict):
        return len(v) > 0 and all(finite_field(x) for x in v.values())
    return False


def benchmark_phase(card: str, counts, dev: torch.device, main_mean_it: float) -> tuple:
    """17. ``python -m cilqr_tpu_torch bench`` in process with the default
    knobs: the line holds every field, each finite; each call launched what
    its section implies and nothing launched outside them; its mean LM
    iterations (off its last ego batch, another draw of phase 5's
    distribution) within BENCH_MEAN_IT_OFF of phase 5's.  Then the headline
    alone with ``BENCH_TRACE``: the trace names K1.  Returns (the launches
    by section and kernel, the JSON line)."""
    from cilqr_tpu_torch.models import solver

    t_phase = time.perf_counter()
    solver.CAPTURED.clear()  # the peaks below hold the benchmark's own graphs only
    line, sections, seconds = bench_run(dev, counts)
    missing = [k for k in BENCH_FIELDS if k not in line]
    require(not missing, f"bench line lacks {missing}")
    bad = [k for k in BENCH_FIELDS if not finite_field(line[k])]
    require(not bad, f"bench fields not finite: {[(k, line[k]) for k in bad]}")
    require(set(sections) == {"single_solve", "mega_b1", "main_path", "mc", "full_stack",
                              "closed_loop"}, f"bench sections {sorted(sections)}")
    require(line["batch"] == MAIN_B and line["path"] == "mega" and line["device"] == card,
            f"bench: batch {line['batch']}, path {line['path']}, device {line['device']}")
    require(abs(line["mean_lm_iterations"] - main_mean_it) <= BENCH_MEAN_IT_OFF,
            f"bench mean LM iterations {line['mean_lm_iterations']}, phase 5 {main_mean_it:.3f}")
    print(f"[17 bench] {card} | " + json.dumps(line), flush=True)
    print(f"[17 bench] {seconds:.1f} s | calls and launches by section: "
          + " | ".join(f"{k}: {n} calls, " + ", ".join(f"{kk} {v}" for kk, v in l.items() if v)
                       for k, (n, l) in sections.items())
          + f" | mean LM iterations {line['mean_lm_iterations']} (phase 5 {main_mean_it:.2f})",
          flush=True)
    print(f"[17 bench budget] p99_under_budget {line['p99_under_budget']}: single solve median "
          f"{line['device_single_solve_ms']} ms, p99 {line['device_p99_single_solve_ms']} ms "
          f"(budget 100 ms), pscan {line['device_single_solve_ms_pscan']} ms, the fused "
          f"kernel at B=1 {line['device_single_solve_ms_mega_b1']} ms on {card}", flush=True)

    with tempfile.TemporaryDirectory() as trace_dir:
        _, trace_sections, trace_s = bench_run(
            dev, counts, BENCH_TRACE=trace_dir, BENCH_MC=0, BENCH_FULL_STACK=0,
            BENCH_CLOSED_LOOP=0, BENCH_PASSES=1)
        files = sorted(pathlib.Path(trace_dir).rglob("*.json"))
        require(len(files) == 1, f"BENCH_TRACE wrote {[f.name for f in files]}")
        events = json.loads(files[0].read_text())["traceEvents"]
        k1_events = sum("lm_opt" in str(e.get("name", "")) for e in events)
        require(k1_events > 0, f"the trace's {len(events)} events name no lm_opt")
        trace_mb = files[0].stat().st_size / 1e6
    print(f"[17 bench trace] BENCH_TRACE, headline alone, one pass: {trace_s:.1f} s, "
          f"{len(events)} events in {trace_mb:.1f} MB, {k1_events} name lm_opt "
          f"(K1 launches {trace_sections['main_path'][1]['lm']} on the main path)", flush=True)
    print(f"[17 done] phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {section: l for section, (_, l) in sections.items()}, line


# The graphed LM loops three ways (phases 18, 20, 21): on the device loop
# (one launch of the loop graph: the condition evaluated on the card), as
# host-polled step replays (the done mask read after each), and eagerly
LOOP_MODES = {"graphed": (True, True), "host-polled": (True, False), "eager": (False, True)}


@contextlib.contextmanager
def loop_mode(mode: str):
    """Inside: ``solver.GRAPHS`` and ``solver.DEVICE_LOOP`` as ``mode`` of
    LOOP_MODES says."""
    from cilqr_tpu_torch.models import solver

    saved = solver.GRAPHS, solver.DEVICE_LOOP
    solver.GRAPHS, solver.DEVICE_LOOP = LOOP_MODES[mode]
    try:
        yield
    finally:
        solver.GRAPHS, solver.DEVICE_LOOP = saved


@contextlib.contextmanager
def no_host_sync(held: list):
    """Inside: ``torch.cuda.set_sync_debug_mode("error")`` (a host read of
    a card tensor raises) and every ``graphs.Loop.count`` held back into
    ``held``: the device loops' one read, made afterwards by the caller."""
    from cilqr_tpu_torch.utils import graphs

    count = graphs.Loop.count
    graphs.Loop.count = lambda loop: held.append(loop)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield held
    finally:
        torch.cuda.set_sync_debug_mode(0)
        graphs.Loop.count = count


def loops_host_free(label: str) -> int:
    """Each captured LM loop of ``solver.CAPTURED`` (its inputs as the last
    call left them): the start replay and the loop launch under
    ``no_host_sync``, then the one read; each loop's steps must equal the
    largest iteration count its start state's solve reaches.  Returns the
    loops checked."""
    from cilqr_tpu_torch.models import solver

    entries = [g for g in solver.CAPTURED.values() if g.loop is not None]
    require(entries, f"{label}: no device loop captured")
    for g in entries:
        with no_host_sync([]):
            g.graphs[0].replay()
            g.loop.launch()
        require(g.loop.count() == int(g.out[0][4].max()),
                f"{label}: the loop's steps differ from the largest iteration count")
    return len(entries)


def loop_stats_line(entries) -> str:
    """Nodes and build seconds of the loop graphs of some captures."""
    stats = [g.loop.stats for g in entries if g.loop is not None]
    return ", ".join(f"{st.nodes} nodes built in {st.build_s:.3f} s (instantiate "
                     f"{st.instantiate_s:.3f} s)" for st in stats) or "none"


# The LM loop's condition on the card (ops/loop_cuda.py, csrc/loop.cu): the
# cases of its plain version's test at the loops' batch sizes
COND_BATCHES = (1, 7, 64, 1025, 4096, 8192, 32768)
COND_REPS = 200


def condition_kernel(card: str, dev: torch.device) -> dict:
    """``lm_continue_kernel`` against its plain version: every lane count of
    COND_BATCHES with every lane stopped, none, or all but one, at steps 0,
    max_iterations - 1 and max_iterations: v and the advanced steps equal
    exactly, one launch counted per call.  Times the wrapper and the plain
    version (CUDA events) at B=MC_B (the hybrid loop's lanes); the bound:
    the mask read once and the count read and written, B operations.
    Returns the kernel's entry of the ``kernels`` line."""
    from cilqr_tpu_torch import SolverParams
    from cilqr_tpu_torch.ops import loop_cuda

    M = SolverParams().max_iterations
    cases = 0
    for B in COND_BATCHES:
        for kind in ("all", "none", "one"):
            done = torch.full((B,), kind != "none", dtype=torch.bool, device=dev)
            if kind == "one":
                done[B // 2] = False
            for s in (0, M - 1, M):
                steps = torch.tensor([s], dtype=torch.int32, device=dev)
                plain_steps = steps.clone()
                before = loop_cuda.LAUNCHES
                v = loop_cuda.lm_continue(done, steps, M)
                want = loop_cuda.lm_continue_plain(done, plain_steps, M)
                torch.cuda.synchronize()
                require(loop_cuda.LAUNCHES == before + 1, "lm_continue launch counter did not move")
                require(torch.equal(v, want) and torch.equal(steps, plain_steps),
                        f"lm_continue B={B} {kind} steps={s}: kernel {int(v)}, {int(steps)}; "
                        f"plain {int(want)}, {int(plain_steps)}")
                cases += 1
    done = torch.zeros(MC_B, dtype=torch.bool, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: loop_cuda.lm_continue(done, steps, M), COND_REPS)
    plain_ms = cuda_ms(lambda: loop_cuda.lm_continue_plain(done, steps, M), COND_REPS)
    b = bound(nbytes(done) + 2 * nbytes(steps), float(done.numel()))
    print(f"[2 lm_continue] the LM loop's condition: {cases} cases (B in {list(COND_BATCHES)}; "
          f"all, none, all but one lane stopped; steps 0, {M - 1}, {M}) equal to the plain "
          f"version exactly | B={MC_B}: wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b['bound_ms']:.6f} ms by {b['bound_by']} (CUDA events, {COND_REPS} calls) on {card}",
          flush=True)
    return dict(name="lm_continue", route="cuda", source="cilqr_tpu_torch/csrc/loop.cu",
                replaces="none: the cond of jax.lax.while_loop (cilqr_tpu/models/solver.py:167, "
                         "cilqr_tpu/models/solver_batched.py:75), which XLA evaluates on the chip",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **b, library_ms=NO_LIBRARY_CALL,
                launches=0, cases=cases, timed=f"B={MC_B}")


# Phase 18, the plain LM loop as CUDA graphs (models/solver.py, GRAPHS)
GRAPH_BATCHES = (1, 64)   # the unbatched solve the benchmark times, and a batch
GRAPH_CALLS = 6           # graphed calls on new egos after the capture
GRAPH_EAGER_CALLS = 2     # of them also solved eagerly, bit for bit
GRAPH_REPLAYS = 50


def device_kernels(fn) -> tuple:
    """(device kernels and copies, their device ms) of one fn() by
    ``torch.profiler``, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3


def graph_phase(card: str, counts, dev: torch.device) -> dict:
    """18. ``solver.run_step`` on the plain LM loop, replayed as CUDA graphs
    (``solver.GRAPHS``; the plan fit in the start graph) against the eager
    loop, ``backward_impl`` "seq" and "pscan", unbatched (B=1, what the
    benchmark's single solve times) and at B=64, on the example world with
    its obstacles and uncertainty map, the graphs captured on
    ``solver.STREAMS`` streams and on one: every field of every graphed
    solve (on the device loop, ``solver.DEVICE_LOOP``) equal to the
    host-polled replay's and to the eager solve's bit for bit, the loop's
    steps equal to the largest iteration count; a call on new egos replays
    the captured graphs (no capture); no kernel of the port launched; the
    unbatched "seq" solve, up to the loop's one read of its steps, reads
    nothing on the host (``no_host_sync``).  Prints ms per solve graphed,
    host-polled and eager, the loop graph's nodes and build seconds; per
    capture (1 and ``solver.STREAMS`` streams) ms per replay of the step
    graph (in turns), device kernels per replay, the plan's longest chain
    and the bytes its pool took; kernels per eager step, LM iterations;
    then the worst case, B=1 "seq" with every lane running all
    ``max_iterations``, graphed and host-polled.  Returns the numbers by
    (impl, B)."""
    from cilqr_tpu_torch import SolverParams
    from cilqr_tpu_torch.models import solver
    from cilqr_tpu_torch.models.reference_path import get_local_plan
    from cilqr_tpu_torch.sim.example_scenario import example_scenario

    t_phase = time.perf_counter()
    zero_counts, read_counts = counts
    solver.CAPTURED.clear()  # phase 17 captured the same shapes: each case here captures anew
    p0 = dataclasses.replace(SolverParams(), horizon=HORIZON)
    plan, n, ego, U0, obstacles, unc = example_scenario(p0, device=dev)
    rng = np.random.default_rng(18)
    out = {}
    streams = solver.STREAMS

    def inputs(B: int):
        e = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (B, 4)),
                         dtype=torch.float32, device=dev)
        return (e[0], U0) if B == 1 else (e, U0.expand(B, HORIZON, 2).contiguous())

    def wall_ms(solve, mode: str, e, u) -> tuple:
        with loop_mode(mode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve(e, u)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, r

    def steps_of(key, r) -> None:
        loop = solver.CAPTURED[key].loop
        require(int(loop.steps) == int(r.iterations.max()),
                f"the device loop ran {int(loop.steps)} steps, iterations {r.iterations.max()}")

    try:
        for impl in ("seq", "pscan"):
            p = dataclasses.replace(p0, backward_impl=impl)
            solve = lambda e, u, p=p: solver.run_step(p, plan, n, e, u, obstacles, unc)
            for B in GRAPH_BATCHES:
                e, u = inputs(B)
                known = set(solver.CAPTURED)
                zero_counts()
                capture_ms, r_g = wall_ms(solve, "graphed", e, u)
                launches = read_counts()
                new_keys = [k for k in solver.CAPTURED if k not in known]
                require(len(new_keys) == 1, f"{impl} B={B}: {len(new_keys)} captures")
                require(not any(launches.values()),
                        f"{impl} B={B}: the plain solve launched {launches}")
                steps_of(new_keys[0], r_g)
                _, r_e = wall_ms(solve, "eager", e, u)
                require(same_bits(r_g, r_e), f"{impl} B={B}: graphed != eager at the capture")
                _, r_h = wall_ms(solve, "host-polled", e, u)
                require(same_bits(r_h, r_e), f"{impl} B={B}: host-polled != eager at the capture")
                loop_line = loop_stats_line([solver.CAPTURED[new_keys[0]]])
                graphed, host, eager, its = [], [], [], []
                for i in range(GRAPH_CALLS):
                    e, u = inputs(B)
                    held = dict(solver.CAPTURED)
                    ms, r_g = wall_ms(solve, "graphed", e, u)
                    steps_of(new_keys[0], r_g)
                    graphed.append(ms)
                    ms, r_h = wall_ms(solve, "host-polled", e, u)
                    require(same_bits(r_g, r_h), f"{impl} B={B}: graphed != host-polled, call {i}")
                    host.append(ms)
                    require(held.keys() == solver.CAPTURED.keys() and all(
                        solver.CAPTURED[k] is g for k, g in held.items()),
                        f"{impl} B={B}: a call on new egos captured again")
                    its.append(float(r_g.iterations.float().mean()))
                    if i < GRAPH_EAGER_CALLS:
                        ms, r_e = wall_ms(solve, "eager", e, u)
                        require(same_bits(r_g, r_e), f"{impl} B={B}: graphed != eager, call {i}")
                        eager.append(ms)
                host_free = ""
                if impl == "seq" and B == 1:
                    e, u = inputs(B)
                    held_loops: list = []
                    with no_host_sync(held_loops):
                        r_g = solve(e, u)
                    (loop,) = held_loops
                    require(loop.count() == int(r_g.iterations),
                            "the held-back read differs from the iterations")
                    _, r_e = wall_ms(solve, "eager", e, u)
                    require(same_bits(r_g, r_e), "the solve under no_host_sync != eager")
                    host_free = (" | the whole solve up to the loop's one read of its steps ran "
                                 "under torch.cuda.set_sync_debug_mode('error'): no host read")
                # the same solve captured on one stream, then both step graphs in turns
                solver.STREAMS, known = 1, set(solver.CAPTURED)
                _, r_1 = wall_ms(solve, "graphed", e, u)
                keys_1 = [k for k in solver.CAPTURED if k not in known]
                require(len(keys_1) == 1, f"{impl} B={B}: {len(keys_1)} captures on one stream")
                _, r_e = wall_ms(solve, "eager", e, u)
                require(same_bits(r_1, r_e), f"{impl} B={B}: one-stream graph != eager")
                solver.STREAMS = streams
                steps = {1: solver.CAPTURED[keys_1[0]].graphs[1],
                         streams: solver.CAPTURED[new_keys[0]].graphs[1]}
                turns = {1: [], streams: []}
                for k in (1, streams, streams, 1):
                    turns[k].append(cuda_ms(steps[k].replay, GRAPH_REPLAYS))
                per = {}
                for k, g in steps.items():
                    kernels, busy = device_kernels(g.replay)
                    st = g.stats
                    per[k] = dict(replay_ms=statistics.mean(turns[k]), replay_kernels=kernels,
                                  replay_busy_ms=busy, pool_bytes=g.pool_bytes,
                                  chain=st.plan_chain if st else None,
                                  dag_chain=st.dag_chain if st else None,
                                  ops=st.ops if st else None, waits=st.waits if st else 0)
                replay_ms, replay_kernels = per[streams]["replay_ms"], per[streams]["replay_kernels"]
                replay_busy = per[streams]["replay_busy_ms"]
                pl = get_local_plan(p, plan, n, e)
                state = solver.start_state(p, e, u)
                step = solver.plain_iteration(p, pl, obstacles, unc)
                lamb_inv = solver.damping_inverse(p, torch.float32, dev)
                step_kernels, step_busy = device_kernels(
                    lambda: solver.lm_step(p, step, lamb_inv, *state))
                row = dict(capture_ms=capture_ms, graphed_ms=statistics.median(graphed),
                           graphed_max_ms=max(graphed), host_ms=statistics.median(host),
                           host_max_ms=max(host), eager_ms=statistics.median(eager),
                           replay_ms=replay_ms, replay_kernels=replay_kernels,
                           replay_busy_ms=replay_busy, step_kernels=step_kernels,
                           step_busy_ms=step_busy, iterations=statistics.mean(its),
                           streams=per)
                out[(impl, B)] = row
                print(f"[18 graph {impl} B={B}] N={HORIZON}, solver.run_step, obstacles + map: "
                      f"graphed (device loop) = host-polled = eager bit for bit on "
                      f"{1 + GRAPH_EAGER_CALLS} ego draws, graphed = host-polled on "
                      f"{1 + GRAPH_CALLS}, the loop's steps = the largest iteration count on "
                      f"every call, {GRAPH_CALLS} calls on new egos replayed (no capture), "
                      f"launches {launches}{host_free} | per solve (host clock, synchronised): "
                      f"graphed median {row['graphed_ms']:.3f} ms (max "
                      f"{row['graphed_max_ms']:.3f}, first call with the capture "
                      f"{capture_ms:.3f}), host-polled median {row['host_ms']:.3f} ms (max "
                      f"{row['host_max_ms']:.3f}), eager median {row['eager_ms']:.3f} ms | loop "
                      f"graph: {loop_line} | step graph: {replay_ms:.4f} ms per replay (CUDA events, "
                      f"{GRAPH_REPLAYS} replays), {replay_kernels} device kernels per replay "
                      f"({replay_busy:.4f} ms busy); eager lm_step {step_kernels} kernels "
                      f"({step_busy:.4f} ms busy) | mean LM iterations {row['iterations']:.2f} "
                      f"on {card}", flush=True)
                ops = per[streams]["ops"]
                for k, v in per.items():
                    chain = v["chain"] if v["chain"] is not None else ops
                    print(f"[18 streams {impl} B={B}] {k} stream(s): {v['replay_ms']:.4f} ms per "
                          f"replay (turns {', '.join(f'{x:.4f}' for x in turns[k])}), "
                          f"{v['replay_kernels']} device kernels per replay "
                          f"({v['replay_busy_ms']:.4f} ms busy), plan's longest chain {chain} of "
                          f"{ops} ops (data's {per[streams]['dag_chain']}), {v['waits']} "
                          f"cross-stream waits, graph pool {v['pool_bytes']} bytes on {card}",
                          flush=True)
        out["worst"] = worst_case_solve(card, p0, plan, n, obstacles, unc, inputs)
    finally:
        solver.GRAPHS, solver.STREAMS = True, streams
    print(f"[18 done] phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def worst_case_solve(card: str, p0, plan, n, obstacles, unc, inputs) -> dict:
    """18, the worst case of the single solve: B=1 "seq" on the example
    world with ``tolerance=0`` and ``lamb_max`` out of reach, so that every
    solve runs all ``max_iterations``; on ``solver.STREAMS`` streams and on
    one, on the device loop and host-polled, each equal to eager bit for
    bit; ms per solve (host clock, synchronised, median and max of
    GRAPH_CALLS calls on new egos after the capturing call), the two ways
    in turns call by call."""
    from cilqr_tpu_torch.models import solver

    p = dataclasses.replace(p0, tolerance=0.0, lamb_max=1e30)
    streams = solver.STREAMS
    res = {}
    try:
        for k in (streams, 1):
            solver.STREAMS = k
            ms = {mode: [] for mode in ("graphed", "host-polled")}
            for i in range(GRAPH_CALLS + 1):
                e, u = inputs(1)
                for mode in (("graphed", "host-polled") if i % 2 else ("host-polled", "graphed")):
                    with loop_mode(mode):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        r = solver.run_step(p, plan, n, e, u, obstacles, unc)
                        torch.cuda.synchronize()
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
                    require(int(r.iterations) == p.max_iterations,
                            f"worst case: {int(r.iterations)} LM iterations")
                    if i in (0, GRAPH_CALLS):
                        with loop_mode("eager"):
                            want = solver.run_step(p, plan, n, e, u, obstacles, unc)
                        require(same_bits(r, want), f"worst case on {k} stream(s): {mode} != eager")
            for mode, v in ms.items():
                res[(k, mode)] = dict(median_ms=statistics.median(v[1:]), max_ms=max(v[1:]),
                                      capture_ms=v[0])
            g, h = res[(k, "graphed")], res[(k, "host-polled")]
            print(f"[18 worst case] seq B=1, {p.max_iterations} LM iterations per solve, {k} "
                  f"stream(s), over {GRAPH_CALLS} calls on new egos in turns (host clock, "
                  f"synchronised): graphed (device loop) median {g['median_ms']:.3f} ms, max "
                  f"{g['max_ms']:.3f} ms (first call with the capture {g['capture_ms']:.3f}); "
                  f"host-polled median {h['median_ms']:.3f} ms, max {h['max_ms']:.3f} ms (first "
                  f"{h['capture_ms']:.3f}); both = eager bit for bit | the 100 ms budget: "
                  f"graphed max {'under' if g['max_ms'] < 100.0 else 'OVER'}, host-polled max "
                  f"{'under' if h['max_ms'] < 100.0 else 'OVER'} on {card}", flush=True)
    finally:
        solver.GRAPHS, solver.STREAMS = True, streams
    return res


# Phase 19, the JAX package's programs on the port (cilqr_tpu_torch/scripts), cut small
SCRIPT_RUNS, SCRIPT_CYCLES = 5, 20      # classification and the sweep cell
NRB_BUDGET, NRB_RUNS = 96, 2             # one budget, its three slaloms


def scripts_phase(card: str, counts, dev: torch.device) -> dict:
    """19. Each of ``python -m cilqr_tpu_torch.scripts.*`` once at a small
    size on the JAX package's noise block, in process: the classification
    (its four cells, SCRIPT_RUNS x SCRIPT_CYCLES: K5 and K4 once per cycle
    of each cell, K3 per LM iteration), the NRB budget table (NRB_BUDGET x
    NRB_RUNS runs x SCRIPT_CYCLES cycles on success1-3, one CUDA graph per
    tree shape, no kernel of the port), and one cell of the r5 rotated grid
    (`cilqr` at sigma 0.5).  Every row well formed and finite.  Returns the
    launches by script."""
    from cilqr_tpu_torch.scripts import classify_failure_modes as cls
    from cilqr_tpu_torch.scripts import nrb_budget_sensitivity as nrb
    from cilqr_tpu_torch.scripts import production_sweeps as ps
    from cilqr_tpu_torch.sim import sweep

    t_phase = time.perf_counter()
    zero_counts, read_counts = counts
    launches = {}
    town = sweep.synthetic_town_prior(torch.float32, dev)
    R, T = SCRIPT_RUNS, SCRIPT_CYCLES

    t0 = time.perf_counter()
    zero_counts()
    rows = cls.run(R, T, device=dev, global_map=town[0], global_geom=town[1])
    torch.cuda.synchronize()
    launches["classify"] = l_cls = read_counts()
    cells = len(cls.WEIGHTS) * len(cls.SIGMAS)
    require(len(rows) == cells and all(
        0 <= r["wall_hits"] <= r["collided"] <= R and 0 <= r["car_hits"] <= r["collided"]
        for r in rows), f"classification rows {rows}")
    require(l_cls["costmap"] == l_cls["sample"] == l_cls["uncertainty"] == cells * T
            and l_cls["lm_iter"] >= cells * T and not l_cls["lm"] and not l_cls["riccati"],
            f"classification launches {l_cls} for {cells} cells x {T} cycles")
    cls_s = time.perf_counter() - t0
    print(f"[19a classify_failure_modes] {R} runs x {T} cycles, {cls_s:.1f} s, launches {l_cls}: "
          + " | ".join(cls.line(r) for r in rows), flush=True)

    t0 = time.perf_counter()
    zero_counts()
    nrows = nrb.rows((NRB_BUDGET,), n_runs=NRB_RUNS, n_cycles=T, device=dev)
    torch.cuda.synchronize()
    launches["nrb_budget"] = l_nrb = read_counts()
    require(len(nrows) == len(nrb.NAMES) and all(
        0 <= r["collision_runs"] <= NRB_RUNS and math.isfinite(r["min_obstacle_distance"])
        and math.isfinite(r["velocity_mean"]) for r in nrows), f"NRB rows {nrows}")
    require(not any(l_nrb.values()), f"NRB launched {l_nrb}")
    print(f"[19b nrb_budget_sensitivity] n_iters {NRB_BUDGET}, {NRB_RUNS} runs x {T} cycles, "
          f"{time.perf_counter() - t0:.1f} s: "
          + " ".join(nrb.table_line(r) for r in nrows), flush=True)

    t0 = time.perf_counter()
    zero_counts()
    srows = ps.run_grid("r5_rot25", R, T, sigmas=(0.5,), algorithms=("cilqr",), device=dev)
    torch.cuda.synchronize()
    launches["production_sweeps"] = l_ps = read_counts()
    (row,) = srows
    require(row["algorithm"] == "cilqr" and row["n_runs"] == R and len(row["collided_mask"]) == R
            and all(math.isfinite(row[k]) for k in ("velocity_mean", "min_obstacle_distance",
                                                     "mean_jerk")),
            f"sweep row {row}")
    require(l_ps["costmap"] == l_ps["sample"] == l_ps["uncertainty"] == T
            and l_ps["lm_iter"] >= T,
            f"sweep cell launches {l_ps} for {T} cycles")
    print(f"[19c production_sweeps] r5_rot25, cilqr at sigma 0.5, {R} runs x {T} cycles, "
          f"{time.perf_counter() - t0:.1f} s, launches {l_ps}: {json.dumps(row)}", flush=True)
    print(f"[19 done] phase 19 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return launches


# Phase 20, the hybrid (K3) and two-phase (K2) LM loops as CUDA graphs
# (models/solver.py: the iteration handed over as a solver.Iteration)
LOOP_CALLS = 3            # timed calls per path, graphed and eager (host clock, synchronised)
LOOP_REPLAYS = 20         # step replays timed per capture, in turns on 1, 4, 4, 1 streams
LOOP_COMPARE_ALGOS = ("cilqr", "ccnmpc")  # compare's planners on these loops (K3, K2)
LOOP_COMPARE_CYCLES = 40  # of phase 15's 120, for the script's time: three runs of it here
LOOP_IDLE_CYCLES = 3      # compare's cycles under the profiler, for the idle share


def tree_equal(a, b) -> bool:
    """Two nests of tuples, lists and dicts of one structure, every tensor
    equal bit for bit and every other leaf equal."""
    from torch.utils._pytree import tree_flatten

    (la, sa), (lb, sb) = tree_flatten(a), tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                            for x, y in zip(la, lb))


def idle_share(fn) -> tuple:
    """(the device's idle share of one fn() call, its device kernels and
    copies, the ms some device event runs, the call's ms) by
    ``torch.profiler`` after a warm-up call: one less the time at least one
    device event runs (the events of several streams overlap) over the
    call's time (CUDA events, under the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy_ms, call_ms = covered_us(spans) / 1e3, start.elapsed_time(end)
    return 1.0 - busy_ms / call_ms, len(spans), busy_ms, call_ms


@contextlib.contextmanager
def capture_seconds(store: list):
    """Inside: every capture of the LM loops' graphs (``solver._capture``)
    appends its seconds to store."""
    from cilqr_tpu_torch.models import solver

    make = solver._capture

    def timed_capture(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = make(*args)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out

    solver._capture = timed_capture
    try:
        yield store
    finally:
        solver._capture = make


def loop_kinds(B: int | None = None) -> set:
    """The iterations (``solver.Iteration.build``) of the LM loops in
    ``solver.CAPTURED`` (with ``B``: of those captured for B lanes; a key
    holds the inputs' (shape, dtype), x0's first, and the constants)."""
    from cilqr_tpu_torch.models import ccnmpc, solver, solver_batched
    from cilqr_tpu_torch.ops import lm_cuda
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim import plant

    # the iterations, and the stages whose start graph builds one
    kinds = {lm_cuda._hybrid: "hybrid", solver_batched._two_phase: "two_phase",
             solver.plain_iteration: "plain", solver_batched.hybrid_before: "hybrid",
             mc._fast_before: "hybrid", plant._full_stack_before: "hybrid",
             solver_batched.two_phase_before: "two_phase", ccnmpc._round_before: "two_phase"}
    return {kinds[leaf] for key in solver.CAPTURED for leaf in key[4]
            if callable(leaf) and leaf in kinds and B in (None, key[3][0][0][0])}


def solved(res) -> tuple:
    """(X, U, iterations, J, lamb) of a ``run_steps_batched`` result or of a
    ``solver.solve`` result ((X, U, iterations, J, lamb), carry)."""
    return pick(res) if hasattr(res, "lamb") else tuple(res[0])


def stream_study(label: str, call, card: str) -> dict:
    """One recorded solve of a path, (``run_steps_batched``,
    ``ccnmpc.solve_round`` or ``solver.solve``, args, keywords), solved
    again alone: eagerly, then
    graphed on one stream and on ``solver.STREAMS``, each equal to the eager
    solve bit for bit; the two step graphs' replays timed in turns (1, S, S,
    1), their device kernels per replay and the S-stream start graph's, the
    plan of the S-stream step, the pools' bytes and the captures'
    seconds."""
    from cilqr_tpu_torch.models import solver

    fn, args, kw = call
    solve = lambda: solved(fn(*args, **kw))
    S = solver.STREAMS
    per = {}
    try:
        solver.GRAPHS = False
        want = solve()
        solver.GRAPHS = True
        solver.CAPTURED.clear()
        for k in (1, S):
            solver.STREAMS, known, secs = k, set(solver.CAPTURED), []
            with capture_seconds(secs):
                got = solve()
                torch.cuda.synchronize()
            new = [key for key in solver.CAPTURED if key not in known]
            require(len(new) == 1 and len(secs) == 1,
                    f"{label}: {len(new)} captures on {k} stream(s)")
            require(tree_equal(got, want), f"{label}: graphed on {k} stream(s) != eager")
            start, step = solver.CAPTURED[new[0]].graphs
            per[k] = dict(start=start, step=step, pool_bytes=start.pool_bytes + step.pool_bytes,
                          capture_s=secs[0], turns=[],
                          loop=loop_stats_line([solver.CAPTURED[new[0]]]))
    finally:
        solver.GRAPHS, solver.STREAMS = True, S
    for k in (1, S, S, 1):
        per[k]["turns"].append(cuda_ms(per[k]["step"].replay, LOOP_REPLAYS))
    for k, v in per.items():
        v["replay_ms"] = statistics.mean(v["turns"])
        v["kernels"], v["busy_ms"] = device_kernels(v["step"].replay)
    start_kernels, start_busy = device_kernels(per[S]["start"].replay)
    st = per[S]["step"].stats
    B = want[0].shape[0]
    print(f"[20 streams {label}] B={B}, the start graph: {start_kernels} device kernels per "
          f"replay ({start_busy:.4f} ms busy) on {S} streams; the step graph: {per[S]['kernels']} "
          f"device kernels per replay ({per[1]['kernels']} on one stream) | ms per replay (CUDA "
          f"events, "
          f"{LOOP_REPLAYS} replays, turns 1, {S}, {S}, 1) 1 stream {per[1]['replay_ms']:.4f} "
          f"({per[1]['busy_ms']:.4f} busy), {S} streams {per[S]['replay_ms']:.4f} "
          f"({per[S]['busy_ms']:.4f} busy) | plan on {S} streams: chain {st.plan_chain} of "
          f"{st.ops} ops (data's {st.dag_chain}), {st.waits} cross-stream waits | pool bytes "
          f"(start + step) 1 stream {per[1]['pool_bytes']}, {S} streams {per[S]['pool_bytes']} | "
          f"capture s 1 stream {per[1]['capture_s']:.3f}, {S} streams {per[S]['capture_s']:.3f} "
          f"(the loop graph's build included) | loop graph 1 stream: {per[1]['loop']}; {S} "
          f"streams: {per[S]['loop']} | graphed = eager bit for bit on both on {card}",
          flush=True)
    return dict(B=B, kernels_per_replay=per[S]["kernels"], kernels_per_replay_1=per[1]["kernels"],
                start_kernels_per_replay=start_kernels,
                replay_ms={k: v["replay_ms"] for k, v in per.items()}, ops=st.ops,
                chain=st.plan_chain, dag_chain=st.dag_chain,
                pool_bytes={k: v["pool_bytes"] for k, v in per.items()},
                capture_s={k: v["capture_s"] for k, v in per.items()})


def loop_path(label: str, run, counts, card: str, kind: str, slope=None) -> dict:
    """A path whose LM loop is ``kind`` ("hybrid" or "two_phase"), run()
    once as a user calls it in each mode of LOOP_MODES (graphed on the
    device loop, host-polled, eager): its outputs and every LM solve's
    (``solver.solve``: X, U, iterations, J, lamb) equal bit for bit, the
    launch counts equal (a replay counts its kernels), the graphed run's
    loops captured as ``kind``, each device loop's steps equal to its
    solve's largest iteration count and the condition run steps + 1 times
    per solve; ms per call each way (the median of LOOP_CALLS calls after
    the first), the device's idle share each way (for the device loop also
    from the host-polled run's busy time: the same kernels, which the
    profiler sees whole), with ``slope`` = (call, make_input, items, g2)
    the benchmark's slope throughput graphed and eager; the graphed loops'
    start replays and launches under ``no_host_sync``; then
    ``stream_study`` on the first solve.  Returns the numbers."""
    from cilqr_tpu_torch import benchmark
    from cilqr_tpu_torch.models import solver
    from cilqr_tpu_torch.ops import loop_cuda
    from cilqr_tpu_torch.utils import graphs

    zero_counts, read_counts = counts
    out, firsts, launches, ms, idle, rate = {}, {}, {}, {}, {}, {}
    calls, cond_runs, loop_line, host_free = [], 0, "", 0
    for mode in LOOP_MODES:
        with loop_mode(mode):
            solver.CAPTURED.clear()
            solves, steps = [], []
            zero_counts()
            cond0 = loop_cuda.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recording(solver, "solve", solves, keep=lambda res, a, k: (a, k, solved(res))), \
                    recording(graphs.Loop, "count", steps):
                res = run()
                torch.cuda.synchronize()
            firsts[mode] = (time.perf_counter() - t0) * 1e3
            launches[mode] = read_counts()
            out[mode] = (res, [r for _, _, r in solves])
            its_max = [int(r[2].max()) for _, _, r in solves]
            if mode == "graphed":
                calls = [(solver.solve, a, k) for a, k, _ in solves]
                require(loop_kinds() == {kind}, f"{label}: graphed loops {loop_kinds()}, "
                        f"expected {kind}")
                require(steps == its_max, f"{label}: device loops' steps {steps}, largest "
                        f"iteration counts {its_max}")
                cond_runs = loop_cuda.LAUNCHES - cond0
                require(cond_runs == sum(its_max) + len(its_max),
                        f"{label}: the condition ran {cond_runs} times for {len(its_max)} solves "
                        f"of {sum(its_max)} steps")
                loop_line = loop_stats_line(solver.CAPTURED.values())
            else:
                require(not steps, f"{label}: {mode} ran a device loop")
                if mode == "eager":
                    require(not solver.CAPTURED, f"{label}: the eager run captured a graph")
            times = []
            for _ in range(LOOP_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[mode] = statistics.median(times)
            idle[mode] = idle_share(run)
            if slope is not None and mode != "host-polled":
                rate[mode] = benchmark.slope_throughput(*slope[:3], g2=slope[3])[0]
            if mode == "graphed":
                host_free = loops_host_free(label)
    for mode in ("graphed", "host-polled"):
        require(tree_equal(out[mode], out["eager"]),
                f"{label}: the {mode} path's results differ from the eager path's")
        require(launches[mode] == launches["eager"],
                f"{label}: launches {mode} {launches[mode]}, eager {launches['eager']}")
    # the device loop's busy time from the host-polled run's (the same kernels)
    idle_from_host = 1.0 - idle["host-polled"][2] / idle["graphed"][3]
    its = torch.cat([r[2].reshape(-1).float() for r in out["graphed"][1]])
    print(f"[20 loops {label}] {len(out['graphed'][1])} {kind} solves, graphed (device loop) = "
          f"host-polled = eager bit for bit (X, U, iterations, J, lambda of every lane, and the "
          f"path's outputs) | launches {launches['graphed']} all three ways; the condition ran "
          f"{cond_runs} times (steps + 1 per solve, steps = the largest iteration count) | "
          f"{host_free} loops' start replay + loop launch under set_sync_debug_mode('error'): no "
          f"host read | loop graphs: {loop_line} | ms per call (host clock, synchronised, median "
          f"of {LOOP_CALLS}): graphed {ms['graphed']:.3f} (first call, with the captures, "
          f"{firsts['graphed']:.3f}), host-polled {ms['host-polled']:.3f} (first "
          f"{firsts['host-polled']:.3f}), eager {ms['eager']:.3f} | device idle share (profiler) "
          + ", ".join(f"{m} {100 * v[0]:.1f}% ({v[1]} device events, {v[2]:.3f} of {v[3]:.3f} ms "
                      f"busy)" for m, v in idle.items())
          + f"; graphed from the host-polled busy time {100 * idle_from_host:.1f}%"
          + (f" | slope throughput (the benchmark's method) graphed {rate['graphed']:.1f}, eager "
             f"{rate['eager']:.1f} per s" if slope else "")
          + f" | mean LM iterations {float(its.mean()):.2f} on {card}", flush=True)
    study = stream_study(label, calls[0], card)
    return dict(graphed_ms=ms["graphed"], first_ms=firsts["graphed"], host_ms=ms["host-polled"],
                eager_ms=ms["eager"], idle={m: v[0] for m, v in idle.items()},
                idle_from_host=idle_from_host, rate=rate, launches=launches["graphed"],
                condition_runs=cond_runs, mean_iterations=float(its.mean()), streams=study)


def compare_loops(card: str, counts, dev: torch.device) -> dict:
    """`compare --full-stack` on its two scenarios at phase 15's runs and
    LOOP_COMPARE_CYCLES cycles, on the algorithms whose planners run these
    loops (`cilqr`: the hybrid loop, K3; `ccnmpc`: two SQP rounds per cycle,
    each a start graph (rollout, covariance, tightening, plan fit) and the
    two-phase loop, K2), in each mode of LOOP_MODES: every planner step's (X, U,
    iterations, J, lamb) equal bit for bit, the launches equal, the
    command's and each algorithm's seconds each way; the idle share over
    LOOP_IDLE_CYCLES cycles each way; ``stream_study`` on each algorithm's
    first solve."""
    from cilqr_tpu_torch.models import ccnmpc, solver, solver_batched
    from cilqr_tpu_torch.sim import runner

    zero_counts, read_counts = counts
    argv = ["compare", "--full-stack", "--scenarios", ",".join(EXP_SCENARIOS), "--runs",
            str(EXP_COMPARE_RUNS), "--algorithms", ",".join(LOOP_COMPARE_ALGOS)]
    steps, secs, launches, per_algo, idle, first = {}, {}, {}, {}, {}, {}
    # the solves recorded with the function that ran them (`cilqr`'s
    # run_steps_batched calls, `ccnmpc`'s SQP rounds)
    by = lambda fn: (lambda res, a, k: (fn, a, k))
    mega, rounds = solver_batched.run_steps_batched, ccnmpc.solve_round
    with tempfile.TemporaryDirectory(prefix="cilqr_loops_") as tmp:
        for mode in LOOP_MODES:
            with loop_mode(mode):
                solver.CAPTURED.clear()
                rec, calls, solves = [], [], []
                zero_counts()
                with steps_recorded(runner, rec), per_call(
                        runner, "run_experiment_batch", read_counts, calls,
                        lambda args, kw: (kw["algorithm"],)), recording(
                        solver_batched, "run_steps_batched", solves, keep=by(mega)), \
                        recording(ccnmpc, "solve_round", solves, keep=by(rounds)):
                    secs[mode], _ = cli_call(argv + ["--cycles", str(LOOP_COMPARE_CYCLES)], dev,
                                             pathlib.Path(tmp) / mode)
                launches[mode] = read_counts()
                steps[mode] = rec
                per_algo[mode] = {a: s for a, (s, _) in by_algorithm(
                    calls, LOOP_COMPARE_ALGOS).items()}
                if mode == "graphed":
                    require(loop_kinds() == {"hybrid", "two_phase"},
                            f"compare: graphed loops {loop_kinds()}")
                    first = {"ccnmpc": next(c for c in solves if c[0] is rounds),
                             "cilqr": next(c for c in solves if c[1][6] is not None)}
                idle[mode] = idle_share(lambda: cli_call(
                    argv + ["--cycles", str(LOOP_IDLE_CYCLES)], dev,
                    pathlib.Path(tmp) / f"idle_{mode}"))
    for mode in ("graphed", "host-polled"):
        require(len(steps[mode]) == len(steps["eager"]) and tree_equal(steps[mode], steps["eager"]),
                f"compare: a {mode} planner step differs from the eager one")
        require(launches[mode] == launches["eager"],
                f"compare: launches {mode} {launches[mode]}, eager {launches['eager']}")
    print(f"[20 loops compare] `{' '.join(argv)} --cycles {LOOP_COMPARE_CYCLES}`: "
          f"{len(steps['graphed'])} planner steps, graphed (device loop) = host-polled = eager "
          f"bit for bit (X, U, iterations, J, lambda of every lane) | launches "
          f"{launches['graphed']} all three ways | command s graphed {secs['graphed']:.3f}, "
          f"host-polled {secs['host-polled']:.3f}, eager {secs['eager']:.3f} | "
          + ", ".join(f"{a} s graphed {per_algo['graphed'][a]:.3f}, host-polled "
                      f"{per_algo['host-polled'][a]:.3f}, eager {per_algo['eager'][a]:.3f}"
                      for a in LOOP_COMPARE_ALGOS)
          + f" | device idle share ({LOOP_IDLE_CYCLES} cycles, profiler) "
          + ", ".join(f"{m} {100 * v[0]:.1f}%" for m, v in idle.items()) + f" on {card}",
          flush=True)
    studies = {a: stream_study(f"compare {a}", first[a], card) for a in LOOP_COMPARE_ALGOS}
    return dict(seconds=secs, per_algo=per_algo, idle={k: v[0] for k, v in idle.items()},
                launches=launches["graphed"], streams=studies)


# Phase 21, the K1 solve and the closed loops' stages as CUDA graphs
# (models/solver.py: solver.run, solver.solve)
STAGE_CALLS = 5           # timed calls per path, graphed and eager (host clock, synchronised)


def graph_path(label: str, run, counts, card: str, loops: bool = False) -> dict:
    """A path run as a user calls it, graphed (``solver.GRAPHS``) against
    eager, and with ``loops`` (its LM loops replayed) host-polled too
    (LOOP_MODES): its outputs equal bit for bit and the launch counts equal
    (a replay counts its kernels); ms per call each way (the median of
    STAGE_CALLS calls after the first; the first graphed call's with the
    captures), the device's idle share each way; the graphs the graphed
    call captured (``solver.CAPTURED``), each replayed alone: device kernels
    per replay, and their pools' bytes; the loop graphs' nodes and build
    seconds.  Returns the numbers."""
    from cilqr_tpu_torch.models import solver

    zero_counts, read_counts = counts
    out, first, launches, ms, idle = {}, {}, {}, {}, {}
    per_graph, pool, loop_line = [], 0, ""
    modes = [m for m in LOOP_MODES if loops or m != "host-polled"]
    try:
        for mode in modes:
            with loop_mode(mode):
                solver.CAPTURED.clear()
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[mode] = run()
                torch.cuda.synchronize()
                first[mode] = (time.perf_counter() - t0) * 1e3
                launches[mode] = read_counts()
                times = []
                for _ in range(STAGE_CALLS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                ms[mode] = statistics.median(times)
                idle[mode] = idle_share(run)
                if mode == "graphed":
                    # each graph replayed alone while its capture is held
                    held = [g for c in solver.CAPTURED.values() for g in c.graphs]
                    require(held, f"{label}: the graphed call captured nothing")
                    per_graph = [device_kernels(g.replay)[0] for g in held]
                    pool = sum(g.pool_bytes for g in held)
                    loop_line = loop_stats_line(solver.CAPTURED.values())
                    require(loops == (loop_line != "none"),
                            f"{label}: device loops {loop_line}, expected {loops}")
                elif mode == "eager":
                    require(not solver.CAPTURED, f"{label}: the eager call captured a graph")
    finally:
        solver.CAPTURED.clear()
    for mode in modes[:-1]:
        require(tree_equal(out[mode], out["eager"]),
                f"{label}: the {mode} call's results differ from the eager call's")
        require(launches[mode] == launches["eager"],
                f"{label}: launches {mode} {launches[mode]}, eager {launches['eager']}")
    print(f"[21 graphs {label}] {' = '.join(modes)} bit for bit (every output) | launches "
          f"{launches['graphed']} {len(modes)} ways | ms per call (host clock, synchronised, "
          f"median of {STAGE_CALLS}): "
          + ", ".join(f"{m} {ms[m]:.3f}" for m in modes)
          + f" (first graphed call, with the captures, {first['graphed']:.3f}) | device idle "
          f"share (profiler) "
          + ", ".join(f"{m} {100 * idle[m][0]:.1f}% ({idle[m][1]} device events)" for m in modes)
          + (f"; graphed from the host-polled busy time "
             f"{100 * (1.0 - idle['host-polled'][2] / idle['graphed'][3]):.1f}%" if loops else "")
          + f" | {len(per_graph)} graphs, device kernels per replay {per_graph}, pool bytes "
          f"{pool}; loop graphs: {loop_line} on {card}", flush=True)
    return dict(graphed_ms=ms["graphed"], first_ms=first["graphed"], eager_ms=ms["eager"],
                host_ms=ms.get("host-polled"), idle={m: v[0] for m, v in idle.items()},
                launches=launches["graphed"], kernels_per_replay=per_graph, pool_bytes=pool)


def ccnmpc_campaign(card: str, counts, dev: torch.device) -> dict:
    """Phase 22: ``closed_loop_batched`` with the CCNMPC plan step on the
    benchmark's deployment (CC_CONFIG: N=40, the three success1 obstacles,
    delta 0.05, two SQP rounds; CC_B starts along the lane, its noise) for
    CC_CYCLES cycles, graphed (per round a start graph, which runs the
    rollout, the covariance, the tightening and the plan fit, and one launch
    of the device loop) and with ``solver.GRAPHS = False``: every record and
    every round's X, U, iterations, J and lambda equal bit for bit; with the
    counters zeroed just before each call, K2's launches the sum of the
    rounds' largest iteration counts (a replay counts the launches its
    capture recorded) and ``ccnmpc.ROUNDS`` n_sqp x CC_CYCLES, both ways.
    Then K2 on one round's own derivatives at (CC_B, N), those of the last
    cycle's first round at its start, held to its plain versions at phase
    3's bars (``k2_held``).  Returns the numbers."""
    from cilqr_tpu_torch.models import ccnmpc, solver
    from cilqr_tpu_torch.ops import cost_cuda
    from cilqr_tpu_torch.sim import plant, runner

    t_phase = time.perf_counter()
    zero_counts, read_counts = counts
    world = cc_deployment(dev)
    p, noise, cc, plan_xy, plan_n, ob, sat, x0s, draws = world
    f32 = dict(dtype=torch.float32, device=dev)

    def closed_loop():
        step = runner.make_plan_step("ccnmpc", p, noise, plan_xy, plan_n, ob, cc_params=cc)
        return plant.closed_loop_batched(p, noise, plan_xy, plan_n, x0s, None, CC_CYCLES,
                                         obs_xyyaw=sat[0], obs_size=sat[1], obs_mask=sat[2],
                                         noise_draws=draws, plan_step_batched=step)

    out, launches, rounds, secs, graphs_held = {}, {}, {}, {}, 0
    try:
        for mode in ("graphed", "eager"):
            with loop_mode(mode), recording(ccnmpc, "solve_round", [],
                                            keep=lambda res, a, kw: (a[4], a[5], res)) as solves:
                solver.CAPTURED.clear()
                torch.cuda.synchronize()
                zero_counts()
                ccnmpc.ROUNDS = 0
                t0 = time.perf_counter()
                final, rec = closed_loop()
                torch.cuda.synchronize()
                secs[mode] = time.perf_counter() - t0
                launches[mode], rounds[mode] = read_counts(), ccnmpc.ROUNDS
                out[mode] = (final, rec, [r for _, _, r in solves])
                if mode == "graphed":
                    graphs_held = len(solver.CAPTURED)
                    require("two_phase" in loop_kinds(CC_B),
                            f"ccnmpc: graphed loops {loop_kinds(CC_B)}, expected the two-phase")
                else:
                    eager_solves = list(solves)
    finally:
        solver.CAPTURED.clear()
    its = [int(r.iterations.max()) for r in out["eager"][2]]
    require(tree_equal(out["graphed"], out["eager"]),
            "ccnmpc: the graphed closed loop differs from the eager one")
    require(graphs_held == 3, f"ccnmpc: {graphs_held} captures, expected the noise stage, "
            "a round and the advance")
    for mode in out:
        require(launches[mode]["riccati"] == sum(its) and rounds[mode] == cc.n_sqp * CC_CYCLES,
                f"ccnmpc {mode}: K2 {launches[mode]['riccati']} launches, rounds {rounds[mode]}; "
                f"expected {sum(its)} (the rounds' largest counts {its}) and "
                f"{cc.n_sqp * CC_CYCLES}")
        require(launches[mode]["cost"] == launches[mode]["riccati"],
                f"ccnmpc {mode}: the derivatives kernel launched {launches[mode]['cost']} times, "
                f"K2 {launches[mode]['riccati']}: expected once per LM step each")
    require(launches["graphed"] == launches["eager"],
            f"ccnmpc: launches graphed {launches['graphed']}, eager {launches['eager']}")

    # the derivatives kernel and K2 on the last cycle's first round at its
    # start: the rollout of its warm start, the obstacles tightened along it,
    # the damping the loop starts from
    egos, U, _ = eager_solves[cc.n_sqp * (CC_CYCLES - 1)]
    plans, X, ob_t, prepared = cc_round_inputs(world, egos, U)
    cost = cost_kernel_check(card, p, plans, X, U, ob_t, prepared)
    d, _ = cost_cuda.cost_derivs(p, plans, X, U, ob_t, None, prepared)
    lamb = torch.full((CC_B,), p.lamb_init, **f32)
    k2_err, roll = k2_held(p, d, X, U, lamb)
    mapped = two_phase_with_maps(card, p, plan_xy, plan_n, egos, U, ob_t, counts)
    print(f"[22 ccnmpc campaign] {CC_CONFIG.name} at B={CC_B} x {CC_CYCLES} cycles, N="
          f"{p.horizon}: graphed = eager bit for bit (every record; every round's X, U, "
          f"iterations, J, lambda) | {graphs_held} captures | rounds {rounds['graphed']} both "
          f"ways, K2 launches {launches['graphed']['riccati']} both ways = the derivatives "
          f"kernel's {launches['graphed']['cost']} = the rounds' largest "
          f"iteration counts {its} | s per call graphed {secs['graphed']:.3f} (the captures "
          f"included), eager {secs['eager']:.3f} | K2 on the derivatives kernel's output for the "
          f"last cycle's first round ({CC_B}, {p.horizon}): max|kernel-plain| {k2_err:.3e} (k/K "
          f"bar 1e-4 rel + 1e-5 abs) | {' | '.join(roll)} on {card}", flush=True)
    print(f"[22 done] phase 22 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return dict(B=CC_B, cycles=CC_CYCLES, launches=launches["graphed"]["riccati"],
                cost_launches=launches["graphed"]["cost"],
                rounds=rounds["graphed"], round_max_iterations=its, max_abs_err=k2_err,
                graphed_s=secs["graphed"], eager_s=secs["eager"], cost_kernel=cost,
                two_phase_with_maps=mapped)


COST_REPS = 20    # back-to-back calls of the derivatives kernel, timed
COST_MAP_B = 1024  # the two-phase solve with one uncertainty map per scenario


class CCWorld(NamedTuple):
    """Phase 22's deployment (CC_CONFIG) at CC_B lanes on the card."""
    p: object
    noise: object
    cc: object
    plan_xy: torch.Tensor
    plan_n: torch.Tensor
    ob: object           # the obstacles, shared
    sat: tuple           # (x, y, yaw), sizes, mask: what the plant carries
    x0s: torch.Tensor    # (CC_B, 4) starts along the lane
    draws: torch.Tensor  # (CC_CYCLES, CC_B, 3) the plant's noise


def cc_deployment(dev: torch.device) -> CCWorld:
    """CC_CONFIG's deployment (N=40, the three success1 obstacles, delta
    0.05, two SQP rounds) at CC_B starts along the lane, with its noise."""
    from cilqr_tpu_torch import NoiseParams, SolverParams
    from cilqr_tpu_torch.models import ccnmpc
    from cilqr_tpu_torch.models import obstacles as obs_mod, reference_path as rp

    cfg = json.loads(CC_CONFIG.read_text())
    w, lane = cfg["world"], cfg["world"]["plan"]
    p = dataclasses.replace(SolverParams(), **cfg["solver"])
    f32 = dict(dtype=torch.float32, device=dev)
    xs = lane["x0"] + lane["spacing"] * np.arange(int(lane["length"] / lane["spacing"]) + 1)
    plan_xy, plan_n = rp.pad_global_plan(p, np.stack([xs, np.full_like(xs, lane["y"])], axis=1),
                                         **f32)
    obs = np.asarray(w["obstacles"], dtype=np.float64)  # (M, 3): x, y, yaw
    sizes = np.tile(np.asarray(w["obstacle_size"], dtype=np.float64), (len(obs), 1))
    ob = obs_mod.make_static_obstacles(p, obs[:, :2], sizes, obs[:, 2], **f32)
    sat = (torch.tensor(obs, **f32), torch.tensor(sizes, **f32), torch.ones(len(obs), **f32))
    gen = torch.Generator(device=dev).manual_seed(22)
    x0s = torch.tensor(w["start"], **f32).repeat(CC_B, 1)
    x0s[:, 0] += w["start_spread_m"] * torch.rand(CC_B, generator=gen, **f32)
    draws = torch.randn((CC_CYCLES, CC_B, 3), generator=gen, **f32)
    return CCWorld(p, NoiseParams(**cfg["noise"]), ccnmpc.CCParams(**cfg["chance"]), plan_xy,
                   plan_n, ob, sat, x0s, draws)


def cc_round_inputs(world: CCWorld, egos: torch.Tensor, U: torch.Tensor) -> tuple:
    """A CCNMPC round's inputs at its start from (egos, U), as its start
    graph makes them: (plans, X the rollout of U, the obstacles tightened
    along it, (table, fit) of ``lm_cuda.prep_iteration(plans)``)."""
    from cilqr_tpu_torch.models import ccnmpc, dynamics
    from cilqr_tpu_torch.models import reference_path as rp
    from cilqr_tpu_torch.ops import lm_cuda

    p = world.p
    W = ccnmpc.process_noise(world.noise, torch.float32, egos.device)
    X = dynamics.rollout(p, egos, U)
    ob_t = ccnmpc.tightened_obstacles(p, world.cc, world.ob,
                                      ccnmpc.propagate_covariance(p, X, U, W, W))
    plans = rp.get_local_plan(p, world.plan_xy, world.plan_n, egos)
    prep = lm_cuda.prep_iteration(plans)
    return plans, X, ob_t, (prep.table, prep.fit)


def cost_kernel_profile(card: str, dev: torch.device) -> dict:
    """The two-phase step's derivatives kernel (``cost_cuda``) on the first
    round of phase 22's deployment (its starts, the cold controls) at
    (CC_B, N) under ``torch.profiler``: one call one device kernel, no copy
    and no other kernel; the kernel's device time per call."""
    from cilqr_tpu_torch.models import solver
    from cilqr_tpu_torch.ops import cost_cuda

    world = cc_deployment(dev)
    p = world.p
    U = solver.initial_controls(p, torch.float32, dev)[None].expand(CC_B, -1, -1).contiguous()
    plans, X, ob_t, prepared = cc_round_inputs(world, world.x0s, U)
    call = lambda: cost_cuda.cost_derivs(p, plans, X, U, ob_t, None, prepared)
    kernel_ms, other_ms, events = kernel_profile(call, COST_REPS, "cost_derivs_kernel")
    require(events == 1 and other_ms < 1e-6, f"a derivatives-kernel call launched {events} device "
            "kernels or copies, expected its one kernel")
    print(f"[3 derivatives kernel] cost_derivs_kernel at ({CC_B}, {p.horizon}) on "
          f"{CC_CONFIG.name}'s first round: kernel alone {kernel_ms:.4f} ms (profiler; "
          f"{events:.0f} device kernel per call, no copy) on {card}", flush=True)
    return dict(profiler_ms=kernel_ms, profiler_events_per_call=events)


def cost_held(label: str, got: tuple, want: tuple) -> float:
    """The derivatives kernel's (l_x, l_xx, l_u, l_uu, J) held element by
    element to the plain version's at phase 3's bars (1e-4 relative + 1e-5
    absolute), every value finite.  Returns the largest |kernel - plain|."""
    err = 0.0
    for name, g, w in zip(("l_x", "l_xx", "l_u", "l_uu", "J"), got, want):
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()),
                f"{label} {name}: a value is not finite")
        e, excess = max_excess(g, w, rtol=1e-4, atol=1e-5)
        err = max(err, e)
        require(excess <= 0.0, f"{label} {name}: max |kernel - plain| {e:.3e} beyond 1e-4 rel + "
                "1e-5 abs")
    return err


def cost_kernel_check(card: str, p, plans, X, U, obstacles, prepared) -> dict:
    """The two-phase step's derivatives kernel (``cost_cuda``) on one CCNMPC
    round's inputs at (CC_B, N), ``prepared`` (table, fit) as the start
    graph prepares it: every output held to the plain version
    (``cost_held``); one call one device kernel (the nodes of a graph of
    one call: ``graph_nodes``); its time alone (CUDA events around a graph
    of COST_REPS calls), by CUDA events around eager calls and the host's
    issue time of those calls, the plain version's time, the bound (bytes:
    X, U, the table, the fit and the live obstacle slots' per-lane dims in;
    the four derivative tensors and J out) and the compiler's resources.
    The profiler's reading is phase 3's (``cost_kernel_profile``)."""
    from cilqr_tpu_torch.models import costs
    from cilqr_tpu_torch.ops import cost_cuda
    from cilqr_tpu_torch.utils.roofline import cost_step_ops

    B, N, S = X.shape[0], p.horizon, p.n_closest_samples
    d, J = cost_cuda.cost_derivs(p, plans, X, U, obstacles, None, prepared)
    want, want_J = costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, None)
    got = (d.l_x, d.l_xx, d.l_u, d.l_uu, J)
    err = cost_held("derivatives kernel", got, (want.l_x, want.l_xx, want.l_u, want.l_uu, want_J))
    call = lambda: cost_cuda.cost_derivs(p, plans, X, U, obstacles, None, prepared)
    ms = cuda_ms(call, COST_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COST_REPS):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / COST_REPS
    torch.cuda.synchronize()
    alone_ms = graph_ms(call, COST_REPS)
    plain_ms = cuda_ms(lambda: costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, None), 5)
    nodes, kernel_nodes = graph_nodes(call, X.device)
    require(nodes == kernel_nodes == 1, f"a derivatives-kernel call enqueued {nodes} graph nodes, "
            f"{kernel_nodes} of them kernels: expected its one kernel")
    live = int((obstacles.mask != 0).sum()) if obstacles.mask.ndim == 1 else obstacles.mask.shape[-1]
    n_bytes = (nbytes(X[:, :N], U, *prepared, *got)
               + B * live * N * 2 * 4 * (obstacles.dims.ndim == 4))
    b = bound(n_bytes, B * N * cost_step_ops(S, live, 0))
    res = cost_cuda.kernel_resources(N, S)
    print(f"[22 derivatives kernel] cost_derivs_kernel at ({B}, {N}), S={S}, {live} live of "
          f"{obstacles.mask.shape[-1]} obstacle slots per lane: max|kernel-plain| {err:.3e} "
          f"(every output at 1e-4 rel + 1e-5 abs) | {res['lanes']} lanes per block, "
          f"{res['registers']} registers, {res['local_bytes']} B local, {res['shared_bytes']} B "
          f"shared per block, {res['blocks_per_sm']} blocks/SM | events {ms:.4f} ms per call "
          f"(the host issues a call in {host_ms:.4f} ms), kernel alone {alone_ms:.4f} ms (events "
          f"over a graph of {COST_REPS} calls; a graph of one call holds {nodes} node, a kernel), "
          f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({n_bytes / 1e6:.1f} MB) on {card}", flush=True)
    return dict(name="cost_derivs", source="cilqr_tpu_torch/csrc/cost.cu", max_abs_err=err,
                ms=ms, host_issue_ms=host_ms, kernel_only_ms=alone_ms, graph_nodes=nodes,
                plain_ms=plain_ms, **b, **res)


def two_phase_with_maps(card: str, p, plan_xy, plan_n, egos, U, obstacles, counts) -> dict:
    """The two-phase solve with one uncertainty map per scenario (the full
    stack's per-lane route, phase 20's loop) at COST_MAP_B lanes of a CCNMPC
    round, the tightened obstacles per lane: graphed on the device loop and
    with ``solver.GRAPHS = False``, bit for bit, the derivatives kernel and
    K2 launched once per step each (the largest iteration count) both ways;
    one iteration's derivatives from the sampled planes held to the plain
    version with the maps (``cost_held``)."""
    from cilqr_tpu_torch.models import costs, dynamics, solver, solver_batched
    from cilqr_tpu_torch.models import reference_path as rp
    from cilqr_tpu_torch.ops import cost_cuda, lm_cuda
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim.example_scenario import example_scenario

    zero_counts, read_counts = counts
    B = COST_MAP_B
    egos, U = egos[:B].contiguous(), U[:B].contiguous()
    ob = obstacles._replace(dims=obstacles.dims[:B], pos=obstacles.pos[:B])
    unc = example_scenario(p, device=egos.device)[-1]
    H, W = unc.values.shape
    gen = torch.Generator(device=egos.device).manual_seed(23)
    values = 100.0 * torch.rand((B, H, W), generator=gen, device=egos.device)
    # the maps' frame at the lane's obstacles, so that every lane meets them
    maps = mc.per_scenario_map(values, unc.geom, egos.new_tensor([100.0, -306.74]),
                               unc.origin_yaw)
    out, launches = {}, {}
    try:
        for mode in ("graphed", "eager"):
            with loop_mode(mode):
                solver.CAPTURED.clear()
                torch.cuda.synchronize()
                zero_counts()
                out[mode] = solver_batched.run_steps_batched(
                    p, plan_xy, plan_n, egos, U, ob, maps, impl="two_phase", world_batched=True)
                torch.cuda.synchronize()
                launches[mode] = read_counts()
    finally:
        solver.CAPTURED.clear()
    steps = int(out["eager"].iterations.max())
    require(tree_equal(out["graphed"], out["eager"]) and bool(torch.isfinite(out["eager"].U).all()),
            "two-phase with maps: the graphed solve differs from the eager one")
    for mode in out:
        require(launches[mode]["cost"] == launches[mode]["riccati"] == steps,
                f"two-phase with maps {mode}: launches {launches[mode]}, expected the derivatives "
                f"kernel and K2 {steps} times each")
    plans = rp.get_local_plan(p, plan_xy, plan_n, egos)
    X = dynamics.rollout(p, egos, U)
    planes = solver_batched.uncertainty_planes(p, maps, X[:, :p.horizon])
    prep = lm_cuda.prep_iteration(plans)
    d, J = cost_cuda.cost_derivs(p, plans, X, U, ob, planes, (prep.table, prep.fit))
    want, want_J = costs.all_cost_derivs_and_J(p, plans, X, U, ob, maps)
    err = cost_held("derivatives kernel with maps", (d.l_x, d.l_xx, d.l_u, d.l_uu, J),
                    (want.l_x, want.l_xx, want.l_u, want.l_uu, want_J))
    inside = float((planes[..., 0] != 0).float().mean())
    print(f"[22 two-phase with maps] B={B}, one {H}x{W} map per scenario ({100 * inside:.1f}% of "
          f"(lane, step) inside their map), per-lane obstacles: graphed = eager bit for bit, "
          f"{steps} LM steps, the derivatives kernel and K2 {steps} launches each both ways | "
          f"one iteration's derivatives from the sampled planes vs the plain version with the "
          f"maps: max|kernel-plain| {err:.3e} on {card}", flush=True)
    return dict(B=B, steps=steps, max_abs_err=err, inside_share=inside)


def main() -> None:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script needs an NVIDIA GPU")
    from cilqr_tpu_torch import CostmapParams, NoiseParams, SolverParams
    from cilqr_tpu_torch.models import costs, dynamics, solver, solver_batched
    from cilqr_tpu_torch.models.reference_path import get_local_plan
    from cilqr_tpu_torch.ops import costmap as costmap_mod
    from cilqr_tpu_torch.ops import (cost_cuda, costmap_cuda, gridmap, lm_cuda, riccati_cuda,
                                     sample_cuda, uncertainty_cuda)
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim import perception, plant
    from cilqr_tpu_torch.sim.example_scenario import example_scenario
    from cilqr_tpu_torch.utils import build, opbench

    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # 2. build the kernels from the sources in the checkout
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_lines((build.BUILD_DIR / "build.log").read_text())
    for kernel in ("lm_opt_kernel", "lm_iter_kernel"):
        for G in lm_cuda.GROUP_SIZES:
            require(any(ln.startswith(f"{kernel}<{G}>:") and "0/0 spill" in ln for ln in ptxas),
                    f"{kernel}<{G}> spills or is missing from the ptxas report: {ptxas}")
    for kernel in ("riccati_kernel", "propagate_kernel", "fields_kernel", "sample_kernel",
                   "costmap_layers_kernel", "lm_continue_kernel", "lm_reset_kernel",
                   "cost_derivs_kernel"):
        found = [ln for ln in ptxas if ln.startswith(kernel)]
        require(found and all("0/0 spill" in ln for ln in found),
                f"{kernel} spills or is missing from the ptxas report: {ptxas}")
    print(f"[2 build] {build_s:.2f} s -> {build.BUILD_DIR / build.LIB_NAME}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)
    # the LM loops' condition, which every graphed LM loop below runs on the card
    condition = condition_kernel(card, dev)

    p = dataclasses.replace(SolverParams(), horizon=HORIZON)
    S = p.n_closest_samples
    # each instantiation of K1 and K3 (a block is one warp of T = 32 / G
    # scenarios): registers and local-memory bytes per thread, shared memory
    # per block, resident blocks per SM
    # (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    for label, whole_loop in (("K1 lm_opt_kernel", True), ("K3 lm_iter_kernel", False)):
        print(f"[2 resources] {label}, S={S}: " + " | ".join(
            "G={G} T={T}: {registers} registers, {local_bytes} B local, {shared_bytes} B shared, "
            "{blocks_per_sm} blocks/SM".format(G=G, T=32 // G, **lm_cuda.kernel_resources(
                whole_loop, G, S)) for G in lm_cuda.GROUP_SIZES), flush=True)
    plan, n, ego, U0, obstacles, unc = example_scenario(p)  # on the card by default
    require(all(t.device == dev for t in (plan, n, ego, U0, obstacles.pos, unc.values)),
            "example_scenario left a tensor off the card")

    def scenario_batch(B: int, seed: int):
        rng = np.random.default_rng(seed)
        egos = torch.tensor(ego.cpu().numpy()[None, :] + rng.normal(0, 0.3, (B, 4)),
                            dtype=torch.float32, device=dev)
        return egos, U0.expand(B, HORIZON, 2).contiguous()

    kernels = {}

    # 3. K2 against its plain version, on derivatives at the initial rollout
    egos, U0s = scenario_batch(K2_CHECK_B, seed=1)
    plans = get_local_plan(p, plan, n, egos)
    X = dynamics.rollout(p, egos, U0s)
    d, _ = costs.all_cost_derivs_and_J(p, plans, X, U0s, obstacles, unc)
    lamb = torch.tensor(np.random.default_rng(1).uniform(0.1, 10.0, K2_CHECK_B),
                        dtype=torch.float32, device=dev)
    k2_err, roll = k2_held(p, d, X, U0s, lamb)
    # time at the main-path shapes: derivatives of B=32768 scenarios
    egos_m, U0_m = scenario_batch(MAIN_B, seed=2)
    plans_m = get_local_plan(p, plan, n, egos_m)
    X_m = dynamics.rollout(p, egos_m, U0_m)
    d_m, _ = costs.all_cost_derivs_and_J(p, plans_m, X_m, U0_m, obstacles, unc)
    lamb_m = torch.ones(MAIN_B, dtype=torch.float32, device=dev)
    require(all(t.is_contiguous() for t in (*d_m, X_m, U0_m, lamb_m)),
            "the derivatives reach K2 non-contiguous: its wrapper would copy them")
    k2_call = lambda: riccati_cuda.backward_forward_batched(p, d_m, X_m, U0_m, lamb_m)
    k2b_call = lambda: riccati_cuda.backward_batched(p, d_m, X_m, U0_m, lamb_m)
    k2_ms = cuda_ms(k2_call, 5)
    k2_plain_ms = cuda_ms(lambda: riccati_cuda.backward_forward_plain(p, d_m, X_m, U0_m, lamb_m), 3)
    k2b_ms = cuda_ms(k2b_call, 5)
    k2b_plain_ms = cuda_ms(lambda: riccati_cuda.backward_plain(p, d_m, X_m, U0_m, lamb_m), 3)
    # one call is one kernel of the port and nothing else on the device: no
    # layout copy, no PyTorch kernel (the profiler's device events per call)
    k2_kernel_ms, k2_other_ms, k2_events = kernel_profile(k2_call, 5, "riccati_kernel")
    k2b_kernel_ms, k2b_other_ms, k2b_events = kernel_profile(k2b_call, 5, "riccati_kernel")
    require(k2_events == 1 and k2b_events == 1 and max(k2_other_ms, k2b_other_ms) < 1e-6,
            f"a K2 call launched {k2_events} / {k2b_events} device kernels or copies, expected "
            "its one kernel")
    # the kernel before K2 in the two-phase step, on phase 22's deployment
    cost_profile = cost_kernel_profile(card, dev)
    # bound: the derivatives the recursion reads (l_ux is identically zero
    # and is not read), X, U and lambda in; X_new and U_new out (backward
    # only: k and K out); one Riccati step and one rollout step per (b, j)
    k2_in = nbytes(d_m.l_x, d_m.l_xx, d_m.l_u, d_m.l_uu, X_m, U0_m, lamb_m)
    k2_bound = bound(k2_in + nbytes(X_m, U0_m),
                     MAIN_B * HORIZON * (RICCATI_STEP_OPS + ROLLOUT_STEP_OPS))
    k2b_bound = bound(k2_in + MAIN_B * HORIZON * (2 + 8) * 4, MAIN_B * HORIZON * RICCATI_STEP_OPS)
    kernels["riccati"] = dict(
        name="riccati_backward_forward", route="cuda", source="cilqr_tpu_torch/csrc/riccati.cu",
        replaces="cilqr_tpu/ops/riccati_pallas.py:84", max_abs_err=k2_err,
        ms=k2_ms, kernel_only_ms=k2_kernel_ms, plain_ms=k2_plain_ms, **k2_bound,
        library_ms=NO_LIBRARY_CALL,
        backward_only=dict(replaces="cilqr_tpu/ops/riccati_pallas.py:296", ms=k2b_ms,
                           kernel_only_ms=k2b_kernel_ms, plain_ms=k2b_plain_ms, **k2b_bound))
    print(f"[3 K2 riccati] B={K2_CHECK_B} max|kernel-plain| {k2_err:.3e} (k/K bar 1e-4 rel + "
          f"1e-5 abs) | {' | '.join(roll)} | B={MAIN_B} at "
          f"{riccati_cuda.SCENARIOS_PER_WARP} scenarios per warp: wrapper {k2_ms:.3f} ms, kernel alone "
          f"{k2_kernel_ms:.3f} ms (profiler; {k2_events:.0f} device kernel per call, no copy), "
          f"plain {k2_plain_ms:.3f} ms, bound {k2_bound['bound_ms']:.3f} ms by "
          f"{k2_bound['bound_by']} | backward only: wrapper {k2b_ms:.3f} ms, kernel alone "
          f"{k2b_kernel_ms:.3f} ms, plain "
          f"{k2b_plain_ms:.3f} ms, bound {k2b_bound['bound_ms']:.3f} ms by "
          f"{k2b_bound['bound_by']}", flush=True)
    del d_m, X_m

    # 4. K1 against its plain version, full world, at the bars of the TPU
    # chip test (head U/X 1e-2 rel + 1e-2 abs, J 2e-2 relative, full-horizon
    # |dU| < 0.5).  The random costmap's bilinear gradient jumps at cell
    # edges, so on a few lanes any float32 rounding sends the solve to another
    # local solution.  Those chaotic lanes are found without the kernel: the
    # lanes where the float32 plain version breaks the bars against the
    # float64 plain version, on the egos as they are or moved by 2 ulps
    # (``check_lanes``).  Every other lane is held to both plain versions.
    egos, U0s = scenario_batch(K1_CHECK_B, seed=3)
    plans = get_local_plan(p, plan, n, egos)
    before = lm_cuda.LAUNCHES
    got = lm_cuda.fused_optimize(p, plans, egos, U0s, obstacles, unc)
    torch.cuda.synchronize()
    require(lm_cuda.LAUNCHES == before + 1, "K1 launch counter did not move")
    want = lm_cuda.fused_optimize_plain(p, plans, egos, U0s, obstacles, unc)
    plan64, n64, _, _, obstacles64, unc64 = example_scenario(p, torch.float64)
    egos64, U0s64 = egos.double(), U0s.double()
    want64 = lm_cuda.fused_optimize_plain(
        p, get_local_plan(p, plan64, n64, egos64), egos64, U0s64, obstacles64, unc64)
    u0_for = lambda e: U0.expand(e.shape[0], HORIZON, 2).contiguous()
    nudged = nudged_results(lambda e: lm_cuda.fused_optimize_plain(
        p, get_local_plan(p, plan, n, e), e, u0_for(e), obstacles, unc), egos, NUDGES)
    k1_line, _, k1_it_share, k1_err = check_lanes("K1", got, want, want64, nudged)
    print(f"[4 K1 lm] B={K1_CHECK_B} {k1_line}", flush=True)
    require(k1_it_share >= 0.99, "K1 iteration counts equal on fewer than 99% of lanes")
    # every lane-group size: a scenario's result must not depend on G, so
    # each instantiation gives the bits of the one just held to the plain
    # versions (iterations, X, U, J and lambda)
    for G in lm_cuda.GROUP_SIZES:
        other = lm_cuda._launch(p, plans, egos, U0s, obstacles, unc, G)
        require(all(torch.equal(a, b) for a, b in zip(other, got)),
                f"K1 at G = {G} differs from the group size launch_shape picks: iterations "
                f"equal {bool(torch.equal(other[2], got[2]))}, max |dX| "
                f"{float((other[0] - got[0]).abs().max()):.3e}")
    print(f"[4 K1 lm] B={K1_CHECK_B} every G of {lm_cuda.GROUP_SIZES} gives the bits of (T, G) = "
          f"{lm_cuda.launch_shape(K1_CHECK_B, S)}: iterations, X, U, J, lambda equal exactly, so "
          f"each is held to the plain versions as above", flush=True)
    plans_m = get_local_plan(p, plan, n, egos_m)
    # the times behind lm_cuda.launch_shape: K1 (wrapper included) at every G
    # on both sides of the rule's two steps
    rule = {}
    for B_r in LAUNCH_RULE_BATCHES:
        e_r, u_r = (egos_m, U0_m) if B_r == MAIN_B else scenario_batch(B_r, seed=2)
        plans_r = plans_m if B_r == MAIN_B else get_local_plan(p, plan, n, e_r)
        rule[B_r] = {G: round(cuda_ms(lambda: lm_cuda._launch(
            p, plans_r, e_r, u_r, obstacles, unc, G), 3), 3) for G in lm_cuda.GROUP_SIZES}
    print(f"[4 launch rule] K1 ms by B and G: {rule} | launch_shape picks G = "
          f"{ {B_r: lm_cuda.launch_shape(B_r, S)[1] for B_r in rule} }", flush=True)
    k1_ms, k1_out = timed(
        lambda: lm_cuda.fused_optimize(p, plans_m, egos_m, U0_m, obstacles, unc), 3)
    k1_plain_ms = cuda_ms(
        lambda: lm_cuda.fused_optimize_plain(p, plans_m, egos_m, U0_m, obstacles, unc), 2)
    # the plain loop replayed as CUDA graphs (solver.GRAPHS): their memory
    # pool at B=32768 would stay held until later captures evict it
    solver.CAPTURED.clear()
    # bound: fit payload, x0, U_init and the shared world in; X, U,
    # iterations, J and lambda out; the iterations this run's lanes took,
    # each of N steps, plus the sample table (30 per sample) and the initial
    # rollout (25 per step) once per lane
    M_obs = obstacles.mask.shape[0]
    world_m = lm_cuda.prep_world(p, obstacles, unc, torch.float32, dev)
    k1_bytes = (nbytes(lm_cuda._fit_payload(plans_m), egos_m, U0_m, world_m.obs, world_m.values,
                       world_m.scl) + nbytes(*k1_out))
    k1_ops = (float(k1_out[2].sum()) * HORIZON * lm_step_ops(S, M_obs, 50)
              + MAIN_B * (30 * S + 25 * HORIZON))
    k1_bound = bound(k1_bytes, k1_ops)
    kernels["lm"] = dict(
        name="lm_opt", route="cuda", source="cilqr_tpu_torch/csrc/lm.cu",
        replaces="cilqr_tpu/ops/lm_pallas.py:682", max_abs_err=k1_err,
        max_abs_err_of="full-horizon U against the float32 plain version, calm lanes",
        ms=k1_ms, plain_ms=k1_plain_ms, **k1_bound, library_ms=NO_LIBRARY_CALL)
    k1_shape = lm_cuda.launch_shape(MAIN_B, S)
    kernels["lm"]["launch_shape"] = dict(T=k1_shape[0], G=k1_shape[1],
                                         **lm_cuda.kernel_resources(True, k1_shape[1], S))
    print(f"[4 K1 lm] B={MAIN_B}: kernel {k1_ms:.3f} ms at (T, G) = {k1_shape}, plain "
          f"{k1_plain_ms:.3f} ms, bound {k1_bound['bound_ms']:.3f} ms by {k1_bound['bound_by']} "
          f"({k1_ops:.3e} operations, {k1_bytes / 1e6:.1f} MB)", flush=True)
    del k1_out

    # 5. the main path: run_steps_batched(impl="mega") at B=32768, N=50.  It
    # launches K1 once; K2's backward step and rollout run inside K1 as
    # device functions, so the mega path launches K2 on its own no time.
    lm_cuda.LAUNCHES = lm_cuda.ITER_LAUNCHES = 0
    riccati_cuda.LAUNCHES = uncertainty_cuda.LAUNCHES = 0
    res = solver_batched.run_steps_batched(p, plan, n, egos_m, U0_m, obstacles, unc, impl="mega")
    torch.cuda.synchronize()
    main_launches = {"lm": lm_cuda.LAUNCHES, "riccati": riccati_cuda.LAUNCHES,
                     "lm_iter": lm_cuda.ITER_LAUNCHES, "uncertainty": uncertainty_cuda.LAUNCHES}
    require(main_launches == {"lm": 1, "riccati": 0, "lm_iter": 0, "uncertainty": 0},
            f"main path launches {main_launches}, expected K1 once and no other kernel on its own")
    require(bool(torch.isfinite(res.X).all() and torch.isfinite(res.U).all()),
            "non-finite X/U on the main path")
    require(tuple(res.U.shape) == (MAIN_B, HORIZON, 2) and tuple(res.X.shape) == (MAIN_B, HORIZON + 1, 4),
            "main-path output shape")
    it_min, it_max = int(res.iterations.min()), int(res.iterations.max())
    require(1 <= it_min and it_max <= p.max_iterations, f"iterations outside [1, 20]: {it_min}..{it_max}")
    mean_it = main_mean_it = float(res.iterations.float().mean())
    # the first lanes against the unfused per-lane solve (the port's
    # reference), in float32 and float64, by the per-lane rule of phase 4
    R = 64
    ref = solver.run_step(p, plan, n, egos_m[:R], U0_m[:R], obstacles, unc)
    ref64 = solver.run_step(p, plan64, n64, egos_m[:R].double(), U0_m[:R].double(),
                            obstacles64, unc64)
    nudged = nudged_results(lambda e: pick(solver.run_step(p, plan, n, e, u0_for(e), obstacles,
                                                           unc)), egos_m[:R], NUDGES)
    ref_line, *_ = check_lanes("main path vs solver.run_step",
                               tuple(t[:R] for t in pick(res)), pick(ref), pick(ref64), nudged)
    main_ms = cuda_ms(lambda: solver_batched.run_steps_batched(
        p, plan, n, egos_m, U0_m, obstacles, unc, impl="mega"), TIMED_CALLS)
    # what K1's persistent groups are for: the spread of the counts, as the
    # work a warp of W neighbouring scenarios would do over the work they need
    it_hist, _ = iteration_spread(res.iterations, 32)
    waste = {W: round(iteration_spread(res.iterations, W)[1], 3) for W in (32, 16, 8, 4, 2)}
    print(f"[5 iterations] B={MAIN_B}: histogram {it_hist} | slowest scenario's count over the "
          f"mean, averaged over warps of W scenarios: {waste} (W = 32 / G; the shape in use is "
          f"(T, G) = {k1_shape})", flush=True)
    print(f"[5 main path] mega B={MAIN_B} N={HORIZON}: launches {main_launches} | mean iterations "
          f"{mean_it:.2f} (range {it_min}..{it_max}) | first {R} lanes vs solver.run_step: {ref_line} "
          f"| {main_ms:.3f} ms/call = {MAIN_B / main_ms * 1e3:.0f} solves/s on {card}", flush=True)

    # 6. serving shape (B=1, mega) and the two-phase path, which launches K2
    e1, u1 = egos_m[:1].contiguous(), U0_m[:1].contiguous()
    before = lm_cuda.LAUNCHES
    r1 = solver_batched.run_steps_batched(p, plan, n, e1, u1, obstacles, unc, impl="mega")
    torch.cuda.synchronize()
    require(lm_cuda.LAUNCHES == before + 1 and bool(torch.isfinite(r1.U).all()), "mega B=1")
    b1_diff = float((r1.U[0] - res.U[0]).abs().max())
    require(b1_diff <= 1e-6 and int(r1.iterations[0]) == int(res.iterations[0]),
            f"B=1 lane 0 differs from lane 0 of the B={MAIN_B} batch by {b1_diff:.3e}")
    b1_ms = cuda_ms(lambda: solver_batched.run_steps_batched(
        p, plan, n, e1, u1, obstacles, unc, impl="mega"), 20)
    e4, u4 = scenario_batch(K2_CHECK_B, seed=5)
    riccati_cuda.LAUNCHES = cost_cuda.LAUNCHES = 0
    r4 = solver_batched.run_steps_batched(p, plan, n, e4, u4, obstacles, unc, impl="two_phase")
    torch.cuda.synchronize()
    two_phase_launches = riccati_cuda.LAUNCHES
    # one K2 launch and one of the derivatives kernel per LM iteration, until
    # the last lane stops
    require(two_phase_launches == int(r4.iterations.max()) == cost_cuda.LAUNCHES
            and bool(torch.isfinite(r4.U).all()),
            f"two_phase: {two_phase_launches} K2 launches, {cost_cuda.LAUNCHES} of the "
            f"derivatives kernel for {int(r4.iterations.max())} iterations")
    tp_ms = cuda_ms(lambda: solver_batched.run_steps_batched(
        p, plan, n, e4, u4, obstacles, unc, impl="two_phase"), 2)
    b1_equal = bool(torch.equal(r1.U[0], res.U[0]) and torch.equal(r1.X[0], res.X[0]))
    print(f"[6 serving/two-phase] mega B=1 {b1_ms:.3f} ms/call at (T, G) = "
          f"{lm_cuda.launch_shape(1, S)} (lane 0 as in the B={MAIN_B} batch: max |dU| "
          f"{b1_diff:.1e}, X and U equal bit for bit: {b1_equal}) | two_phase B={K2_CHECK_B} "
          f"{tp_ms:.3f} ms/call ({int(r4.iterations.max())} LM iterations, "
          f"{two_phase_launches} K2 launches)", flush=True)

    # 7. where the time goes: device time by kernel against the call's time,
    # both in one profiled run (the profiler adds host overhead to the call)
    for label, e, u in (("B=%d" % MAIN_B, egos_m, U0_m), ("B=1", e1, u1)):
        print(f"[7 profile] {label}: " + profile_line(lambda: solver_batched.run_steps_batched(
            p, plan, n, e, u, obstacles, unc, impl="mega"), reps=3, kernels={"K1": "lm_opt"}),
            flush=True)
    del egos_m, U0_m, plans_m, res

    # The Monte-Carlo path (cilqr_tpu/benchmark.py:355-412 at full size): the
    # 152x104 costmap at 0.2 m centred at (15, 0) in the ego frame, a
    # uniform(0, 100) prior, per-scenario sigmas up to SIGMA_HI and ego noise,
    # the band plan of that bound, the example world's plan and obstacles.
    cp = CostmapParams()
    center = (cp.x_position, cp.y_position)
    cp = mc.ensure_window_covers(cp, cp.rows, cp.cols, center, SIGMA_HI)
    rows, cols = cp.rows, cp.cols
    band_plan = uncertainty_cuda.make_band_plan(cp, rows, cols, center, SIGMA_HI)
    bands, discs = band_plan.bands, band_plan.disc_radii
    prior_np = np.random.default_rng(4).uniform(0.0, 100.0, (rows, cols))

    def mc_world(dtype):
        return (torch.tensor(prior_np, dtype=dtype, device=dev),
                gridmap.make_geom(center, cp.resolution, rows, cols, dtype, dev),
                ego[:2].to(dtype), ego[3].to(dtype))

    prior, geom, origin_xy, origin_yaw = mc_world(torch.float32)
    prior64, geom64, origin_xy64, origin_yaw64 = mc_world(torch.float64)
    samples = mc.sample_scenarios(torch.Generator().manual_seed(0), MC_B, ego.cpu(),
                                  sigma_hi=SIGMA_HI, device=dev)

    # 8. K4 against its plain version in float32 at the JAX kernel-vs-reference
    # bar (rtol 2e-5, atol 2e-4; tests/test_uncertainty_pallas.py:51), kept-prior
    # cells exactly, and against the float64 plain version: no further from
    # it than twice the float32 plain version plus 1e-4.  Three forms: the MC
    # form (shared prior, banded), per-scenario priors (banded), and the
    # single-map entry (full window, faithful rho, whose non-PSD cells keep
    # the prior).
    def k4_compare(label, got, want, prior32, psd):
        err, excess = max_excess(got, want, rtol=2e-5, atol=2e-4)
        require(excess <= 0.0, f"K4 {label}: max |diff| {err:.3e} exceeds 2e-5 rel + 2e-4 abs")
        kept = (psd == 0).expand_as(got)
        prior_b = prior32.expand_as(got)
        require(torch.equal(got[kept], prior_b[kept]) and torch.equal(want[kept], prior_b[kept]),
                f"K4 {label}: a kept-prior cell moved")
        return err, int(kept.sum())

    def k4_check(label, prior32, prior_64, geom_64, yaw_64, sigmas, faithful, bnds, dsc, fused_entry):
        f32 = uncertainty_cuda.prep_fields(cp, geom, origin_yaw, sigmas, faithful, rows, cols)
        f64 = uncertainty_cuda.prep_fields(cp, geom_64, yaw_64, None if sigmas is None else
                                           sigmas.double(), faithful, rows, cols, torch.float64)
        before = uncertainty_cuda.LAUNCHES
        got = uncertainty_cuda.propagate_banded(cp, prior32, f32, bnds, dsc)
        fused = fused_entry(prior32)  # the fields computed in the kernel
        torch.cuda.synchronize()
        require(uncertainty_cuda.LAUNCHES == before + 2, "K4 launch counter did not move")
        want = uncertainty_cuda.propagate_banded_plain(cp, prior32, f32, bnds, dsc)
        want64 = uncertainty_cuda.propagate_banded_plain(cp, prior_64, f64, bnds, dsc)
        err, n_kept = k4_compare(label, got, want, prior32, f32[3])
        err_f, _ = k4_compare(label + ", fused", fused.reshape(got.shape), want, prior32, f32[3])
        for name, out in (("fields given", got), ("fused", fused.reshape(got.shape))):
            k_dev = float((out.double() - want64).abs().max())
            p_dev = float((want.double() - want64).abs().max())
            require(k_dev <= 2.0 * p_dev + 1e-4, f"K4 {label}, {name}: kernel {k_dev:.3e} from "
                    f"float64, float32 plain {p_dev:.3e}")
        same = bool(torch.equal(fused.reshape(got.shape), got))
        require(same, f"K4 {label}: the fused form differs from the fields-given form")
        return got, max(err, err_f), (
            f"{label}: max|kernel-plain| fields given {err:.3e}, fused {err_f:.3e} (fused equals "
            f"fields given bit for bit: {same}), kept-prior cells {n_kept}, kernel-f64 "
            f"{k_dev:.3e} plain32-f64 {p_dev:.3e}")

    def fields_check(B_f, geom_f, yaw_f, sigmas, faithful):
        """The kernel's own fields (cell_fields) against prep_fields: every
        cell of all four equal; returns the count of non-PSD cells."""
        before = uncertainty_cuda.FIELD_LAUNCHES
        got_f = uncertainty_cuda.fields_on_card(cp, geom_f, yaw_f, sigmas, faithful, rows, cols)
        torch.cuda.synchronize()
        require(uncertainty_cuda.FIELD_LAUNCHES == before + 1, "fields launch counter did not move")
        want_f = uncertainty_cuda.prep_fields(cp, geom_f, yaw_f, sigmas, faithful, rows, cols)
        for name, g, w in zip(("sx", "sy", "rho", "psd"), got_f, want_f):
            require(g.shape == w.shape and torch.equal(g, w),
                    f"K4 fields B={B_f} faithful={faithful}: {name} differs from prep_fields on "
                    f"{int((g != w).sum())} cells")
        return int((want_f[3] == 0).sum())

    # the fields the fused form computes per cell, bit for bit those of
    # prep_fields: B=256 and B=8192, both rho formulas, per-scenario sigmas,
    # yaws (all quadrants) and frames
    field_lines = []
    for B_f in (K4_CHECK_B, MC_B):
        rng_f = np.random.default_rng(20 + B_f)
        yaw_f = torch.tensor(rng_f.uniform(-math.pi, math.pi, B_f), dtype=torch.float32, device=dev)
        geom_f = costmap_mod.vehicle_geom(cp, torch.tensor(
            np.stack([rng_f.uniform(5.0, 20.0, B_f), rng_f.uniform(-3.0, 3.0, B_f)], axis=1),
            dtype=torch.float32, device=dev))
        for faithful in (False, True):
            kept_f = fields_check(B_f, geom_f, yaw_f, samples.sigmas[:B_f], faithful)
            fields_check(B_f, geom, origin_yaw, samples.sigmas[:B_f] if not faithful else None,
                         faithful)
            field_lines.append(f"B={B_f} faithful={faithful}: equal ({kept_f} non-PSD cells)")
    print(f"[8 K4 fields] cell_fields vs prep_fields, sx, sy, rho, psd on every cell: "
          + " | ".join(field_lines), flush=True)

    sig4 = samples.sigmas[:K4_CHECK_B]
    banded = lambda sig: lambda prior_t: uncertainty_cuda.propagate_uncertainty_banded(
        cp, prior_t, geom, origin_yaw, sig, band_plan)
    _, k4_err, line_mc = k4_check("MC form", prior, prior64, geom64, origin_yaw64, sig4, False,
                                  bands, discs, banded(sig4))
    priors = torch.tensor(np.random.default_rng(5).uniform(0.0, 100.0, (K4_CHECK_B, rows, cols)),
                          dtype=torch.float32, device=dev)
    _, err_b, line_b = k4_check("per-scenario priors", priors, priors.double(), geom64,
                                origin_yaw64, sig4, False, bands, discs, banded(sig4))
    full = uncertainty_cuda.full_window_plan(cp, rows).bands
    got1, err_1, line_1 = k4_check(
        "single map", prior, prior64, geom64, origin_yaw64, None, True, full, None,
        lambda prior_t: uncertainty_cuda.propagate_uncertainty(cp, prior_t, geom, origin_yaw,
                                                               faithful_rho=True))
    # at the MC path's shape, B=8192: the last timed outputs of the fused
    # form (what the path launches), of the fields-given form and of the
    # plain version, compared
    fused_call = lambda: uncertainty_cuda.propagate_uncertainty_banded(
        cp, prior, geom, origin_yaw, samples.sigmas, band_plan)
    k4_ms, got_m = timed(fused_call, 3)
    k4_kernel_ms, k4_other_ms, k4_events = kernel_profile(fused_call, 3, "propagate_kernel")
    fields_ms, fields_m = timed(lambda: uncertainty_cuda.prep_fields(
        cp, geom, origin_yaw, samples.sigmas, False, rows, cols), 2)
    k4_given_ms, given_m = timed(
        lambda: uncertainty_cuda.propagate_banded(cp, prior, fields_m, bands, discs), 3)
    k4_plain_ms, want_m = timed(
        lambda: uncertainty_cuda.propagate_banded_plain(cp, prior, fields_m, bands, discs), 1)
    err_m, kept_m = k4_compare(f"B={MC_B}", got_m, want_m, prior, fields_m[3])
    require(torch.equal(got_m, given_m), f"K4 B={MC_B}: the fused form differs from the "
            "fields-given form")
    k4_err = max(k4_err, err_b, err_1, err_m)

    mc_k4_bound = k4_bound(cp, prior, fields_m, fused=True)
    mc_given_bound = k4_bound(cp, prior, fields_m)
    # the single-map entry (one 152x104 map, full window, faithful rho)
    fields_1 = uncertainty_cuda.prep_fields(cp, geom, origin_yaw, None, True, rows, cols)
    single_call = lambda: uncertainty_cuda.propagate_uncertainty(cp, prior, geom, origin_yaw,
                                                                 faithful_rho=True)
    k4a_ms = cuda_ms(single_call, 5)
    k4a_kernel_ms, _, _ = kernel_profile(single_call, 5, "propagate_kernel")
    k4a_plain_ms = cuda_ms(
        lambda: uncertainty_cuda.propagate_banded_plain(cp, prior, fields_1, full), 1)
    k4a_bound = k4_bound(cp, prior, fields_1, fused=True, faithful=True)
    kernels["uncertainty"] = dict(
        name="propagate", route="cuda", source="cilqr_tpu_torch/csrc/uncertainty.cu",
        replaces="cilqr_tpu/ops/uncertainty_pallas.py:300",
        also_replaces=["cilqr_tpu/ops/uncertainty_pallas.py:199",
                       "cilqr_tpu/ops/uncertainty_pallas.py:283"],
        max_abs_err=k4_err, ms=k4_ms, kernel_only_ms=k4_kernel_ms, plain_ms=k4_plain_ms,
        **mc_k4_bound, library_ms=NO_LIBRARY_CALL,
        fields_given=dict(ms=k4_given_ms, prep_fields_ms=fields_ms, **mc_given_bound),
        single_map=dict(replaces="cilqr_tpu/ops/uncertainty_pallas.py:199", ms=k4a_ms,
                        kernel_only_ms=k4a_kernel_ms, plain_ms=k4a_plain_ms, **k4a_bound))
    print(f"[8 K4 uncertainty] B={K4_CHECK_B} {line_mc} | {line_b} | {line_1} | {len(bands)} bands, "
          f"radii {[R for (_, _, R) in bands]} | B={MC_B}: max|kernel-plain| {err_m:.3e}, kept-prior "
          f"cells {kept_m}, fused equals fields given bit for bit | fused (the path's form): wrapper "
          f"{k4_ms:.3f} ms, kernel alone {k4_kernel_ms:.3f} ms, {k4_events - 1:.0f} other device "
          f"kernels {k4_other_ms:.3f} ms (the scenario table), bound "
          f"{mc_k4_bound['bound_ms']:.3f} ms by {mc_k4_bound['bound_by']} | fields given: kernel "
          f"{k4_given_ms:.3f} ms after prep_fields {fields_ms:.3f} ms, bound "
          f"{mc_given_bound['bound_ms']:.3f} ms by {mc_given_bound['bound_by']} | plain "
          f"{k4_plain_ms:.3f} ms | one map, full window (fused): wrapper {k4a_ms:.3f} ms, kernel "
          f"alone {k4a_kernel_ms:.3f} ms, plain {k4a_plain_ms:.3f} ms, bound "
          f"{k4a_bound['bound_ms']:.5f} ms by {k4a_bound['bound_by']}", flush=True)
    del fields_m, priors, got_m, want_m, given_m

    # 9. K3 against its plain version: one iteration with external planes
    # (k, K and each rollout step at K2's bars, J within 2e-5 relative),
    # then the whole hybrid loop per lane (check_lanes), on per-scenario maps
    # from K4.
    def hybrid_inputs(B: int, dtype=torch.float32):
        maps = uncertainty_cuda.propagate_uncertainty_banded(
            cp, prior, geom, origin_yaw, samples.sigmas[:B], band_plan)
        egos_b = samples.egos[:B].to(dtype)
        if dtype == torch.float64:
            umaps = mc.per_scenario_map(maps.double(), geom64, origin_xy64, origin_yaw64)
            return umaps, egos_b, get_local_plan(p, plan64, n64, egos_b)
        umaps = mc.per_scenario_map(maps, geom, origin_xy, origin_yaw)
        return umaps, egos_b, get_local_plan(p, plan, n, egos_b)

    umaps3, egos3, plans3 = hybrid_inputs(K3_CHECK_B)
    sampler3 = solver_batched.map_sampler(p, umaps3)
    U3 = U0.expand(K3_CHECK_B, HORIZON, 2).contiguous()
    world = lm_cuda.prep_world(p, obstacles, None, torch.float32, dev)
    X3 = dynamics.rollout(p, egos3, U3)
    lamb3 = torch.tensor(np.random.default_rng(6).uniform(0.1, 10.0, K3_CHECK_B),
                         dtype=torch.float32, device=dev)
    uext3 = sampler3(X3[:, :HORIZON])
    def k3_compare(X, U, got, want):
        """(max |dk|, |dK|; rollout per-step errors; max relative dJ)."""
        Xn, Un, J, k, K = got
        _, _, Jw, kw, Kw = want
        err = 0.0
        for name, g, w in (("k", k, kw), ("K", K, Kw)):
            e, excess = max_excess(g, w, rtol=1e-4, atol=1e-5)
            err = max(err, e)
            require(excess <= 0.0, f"K3 {name}: max |diff| {e:.3e} exceeds 1e-4 rel + 1e-5 abs")
        roll = rollout_step_check(p, X, U, k, K, Xn, Un)
        j_rel = float(((J.double() - Jw.double()).abs() / Jw.double().abs()).max())
        require(j_rel <= 2e-5, f"K3 J: relative difference {j_rel:.3e} beyond 2e-5")
        return err, roll, j_rel

    before = lm_cuda.ITER_LAUNCHES
    got3 = lm_cuda.fused_iteration(p, world, plans3, X3, U3, lamb3, uext3)
    torch.cuda.synchronize()
    require(lm_cuda.ITER_LAUNCHES == before + 1, "K3 launch counter did not move")
    k3_err, roll3, j_rel = k3_compare(
        X3, U3, got3, lm_cuda.fused_iteration_plain(p, world, plans3, X3, U3, lamb3, uext3))
    # every lane-group size gives the bits of the one just held to the plain
    # version (all five outputs)
    for G in lm_cuda.GROUP_SIZES:
        other = lm_cuda._launch_iteration(p, world, plans3, X3, U3, lamb3, uext3, G)
        require(all(torch.equal(a, b) for a, b in zip(other, got3)),
                f"K3 at G = {G} differs from the group size launch_shape picks")
    # planted ties: the second half of every scenario's sample table repeats
    # its first half, so every winner has an exact twin S/2 samples later;
    # the first must win in every lane group, or the refine lands S/2
    # samples down the path
    half = S // 2
    twin = lambda t: torch.cat([t[:, :half], t[:, :half], t[:, 2 * half:]], dim=1)
    plans_tie = plans3._replace(sample_xl=twin(plans3.sample_xl), sample_yl=twin(plans3.sample_yl),
                                sample_r=twin(plans3.sample_r))
    want_tie = lm_cuda.fused_iteration_plain(p, world, plans_tie, X3, U3, lamb3, uext3)
    tie_err = 0.0
    for G in lm_cuda.GROUP_SIZES:
        got_tie = lm_cuda._launch_iteration(p, world, plans_tie, X3, U3, lamb3, uext3, G)
        tie_err = max(tie_err, k3_compare(X3, U3, got_tie, want_tie)[0])
    before = lm_cuda.ITER_LAUNCHES
    got = lm_cuda.fused_optimize(p, plans3, egos3, U3, obstacles, None, unc_sampler=sampler3)
    torch.cuda.synchronize()
    hybrid_launches = lm_cuda.ITER_LAUNCHES - before
    require(hybrid_launches == int(got[2].max()),
            f"hybrid loop: {hybrid_launches} K3 launches for {int(got[2].max())} iterations")
    want = lm_cuda.fused_optimize_plain(p, plans3, egos3, U3, obstacles, None,
                                        unc_sampler=sampler3)
    umaps64, egos64_3, plans64_3 = hybrid_inputs(K3_CHECK_B, torch.float64)
    want64 = lm_cuda.fused_optimize_plain(p, plans64_3, egos64_3, U3.double(), obstacles64, None,
                                          unc_sampler=solver_batched.map_sampler(p, umaps64))
    nudged = [lm_cuda.fused_optimize_plain(p, get_local_plan(p, plan, n, e), e, U3, obstacles,
                                           None, unc_sampler=sampler3)
              for e in perturbed(egos3, NUDGES)]
    require(1 <= int(got[2].min()) and int(got[2].max()) <= p.max_iterations,
            "hybrid loop: iterations outside [1, 20]")
    # A chaotic lane of the hybrid loop can end on another local solution
    # after another number of iterations (2 apart on one of 1024 lanes, in
    # one run): the calm lanes are held to equal counts, the chaotic ones to
    # within their nudged spread + 2.
    k3_line, _, _, k3_loop_err = check_lanes("K3 hybrid loop", got, want, want64, nudged,
                                             chaotic_it_off=2, by_spread=True)
    del umaps64, want64, nudged
    umapsM, egosM, plansM = hybrid_inputs(MC_B)
    UM = U0.expand(MC_B, HORIZON, 2).contiguous()
    XM = dynamics.rollout(p, egosM, UM)
    uextM = solver_batched.map_sampler(p, umapsM)(XM[:, :HORIZON])
    lambM = torch.ones(MC_B, dtype=torch.float32, device=dev)
    # as the hybrid loop launches it (table and fit payload prepared once per
    # solve), and called on its own (prepared on every call)
    worldM = world._replace(iteration=lm_cuda.prep_iteration(plansM))
    k3_ms, gotM = timed(lambda: lm_cuda.fused_iteration(p, worldM, plansM, XM, UM, lambM, uextM), 5)
    k3_alone_ms, aloneM = timed(
        lambda: lm_cuda.fused_iteration(p, world, plansM, XM, UM, lambM, uextM), 5)
    require(all(torch.equal(a, b) for a, b in zip(gotM, aloneM)),
            "K3 with inputs prepared once differs from K3 called on its own")
    k3_plain_ms, wantM = timed(
        lambda: lm_cuda.fused_iteration_plain(p, world, plansM, XM, UM, lambM, uextM), 2)
    k3_err_m, roll_m, j_rel_m = k3_compare(XM, UM, gotM, wantM)
    # bound: what K3 is given (the fit payload and the [sxl, syl] sample
    # table, r being recomputed), X, U, lambda, planes and obstacle payload
    # in; X_new, U_new, J, k and K out; one iteration of N steps
    k3_bound = bound(
        nbytes(worldM.iteration.table, worldM.iteration.fit, XM, UM, lambM, uextM, world.obs)
        + nbytes(*gotM),
        MC_B * HORIZON * lm_step_ops(p.n_closest_samples, obstacles.mask.shape[0], 20))
    kernels["lm_iter"] = dict(
        name="lm_iter", route="cuda", source="cilqr_tpu_torch/csrc/lm.cu",
        replaces="cilqr_tpu/ops/lm_pallas.py:663", max_abs_err=max(k3_err, k3_err_m),
        max_abs_err_of="one iteration's gains k, K against the float32 plain version",
        ms=k3_ms, ms_called_alone=k3_alone_ms, plain_ms=k3_plain_ms, **k3_bound,
        library_ms=NO_LIBRARY_CALL)
    k3_shape = lm_cuda.launch_shape(MC_B, S)
    kernels["lm_iter"]["launch_shape"] = dict(T=k3_shape[0], G=k3_shape[1],
                                              **lm_cuda.kernel_resources(False, k3_shape[1], S))
    print(f"[9 K3 lm_iter] B={K3_CHECK_B} one iteration: max|kernel-plain| k/K {k3_err:.3e} "
          f"(bar 1e-4 rel + 1e-5 abs) | per step " + ", ".join(f"{nm} {e:.3e}" for nm, e in roll3)
          + f" | J rel {j_rel:.3e} | every G of {lm_cuda.GROUP_SIZES} gives the same bits | "
          f"planted ties (table halves equal), every G: max|kernel-plain| k/K {tie_err:.3e} at "
          f"the same bars "
          f"| hybrid loop ({hybrid_launches} K3 launches): {k3_line} "
          f"(max full-horizon |dU| on calm lanes {k3_loop_err:.3e}) | B={MC_B} one iteration: "
          f"max|kernel-plain| k/K {k3_err_m:.3e}, per step "
          + ", ".join(f"{nm} {e:.3e}" for nm, e in roll_m)
          + f", J rel {j_rel_m:.3e}, kernel {k3_ms:.3f} ms with its inputs prepared once per solve "
          f"({k3_alone_ms:.3f} ms called on its own) at (T, G) = {k3_shape}, plain "
          f"{k3_plain_ms:.3f} ms, bound "
          f"{k3_bound['bound_ms']:.3f} ms by {k3_bound['bound_by']}", flush=True)
    del umapsM, egosM, plansM, XM, uextM, gotM, wantM, aloneM, worldM

    # 10. the Monte-Carlo path: monte_carlo(impl="fast") at B=8192, N=50.  It
    # launches K4 once and K3 once per LM iteration, and never K1 or K2.
    def mc_fast(s):
        return mc.monte_carlo(p, cp, prior, geom, origin_xy, origin_yaw, plan, n, s, obstacles,
                              sigma_hi=SIGMA_HI, impl="fast", band_plan=band_plan)

    lm_cuda.LAUNCHES = lm_cuda.ITER_LAUNCHES = 0
    riccati_cuda.LAUNCHES = uncertainty_cuda.LAUNCHES = costmap_cuda.LAUNCHES = 0
    res = mc_fast(samples)
    torch.cuda.synchronize()
    mc_launches = {"uncertainty": uncertainty_cuda.LAUNCHES, "lm_iter": lm_cuda.ITER_LAUNCHES,
                   "lm": lm_cuda.LAUNCHES, "riccati": riccati_cuda.LAUNCHES,
                   "costmap": costmap_cuda.LAUNCHES}
    it_min, it_max = int(res.iterations.min()), int(res.iterations.max())
    require(mc_launches == {"uncertainty": 1, "lm_iter": it_max, "lm": 0, "riccati": 0,
                            "costmap": 0},
            f"MC path launches {mc_launches}, expected K4 once, K3 {it_max} times, K1, K2 and "
            "the costmap layers kernel never")
    require("hybrid" in loop_kinds(MC_B), f"MC path: the graphed loops are {loop_kinds()}")
    require(bool(torch.isfinite(res.X).all() and torch.isfinite(res.U).all()),
            "non-finite X/U on the MC path")
    require(tuple(res.U.shape) == (MC_B, HORIZON, 2) and tuple(res.X.shape) == (MC_B, HORIZON + 1, 4),
            "MC path output shape")
    require(1 <= it_min and it_max <= p.max_iterations, f"iterations outside [1, 20]: {it_min}..{it_max}")
    maps = uncertainty_cuda.propagate_uncertainty_banded(cp, prior, geom, origin_yaw,
                                                         samples.sigmas, band_plan)
    require(bool(torch.isfinite(maps).all()) and float(maps.min()) >= 0.0
            and float(maps.max()) <= 100.0, "propagated maps outside [0, 100]")
    del maps
    L = MC_REF_LANES
    sub = mc.MCSample(samples.sigmas[:L], samples.egos[:L])

    def mc_reference(s, dtype=torch.float32):
        if dtype == torch.float64:
            return pick(mc.monte_carlo(p, cp, prior64, geom64, origin_xy64, origin_yaw64, plan64,
                                       n64, mc.MCSample(*(t.double() for t in s)), obstacles64,
                                       sigma_hi=SIGMA_HI, impl="reference"))
        return pick(mc.monte_carlo(p, cp, prior, geom, origin_xy, origin_yaw, plan, n, s,
                                   obstacles, sigma_hi=SIGMA_HI, impl="reference"))

    nudged = nudged_results(lambda e: mc_reference(mc.MCSample(sub.sigmas.repeat(NUDGES, 1), e)),
                            sub.egos, NUDGES)
    mc_line, *_ = check_lanes("MC path vs monte_carlo(impl='reference')",
                              tuple(t[:L] for t in pick(res)), mc_reference(sub),
                              mc_reference(sub, torch.float64), nudged, chaotic_it_off=2,
                              by_spread=True)
    mean_it = float(res.iterations.float().mean())
    mc_ms = cuda_ms(lambda: mc_fast(samples), 3)
    print(f"[10 MC path] fast B={MC_B} N={HORIZON}: launches {mc_launches} | mean iterations "
          f"{mean_it:.2f} (range {it_min}..{it_max}) | first {L} lanes vs "
          f"monte_carlo(impl='reference'): {mc_line} | {mc_ms:.3f} ms/call = "
          f"{MC_B / mc_ms * 1e3:.0f} scenarios/s on {card}", flush=True)
    print(f"[10 profile] B={MC_B}: " + profile_lines(
        lambda: mc_fast(samples), reps=2, kernels={"K4": "propagate_kernel", "K3": "lm_iter_kernel"},
        annotation="uncertainty_sample_batched"), flush=True)

    del res, samples, prior, prior64

    # The full-stack path (cilqr_tpu/benchmark.py:424-449 at full size):
    # CostmapParams() (152x104 cells at 0.2 m, window radius 12), a 256x256
    # float32 global map at 0.5 m centred at (110, -300), the example
    # world's plan and two obstacles (also rasterized into every costmap and
    # checked for collisions), B=8192 egos ego + N(0, 0.3), NoiseParams(),
    # 5 cycles, the band plan of the configured sigmas over the route's
    # corridor bounds.
    cpf = CostmapParams()
    noise = NoiseParams()
    fs_rows, fs_cols = cpf.rows, cpf.cols

    def fs_world(dtype):
        return (gridmap.make_geom([110.0, -300.0], 0.5, 256, 256, dtype),
                torch.tensor([[115.0, -305.0, 0.0], [130.0, -304.0, 0.2]], dtype=dtype, device=dev),
                torch.tensor([3.63, 1.84], dtype=dtype, device=dev),
                torch.ones(2, dtype=dtype, device=dev))

    ggeom, obs_xyyaw, obs_size, obs_mask = fs_world(torch.float32)
    ggeom64, obs_xyyaw64, obs_size64, obs_mask64 = fs_world(torch.float64)
    require(ggeom.center.device == dev, "make_geom left the geometry off the card")
    gmap_np = np.random.default_rng(8).uniform(0.0, 100.0, (256, 256))
    gmap = torch.tensor(gmap_np, dtype=torch.float32, device=dev)
    gmap_zero = torch.zeros_like(gmap)  # the benchmark's global map
    xr, yr = costmap_mod.corridor_center_bounds(cpf, plan, n)
    fs_band = uncertainty_cuda.make_band_plan_bounds(
        cpf, fs_rows, fs_cols, xr, yr, (cpf.sigma_x, cpf.sigma_y, cpf.sigma_theta))
    x0s = torch.tensor(ego.cpu().numpy()[None, :]
                       + np.random.default_rng(9).normal(0, 0.3, (FS_B, 4)),
                       dtype=torch.float32, device=dev)

    # 11. K5 against its plain version: a pure gather and selects, equal on
    # every cell, alone (the resample) and with the overrides (the vehicle
    # map the build launches: bbox, and bbox then semantic).  Poses inside
    # the global map, across its border and wholly outside it, yaws in all
    # four quadrants and at 0, +-pi/2 and +-pi; override layers of values
    # below, at and above 90.
    def k5_poses(B: int, seed: int):
        rng = np.random.default_rng(seed)
        xy = np.stack([rng.uniform(30.0, 190.0, B), rng.uniform(-380.0, -220.0, B)], axis=1)
        yaw = rng.uniform(-math.pi, math.pi, B)
        yaw[:8] = [0.0, math.pi / 2, -math.pi / 2, math.pi, -math.pi, 0.3, 2.0, -2.5]
        # wholly outside: beyond each corner (every cell reads that corner
        # cell) and beyond one edge (every cell reads the border row / column)
        xy[8:14] = [[1e4, 1e4], [-1e4, -1e4], [1e4, -1e4], [-1e4, 1e4], [1e4, -300.0], [110.0, 1e5]]
        centers = np.stack([rng.uniform(5.0, 20.0, B), rng.uniform(-3.0, 3.0, B)], axis=1)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        return costmap_mod.vehicle_geom(cpf, t(centers)), t(xy), t(yaw)

    def k5_layers(B: int, seed: int):
        """bbox and semantic frames, each cell one of 0, 50, 89.99, 90, the
        next float above 90 and 100."""
        vals = torch.tensor([0.0, 50.0, 89.99, 90.0, float(np.nextafter(np.float32(90.0),
                                                                      np.float32(100.0))),
                             100.0], dtype=torch.float32, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        return [vals[torch.randint(0, len(vals), (B, fs_rows, fs_cols), generator=g, device=dev)]
                for _ in range(2)]

    def k5_plain(geoms, xy, yaw, *layers):
        """The plain version over chunks of the scenario axis (whole, its
        int64 indices alone take 2 GB at B=8192); with layers, the overrides."""
        chunk = lambda t, c: t[c:c + K5_PLAIN_CHUNK]
        fn = (sample_cuda.vehicle_map_batched_plain if layers
              else sample_cuda.sample_prior_batched_plain)
        return torch.cat([fn(type(geoms)(*(chunk(t, c) for t in geoms)), fs_rows, fs_cols, gmap,
                             ggeom, chunk(xy, c), chunk(yaw, c), *(chunk(t, c) for t in layers))
                          for c in range(0, xy.shape[0], K5_PLAIN_CHUNK)])

    def k5_check(B: int, seed: int) -> tuple:
        """Both forms at B against the plain version, every cell: (the
        poses, the layers, the lines)."""
        geoms_c, xy_c, yaw_c = k5_poses(B, seed)
        bbox_c, sem_c = k5_layers(B, seed)
        lines = []
        for label, layers in (("resample", ()), ("bbox", (bbox_c,)),
                              ("bbox + semantic", (bbox_c, sem_c))):
            fn = sample_cuda.vehicle_map_batched if layers else sample_cuda.sample_prior_batched
            before = sample_cuda.LAUNCHES
            got_c = fn(geoms_c, fs_rows, fs_cols, gmap, ggeom, xy_c, yaw_c, *layers)
            torch.cuda.synchronize()
            require(sample_cuda.LAUNCHES == before + 1, "K5 launch counter did not move")
            diff = int((got_c != k5_plain(geoms_c, xy_c, yaw_c, *layers)).sum())
            require(diff == 0, f"K5 B={B} {label}: {diff} of {got_c.numel()} cells differ from the "
                    "plain version")
            if not layers:
                edge = int(((got_c == gmap[0, 0]) | (got_c == gmap[-1, -1]) | (got_c == gmap[0, -1])
                            | (got_c == gmap[-1, 0])).all(dim=(1, 2)).sum())
                require(edge >= 4, "K5: the poses wholly outside the map did not read its corner "
                        "cells")
                lines.append(f"{label} {diff} differ ({edge} poses read only corner cells)")
            else:
                kept = float((got_c == bbox_c).double().mean())
                lines.append(f"{label} {diff} differ ({100 * kept:.1f}% of cells from bbox)")
            del got_c
        return (geoms_c, xy_c, yaw_c), (bbox_c, sem_c), lines

    _, _, lines5 = k5_check(K5_CHECK_B, seed=10)
    (geomsM5, xyM5, yawM5), (bboxM5, semM5), linesM5 = k5_check(FS_B, seed=11)
    resample = lambda: sample_cuda.sample_prior_batched(geomsM5, fs_rows, fs_cols, gmap, ggeom,
                                                        xyM5, yawM5)
    fused = lambda: sample_cuda.vehicle_map_batched(geomsM5, fs_rows, fs_cols, gmap, ggeom, xyM5,
                                                    yawM5, bboxM5)
    # the build's vehicle map before the overrides were fused into K5: the
    # resample, then the bbox override as its own PyTorch pass
    unfused = lambda: torch.where(bboxM5 > 90.0, bboxM5, resample())
    require(torch.equal(fused(), unfused()), "K5: the fused form differs from resample + where")
    # the old and the new form in turns (old, new, new, old), one call
    turns = [("unfused", unfused), ("fused", fused), ("fused", fused), ("unfused", unfused)]
    turn_ms = {"unfused": [], "fused": []}
    for label, fn in turns:
        turn_ms[label].append(cuda_ms(fn, 5))
    k5f_ms, k5_unfused_ms = (sum(v) / len(v) for v in (turn_ms["fused"], turn_ms["unfused"]))
    k5_ms, gotM5 = timed(resample, 5)
    k5_kernel_ms, k5_other_ms, _ = kernel_profile(resample, 5, "sample_kernel")
    k5f_kernel_ms, _, _ = kernel_profile(fused, 5, "sample_kernel")
    k5_plain_ms, wantM5 = timed(lambda: k5_plain(geomsM5, xyM5, yawM5), 1)
    k5f_plain_ms = cuda_ms(lambda: k5_plain(geomsM5, xyM5, yawM5, bboxM5), 1)
    require(torch.equal(gotM5, wantM5), f"K5 B={FS_B}: the timed output differs from the plain "
            "version")
    k5_err = float((gotM5 - wantM5).abs().max())
    del wantM5
    # the library call: one grid_sample, nearest cell, border padding, over
    # the cell positions the plain version computes, as pixel coordinates of
    # the map (cell centres at integers; align_corners=True), built here
    # outside the timed window.  Its rounding to the nearest centre and the
    # plain version's floor of the edge-based index differ on ties.
    xs5, ys5 = gridmap.cell_positions(geomsM5, fs_rows, fs_cols)
    c5, s5 = torch.cos(yawM5)[:, None, None], torch.sin(yawM5)[:, None, None]
    gx5 = xs5[:, :, None] * c5 - ys5[:, None, :] * s5 + xyM5[:, 0, None, None]
    gy5 = xs5[:, :, None] * s5 + ys5[:, None, :] * c5 + xyM5[:, 1, None, None]
    top5 = ggeom.center + 0.5 * ggeom.length
    H5, W5 = gmap.shape
    u5 = (top5[0] - gx5) / ggeom.resolution - 0.5
    v5 = (top5[1] - gy5) / ggeom.resolution - 0.5
    grid5 = torch.stack([2.0 * v5 / (W5 - 1) - 1.0, 2.0 * u5 / (H5 - 1) - 1.0],
                        dim=-1).reshape(1, FS_B * fs_rows, fs_cols, 2)
    del xs5, ys5, gx5, gy5, u5, v5
    k5_lib_ms, lib5 = timed(lambda: torch.nn.functional.grid_sample(
        gmap[None, None], grid5, mode="nearest", padding_mode="border", align_corners=True), 5)
    lib_diff = int((lib5.reshape(gotM5.shape) != gotM5).sum())
    del grid5, lib5
    # bounds: the map and 32 bytes per scenario (first, ego x/y, cos, sin,
    # resolution) in, B x 152 x 104 floats out; 20 operations per cell.
    # Fused: bbox in as well, and a compare and a select per cell.
    k5_bound = bound(nbytes(gmap) + FS_B * 32 + nbytes(gotM5), 20 * gotM5.numel())
    k5f_bound = bound(nbytes(gmap) + FS_B * 32 + nbytes(bboxM5, gotM5), 22 * gotM5.numel())
    k5_bound["library_ms"] = k5_lib_ms
    kernels["sample"] = dict(
        name="sample_prior", route="cuda", source="cilqr_tpu_torch/csrc/sample.cu",
        replaces="cilqr_tpu/ops/sample_pallas.py:236",
        also_replaces=["cilqr_tpu/ops/sample_pallas.py:165", "cilqr_tpu/ops/sample_pallas.py:174"],
        max_abs_err=k5_err, ms=k5_ms, kernel_only_ms=k5_kernel_ms, plain_ms=k5_plain_ms,
        **k5_bound, library_cells_differing=lib_diff,
        vehicle_map=dict(ms=k5f_ms, kernel_only_ms=k5f_kernel_ms, plain_ms=k5f_plain_ms,
                         unfused_ms=k5_unfused_ms, turns_ms=turn_ms, **k5f_bound))
    print(f"[11 K5 sample] B={K5_CHECK_B}: {' | '.join(lines5)} | B={FS_B}: {' | '.join(linesM5)} "
          f"| resample: wrapper {k5_ms:.3f} ms, kernel alone {k5_kernel_ms:.3f} ms (other device "
          f"kernels {k5_other_ms:.3f} ms), plain (chunks of {K5_PLAIN_CHUNK}) "
          f"{k5_plain_ms:.3f} ms, bound {k5_bound['bound_ms']:.3f} ms by {k5_bound['bound_by']}, grid_sample "
          f"{k5_lib_ms:.3f} ms ({lib_diff} of {gotM5.numel()} cells differ) | vehicle map (bbox "
          f"fused, what the build launches): {k5f_ms:.3f} ms, kernel alone {k5f_kernel_ms:.3f} ms, "
          f"plain {k5f_plain_ms:.3f} ms, bound {k5f_bound['bound_ms']:.3f} ms by "
          f"{k5f_bound['bound_by']} | resample + torch.where (the build before fusing) "
          f"{k5_unfused_ms:.3f} ms | in turns (ms): unfused {turn_ms['unfused']}, fused "
          f"{turn_ms['fused']}", flush=True)
    del gotM5, geomsM5, bboxM5, semM5

    # 12. the costmap build at B=8192: the layers kernel once, K5 once, K4
    # once (per-scenario priors, frames and yaws).  Against the same build on
    # the plain versions: the corridor mask, the box layer and the vehicle
    # map (a gather and two overrides) exactly, the uncertainty map at K4's
    # bar; lane 0 against the single-scenario build in float64.
    def fs_build(states, **kw):
        return costmap_mod.build_local_costmap_batched(
            cpf, gmap, ggeom, plan, n, states, obs_xyyaw[:, :2], obs_size.expand(2, 2),
            obs_xyyaw[:, 2], obs_mask, band_plan=fs_band, **kw)

    def build_counts():
        return {"costmap": costmap_cuda.LAUNCHES, "sample": sample_cuda.LAUNCHES,
                "uncertainty": uncertainty_cuda.LAUNCHES}

    costmap_cuda.LAUNCHES = sample_cuda.LAUNCHES = uncertainty_cuda.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    layer_terms = []
    with recording(costmap_cuda, "_launch", layer_terms, keep=lambda out, args, kw: args):
        cm = fs_build(x0s)
    torch.cuda.synchronize()
    build_launches = build_counts()
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    require(build_launches == {"costmap": 1, "sample": 1, "uncertainty": 1},
            f"costmap build launches {build_launches}, expected the layers kernel, K5 and K4 "
            "once each")
    require(len(layer_terms) == 1, f"the build called the layers wrapper {len(layer_terms)} times")
    with route.plain():
        cm_plain = fs_build(x0s)
    require(build_launches == build_counts(), "the plain build launched a kernel")
    for f in ("corridor_mask", "bounding_box_map", "vehicle_map"):
        require(torch.equal(getattr(cm, f), getattr(cm_plain, f)),
                f"costmap build: {f} differs from the plain build")
    err12, excess12 = max_excess(cm.uncertainty_map, cm_plain.uncertainty_map, rtol=2e-5, atol=2e-4)
    require(excess12 <= 0.0, f"costmap build: uncertainty map off by {err12:.3e}, beyond 2e-5 rel "
            "+ 2e-4 abs")
    require(float(cm.uncertainty_map.min()) >= 0.0 and float(cm.uncertainty_map.max()) <= 100.0,
            "costmap build: uncertainty map outside [0, 100]")
    bbox_cells = int((cm.bounding_box_map[0] > 0).sum())
    require(bbox_cells > 0, "costmap build: no obstacle cell in lane 0")
    cm64 = costmap_mod.build_local_costmap(
        cpf, gmap.double(), ggeom64, plan64, n64, x0s[0].double(), obs_xyyaw64[:, :2],
        obs_size64.expand(2, 2), obs_xyyaw64[:, 2], obs_mask64)
    # float32 and float64 put a few cells of the rotated gather on the other
    # side of a floor; elsewhere the layers agree
    same_cells = float((cm.vehicle_map[0].double() == cm64.vehicle_map).double().mean())
    require(same_cells >= 0.99, f"costmap build: lane 0 shares {100 * same_cells:.2f}% of its "
            "vehicle map with the float64 build")
    same = cm.vehicle_map[0].double() == cm64.vehicle_map
    k_dev = float((cm.uncertainty_map[0].double() - cm64.uncertainty_map).abs().mean())
    p_dev = float((cm_plain.uncertainty_map[0].double() - cm64.uncertainty_map).abs().mean())
    require(k_dev <= 2.0 * p_dev + 1e-4, f"costmap build: lane 0 mean |kernel - float64| "
            f"{k_dev:.3e}, float32 plain {p_dev:.3e}")
    build_ms = cuda_ms(lambda: fs_build(x0s), 2)
    fs_k4_call = lambda: uncertainty_cuda.propagate_uncertainty_banded(
        cpf, cm.vehicle_map, cm.geom, cm.origin_yaw, None, fs_band)
    k4_fs_ms = cuda_ms(fs_k4_call, 2)
    # the fused form holds no (B, rows, cols) field tensor and runs no
    # PyTorch kernel over cells: beyond its output the call allocates next to
    # nothing, and its other device kernels (the scenario table, (B,)-sized)
    # take next to no time
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out_fs = fs_k4_call()
    torch.cuda.synchronize()
    k4_call_mem = torch.cuda.max_memory_allocated() - base_mem
    require(k4_call_mem <= nbytes(out_fs) + 16e6,
            f"propagate_uncertainty_banded allocated {k4_call_mem / 1e6:.1f} MB for an output of "
            f"{nbytes(out_fs) / 1e6:.1f} MB: a field tensor?")
    del out_fs
    k4_fs_kernel_ms, k4_fs_other_ms, k4_fs_events = kernel_profile(fs_k4_call, 2, "propagate_kernel")
    require(k4_fs_other_ms <= 0.05 * k4_fs_kernel_ms + 0.2,
            f"the fused call's other kernels take {k4_fs_other_ms:.3f} ms: an elementwise pass "
            "over cells?")
    fields_fs_ms, fields_fs = timed(lambda: uncertainty_cuda.prep_fields(
        cpf, cm.geom, cm.origin_yaw, None, False, fs_rows, fs_cols), 2)
    k4_fs_given_ms, given_fs = timed(lambda: uncertainty_cuda.propagate_banded(
        cpf, cm.vehicle_map, fields_fs, fs_band.bands, fs_band.disc_radii), 2)
    require(torch.equal(given_fs, cm.uncertainty_map), "full-stack K4: the fused form differs "
            "from the fields-given form")
    del given_fs
    fs_k4_bound = k4_bound(cpf, cm.vehicle_map, fields_fs, fused=True)
    fs_given_bound = k4_bound(cpf, cm.vehicle_map, fields_fs)
    kernels["uncertainty"]["full_stack"] = dict(
        ms_with_fields=k4_fs_ms, kernel_only_ms=k4_fs_kernel_ms, max_abs_err=err12, **fs_k4_bound,
        fields_given=dict(ms=k4_fs_given_ms, prep_fields_ms=fields_fs_ms, **fs_given_bound))
    print(f"[12 costmap build] B={FS_B}: launches {build_launches} | corridor mask, box layer "
          f"and vehicle map equal to the plain build on every cell | uncertainty map max|kernel-plain| {err12:.3e} (bar 2e-5 rel + "
          f"2e-4 abs) | lane 0 vs float64 build_local_costmap: {100 * same_cells:.2f}% of vehicle-"
          f"map cells equal, mean |uncertainty - float64| kernel {k_dev:.3e} plain {p_dev:.3e} | "
          f"{bbox_cells} obstacle cells in lane 0 | {len(fs_band.bands)} bands, radii "
          f"{[R for (_, _, R) in fs_band.bands]} | build {build_ms:.3f} ms, of which fields + K4 "
          f"{k4_fs_ms:.3f} ms (fused: the kernel alone {k4_fs_kernel_ms:.3f} ms, "
          f"{k4_fs_events - 1:.0f} other device kernels {k4_fs_other_ms:.3f} ms, "
          f"{k4_call_mem / 1e6:.1f} MB allocated by the call; bound "
          f"{fs_k4_bound['bound_ms']:.3f} ms by {fs_k4_bound['bound_by']}) | fields given: kernel "
          f"{k4_fs_given_ms:.3f} ms after prep_fields {fields_fs_ms:.3f} ms, bound "
          f"{fs_given_bound['bound_ms']:.3f} ms by {fs_given_bound['bound_by']} | peak memory of "
          f"the build {build_peak:.2f} GB", flush=True)
    del cm, cm_plain, cm64, fields_fs, same

    # the layers kernel alone on the build's own terms at B=8192 (the
    # corridor bounds, cell centres, obstacle corners and flags the build
    # formed): equal to its plain version on every cell of both layers, and
    # timed against it.  Bound: the terms read once and the two maps written
    # once; per cell 4 compares for the corridor and, per obstacle edge, a
    # product, two subtractions and two compares.  Timed by CUDA events over
    # back-to-back calls, with the host's seconds to issue them beside: where
    # the host issues faster than the card runs, the events time the kernel.
    # (torch.profiler's kernel time for this kernel read below its byte bound.)
    (terms12,) = layer_terms
    layers_call = lambda: costmap_cuda.costmap_layers(*terms12)
    got12 = layers_call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(LAYERS_REPS):
        layers_call()
    end.record()
    layers_issue_ms = (time.perf_counter() - t0) * 1e3 / LAYERS_REPS
    torch.cuda.synchronize()
    layers_ms = start.elapsed_time(end) / LAYERS_REPS
    layers_plain_ms, want12 = timed(lambda: costmap_cuda.costmap_layers_plain(*terms12), 2)
    for f, g, w in zip(("corridor mask", "box layer"), got12, want12):
        require(torch.equal(g, w), f"layers kernel B={FS_B}: {int((g != w).sum())} cells of the "
                f"{f} differ from the plain version")
    n_obs = terms12[3].shape[-3]
    layers_bound = bound(nbytes(*terms12) + nbytes(*got12), got12[0].numel() * (4 + 20 * n_obs))
    box_cells = int((got12[1] > 0).sum())
    corridor_share = float(got12[0].double().mean())
    kernels["costmap"] = dict(
        name="costmap_layers", route="cuda", source="cilqr_tpu_torch/csrc/costmap.cu",
        replaces="none: the corridor mask and rasterize_obstacles of cilqr_tpu/ops/costmap.py, "
                 "which XLA fuses on the chip",
        max_abs_err=0.0, ms=layers_ms, host_issue_ms=layers_issue_ms, plain_ms=layers_plain_ms,
        **layers_bound, library_ms=NO_LIBRARY_CALL, timed=f"B={FS_B}, {n_obs} obstacles")
    print(f"[12 costmap layers] B={FS_B} frames of {fs_rows} x {fs_cols}, {n_obs} obstacles "
          f"(the build's terms): corridor mask ({100 * corridor_share:.1f}% of cells) and box "
          f"layer ({box_cells} cells) equal to the plain version on every cell | wrapper "
          f"{layers_ms:.3f} ms a call over {LAYERS_REPS} back-to-back calls (the host issued "
          f"each in {layers_issue_ms:.3f} ms), plain {layers_plain_ms:.3f} ms, bound "
          f"{layers_bound['bound_ms']:.3f} ms by {layers_bound['bound_by']} on {card}", flush=True)
    del layer_terms, terms12, got12, want12

    # 13. the full-stack path: closed_loop_full_stack_batched at B=8192,
    # 5 cycles.  Per cycle it launches the layers kernel once, K5 once, K4
    # once and K3 once per LM iteration of the slowest lane; never K1 or K2.
    fs_draws = torch.randn((FS_CYCLES, FS_B, 3), dtype=torch.float32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(12))

    def full_stack(gm, states, draws, dtype=torch.float32, **kw):
        if dtype == torch.float64:
            world = (gm.double(), ggeom64, plan64, n64)
            obs = dict(obstacles=obstacles64, obs_xyyaw=obs_xyyaw64, obs_size=obs_size64,
                       obs_mask=obs_mask64)
        else:
            world = (gm, ggeom, plan, n)
            obs = dict(obstacles=obstacles, obs_xyyaw=obs_xyyaw, obs_size=obs_size,
                       obs_mask=obs_mask)
        return plant.closed_loop_full_stack_batched(
            p, cpf, noise, *world, states.to(dtype), None, draws.shape[0], band_plan=fs_band,
            global_res=0.5, noise_draws=draws, **obs, **kw)

    def zero_counts():
        lm_cuda.LAUNCHES = lm_cuda.ITER_LAUNCHES = costmap_cuda.LAUNCHES = 0
        riccati_cuda.LAUNCHES = uncertainty_cuda.LAUNCHES = sample_cuda.LAUNCHES = 0
        cost_cuda.LAUNCHES = 0

    def read_counts():
        return {"costmap": costmap_cuda.LAUNCHES, "sample": sample_cuda.LAUNCHES,
                "uncertainty": uncertainty_cuda.LAUNCHES,
                "lm_iter": lm_cuda.ITER_LAUNCHES, "lm": lm_cuda.LAUNCHES,
                "riccati": riccati_cuda.LAUNCHES, "cost": cost_cuda.LAUNCHES}

    fs_lines = []
    for label, gm in (("all-zero map", gmap_zero), ("random map", gmap)):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        xf, rec = full_stack(gm, x0s, fs_draws)
        torch.cuda.synchronize()
        fs_launches = read_counts()
        fs_peak = torch.cuda.max_memory_allocated() / 1e9
        it_max = [int(v) for v in rec["iterations"].amax(dim=1)]
        require(fs_launches == {"costmap": FS_CYCLES, "sample": FS_CYCLES,
                                "uncertainty": FS_CYCLES, "lm_iter": sum(it_max), "lm": 0,
                                "riccati": 0, "cost": 0},
                f"full-stack launches {fs_launches} on the {label}, expected the layers kernel, "
                f"K5 and K4 once per cycle, K3 {it_max} per cycle, K1 and K2 never")
        require("hybrid" in loop_kinds(FS_B), f"full stack: the graphed loops are {loop_kinds()}")
        require(all(bool(torch.isfinite(v.float()).all()) for v in rec.values())
                and bool(torch.isfinite(xf).all()), f"non-finite record on the {label}")
        require(tuple(rec["start_pos"].shape) == (FS_CYCLES, FS_B, 4)
                and tuple(rec["J"].shape) == (FS_CYCLES, FS_B) and tuple(xf.shape) == (FS_B, 4),
                "full-stack record shapes")
        require(1 <= int(rec["iterations"].min()) and max(it_max) <= p.max_iterations,
                f"iterations outside [1, {p.max_iterations}] on the {label}")
        require(float(rec["uncertainty_max"].min()) >= 0.0
                and float(rec["uncertainty_max"].max()) <= 100.0,
                f"uncertainty_max outside [0, 100] on the {label}")
        progress = float((xf[:, 0] - x0s[:, 0]).mean())
        require(progress > 0.5, f"the egos did not advance on the {label}: {progress:.3f} m")
        fs_ms = cuda_ms(lambda: full_stack(gm, x0s, fs_draws), 2)
        mean_it = [round(float(v), 2) for v in rec["iterations"].float().mean(dim=1)]
        fs_lines.append(
            f"{label}: launches {fs_launches} (K3 per cycle {it_max}) | mean iterations per cycle "
            f"{mean_it} | uncertainty_max up to {float(rec['uncertainty_max'].max()):.1f} | "
            f"collisions {int(rec['collided'].sum())} | mean advance {progress:.2f} m | "
            f"{fs_ms:.3f} ms/call = {FS_CYCLES * FS_B / fs_ms * 1e3:.0f} cycles/s | peak memory "
            f"{fs_peak:.2f} GB")
    for ln in fs_lines:
        print(f"[13 full-stack path] B={FS_B} N={HORIZON} {FS_CYCLES} cycles, {ln} on {card}",
              flush=True)

    # The first 64 lanes, cycle by cycle, against the same loop on the plain
    # versions with the same noise (``hold_loop``).  On the benchmark's
    # all-zero map (only the obstacles' smeared boxes) the lanes stay calm
    # through all 5 cycles; on the random map about a third turn chaotic per
    # cycle, so it is held for 2 cycles.
    L = FS_REF_LANES

    def captured(gm):
        def run(states, draws, dtype, use_kernels):
            """The loop's per-cycle solve results (X, U, iterations, J,
            lamb), taken through the plan_step_batched hook around the
            default solve."""
            world = (plan64, n64, obstacles64) if dtype == torch.float64 else (plan, n, obstacles)
            out = []

            def step(noisy, U_warm, umaps):
                r = solver_batched.run_steps_batched(
                    p, world[0], world[1], noisy, U_warm.contiguous(), world[2], umaps,
                    impl="mega", world_batched=True)
                out.append(pick(r))
                return r

            full_stack(gm, states, draws, dtype, plan_step_batched=step, use_kernels=use_kernels)
            return out
        return run

    for label, gm, cycles in (("all-zero map", gmap_zero, FS_CYCLES), ("random map", gmap, 2)):
        sub_launches, got_c, line = hold_loop(f"full-stack, {label}", captured(gm), x0s[:L],
                                              fs_draws[:cycles, :L], (zero_counts, read_counts))
        require(sub_launches == {"costmap": cycles, "sample": cycles, "uncertainty": cycles,
                                 "lm": 0, "riccati": 0, "cost": 0,
                                 "lm_iter": sum(int(g[2].max()) for g in got_c)},
                f"the {L}-lane run launched {sub_launches}")
        print(f"[13 lanes] {label}, first {L} lanes vs the loop on the plain versions: {line}",
              flush=True)
    del got_c
    print(f"[13 profile] B={FS_B}: " + profile_lines(
        lambda: full_stack(gmap, x0s, fs_draws), reps=1,
        kernels={"K5": "sample_kernel", "K4": "propagate_kernel", "K3": "lm_iter_kernel"},
        annotation="uncertainty_sample_batched"), flush=True)

    # closed_loop_batched: one shared map, K1 once per cycle, the JAX
    # benchmark's 10 cycles at B=32768
    egos_cl, _ = scenario_batch(MAIN_B, seed=13)
    cl_draws = torch.randn((CL_CYCLES, MAIN_B, 3), dtype=torch.float32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(14))

    def closed_loop():
        return plant.closed_loop_batched(p, noise, plan, n, egos_cl, None, CL_CYCLES, obstacles, unc,
                                         obs_xyyaw, obs_size, obs_mask, noise_draws=cl_draws)

    zero_counts()
    xf_cl, rec_cl = closed_loop()
    torch.cuda.synchronize()
    cl_launches = read_counts()
    require(cl_launches == {"costmap": 0, "sample": 0, "uncertainty": 0, "lm_iter": 0,
                            "lm": CL_CYCLES, "riccati": 0, "cost": 0},
            f"closed_loop_batched launches {cl_launches}")
    require(bool(torch.isfinite(xf_cl).all()) and bool(torch.isfinite(rec_cl["J"]).all())
            and 1 <= int(rec_cl["iterations"].min())
            and int(rec_cl["iterations"].max()) <= p.max_iterations, "closed_loop_batched record")
    cl_ms = cuda_ms(closed_loop, 2)
    # the perception channel: obstacle 0 moves, is seen by the camera only,
    # tracked per scenario and painted into the semantic layer
    PB = 256
    percept = perception.PerceptionSim(0, torch.tensor([0.5, 0.0], device=dev), bbox_sigma=0.3)
    xf_p, rec_p = plant.closed_loop_full_stack_batched(
        p, cpf, noise, gmap, ggeom, plan, n, x0s[:PB], torch.Generator(device=dev).manual_seed(15),
        3, obstacles=obstacles, obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
        band_plan=fs_band, percept=percept)
    require(all(bool(torch.isfinite(v.float()).all()) for v in rec_p.values())
            and bool(torch.isfinite(xf_p).all()), "non-finite record with percept")
    valid_share = float(rec_p["bbox_valid"].float().mean())
    require(valid_share > 0.5 and float(rec_p["semantic_max"].max()) == 100.0,
            f"percept: {100 * valid_share:.1f}% valid boxes, semantic_max "
            f"{float(rec_p['semantic_max'].max())}")
    print(f"[13 other loops] closed_loop_batched B={MAIN_B} {CL_CYCLES} cycles: launches "
          f"{cl_launches} | mean iterations {float(rec_cl['iterations'].float().mean()):.2f} | "
          f"{cl_ms:.3f} ms/call = {CL_CYCLES * MAIN_B / cl_ms * 1e3:.0f} cycles/s | percept B={PB} "
          f"3 cycles: finite, bbox_valid {100 * valid_share:.1f}%, semantic_max "
          f"{float(rec_p['semantic_max'].max()):.0f}", flush=True)
    del egos_cl, cl_draws, rec_cl, rec_p

    # 14. K6, the op-throughput probe: every body against its plain version
    # at a small depth (1e-5 rel + 1e-5 abs; the exp body 1e-4: the kernel
    # contracts a multiply-add that PyTorch rounds twice), then the report.
    # The select body flips the sign of a where b crosses a threshold; an
    # element whose float64 chain passes within 1e-4 of it may flip in one
    # float32 version and not the other, and is left out.
    n6 = torch.cuda.get_device_properties(dev).multi_processor_count * 2048 * opbench.WAVES
    x6 = opbench.probe_input(n6, seed=16)
    require(x6.device == dev, "probe_input left the probe off the card")
    k6_err, k6_lines = 0.0, []
    for body in opbench.BODIES:
        before = opbench.LAUNCHES
        got6 = opbench.opchain(body, K6_CHECK_ROUNDS, x6)
        torch.cuda.synchronize()
        require(opbench.LAUNCHES == before + 1, "K6 launch counter did not move")
        want6 = opbench.opchain_plain(body, K6_CHECK_ROUNDS, x6)
        tol = 1e-4 if body == "exp" else 1e-5
        left_out = 0
        if body == "sel":
            robust = opbench.sel_margin(K6_CHECK_ROUNDS, x6) > 1e-4
            left_out = int((~robust).sum())
            require(left_out <= n6 // 100, f"K6 sel: {left_out} elements near a threshold")
            got6, want6 = got6[:, robust], want6[:, robust]
        err, excess = max_excess(got6, want6, rtol=tol, atol=tol)
        require(excess <= 0.0, f"K6 {body}: max |diff| {err:.3e} beyond {tol:g} rel + {tol:g} abs")
        k6_err = max(k6_err, err)
        k6_lines.append(f"{body} {err:.2e}" + (f" ({left_out} left out)" if left_out else ""))
    opbench.LAUNCHES = 0
    report = opbench.measure()
    k6_launches = opbench.LAUNCHES
    r0 = report["rounds"][0]
    k6_plain_ms = cuda_ms(lambda: opbench.opchain_plain("rot", r0, x6), 1)
    # bound of the rotation body at the report's first depth: the pairs
    # read and written once; 6 operations per round (2 multiplies, 2 fused
    # multiply-adds)
    k6_bound = bound(2 * nbytes(x6), 6.0 * r0 * n6)
    kernels["opchain"] = dict(
        name="opchain", route="cuda", source="cilqr_tpu_torch/csrc/opchain.cu",
        replaces="scripts/microbench_vpu.py:57", max_abs_err=k6_err,
        ms=report["kernels"]["rot"]["t_r0_us"] / 1e3, plain_ms=k6_plain_ms, **k6_bound,
        library_ms=NO_LIBRARY_CALL,
        launches=k6_launches, path="utils.opbench.measure(), phase 14",
        timed_body=f"rot, {r0} rounds, {n6} elements")
    c6 = report["constants"]
    print(f"[14 K6 opchain] {n6} elements, {K6_CHECK_ROUNDS} rounds, max|kernel-plain|: "
          + ", ".join(k6_lines) + f" | report ({k6_launches} launches, grid "
          f"{report['grid']['blocks']} x {report['grid']['threads_per_block']}, depths "
          f"{report['rounds']}): mul {c6['mul_ops_per_s']:.4g} op/s, fma "
          f"{c6['fma_flops_per_s']:.4g} FLOP/s = {100 * c6['fma_share_of_published_fp32_peak']:.1f}% "
          f"of the published {PEAK_TFLOPS:.0f} TFLOP/s, fma/mul {c6['fma_vs_mul']:.2f}, rot "
          f"{c6['rot_slots_check']:.2f} slots, cmp+select {c6['cmp_select_slots']:.2f}, expf "
          f"{c6['exp_slots']:.2f}, shuffle gather {c6['shuffle_gather_slots']:.2f}, shuffle roll "
          f"{c6['shuffle_roll_slots']:.2f}, shared-memory transpose "
          f"{c6['smem_transpose_slots']:.2f} | rot at {r0} rounds: kernel "
          f"{kernels['opchain']['ms']:.3f} ms, plain {k6_plain_ms:.3f} ms, bound "
          f"{k6_bound['bound_ms']:.3f} ms by {k6_bound['bound_by']}", flush=True)
    print("[14 report] " + json.dumps(report), flush=True)

    # 15. the experiment layer: the CLI's run, compare and sweep
    exp_launches, exp_algos = experiment_layer(card, (zero_counts, read_counts), dev)
    for name in ("lm", "riccati", "lm_iter", "uncertainty", "sample", "costmap"):
        kernels[name]["experiment_launches"] = {cmd: c[name] for cmd, c in exp_launches.items()}
        kernels[name]["experiment_launches_by_algorithm"] = {
            cmd: {a: v["launches"][name] for a, v in by.items() if v["launches"][name]}
            for cmd, by in exp_algos.items()}

    # 16. the scale-out layer (sharded solve, Monte-Carlo, full stack,
    # campaign, dry run) and the pscan option at B=1
    so = scale_out(card, (zero_counts, read_counts), dev)
    kernels["lm"]["sharded_solve_launches_by_shards"] = so["solve"]
    for name in ("uncertainty", "lm_iter"):
        kernels[name]["sharded_mc_launches_by_shards"] = {k: v[name] for k, v in so["mc"].items()}
    for name in ("sample", "uncertainty", "lm_iter", "costmap"):
        kernels[name]["sharded_full_stack_launches"] = so["full_stack"][name]

    # 17. the benchmark driver at its defaults, and its trace
    bench, bench_line = benchmark_phase(card, (zero_counts, read_counts), dev, main_mean_it)
    for name in ("lm", "riccati", "lm_iter", "uncertainty", "sample", "costmap"):
        kernels[name]["benchmark_launches"] = {
            section: launches[name] for section, launches in bench.items() if launches[name]}

    # 18. the plain LM loop as CUDA graphs against its eager loop
    graph_phase(card, (zero_counts, read_counts), dev)

    # 19. the JAX package's programs on the port, cut small
    script_launches = scripts_phase(card, (zero_counts, read_counts), dev)
    for name in ("lm_iter", "uncertainty", "sample", "costmap"):
        kernels[name]["scripts_launches"] = {k: v[name] for k, v in script_launches.items()}

    # 20. the hybrid (K3) and two-phase (K2) LM loops as CUDA graphs against
    # their eager loops, at the paths' own shapes
    t_phase = time.perf_counter()
    prior, geom, origin_xy, origin_yaw = mc_world(torch.float32)
    samples = mc.sample_scenarios(torch.Generator().manual_seed(0), MC_B, ego.cpu(),
                                  sigma_hi=SIGMA_HI, device=dev)
    counts = (zero_counts, read_counts)
    loops = {
        "mc": loop_path(f"monte_carlo B={MC_B}", lambda: mc_fast(samples), counts, card, "hybrid",
                        slope=(lambda a: mc_fast(mc.MCSample(*a)), lambda i: (
                            samples.sigmas * (1.0 + 1e-7 * (i + 1)), samples.egos), MC_B, 4)),
        "full_stack": loop_path(
            f"full stack B={FS_B} x {FS_CYCLES} cycles", lambda: full_stack(gmap, x0s, fs_draws),
            counts, card, "hybrid", slope=(lambda x: full_stack(gmap_zero, x, fs_draws),
                                           lambda i: x0s + 1e-5 * (i + 1), FS_CYCLES * FS_B, 3)),
        "two_phase": loop_path(f"two_phase B={K2_CHECK_B}", lambda: solver_batched.run_steps_batched(
            p, plan, n, e4, u4, obstacles, unc, impl="two_phase"), counts, card, "two_phase"),
    }
    loops["compare"] = compare_loops(card, counts, dev)
    bench_rates = {k: bench_line[k] for k in ("mc_scenarios_per_sec", "full_stack_cycles_per_sec")}
    print(f"[20 bench] phase 17's bench (graphed loops): {json.dumps(bench_rates)} | this phase's "
          f"slope (the benchmark's method, same call) graphed / eager: mc_scenarios_per_sec "
          f"{loops['mc']['rate']['graphed']:.1f} / {loops['mc']['rate']['eager']:.1f}, "
          f"full_stack_cycles_per_sec {loops['full_stack']['rate']['graphed']:.1f} / "
          f"{loops['full_stack']['rate']['eager']:.1f} on {card}", flush=True)
    # the condition's runs on this slice's path: the hybrid loop of the
    # Monte-Carlo path on the device loop (counts zeroed just before it)
    condition["launches"] = loops["mc"]["condition_runs"]
    condition["path"] = "monte_carlo(impl='fast') on the device loop, phase 20"
    condition["device_loop_runs"] = {k: v["condition_runs"] for k, v in loops.items()
                                     if "condition_runs" in v}
    for name, paths in (("lm_iter", {"mc": loops["mc"]["streams"],
                                     "full_stack": loops["full_stack"]["streams"],
                                     "compare_cilqr": loops["compare"]["streams"]["cilqr"]}),
                        ("riccati", {"two_phase": loops["two_phase"]["streams"],
                                     "compare_ccnmpc": loops["compare"]["streams"]["ccnmpc"]})):
        kernels[name]["graphed_loops"] = {k: dict(
            B=v["B"], kernels_per_replay=v["kernels_per_replay"],
            ms_per_replay=v["replay_ms"][solver.STREAMS], ms_per_replay_one_stream=v["replay_ms"][1])
            for k, v in paths.items()}
    print(f"[20 done] phase 20 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)

    # 21. the K1 solve and the closed loops' stages as CUDA graphs against
    # their eager calls, at the paths' own shapes
    t_phase = time.perf_counter()
    egos_m, U0_m = scenario_batch(MAIN_B, seed=2)
    egos_cl, _ = scenario_batch(MAIN_B, seed=13)
    cl_draws = torch.randn((CL_CYCLES, MAIN_B, 3), dtype=torch.float32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(14))
    mega = lambda e, u: solver_batched.run_steps_batched(p, plan, n, e, u, obstacles, unc)
    stages = {
        "mega_b1": graph_path("mega B=1", lambda: mega(egos_m[:1], U0_m[:1]), counts, card),
        "mega": graph_path(f"mega B={MAIN_B}", lambda: mega(egos_m, U0_m), counts, card),
        "closed_loop": graph_path(
            f"closed_loop_batched B={MAIN_B} x {CL_CYCLES} cycles",
            lambda: plant.closed_loop_batched(p, noise, plan, n, egos_cl, None, CL_CYCLES,
                                              obstacles, unc, obs_xyyaw, obs_size, obs_mask,
                                              noise_draws=cl_draws), counts, card),
        "mc": graph_path(f"monte_carlo B={MC_B}", lambda: mc_fast(samples), counts, card,
                         loops=True),
        "full_stack": graph_path(f"full stack B={FS_B} x {FS_CYCLES} cycles",
                                 lambda: full_stack(gmap, x0s, fs_draws), counts, card,
                                 loops=True),
    }
    want21 = {"mega_b1": dict(lm=1), "mega": dict(lm=1), "closed_loop": dict(lm=CL_CYCLES),
              "mc": dict(uncertainty=1, costmap=0),
              "full_stack": dict(costmap=FS_CYCLES, sample=FS_CYCLES, uncertainty=FS_CYCLES)}
    for k, want in want21.items():
        got = {name: stages[k]["launches"][name] for name in want}
        require(got == want, f"phase 21 {k}: launches {stages[k]['launches']}, expected {want}")
    kernels["lm"]["graphed_solve"] = {k: dict(
        graphed_ms=stages[k]["graphed_ms"], eager_ms=stages[k]["eager_ms"],
        kernels_per_replay=stages[k]["kernels_per_replay"]) for k in ("mega_b1", "mega",
                                                                      "closed_loop")}
    for name, k in (("uncertainty", "mc"), ("sample", "full_stack"), ("costmap", "full_stack")):
        kernels[name]["graphed_stages"] = dict(
            graphed_ms=stages[k]["graphed_ms"], eager_ms=stages[k]["eager_ms"],
            kernels_per_replay=stages[k]["kernels_per_replay"])
    del egos_m, U0_m, egos_cl, cl_draws
    print(f"[21 done] phase 21 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)

    # 22. the CCNMPC campaign of the benchmark's deployment, graphed against
    # eager, and K2 on one of its rounds' derivatives
    cc = kernels["riccati"]["ccnmpc_campaign"] = ccnmpc_campaign(card, counts, dev)
    kernels["cost_derivs"] = dict(cc["cost_kernel"], **cost_profile,
                                  launches=cc["cost_launches"],
                                  path="campaign.ccnmpc_b8192's deployment, phase 22")

    kernels["lm"]["launches"] = main_launches["lm"]
    # K2's own path: ccnmpc's two-phase solves in `compare --full-stack`
    kernels["riccati"]["launches"] = exp_launches["compare"]["riccati"]
    kernels["riccati"]["path"] = "compare --full-stack, ccnmpc, phase 15"
    kernels["riccati"]["main_path_launches"] = main_launches["riccati"]
    kernels["riccati"]["on_main_path"] = (
        "inside lm_opt: its device functions riccati_backward_step and rollout_step run "
        "in K1, so impl='mega' does not launch it on its own")
    kernels["riccati"]["two_phase_launches"] = two_phase_launches
    kernels["lm_iter"]["launches"] = mc_launches["lm_iter"]
    kernels["uncertainty"]["launches"] = mc_launches["uncertainty"]
    for name in ("lm_iter", "uncertainty"):
        kernels[name]["path"] = "monte_carlo(impl='fast'), phase 10"
        kernels[name]["full_stack_launches"] = fs_launches[name]
    kernels["lm"]["path"] = "run_steps_batched(impl='mega'), phase 5"
    kernels["lm"]["closed_loop_batched_launches"] = cl_launches["lm"]
    kernels["sample"]["launches"] = fs_launches["sample"]
    kernels["sample"]["path"] = "closed_loop_full_stack_batched, phase 13"
    kernels["costmap"]["launches"] = fs_launches["costmap"]
    kernels["costmap"]["path"] = "closed_loop_full_stack_batched, phase 13"
    kernels["costmap"]["mc_launches"] = mc_launches["costmap"]
    kernels["costmap"]["closed_loop_batched_launches"] = cl_launches["costmap"]
    require("jax" not in sys.modules and "cilqr_tpu" not in sys.modules,
            "jax or the JAX package was imported")
    print(f"[done] {time.perf_counter() - t_script:.1f} s, the build included", flush=True)
    kernels["lm_continue"] = condition
    print(json.dumps({"kernels": [kernels[k] for k in ("lm", "riccati", "lm_iter", "uncertainty",
                                                       "sample", "costmap", "opchain",
                                                       "lm_continue", "cost_derivs")]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
