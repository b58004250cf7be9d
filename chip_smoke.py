"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from cilqr_tpu_torch/csrc, holds each against its
plain PyTorch version on the card, then drives the port's paths and checks
that each went through its kernels:

  phases 1-7   the batched solve ``run_steps_batched(impl="mega")`` at
               B=32768, N=50 on the example world (kernels K1 and K2), and
               where a call's time goes;
  phases 8-10  the Monte-Carlo path ``monte_carlo(impl="fast")`` at B=8192,
               N=50 on the full 152x104 costmap (kernels K4 and K3), and
               where its time goes.

Every phase prints a line (the profiles one per batch size); any failure
raises, so the exit code is nonzero.  The last line is one JSON object:
{"ok": true, "device": {...}}.  Without a CUDA device it fails before
printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_B = 32768      # main-path batch (the benchmark's B)
HORIZON = 50
K2_CHECK_B = 4096
K1_CHECK_B = 1024
TIMED_CALLS = 5
NUDGES = 8          # 2-ulp perturbations of the egos that find chaotic lanes
MC_B = 8192         # Monte-Carlo batch (the JAX benchmark's B)
K4_CHECK_B = 256
K3_CHECK_B = 1024
MC_REF_LANES = 64
SIGMA_HI = (0.16, 0.16, 0.017)  # the JAX benchmark's sampling bound


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


def profile_line(fn, reps: int, kernels: dict, annotation: str | None = None) -> str:
    """Device time per call by kernel (``torch.profiler``) and the call's
    time (CUDA events), both over the same reps calls after a warm-up call.
    The device is busy for the sum of its kernels' times: one stream, so
    they do not overlap.  ``kernels`` maps a label to a substring of a
    kernel's name; ``annotation`` names a ``record_function`` range whose
    kernels' device time is split out of the other kernels'."""
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
    for evt in prof.events():
        user_range = getattr(evt, "is_user_annotation", False) or evt.name == annotation
        if evt.device_type == DeviceType.CUDA and not user_range:
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
    parts = [f"call {call_ms:.3f} ms (CUDA events, under the profiler)",
             f"device busy {busy:.3f} ms = {100 * busy / call_ms:.1f}% of the call"]
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


def ptxas_lines(log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v report: its name
    (template argument from the mangled name), registers and spill bytes."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            base = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)", mangled)
            name = base.group(1) if base else mangled
            name += "<true>" if "ILb1E" in mangled else "<false>" if "ILb0E" in mangled else ""
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


def check_lanes(label: str, got, want32, want64, nudged32, chaotic_it_off: int = 1,
                by_spread: bool = False):
    """Hold a float32 solve result (X, U, it, J, lamb) per lane to a float32
    reference computed another way (want32) and to its float64 counterpart.

    The chaotic lanes are found without ``got``: those where the float32
    reference breaks the bars against want64, either as it is or on any of
    the inputs moved by 2 ulps (nudged32, the float32 reference's results on
    ``perturbed`` egos).  Every other (calm) lane must meet the bars against
    both references, with want32's iteration count; on the chaotic lanes the
    counts differ from want32's by at most ``chaotic_it_off``, plus, with
    ``by_spread``, that lane's spread: the largest distance of a nudged or
    float64 reference's count from want32's.
    Returns (summary line, calm-lane mask, share of lanes with equal counts,
    max full-horizon |dU| against want32 on the calm lanes)."""
    chaotic = lane_deviation(want32, want64)["fail"]
    spread = (want64[2] - want32[2]).abs()
    for res in nudged32:
        chaotic = chaotic | lane_deviation(res, want64)["fail"]
        spread = torch.maximum(spread, (res[2] - want32[2]).abs())
    calm = ~chaotic
    allowed = chaotic_it_off + (spread if by_spread else 0)
    dev32 = lane_deviation(got, want32)
    dev64 = lane_deviation(got, want64)
    same = got[2] == want32[2]
    it_share = float(same.float().mean())
    off = (got[2] - want32[2]).abs()
    it_off = int(off.max())
    line = (f"chaotic lanes {int(chaotic.sum())} of {chaotic.numel()} | iterations equal on "
            f"{100 * it_share:.2f}% (max off {it_off}, calm lanes "
            f"{100 * float(same[calm].float().mean()):.2f}%, chaotic lanes held within "
            f"{'their spread + ' if by_spread else ''}{chaotic_it_off}, max spread "
            f"{int(spread.max())}) | calm lanes vs float32 plain: "
            f"{describe(dev32, calm)} | vs float64 plain: {describe(dev64, calm)}")
    require(bool(same[calm].all()) and bool((off <= allowed).all()),
            f"{label} iteration counts disagree: {line}")
    require(not bool(dev32["fail"][calm].any()),
            f"{label}: a calm lane breaks the bars against the float32 plain version: {line}")
    require(not bool(dev64["fail"][calm].any()),
            f"{label}: a calm lane breaks the bars against the float64 plain version: {line}")
    return line, calm, it_share, float((got[1] - want32[1]).abs().amax(dim=(1, 2))[calm].max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script needs an NVIDIA GPU")
    from cilqr_tpu_torch import CostmapParams, SolverParams
    from cilqr_tpu_torch.models import costs, dynamics, solver, solver_batched
    from cilqr_tpu_torch.models.reference_path import get_local_plan
    from cilqr_tpu_torch.ops import gridmap, lm_cuda, riccati_cuda, uncertainty_cuda
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim.example_scenario import example_scenario
    from cilqr_tpu_torch.utils import build

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
    require(any(ln.startswith("lm_opt_kernel:") and "0/0 spill" in ln for ln in ptxas),
            f"K1 spills or is missing from the ptxas report: {ptxas}")
    print(f"[2 build] {build_s:.2f} s -> {build.BUILD_DIR / build.LIB_NAME}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

    p = dataclasses.replace(SolverParams(), horizon=HORIZON)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, torch.float32, dev)

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
    before = riccati_cuda.LAUNCHES
    k_got, K_got = riccati_cuda.backward_batched(p, d, X, U0s, lamb)
    Xn_got, Un_got = riccati_cuda.backward_forward_batched(p, d, X, U0s, lamb)
    torch.cuda.synchronize()
    require(riccati_cuda.LAUNCHES == before + 2, "K2 launch counter did not move")
    k_want, K_want = riccati_cuda.backward_plain(p, d, X, U0s, lamb)
    Xn_want, Un_want = riccati_cuda.backward_forward_plain(p, d, X, U0s, lamb)
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
            for name, err in rollout_step_check(p, X, U0s, k_got, K_got, Xn_got, Un_got)]
    d64 = costs.CostDerivs(*(t.double() for t in d))
    Xn_64, Un_64 = riccati_cuda.backward_forward_plain(
        p, d64, X.double(), U0s.double(), lamb.double())
    for name, got, want, ref in (("X_new", Xn_got, Xn_want, Xn_64), ("U_new", Un_got, Un_want, Un_64)):
        k_dev = float((got.double() - ref).abs().max())
        p_dev = float((want.double() - ref).abs().max())
        k2_err = max(k2_err, float((got - want).abs().max()))
        roll.append(f"{name} whole: kernel-f64 {k_dev:.3e} plain32-f64 {p_dev:.3e}")
        require(k_dev <= 2.0 * p_dev + 1e-6, f"K2 {name}: kernel {k_dev:.3e} from float64, "
                f"float32 plain {p_dev:.3e}")
    # time at the main-path shapes: derivatives of B=32768 scenarios
    egos_m, U0_m = scenario_batch(MAIN_B, seed=2)
    plans_m = get_local_plan(p, plan, n, egos_m)
    X_m = dynamics.rollout(p, egos_m, U0_m)
    d_m, _ = costs.all_cost_derivs_and_J(p, plans_m, X_m, U0_m, obstacles, unc)
    lamb_m = torch.ones(MAIN_B, dtype=torch.float32, device=dev)
    k2_ms = cuda_ms(lambda: riccati_cuda.backward_forward_batched(p, d_m, X_m, U0_m, lamb_m), 5)
    k2_plain_ms = cuda_ms(lambda: riccati_cuda.backward_forward_plain(p, d_m, X_m, U0_m, lamb_m), 3)
    kernels["riccati"] = dict(
        name="riccati_backward_forward", route="cuda", source="cilqr_tpu_torch/csrc/riccati.cu",
        replaces="cilqr_tpu/ops/riccati_pallas.py:84", max_abs_err=k2_err,
        ms=k2_ms, plain_ms=k2_plain_ms)
    print(f"[3 K2 riccati] B={K2_CHECK_B} max|kernel-plain| {k2_err:.3e} (k/K bar 1e-4 rel + "
          f"1e-5 abs) | {' | '.join(roll)} | B={MAIN_B}: kernel {k2_ms:.3f} ms, "
          f"plain {k2_plain_ms:.3f} ms", flush=True)
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
    plan64, n64, _, _, obstacles64, unc64 = example_scenario(p, torch.float64, dev)
    egos64, U0s64 = egos.double(), U0s.double()
    want64 = lm_cuda.fused_optimize_plain(
        p, get_local_plan(p, plan64, n64, egos64), egos64, U0s64, obstacles64, unc64)
    nudged = [lm_cuda.fused_optimize_plain(p, get_local_plan(p, plan, n, e), e, U0s, obstacles, unc)
              for e in perturbed(egos, NUDGES)]
    k1_line, _, k1_it_share, k1_err = check_lanes("K1", got, want, want64, nudged)
    print(f"[4 K1 lm] B={K1_CHECK_B} {k1_line}", flush=True)
    require(k1_it_share >= 0.99, "K1 iteration counts equal on fewer than 99% of lanes")
    plans_m = get_local_plan(p, plan, n, egos_m)
    k1_ms = cuda_ms(lambda: lm_cuda.fused_optimize(p, plans_m, egos_m, U0_m, obstacles, unc), 3)
    k1_plain_ms = cuda_ms(
        lambda: lm_cuda.fused_optimize_plain(p, plans_m, egos_m, U0_m, obstacles, unc), 2)
    kernels["lm"] = dict(
        name="lm_opt", route="cuda", source="cilqr_tpu_torch/csrc/lm.cu",
        replaces="cilqr_tpu/ops/lm_pallas.py:682", max_abs_err=k1_err,
        max_abs_err_of="full-horizon U against the float32 plain version, calm lanes",
        ms=k1_ms, plain_ms=k1_plain_ms)
    print(f"[4 K1 lm] B={MAIN_B}: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms", flush=True)

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
    mean_it = float(res.iterations.float().mean())
    # the first lanes against the unfused per-lane solve (the port's
    # reference), in float32 and float64, by the per-lane rule of phase 4
    R = 64
    ref = solver.run_step(p, plan, n, egos_m[:R], U0_m[:R], obstacles, unc)
    ref64 = solver.run_step(p, plan64, n64, egos_m[:R].double(), U0_m[:R].double(),
                            obstacles64, unc64)
    pick = lambda r: (r.X, r.U, r.iterations, r.J, r.lamb)
    nudged = [pick(solver.run_step(p, plan, n, e, U0_m[:R], obstacles, unc))
              for e in perturbed(egos_m[:R], NUDGES)]
    ref_line, *_ = check_lanes("main path vs solver.run_step",
                               tuple(t[:R] for t in pick(res)), pick(ref), pick(ref64), nudged)
    main_ms = cuda_ms(lambda: solver_batched.run_steps_batched(
        p, plan, n, egos_m, U0_m, obstacles, unc, impl="mega"), TIMED_CALLS)
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
    riccati_cuda.LAUNCHES = 0
    r4 = solver_batched.run_steps_batched(p, plan, n, e4, u4, obstacles, unc, impl="two_phase")
    torch.cuda.synchronize()
    two_phase_launches = riccati_cuda.LAUNCHES
    # one K2 launch per LM iteration, until the last lane stops
    require(two_phase_launches == int(r4.iterations.max()) and bool(torch.isfinite(r4.U).all()),
            f"two_phase: {two_phase_launches} K2 launches for {int(r4.iterations.max())} iterations")
    tp_ms = cuda_ms(lambda: solver_batched.run_steps_batched(
        p, plan, n, e4, u4, obstacles, unc, impl="two_phase"), 2)
    print(f"[6 serving/two-phase] mega B=1 {b1_ms:.3f} ms/call (lane 0 as in the B={MAIN_B} "
          f"batch: max |dU| {b1_diff:.1e}) | two_phase B={K2_CHECK_B} "
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

    def k4_check(label, prior32, prior_64, geom_64, yaw_64, sigmas, faithful, bnds, dsc):
        f32 = uncertainty_cuda.prep_fields(cp, geom, origin_yaw, sigmas, faithful, rows, cols)
        f64 = uncertainty_cuda.prep_fields(cp, geom_64, yaw_64, None if sigmas is None else
                                           sigmas.double(), faithful, rows, cols, torch.float64)
        before = uncertainty_cuda.LAUNCHES
        got = uncertainty_cuda.propagate_banded(cp, prior32, f32, bnds, dsc)
        torch.cuda.synchronize()
        require(uncertainty_cuda.LAUNCHES == before + 1, "K4 launch counter did not move")
        want = uncertainty_cuda.propagate_banded_plain(cp, prior32, f32, bnds, dsc)
        want64 = uncertainty_cuda.propagate_banded_plain(cp, prior_64, f64, bnds, dsc)
        err, n_kept = k4_compare(label, got, want, prior32, f32[3])
        k_dev = float((got.double() - want64).abs().max())
        p_dev = float((want.double() - want64).abs().max())
        require(k_dev <= 2.0 * p_dev + 1e-4,
                f"K4 {label}: kernel {k_dev:.3e} from float64, float32 plain {p_dev:.3e}")
        return got, err, (f"{label}: max|kernel-plain| {err:.3e}, kept-prior cells "
                          f"{n_kept}, kernel-f64 {k_dev:.3e} plain32-f64 {p_dev:.3e}")

    sig4 = samples.sigmas[:K4_CHECK_B]
    _, k4_err, line_mc = k4_check("MC form", prior, prior64, geom64, origin_yaw64, sig4, False,
                                  bands, discs)
    priors = torch.tensor(np.random.default_rng(5).uniform(0.0, 100.0, (K4_CHECK_B, rows, cols)),
                          dtype=torch.float32, device=dev)
    _, err_b, line_b = k4_check("per-scenario priors", priors, priors.double(), geom64,
                                origin_yaw64, sig4, False, bands, discs)
    full = uncertainty_cuda.full_window_plan(cp, rows).bands
    got1, err_1, line_1 = k4_check("single map", prior, prior64, geom64, origin_yaw64, None, True,
                                   full, None)
    single = uncertainty_cuda.propagate_uncertainty(cp, prior, geom, origin_yaw, faithful_rho=True)
    require(torch.equal(single, got1[0]), "K4 single-map entry differs from the kernel on its fields")
    # at the MC path's shape, B=8192: the last timed outputs of both, compared
    fields_m = uncertainty_cuda.prep_fields(cp, geom, origin_yaw, samples.sigmas, False, rows, cols)
    k4_ms, got_m = timed(
        lambda: uncertainty_cuda.propagate_banded(cp, prior, fields_m, bands, discs), 3)
    k4_plain_ms, want_m = timed(
        lambda: uncertainty_cuda.propagate_banded_plain(cp, prior, fields_m, bands, discs), 1)
    err_m, kept_m = k4_compare(f"B={MC_B}", got_m, want_m, prior, fields_m[3])
    k4_err = max(k4_err, err_b, err_1, err_m)
    kernels["uncertainty"] = dict(
        name="propagate", route="cuda", source="cilqr_tpu_torch/csrc/uncertainty.cu",
        replaces="cilqr_tpu/ops/uncertainty_pallas.py:300",
        also_replaces=["cilqr_tpu/ops/uncertainty_pallas.py:199",
                       "cilqr_tpu/ops/uncertainty_pallas.py:283"],
        max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain_ms)
    print(f"[8 K4 uncertainty] B={K4_CHECK_B} {line_mc} | {line_b} | {line_1} | {len(bands)} bands, "
          f"radii {[R for (_, _, R) in bands]} | B={MC_B}: max|kernel-plain| {err_m:.3e}, kept-prior "
          f"cells {kept_m}, kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms", flush=True)
    del fields_m, priors, got_m, want_m

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
    k3_ms, gotM = timed(lambda: lm_cuda.fused_iteration(p, world, plansM, XM, UM, lambM, uextM), 5)
    k3_plain_ms, wantM = timed(
        lambda: lm_cuda.fused_iteration_plain(p, world, plansM, XM, UM, lambM, uextM), 2)
    k3_err_m, roll_m, j_rel_m = k3_compare(XM, UM, gotM, wantM)
    kernels["lm_iter"] = dict(
        name="lm_iter", route="cuda", source="cilqr_tpu_torch/csrc/lm.cu",
        replaces="cilqr_tpu/ops/lm_pallas.py:663", max_abs_err=max(k3_err, k3_err_m),
        max_abs_err_of="one iteration's gains k, K against the float32 plain version",
        ms=k3_ms, plain_ms=k3_plain_ms)
    print(f"[9 K3 lm_iter] B={K3_CHECK_B} one iteration: max|kernel-plain| k/K {k3_err:.3e} "
          f"(bar 1e-4 rel + 1e-5 abs) | per step " + ", ".join(f"{nm} {e:.3e}" for nm, e in roll3)
          + f" | J rel {j_rel:.3e} | hybrid loop ({hybrid_launches} K3 launches): {k3_line} "
          f"(max full-horizon |dU| on calm lanes {k3_loop_err:.3e}) | B={MC_B} one iteration: "
          f"max|kernel-plain| k/K {k3_err_m:.3e}, per step "
          + ", ".join(f"{nm} {e:.3e}" for nm, e in roll_m)
          + f", J rel {j_rel_m:.3e}, kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.3f} ms", flush=True)
    del umapsM, egosM, plansM, XM, uextM, gotM, wantM

    # 10. the Monte-Carlo path: monte_carlo(impl="fast") at B=8192, N=50.  It
    # launches K4 once and K3 once per LM iteration, and never K1 or K2.
    def mc_fast(s):
        return mc.monte_carlo(p, cp, prior, geom, origin_xy, origin_yaw, plan, n, s, obstacles,
                              sigma_hi=SIGMA_HI, impl="fast", band_plan=band_plan)

    lm_cuda.LAUNCHES = lm_cuda.ITER_LAUNCHES = 0
    riccati_cuda.LAUNCHES = uncertainty_cuda.LAUNCHES = 0
    res = mc_fast(samples)
    torch.cuda.synchronize()
    mc_launches = {"uncertainty": uncertainty_cuda.LAUNCHES, "lm_iter": lm_cuda.ITER_LAUNCHES,
                   "lm": lm_cuda.LAUNCHES, "riccati": riccati_cuda.LAUNCHES}
    it_min, it_max = int(res.iterations.min()), int(res.iterations.max())
    require(mc_launches == {"uncertainty": 1, "lm_iter": it_max, "lm": 0, "riccati": 0},
            f"MC path launches {mc_launches}, expected K4 once, K3 {it_max} times, K1 and K2 never")
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

    nudged = [mc_reference(mc.MCSample(sub.sigmas, e)) for e in perturbed(sub.egos, NUDGES)]
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
    print(f"[10 profile] B={MC_B}: " + profile_line(
        lambda: mc_fast(samples), reps=2, kernels={"K4": "propagate_kernel", "K3": "lm_iter_kernel"},
        annotation="uncertainty_sample_batched"), flush=True)

    kernels["lm"]["launches"] = main_launches["lm"]
    kernels["riccati"]["launches"] = main_launches["riccati"]
    kernels["riccati"]["on_main_path"] = (
        "inside lm_opt: its device functions riccati_backward_step and rollout_step run "
        "in K1, so impl='mega' does not launch it on its own")
    kernels["riccati"]["two_phase_launches"] = two_phase_launches
    kernels["lm_iter"]["launches"] = mc_launches["lm_iter"]
    kernels["uncertainty"]["launches"] = mc_launches["uncertainty"]
    for name in ("lm_iter", "uncertainty"):
        kernels[name]["path"] = "monte_carlo(impl='fast'), phase 10"
    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [kernels[k] for k in ("lm", "riccati", "lm_iter", "uncertainty")]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
