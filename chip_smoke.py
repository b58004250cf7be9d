"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from cilqr_tpu_torch/csrc, holds each against its
plain PyTorch version on the card, then drives the port's main path — the
batched solve ``run_steps_batched(impl="mega")`` at B=32768, N=50 on the
example world — and checks that it went through the kernels.  Then it
profiles where a call's time goes.  Every phase prints a line (the profile
one per batch size); any failure raises, so the exit code is nonzero.  The last
line is one JSON object: {"ok": true, "device": {...}}.  Without a CUDA
device it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over reps calls, by CUDA events
    (one warm-up call first)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_line(fn, reps: int) -> str:
    """Device time per call by kernel (``torch.profiler``) and the call's
    time (CUDA events), both over the same reps calls after a warm-up call.
    The device is busy for the sum of its kernels' times: one stream, so
    they do not overlap."""
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
    k1_ms = other_ms = 0.0
    n_other = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3 / reps
        if "lm_opt" in evt.name:
            k1_ms += ms
        else:
            other_ms += ms
            n_other += 1
    busy = k1_ms + other_ms
    require(k1_ms > 0.0, "the profiler saw no K1 device time")
    return (f"call {call_ms:.3f} ms (CUDA events, under the profiler) | device busy "
            f"{busy:.3f} ms = {100 * busy / call_ms:.1f}% of the call | K1 {k1_ms:.3f} ms "
            f"({100 * k1_ms / busy:.1f}% of device time) | {n_other / reps:.0f} other kernels "
            f"{other_ms:.3f} ms")


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


def check_lanes(label: str, got, want32, want64, nudged32):
    """Hold a float32 solve result (X, U, it, J, lamb) per lane to a float32
    reference computed another way (want32) and to its float64 counterpart.

    The chaotic lanes are found without ``got``: those where the float32
    reference breaks the bars against want64, either as it is or on any of
    the inputs moved by 2 ulps (nudged32, the float32 reference's results on
    ``perturbed`` egos).  Every other (calm) lane must meet the bars against
    both references, with want32's iteration count; on every lane the counts
    differ by at most 1.  Returns (summary line, calm-lane mask, share of
    lanes with equal counts, max full-horizon |dU| against want32 on the
    calm lanes)."""
    chaotic = lane_deviation(want32, want64)["fail"]
    for res in nudged32:
        chaotic = chaotic | lane_deviation(res, want64)["fail"]
    calm = ~chaotic
    dev32 = lane_deviation(got, want32)
    dev64 = lane_deviation(got, want64)
    same = got[2] == want32[2]
    it_share = float(same.float().mean())
    it_off = int((got[2] - want32[2]).abs().max())
    line = (f"chaotic lanes {int(chaotic.sum())} of {chaotic.numel()} | iterations equal on "
            f"{100 * it_share:.2f}% (max off {it_off}) | calm lanes vs float32 plain: "
            f"{describe(dev32, calm)} | vs float64 plain: {describe(dev64, calm)}")
    require(it_off <= 1 and bool(same[calm].all()), f"{label} iteration counts disagree: {line}")
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
    from cilqr_tpu_torch import SolverParams
    from cilqr_tpu_torch.models import costs, dynamics, solver, solver_batched
    from cilqr_tpu_torch.models.reference_path import get_local_plan
    from cilqr_tpu_torch.ops import lm_cuda, riccati_cuda
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
    ptxas = [ln.strip() for ln in (build.BUILD_DIR / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
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
    # Rollout, step by step at the same bar: each step u = U + k + K (x - X),
    # x' = step(x, u) of the kernel is held to that step computed in float64
    # from the kernel's own previous state and gains.  The whole trajectories
    # of two float32 rollouts drift apart by ~1e-4 in u (float32 positions
    # near 300 m carry an ulp of 3e-5 m, which the gains, |K| up to ~13,
    # amplify along the horizon), so the whole trajectory is held instead to
    # the float64 plain version: at most twice as far from it as the float32
    # plain version is.
    Xg, Ug = Xn_got.double(), Un_got.double()
    u_step = (U0s.double() + k_got.double()
              + (K_got.double() @ (Xg[:, :-1] - X[:, :-1].double())[..., None])[..., 0])
    x_step = torch.cat([X[:, :1].double(), dynamics.step(p, Xg[:, :-1], Ug)], dim=1)
    roll = []
    for name, got, want in (("X_new", Xg, x_step), ("U_new", Ug, u_step)):
        err, excess = max_excess(got, want, rtol=1e-4, atol=1e-5)
        roll.append(f"{name} per step {err:.3e}")
        require(excess <= 0.0, f"K2 {name}: a rollout step is off by {err:.3e}, beyond "
                "1e-4 rel + 1e-5 abs")
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
    lm_cuda.LAUNCHES = 0
    riccati_cuda.LAUNCHES = 0
    res = solver_batched.run_steps_batched(p, plan, n, egos_m, U0_m, obstacles, unc, impl="mega")
    torch.cuda.synchronize()
    main_launches = {"lm": lm_cuda.LAUNCHES, "riccati": riccati_cuda.LAUNCHES}
    require(main_launches == {"lm": 1, "riccati": 0},
            f"main path launches {main_launches}, expected K1 once and K2 not on its own")
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
            p, plan, n, e, u, obstacles, unc, impl="mega"), reps=3), flush=True)

    kernels["lm"]["launches"] = main_launches["lm"]
    kernels["riccati"]["launches"] = main_launches["riccati"]
    kernels["riccati"]["on_main_path"] = (
        "inside lm_opt: its device functions riccati_backward_step and rollout_step run "
        "in K1, so impl='mega' does not launch it on its own")
    kernels["riccati"]["two_phase_launches"] = two_phase_launches
    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [kernels["lm"], kernels["riccati"]]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
