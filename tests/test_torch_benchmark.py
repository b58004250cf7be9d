"""The port's benchmark driver (``cilqr_tpu_torch.benchmark``, ``python -m
cilqr_tpu_torch bench``) and its H100 bound model (``utils/roofline.py``)
against the JAX benchmark.

- ``slope_throughput``: the stall guard, and the JAX function's numbers on
  the same fake clock.
- The inputs: both drivers run with their solves replaced by recorders
  (the JAX one with ``jax.jit`` as the identity, so the recorders see
  arrays), and the egos, ego batches, Monte-Carlo prior and full-stack
  states they were handed must be equal, with each extra on and off.
- The whole driver on the CPU at tiny knobs: one JSON line with the
  field set of the JAX line less the tunnel fields, every path run, and
  ``mean_lm_iterations`` equal to JAX's ``vmap(solver.run_step)`` on the
  same egos in float32, lane for lane.
- The bound model: the numbers ``chip_smoke.py`` gave before it moved.
"""

import dataclasses
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cilqr_tpu.benchmark as jbench
from cilqr_tpu.models import solver as jsolver, solver_batched as jsb
from cilqr_tpu.parallel import batch as jpbatch, monte_carlo as jmc
from cilqr_tpu.sim import plant as jplant
from cilqr_tpu.sim.example_scenario import example_scenario as jax_example
import cilqr_tpu.ops.costmap  # noqa: F401  (imported by the JAX driver's body)
import cilqr_tpu.ops.gridmap  # noqa: F401
import cilqr_tpu.ops.uncertainty_pallas  # noqa: F401
import cilqr_tpu.utils.roofline  # noqa: F401
import cilqr_tpu_torch.benchmark as tbench
from cilqr_tpu_torch.__main__ import main as cli_main
from cilqr_tpu_torch.models import solver as tsolver, solver_batched as tsb
from cilqr_tpu_torch.parallel import batch as tpbatch, monte_carlo as tmc
from cilqr_tpu_torch.sim import plant as tplant
from cilqr_tpu_torch.utils import roofline
from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams

DEV = "cpu"  # the port allocates on the card unless told otherwise

# the JAX line's fields less the dropped ones (the tunnel's and vs_baseline),
# plus peak_memory_gb
FIELDS = {"metric", "value", "value_spread", "unit", "path", "batch", "batched_step_ms",
          "device_p99_single_solve_ms", "p99_under_budget", "device_single_solve_ms",
          "device_single_solve_ms_pscan", "device_single_solve_ms_mega_b1",
          "mean_lm_iterations", "mega_pct_of_sol", "mega_sol_binding_resource", "device",
          "peak_memory_gb"}
EXTRA_FIELDS = {
    "BENCH_MC": {"mc_scenarios_per_sec", "mc_scenarios_per_sec_spread", "mc_window_radius"},
    "BENCH_FULL_STACK": {"full_stack_cycles_per_sec", "full_stack_cycles_per_sec_spread"},
    "BENCH_CLOSED_LOOP": {"closed_loop_cycles_per_sec", "closed_loop_cycles_per_sec_spread"},
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs: the tier runs six workers at
    once, and these small eager loops only lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """A device whose dispatches cost ``per`` seconds each and whose groups
    pay ``stall`` seconds once: timer() advances only in blocker()."""

    def __init__(self, per, stall):
        self.t, self.per, self.stall = 0.0, per, stall
        self.pending = 0

    def timer(self):
        return self.t

    def call(self, x):
        self.pending += 1
        return x

    def blocker(self, outs):
        self.t += self.stall + self.per * self.pending
        self.pending = 0


def test_slope_throughput_stall_guard():
    """A stall straddling the whole phase makes both group timings ~= the
    stall, exploding the slope: the guard must reject such reps and fall back
    to the blocking bound; a clean session passes through unchanged."""
    items = 1000.0
    clk = FakeClock(per=0.1, stall=0.03)
    med, spread = tbench.slope_throughput(
        clk.call, lambda i: i, items, timer=clk.timer, blocker=clk.blocker)
    assert abs(med - items / 0.1) / (items / 0.1) < 1e-6
    assert spread[0] <= med <= spread[1]

    clk = FakeClock(per=1e-4, stall=5.0)
    med, spread = tbench.slope_throughput(
        clk.call, lambda i: i, items, timer=clk.timer, blocker=clk.blocker)
    bound = items * 4 / (5.0 + 4 * 1e-4)  # g2=4 dispatches, one stall
    assert med <= bound * 1.01
    assert med < 0.001 * (items / 1e-4)


@pytest.mark.parametrize("per, stall, kw", [
    (0.1, 0.03, {}), (1e-4, 5.0, {}), (0.02, 0.5, {"g2": 3}), (0.004, 0.07, {"reps": 5})],
    ids=["clean", "stalled", "g2=3", "reps=5"])
def test_slope_throughput_equals_the_jax_function(per, stall, kw):
    got_clk, want_clk = FakeClock(per, stall), FakeClock(per, stall)
    seen_got, seen_want = [], []
    got = tbench.slope_throughput(got_clk.call, lambda i: seen_got.append(i) or i, 1234.0,
                                  timer=got_clk.timer, blocker=got_clk.blocker, **kw)
    want = jbench.slope_throughput(want_clk.call, lambda i: seen_want.append(i) or i, 1234.0,
                                   timer=want_clk.timer, blocker=want_clk.blocker, **kw)
    assert got == want
    assert seen_got == seen_want


# --- the inputs: both drivers with their solves replaced by recorders -------

class FakeResult(NamedTuple):
    X: object
    U: object
    iterations: object


def _jax_fakes(rec: dict, B: int):
    def concrete(x):
        return not isinstance(x, jax.core.Tracer)

    def run_step(p, plan, n, e, u, *a, **k):
        if concrete(e):
            rec["single"].append(np.asarray(e))
        return FakeResult(jnp.zeros(e.shape[:-1] + (p.horizon + 1, 4), e.dtype), u,
                          jnp.ones(e.shape[:-1], jnp.int32))

    def run_steps_batched(p, plan, n, e, u, *a, **k):
        if concrete(e) and e.shape[0] == B:
            rec["batched"].append(np.asarray(e))
        return run_step(p, plan, n, e, u)

    return {
        (jsolver, "run_step"): run_step,
        (jsb, "run_steps_batched"): run_steps_batched,
        (jpbatch, "batched_solve"): run_steps_batched,
        (jmc, "monte_carlo"): lambda *a, **k: rec["prior"].append(np.asarray(a[2])) or a[2],
        (jplant, "closed_loop_full_stack_batched"):
            lambda *a, **k: rec["x0s"].append(np.asarray(a[7])) or a[7],
        (jplant, "closed_loop_batched"): lambda *a, **k: a[4],
        (jbench, "slope_throughput"): lambda *a, **k: (1.0, [1.0, 1.0]),
        (jax, "jit"): lambda f=None, **kw: f if f is not None else (lambda g: g),
        # the chained single solves draw nothing: skip them
        (jax.lax, "fori_loop"): lambda lo, hi, body, init: init,
    }


def _torch_fakes(rec: dict, B: int):
    def run_step(p, plan, n, e, u, *a, **k):
        rec["single"].append(e.numpy().copy())
        return FakeResult(torch.zeros(e.shape[:-1] + (p.horizon + 1, 4), dtype=e.dtype), u,
                          torch.ones(e.shape[:-1], dtype=torch.int32))

    def run_steps_batched(p, plan, n, e, u, *a, **k):
        if e.shape[0] == B:
            rec["batched"].append(e.numpy().copy())
            rec["impl"].append(k.get("impl"))
        return run_step(p, plan, n, e, u)

    def batched_solve(p, plan, n, e, u, *a, **k):
        rec["impl"].append("batched_solve")
        rec["batched"].append(e.numpy().copy())
        return run_step(p, plan, n, e, u)

    return {
        (tsolver, "run_step"): run_step,
        (tsb, "run_steps_batched"): run_steps_batched,
        (tpbatch, "batched_solve"): batched_solve,
        (tmc, "monte_carlo"): lambda *a, **k: rec["prior"].append(a[2].numpy().copy()) or a[2],
        (tplant, "closed_loop_full_stack_batched"):
            lambda *a, **k: rec["x0s"].append(a[7].numpy().copy()) or a[7],
        (tplant, "closed_loop_batched"): lambda *a, **k: a[4],
        (tbench, "slope_throughput"): lambda *a, **k: (1.0, [1.0, 1.0]),
    }


def _recorded(monkeypatch, fakes, run, B):
    rec = {k: [] for k in ("single", "batched", "impl", "prior", "x0s")}
    with monkeypatch.context() as m:
        for (module, name), fake in fakes(rec, B).items():
            m.setattr(module, name, fake)
        run()
    return rec


KNOBS = dict(BENCH_BATCH="8", BENCH_ITERS="2", BENCH_PASSES="2", BENCH_MC_BATCH="4",
             BENCH_FS_BATCH="5")


@pytest.mark.parametrize("mc, fs, cl", [("1", "1", "1"), ("0", "1", "1"), ("1", "0", "0"),
                                        ("0", "0", "0")])
def test_input_draws_equal_the_jax_benchmark(monkeypatch, capsys, mc, fs, cl):
    """Egos, ego batches, Monte-Carlo prior and full-stack states handed to
    the paths by both drivers from one default_rng(2), in the JAX file's
    order, with each extra on and off."""
    for k, v in dict(KNOBS, BENCH_MC=mc, BENCH_FULL_STACK=fs, BENCH_CLOSED_LOOP=cl).items():
        monkeypatch.setenv(k, v)
    B, iters = 8, 2
    want = _recorded(monkeypatch, _jax_fakes, jbench.main, B)
    got = _recorded(monkeypatch, _torch_fakes, lambda: tbench.main(["--device", DEV]), B)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(got["single"]) >= B and len(want["single"]) >= B
    np.testing.assert_array_equal(np.stack(got["single"][:B]), np.stack(want["single"][:B]))
    assert [a.dtype for a in got["single"][:B]] == [np.float32] * B
    # the warm call, then the first pass: ego_batches[0], ego_batches[0..iters-1]
    assert len(got["batched"]) == len(want["batched"]) == 1 + 2 * iters
    for g, w in zip(got["batched"], want["batched"]):
        np.testing.assert_array_equal(g, w)
    assert set(got["impl"]) == {"mega"}
    for key, on, shape in (("prior", mc, (152, 104)), ("x0s", fs, (5, 4))):
        assert len(got[key]) == len(want[key]) == (1 if on == "1" else 0)
        for g, w in zip(got[key], want[key]):
            assert g.shape == shape and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    extras = set().union(*(EXTRA_FIELDS[k] for k, on in (("BENCH_MC", mc),
                                                         ("BENCH_FULL_STACK", fs),
                                                         ("BENCH_CLOSED_LOOP", cl)) if on == "1"))
    assert set(line) == FIELDS | extras


@pytest.mark.parametrize("path, route", [("mega", "mega"), ("fused", "two_phase"),
                                         ("vmap", "batched_solve")])
def test_bench_path_picks_the_route(monkeypatch, capsys, path, route):
    for k, v in dict(KNOBS, BENCH_PATH=path, BENCH_MC="0", BENCH_FULL_STACK="0",
                     BENCH_CLOSED_LOOP="0").items():
        monkeypatch.setenv(k, v)
    got = _recorded(monkeypatch, _torch_fakes, lambda: tbench.main(["--device", DEV]), 8)
    assert got["impl"] == [route] * 5
    assert json.loads(capsys.readouterr().out)["path"] == path


def test_bench_path_unknown_raises(monkeypatch):
    monkeypatch.setenv("BENCH_PATH", "pallas")
    with pytest.raises(ValueError, match="BENCH_PATH"):
        tbench.run(DEV)


# --- the whole driver on the CPU ---------------------------------------------

@pytest.fixture(scope="module")
def jax_mean_reference():
    """jax.vmap(solver.run_step) in float32 on the egos the port's driver
    reads its mean off at BENCH_BATCH=8, ITERS=1, PASSES=1: the JAX file's
    ego_batches[0], the second draw of default_rng(2)."""
    p = dataclasses.replace(SolverParams(), horizon=50)
    jplan, jn, jego, jU0, jo, ju = jax_example(p, jnp.float32)
    rng = np.random.default_rng(2)
    rng.normal(0, 0.3, (8, 4))
    egos = jnp.asarray(np.asarray(jego)[None, :] + rng.normal(0, 0.3, (8, 4)), jnp.float32)
    U0s = jnp.broadcast_to(jU0, (8,) + jU0.shape)
    res = jax.jit(jax.vmap(lambda e, u: jsolver.run_step(p, jplan, jn, e, u, jo, ju)))(egos, U0s)
    return np.asarray(egos), np.asarray(res.iterations)


def test_bench_runs_every_path_on_the_cpu(monkeypatch, capsys, jax_mean_reference):
    """`python -m cilqr_tpu_torch bench --device cpu` in process at tiny
    knobs: one JSON line with exactly the field set, every path run for real
    (slope_throughput's timing loops stubbed), mean_lm_iterations equal to
    JAX's on the same egos."""
    for k, v in dict(BENCH_BATCH="8", BENCH_ITERS="1", BENCH_PASSES="1", BENCH_MC_BATCH="4",
                     BENCH_FS_BATCH="4").items():
        monkeypatch.setenv(k, v)
    for name in ("SINGLE_REPS", "PSCAN_REPS", "MEGA_B1_REPS"):
        monkeypatch.setattr(tbench, name, 1)
    monkeypatch.setattr(tbench, "WARM_CALLS", 0)
    monkeypatch.setattr(tbench, "slope_throughput", lambda *a, **k: (2.0, [1.0, 3.0]))
    calls = {}

    def count(module, name, keep=lambda args, out: None):
        real = getattr(module, name)

        def wrapped(*args, **kw):
            out = real(*args, **kw)
            calls.setdefault(name, []).append(keep(args, out))
            return out

        monkeypatch.setattr(module, name, wrapped)

    count(tsolver, "run_step", keep=lambda a, out: int(out.iterations))
    count(tsb, "run_steps_batched", keep=lambda a, out: (a[3].numpy().copy(),
                                                          out.iterations.numpy().copy()))
    count(tmc, "monte_carlo")
    count(tplant, "closed_loop_full_stack_batched")
    count(tplant, "closed_loop_batched")

    assert cli_main(["bench", "--device", DEV]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == FIELDS | set().union(*EXTRA_FIELDS.values())
    assert line["metric"] == "cilqr_solves_per_sec_1chip_N50_full_constraints"
    assert line["unit"] == "solves/s" and line["path"] == "mega" and line["batch"] == 8
    assert line["device"] == "cpu"
    assert line["mega_sol_binding_resource"] == "operations"
    assert line["mc_window_radius"] == 12
    assert line["mc_scenarios_per_sec"] == 2.0 and line["closed_loop_cycles_per_sec_spread"] == [1.0, 3.0]
    assert line["p99_under_budget"] == (line["device_p99_single_solve_ms"] < 100.0)
    for k in ("value", "batched_step_ms", "device_single_solve_ms", "device_single_solve_ms_pscan",
              "device_single_solve_ms_mega_b1"):
        assert np.isfinite(line[k]) and line[k] > 0, k
    assert 0.0 <= line["mega_pct_of_sol"] < 1.0  # ~1e-4 % on the CPU, rounded to 0.1
    assert line["value_spread"][0] <= line["value"] <= line["value_spread"][1]
    assert line["peak_memory_gb"] == dict.fromkeys(
        ("single_solve", "single_solve_pscan", "single_solve_mega_b1", "batched_step", "mc",
         "full_stack", "closed_loop"))
    # every path ran: 2 unfused single solves (seq, pscan), the B=1 fused one,
    # the warm call and one pass of the main path, one call of each extra
    # (the Monte-Carlo path's hybrid solve and the closed loop's 10 cycles
    # call run_steps_batched too)
    assert len(calls["run_step"]) == 2
    assert len(calls["monte_carlo"]) == len(calls["closed_loop_full_stack_batched"]) == 1
    assert len(calls["closed_loop_batched"]) == 1
    main_calls = [(e, it) for e, it in calls["run_steps_batched"] if e.shape == (8, 4)]
    assert sum(e.shape == (1, 4) for e, _ in calls["run_steps_batched"]) == 1
    assert len(main_calls) == 2 + tbench.CL_CYCLES
    egos, want_it = jax_mean_reference
    np.testing.assert_array_equal(main_calls[1][0], egos)
    np.testing.assert_array_equal(main_calls[1][1], want_it)
    assert line["mean_lm_iterations"] == round(float(want_it.astype(np.float32).mean()), 2)


@pytest.mark.parametrize("argv", [["bench"], None], ids=["cli", "module"])
def test_bench_defaults_to_the_card(argv):
    """Without --device both entries run on the card: here that fails with
    PyTorch's own CUDA error, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        if argv is None:
            tbench.main([])
        else:
            cli_main(argv)


# --- the bound model ---------------------------------------------------------

def _fields():
    rng = np.random.default_rng(7)
    sx, sy = (torch.tensor(rng.uniform(0.05, 0.4, (3, 6, 5)), dtype=torch.float32)
              for _ in range(2))
    rho = torch.tensor(rng.uniform(-0.9, 0.9, (3, 6, 5)), dtype=torch.float32)
    return sx, sy, rho, torch.ones((3, 6, 5), dtype=torch.bool)


def test_roofline_gives_the_numbers_chip_smoke_gave():
    """bound, lm_step_ops and k4_bound on fixed inputs: the numbers of
    chip_smoke.py's own functions before they moved into the package."""
    assert roofline.bound(1.0e9, 1.0e12) == {"bound_ms": 14.925373134328359,
                                             "bound_by": "operations"}
    assert roofline.bound(3.0e9, 1.0e10) == {"bound_ms": 0.8955223880597015, "bound_by": "bytes"}
    assert [roofline.lm_step_ops(200, 8, 50), roofline.lm_step_ops(200, 8, 20),
            roofline.lm_step_ops(40, 0, 50)] == [2417, 2387, 1057]
    cp, prior, fields = CostmapParams(), torch.zeros((6, 5), dtype=torch.float32), _fields()
    want = {(False, False): (4.925373134328358e-07, "bytes"),
            (False, True): (4.925373134328358e-07, "bytes"),
            (True, False): (3.411609402021452e-07, "operations"),
            (True, True): (3.5728034318721986e-07, "operations")}
    for (fused, faithful), (ms, by) in want.items():
        assert roofline.k4_bound(cp, prior, fields, fused=fused, faithful=faithful) == {
            "bound_ms": ms, "bound_by": by}


def test_chip_smoke_takes_the_bound_model_from_the_package():
    for name in ("bound", "nbytes", "lm_step_ops", "k4_bound", "RICCATI_STEP_OPS",
                 "ROLLOUT_STEP_OPS", "FP32_OPS_PER_S"):
        assert getattr(chip_smoke, name) is getattr(roofline, name), name


def test_mega_iteration_cost():
    """One LM iteration of one scenario at N=50 on the benchmark's world
    (S=200 samples, M=8 obstacle slots, the map's uncertainty term):
    50 x 2417 operations, X and U read and written once; operations bind."""
    p = dataclasses.replace(SolverParams(), horizon=50)
    c = roofline.mega_iteration_cost(p, p.n_closest_samples, 8, 50)
    assert p.n_closest_samples == 200
    assert c.n_ops == 50 * 2417 and c.n_bytes == 4 * (51 * 4 + 50 * 2) * 2
    assert c.bound == "operations"
    assert c.t_sol == max(c.n_ops / roofline.FP32_OPS_PER_S, c.n_bytes / roofline.MEM_BYTES_PER_S)
