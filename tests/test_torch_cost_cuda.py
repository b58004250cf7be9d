"""The two-phase LM step's cost derivatives and J as one op
(``cilqr_tpu_torch/ops/cost_cuda.py``, op ``cilqr_torch::cost_derivs``,
kernel ``csrc/cost.cu``).

Here, on the CPU: the op's CPU implementation equal, bit for bit, to
``costs.all_cost_derivs_and_J`` in float32 and float64, with shared and
per-lane obstacles (CCNMPC's tightened ones: per-lane dims, a broadcast
pose), padding slots, per-lane masks, with and without external uncertainty
planes; ``opcheck`` and the fake's shapes; the two-phase loop on the CPU
never reaching the kernel's launch; the kernel's entry point called only
inside the op; the ctypes mirror of the kernel's config, field for field.
The ``cuda`` tests hold the kernel to its plain version per lane at phase
3's bars (1e-4 relative + 1e-5 absolute) on CCNMPC's deployment at (8192,
40) and at odd B, with and without planes; planted ties in the sample table
against the plain tournament's winner; a padding slot whose barrier
overflows; the two-phase loop graphed = eager with one launch per step, as
many as K2's.
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from cilqr_tpu_torch.models import ccnmpc, costs, dynamics, solver, solver_batched
from cilqr_tpu_torch.models import obstacles as obs_mod
from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.ops import cost_cuda, lm_cuda, riccati_cuda
from cilqr_tpu_torch.utils.params import NoiseParams, SolverParams
from tests.test_torch_graph_loops import PORT, calls_by_function

DEV = "cpu"  # the port allocates on the card unless told otherwise
DTYPES = (torch.float32, torch.float64)
CC_CONFIG = PORT.parent / "benchmarks" / "configs" / "ccnmpc_success1_n40.json"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs (six test workers share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ccnmpc_world(B: int, dtype, device, seed: int, p=None):
    """CCNMPC's deployment (the benchmark cell's config: the success1 lane
    and its three obstacles in eight slots, N=40): (p, plans, X, U,
    obstacles shared, obstacles tightened per lane) at B starts along the
    lane, the trajectory the rollout of the initial controls moved by a
    random warm start, the obstacles tightened along it as a round's start
    does."""
    cfg = json.loads(CC_CONFIG.read_text())
    w, lane = cfg["world"], cfg["world"]["plan"]
    p = p or dataclasses.replace(SolverParams(), **cfg["solver"])
    noise, cc = NoiseParams(**cfg["noise"]), ccnmpc.CCParams(**cfg["chance"])
    kw = dict(dtype=dtype, device=device)
    xs = lane["x0"] + lane["spacing"] * np.arange(int(lane["length"] / lane["spacing"]) + 1)
    plan_xy, plan_n = rp.pad_global_plan(p, np.stack([xs, np.full_like(xs, lane["y"])], axis=1),
                                         **kw)
    obs = np.asarray(w["obstacles"], dtype=np.float64)
    sizes = np.tile(np.asarray(w["obstacle_size"], dtype=np.float64), (len(obs), 1))
    ob = obs_mod.make_static_obstacles(p, obs[:, :2], sizes, obs[:, 2], **kw)
    rng = np.random.default_rng(seed)
    egos = torch.tensor(np.asarray(w["start"])[None, :] + np.stack(
        [rng.uniform(0.0, w["start_spread_m"], B), rng.normal(0.0, 0.5, B),
         rng.uniform(-1.0, 1.0, B), rng.normal(0.0, 0.05, B)], axis=1), **kw)
    U = (solver.initial_controls(p, **kw)[None]
         + torch.tensor(rng.normal(0.0, 0.3, (B, p.horizon, 2)), **kw))
    X = dynamics.rollout(p, egos, U)
    W = ccnmpc.process_noise(noise, **kw)
    ob_t = ccnmpc.tightened_obstacles(p, cc, ob, ccnmpc.propagate_covariance(p, X, U, W, W))
    return p, rp.get_local_plan(p, plan_xy, plan_n, egos), X, U, ob, ob_t


def random_planes(B: int, N: int, dtype, device, seed: int) -> torch.Tensor:
    """(B, N, 3) uncertainty planes [e, gx, gy]: e 0 on a third of the
    steps (outside the map), else up to the barrier's top, gradients of the
    map's size."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(0.0, 2.5 * np.exp(2.5), (B, N)) * (rng.random((B, N)) > 1 / 3)
    g = rng.normal(0.0, 0.1, (B, N, 2))
    return torch.tensor(np.concatenate([e[..., None], g], axis=-1), dtype=dtype, device=device)


def world_case(case: str, ob, ob_t, B: int):
    """The obstacles of a case: none; shared; tightened per lane (dims per
    lane, pose a broadcast); per lane with a per-lane mask that also pads a
    real obstacle in every other lane."""
    if case == "none":
        return None
    if case == "shared":
        return ob
    if case == "per_lane":
        return ob_t
    mask = ob_t.mask.expand(B, -1).clone()
    mask[::2, 1] = 0.0
    return ob_t._replace(mask=mask)


CASES = ["none", "shared", "per_lane", "per_lane_mask"]


def prepared(plans) -> tuple:
    """(table, fit) of ``lm_cuda.prep_iteration(plans)``, as the two-phase
    iteration prepares them once per solve."""
    prep = lm_cuda.prep_iteration(plans)
    return prep.table, prep.fit


@pytest.mark.parametrize("planes", [False, True], ids=["no_planes", "planes"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_op_on_the_cpu_is_the_plain_version(dtype, case, planes):
    """The op's CPU implementation (the op called on CPU tensors) returns
    ``costs.all_cost_derivs_and_J``'s l_x, l_xx, l_u, l_uu and J bit for
    bit, l_ux left out; the padding slots (five of eight) and a per-lane
    mask included."""
    B = 6
    p, plans, X, U, ob, ob_t = ccnmpc_world(B, dtype, DEV, seed=3)
    obstacles = world_case(case, ob, ob_t, B)
    pl = random_planes(B, p.horizon, dtype, DEV, seed=4) if planes else None
    table, fit = prepared(plans)
    outs = torch.ops.cilqr_torch.cost_derivs(
        riccati_cuda.params_arg(p), X, U, fit, table, list(plans),
        [] if obstacles is None else list(obstacles), pl)
    want, want_J = costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, None, unc_planes=pl)
    assert len(outs) == 5
    for got, ref in zip(outs, (want.l_x, want.l_xx, want.l_u, want.l_uu, want_J)):
        assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("case", ["shared", "per_lane"])
def test_opcheck_cost_derivs(case):
    """``torch.library.opcheck`` on the op (schema, fake, dispatch) with
    shared and with per-lane obstacles, planes given."""
    B = 3
    p, plans, X, U, ob, ob_t = ccnmpc_world(B, torch.float32, DEV, seed=5,
                                            p=dataclasses.replace(SolverParams(), horizon=8))
    obstacles = world_case(case, ob, ob_t, B)
    prep = lm_cuda.prep_iteration(plans)
    args = (riccati_cuda.params_arg(p), X, U, prep.fit, prep.table, list(plans),
            list(obstacles), random_planes(B, p.horizon, torch.float32, DEV, 6))
    torch.library.opcheck(torch.ops.cilqr_torch.cost_derivs.default, args)


@pytest.mark.parametrize("planes", [False, True], ids=["no_planes", "planes"])
def test_the_fake_gives_the_shapes(planes):
    """Under a fake mode the op gives (B, N, 4), (B, N, 4, 4), (B, N, 2),
    (B, N, 2, 2) and (B,) in the inputs' dtype, as the kernel writes them."""
    B = 5
    p, plans, X, U, ob, ob_t = ccnmpc_world(B, torch.float32, DEV, seed=7)
    N = p.horizon
    pl = random_planes(B, N, torch.float32, DEV, 8) if planes else None
    prep = lm_cuda.prep_iteration(plans)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = lambda t: None if t is None else mode.from_tensor(t)
        outs = torch.ops.cilqr_torch.cost_derivs(
            riccati_cuda.params_arg(p), fake(X), fake(U), fake(prep.fit), fake(prep.table),
            [fake(t) for t in plans], [fake(t) for t in ob_t], fake(pl))
    assert [tuple(t.shape) for t in outs] == [(B, N, 4), (B, N, 4, 4), (B, N, 2), (B, N, 2, 2),
                                              (B,)]
    assert all(t.dtype == torch.float32 for t in outs)


def test_two_phase_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    """On the CPU the two-phase loop takes ``costs.all_cost_derivs_and_J``
    as before: the derivatives op and its launch function are never called,
    no payload is prepared, and the solve equals the loop written with the
    plain derivatives."""
    def refuse(*args, **kw):
        raise AssertionError("the derivatives kernel's route was taken on the CPU")

    B = 4
    p, plans, X, U, ob, ob_t = ccnmpc_world(B, torch.float32, DEV, seed=9)
    egos = X[:, 0]
    it = solver_batched.two_phase_iteration(plans, ob_t)
    assert it.world[-1] is None
    monkeypatch.setattr(cost_cuda, "_launch", refuse)
    monkeypatch.setattr(cost_cuda, "cost_derivs", refuse)
    got = solver.optimize(p, plans, egos, U, iteration=it)

    def plain(X, U, lamb):
        d, J = costs.all_cost_derivs_and_J(p, plans, X, U, ob_t, None)
        return (*riccati_cuda.backward_forward_plain(p, d, X, U, lamb), J)

    want = solver.optimize(p, plans, egos, U, iteration=plain)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_launch_refuses_what_the_kernel_cannot_take():
    """The launch function takes float32 CUDA tensors of the solve's shapes
    and at most ``MAX_THREADS`` steps."""
    p, plans, X, U, ob, ob_t = ccnmpc_world(2, torch.float32, DEV, seed=11)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cost_cuda._launch(p, plans, X, U, ob_t, None, prepared(plans))
    assert cost_cuda.lanes_per_block(40) == 8 and cost_cuda.lanes_per_block(100) == 5
    assert cost_cuda.lanes_per_block(cost_cuda.MAX_THREADS) == 1
    with pytest.raises(ValueError, match="at most"):
        cost_cuda.lanes_per_block(cost_cuda.MAX_THREADS + 1)


def test_the_kernel_launches_only_inside_its_op():
    """By the source: the entry point ``lib.cilqr_cost_derivs`` is called
    once, in the op's CUDA implementation; the op from the launch function
    alone; the launch function from ``cost_derivs`` alone; no other file of the port, nor ``chip_smoke.py``,
    names the entry point or the op's implementation, and only the two-phase
    iteration calls ``cost_derivs``."""
    calls = calls_by_function(PORT / "ops" / "cost_cuda.py")
    assert calls["lib.cilqr_cost_derivs"] == ["_cost_derivs_kernel"]
    assert calls["torch.ops.cilqr_torch.cost_derivs"] == ["_launch"]
    assert calls["_launch"] == ["cost_derivs"]
    for f in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]:
        if f.name == "cost_cuda.py":
            continue
        text = f.read_text()
        for name in ("_cost_derivs_kernel", "cilqr_cost_derivs("):
            assert name not in text, (f, name)
        found = calls_by_function(f)
        assert "cost_cuda._launch" not in found, f
        if f.name not in ("solver_batched.py", "chip_smoke.py"):
            assert "cost_cuda.cost_derivs" not in found, f
    assert calls_by_function(PORT / "models" / "solver_batched.py")["cost_cuda.cost_derivs"] == [
        "iteration"]
    op = torch.ops.cilqr_torch.cost_derivs.default
    assert all(a.alias_info is None for a in op._schema.arguments)
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key)


def test_the_config_mirror_matches_the_kernel_struct():
    """``cost_cuda._CostConfig`` lists the fields of ``CostConfig`` in
    ``csrc/cost.cu`` in order, with their C types (the card checks only the
    size)."""
    import ctypes

    src = (PORT / "csrc" / "cost.cu").read_text()
    body = re.search(r"struct CostConfig \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        ctype, names = re.match(r"(long long|int|float|DynConst)\s+(.*)", line).groups()
        if ctype == "DynConst":  # cilqr_common.cuh: six floats
            fields += [(n, "float") for n in ("dt", "acc_min", "acc_max", "tan_lo", "tan_hi",
                                              "speed_max")]
            continue
        for name in (n.strip() for n in names.split(",")):
            size = re.match(r"(\w+)(?:\[(\d+)\])?$", name)
            fields.append((size.group(1), ctype + (f"[{size.group(2)}]" if size.group(2) else "")))
    c_name = {ctypes.c_int: "int", ctypes.c_float: "float", ctypes.c_longlong: "long long"}
    mirror = [(n, f"{c_name[t._type_]}[{t._length_}]" if hasattr(t, "_length_") else c_name[t])
              for n, t in cost_cuda._CostConfig._fields_]
    assert mirror == fields


# ------------------------------------------------------------- on the card
def _held(got, want, rtol=1e-4, atol=1e-5) -> float:
    """The largest excess of |got - want| over atol + rtol |want| (<= 0:
    within the bar), after both are found finite."""
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    diff = (got.double() - want.double()).abs()
    return float((diff - (atol + rtol * want.double().abs())).max())


def _kernel_against_plain(p, plans, X, U, obstacles, planes) -> None:
    d, J = cost_cuda.cost_derivs(p, plans, X, U, obstacles, planes, prepared(plans))
    want, want_J = costs.all_cost_derivs_and_J(p, plans, X, U, obstacles, None, unc_planes=planes)
    for name, got, ref in zip(("l_x", "l_xx", "l_u", "l_uu", "J"),
                              (d.l_x, d.l_xx, d.l_u, d.l_uu, J),
                              (want.l_x, want.l_xx, want.l_u, want.l_uu, want_J)):
        assert got.shape == ref.shape and got.is_contiguous(), name
        assert _held(got, ref) <= 0.0, name


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("B", [8192, 1023, 1])
def test_kernel_equals_its_plain_version_on_the_card(B):
    """On CCNMPC's deployment (N=40, the success1 obstacles tightened per
    lane, five padding slots): every output of the kernel within 1e-4
    relative + 1e-5 absolute of the plain version, element by element, with
    and without planes, shared and per-lane obstacles; one launch per call."""
    dev = torch.device("cuda", 0)
    p, plans, X, U, ob, ob_t = ccnmpc_world(B, torch.float32, dev, seed=21)
    before = cost_cuda.LAUNCHES
    for case in CASES:
        for planes in (None, random_planes(B, p.horizon, torch.float32, dev, 22)):
            _kernel_against_plain(p, plans, X, U, world_case(case, ob, ob_t, B), planes)
    torch.cuda.synchronize()
    assert cost_cuda.LAUNCHES - before == 2 * len(CASES)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_planted_ties_pick_the_plain_winner_on_the_card():
    """The sample table's second half repeats its first, so every
    tournament winner has an exact twin S/2 samples later: the kernel must
    take the first, as the plain argmin does, or its closest point lands
    S/2 samples down the path.  Without world terms l_x is the tracking
    residual alone."""
    dev = torch.device("cuda", 0)
    p, plans, X, U, ob, ob_t = ccnmpc_world(4096, torch.float32, dev, seed=23)
    S = p.n_closest_samples
    half = S // 2
    twin = lambda t: torch.cat([t[:, :half], t[:, :half], t[:, 2 * half:]], dim=1)
    tied = plans._replace(sample_xl=twin(plans.sample_xl), sample_yl=twin(plans.sample_yl),
                          sample_r=twin(plans.sample_r))
    _kernel_against_plain(p, tied, X, U, None, None)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_a_padding_slot_that_overflows_gives_no_nan_on_the_card():
    """A padding slot (mask 0) placed on the ego's front disc with a barrier
    steep enough to overflow (q2 = 100: exp(100) > float32's largest) is passed
    over: the kernel's outputs are finite and equal, at the bars, to the
    plain version on the obstacles without that slot.  The plain version
    multiplies it by its mask: inf * 0 = NaN.  The live obstacles lie 1 km
    ahead, where their barriers are 0 whatever q2."""
    dev = torch.device("cuda", 0)
    cfg = json.loads(CC_CONFIG.read_text())
    p = dataclasses.replace(SolverParams(), **{**cfg["solver"], "q2_front": 100.0,
                                                "q2_rear": 100.0})
    p, plans, X, U, ob, ob_t = ccnmpc_world(64, torch.float32, dev, seed=25, p=p)
    pos = ob_t.pos.clone()
    pos[:, ob_t.mask != 0, :, 0] += 1000.0
    # the last slot (padding) on the front disc's centre: its barrier there is
    # q1 exp(q2), which overflows
    Xh = X[:, :p.horizon]
    pos[:, -1, :, 0] = Xh[..., 0] + torch.cos(Xh[..., 3]) * p.ego_front
    pos[:, -1, :, 1] = Xh[..., 1] + torch.sin(Xh[..., 3]) * p.ego_front
    assert float(ob_t.mask[-1]) == 0.0
    planted = ob_t._replace(pos=pos)
    d, J = cost_cuda.cost_derivs(p, plans, X, U, planted, None, prepared(plans))
    want, _ = costs.all_cost_derivs_and_J(p, plans, X, U, planted, None)
    assert not bool(torch.isfinite(want.l_x).all())
    assert all(bool(torch.isfinite(t).all()) for t in (d.l_x, d.l_xx, d.l_u, d.l_uu, J))
    kept = planted._replace(dims=planted.dims[:, :-1], pos=planted.pos[:, :-1],
                            mask=planted.mask[:-1])
    ref, ref_J = costs.all_cost_derivs_and_J(p, plans, X, U, kept, None)
    for got, r in zip((d.l_x, d.l_xx, d.l_u, d.l_uu, J),
                      (ref.l_x, ref.l_xx, ref.l_u, ref.l_uu, ref_J)):
        assert _held(got, r) <= 0.0


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("world", ["per_lane", "per_lane_map"])
def test_two_phase_loop_launches_the_kernel_once_per_step_on_the_card(world):
    """The two-phase loop (``run_steps_batched(impl="two_phase")``, per-lane
    tightened obstacles, with and without one map per scenario) graphed on
    the device loop equals ``solver.GRAPHS = False`` bit for bit, and in both
    the derivatives kernel launched once per LM step: as often as K2, the
    largest iteration count."""
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim.example_scenario import example_scenario

    dev = torch.device("cuda", 0)
    B = 256
    p, plans, X, U, ob, ob_t = ccnmpc_world(B, torch.float32, dev, seed=27)
    cfg = json.loads(CC_CONFIG.read_text())
    lane = cfg["world"]["plan"]
    xs = lane["x0"] + lane["spacing"] * np.arange(int(lane["length"] / lane["spacing"]) + 1)
    plan_xy, plan_n = rp.pad_global_plan(p, np.stack([xs, np.full_like(xs, lane["y"])], axis=1),
                                         dtype=torch.float32, device=dev)
    maps = None
    if world == "per_lane_map":
        unc = example_scenario(p, device=dev)[-1]
        H, W = unc.values.shape
        values = torch.rand((B, H, W), generator=torch.Generator(device=dev).manual_seed(28),
                            device=dev) * 100.0
        centred = unc.origin_xy.new_tensor([95.0, -306.74])
        maps = mc.per_scenario_map(values, unc.geom, centred, unc.origin_yaw)
    egos = X[:, 0].contiguous()
    out, counts = {}, {}
    try:
        for graphed in (True, False):
            solver.GRAPHS = graphed
            solver.CAPTURED.clear()
            before = (cost_cuda.LAUNCHES, riccati_cuda.LAUNCHES)
            out[graphed] = solver_batched.run_steps_batched(
                p, plan_xy, plan_n, egos, U.contiguous(), ob_t, maps, impl="two_phase",
                world_batched=True)
            torch.cuda.synchronize()
            counts[graphed] = (cost_cuda.LAUNCHES - before[0], riccati_cuda.LAUNCHES - before[1])
    finally:
        solver.GRAPHS = True
        solver.CAPTURED.clear()
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))
    steps = int(out[True].iterations.max())
    assert counts[True] == counts[False] == (steps, steps)
    assert bool(torch.isfinite(out[True].U).all())
