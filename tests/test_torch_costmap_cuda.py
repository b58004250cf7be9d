"""The costmap build's corridor mask and obstacle layer as one op
(``cilqr_tpu_torch/ops/costmap_cuda.py``, op ``cilqr_torch::costmap_layers``,
kernel ``csrc/costmap.cu``).

Here, on the CPU: the op's CPU implementation equal, bit for bit, to the
corridor mask and the rasterization loop written out below step by step
(``reference_layers``: the plain PyTorch of both layers, kept here apart
from the port's own plain version), in float32 and
float64, with 0, 1 and 8 obstacles, inactive and out-of-range obstacles,
both vertex orders and planted ties (vertices on cell centres, so that
cross products and corridor bounds are exactly 0 away); the op's fake;
the builds with and without kernels giving the same layers; the kernel's
entry point called only inside the op.  The ``cuda`` tests hold the kernel
to its plain version on every cell of both layers, count its launches in
the full stack and the Monte-Carlo path, and hold the full stack to the
route that forms the layers in plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from cilqr_tpu_torch.models import reference_path as rp
from cilqr_tpu_torch.ops import costmap, costmap_cuda, gridmap
from cilqr_tpu_torch.utils.params import CostmapParams, SolverParams
from tests.test_torch_graph_loops import PORT, calls_by_function

DEV = "cpu"  # the port allocates on the card unless told otherwise
DTYPES = (torch.float32, torch.float64)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One PyTorch thread while this file runs (six test workers share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_layers(xs, ys, bounds, verts, active):
    """The corridor mask and the obstacle layer, step by step in plain
    PyTorch: the corridor's four compares; per obstacle the
    all-same-side test edge by edge, gated by ``active``, into a running
    maximum, then x100."""
    x_min, x_max, y_min, y_max = (b[..., None, None] for b in bounds.unbind(-1))
    corridor = ((xs[..., :, None] >= x_min) & (xs[..., :, None] <= x_max)
                & (ys[..., None, :] >= y_min) & (ys[..., None, :] <= y_max)).to(xs.dtype)
    px, py = xs[..., :, None], ys[..., None, :]
    out = torch.zeros(tuple(active.shape[:-1]) + (xs.shape[-1], ys.shape[-1]), dtype=xs.dtype)
    for m in range(verts.shape[-3]):
        vertices = verts[..., m, :, :]
        K = vertices.shape[-2]
        all_ge = all_le = None
        for k in range(K):
            v = vertices[..., k, :]
            vn = vertices[..., (k + 1) % K, :]
            ex = (vn[..., 0] - v[..., 0])[..., None, None]
            ey = (vn[..., 1] - v[..., 1])[..., None, None]
            rx = px - v[..., 0, None, None]
            ry = py - v[..., 1, None, None]
            cross = ex * ry - ey * rx
            ge, le = cross >= 0, cross <= 0
            all_ge = ge if all_ge is None else all_ge & ge
            all_le = le if all_le is None else all_le & le
        mask = (all_ge | all_le).to(xs.dtype)
        out = torch.maximum(out, torch.where(active[..., m, None, None], mask,
                                             torch.zeros_like(mask)))
    return corridor, 100.0 * out


def planted_terms(B: int, rows: int, cols: int, M: int, dtype, device, seed: int,
                  cw: bool = False, active_share: float = 0.75, nan: bool = False):
    """Per-scenario terms on frames of ``rows`` x ``cols`` cells at 0.2 m
    (cell centres as ``gridmap.cell_positions`` forms them): corridor bounds
    half of them on cell centres; M obstacles per scenario, cycling through
    an axis-aligned box and a diamond with every vertex on a cell centre
    (edges through cell centres: exact zero cross products) and a rotated
    box anywhere on the frame; vertex order counter-clockwise, or clockwise
    with ``cw``; each obstacle active with probability ``active_share``;
    with ``nan`` a NaN corner in some scenarios."""
    rng = np.random.default_rng(seed)
    geom = gridmap.GridGeom(torch.tensor(rng.uniform(-8.0, 8.0, (B, 2)), dtype=dtype),
                            torch.tensor(0.2, dtype=dtype).expand(B),
                            torch.tensor([rows * 0.2, cols * 0.2], dtype=dtype).expand(B, 2))
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    ar = torch.arange(B)
    i = torch.tensor(rng.integers(0, rows, (B, 2)))
    j = torch.tensor(rng.integers(0, cols, (B, 2)))
    # positions fall as indices grow: the larger index is the lower bound
    on_centres = torch.stack([xs[ar, i.amax(1)], xs[ar, i.amin(1)], ys[ar, j.amax(1)],
                              ys[ar, j.amin(1)]], dim=-1)
    x0 = xs[:, 0] - torch.tensor(rng.uniform(0.0, rows * 0.2, B), dtype=dtype)
    y0 = ys[:, 0] - torch.tensor(rng.uniform(0.0, cols * 0.2, B), dtype=dtype)
    anywhere = torch.stack([x0, x0 + 6.0, y0, y0 + 4.0], dim=-1)
    bounds = torch.where(torch.tensor(rng.random(B) < 0.5)[:, None], on_centres, anywhere)

    verts = torch.empty((B, M, 4, 2), dtype=dtype)
    for m in range(M):
        a = torch.tensor(rng.integers(2, rows - 2, B))
        c = torch.tensor(rng.integers(2, cols - 2, B))
        k = torch.tensor(rng.integers(1, 3, B))
        if m % 3 == 0:  # axis-aligned box, corners on cell centres
            i0, i1 = (a - k).clamp(min=0), (a + k).clamp(max=rows - 1)
            j0, j1 = (c - k).clamp(min=0), (c + k).clamp(max=cols - 1)
            pts = [(i1, j1), (i0, j1), (i0, j0), (i1, j0)]
        elif m % 3 == 1:  # diamond, corners on cell centres
            pts = [(a, (c - k).clamp(min=0)), ((a + k).clamp(max=rows - 1), c),
                   (a, (c + k).clamp(max=cols - 1)), ((a - k).clamp(min=0), c)]
        else:  # rotated box anywhere
            cx = torch.tensor(rng.uniform(-0.5 * rows * 0.2, 0.5 * rows * 0.2, B), dtype=dtype)
            cy = torch.tensor(rng.uniform(-0.5 * cols * 0.2, 0.5 * cols * 0.2, B), dtype=dtype)
            yaw = torch.tensor(rng.uniform(-np.pi, np.pi, B), dtype=dtype)
            hx = torch.tensor(rng.uniform(1.0, 1.5, B), dtype=dtype)
            hy = torch.tensor(rng.uniform(0.6, 0.9, B), dtype=dtype)
            co, so = torch.cos(yaw), torch.sin(yaw)
            corners = []
            for sx, sy in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
                lx, ly = sx * hx, sy * hy
                corners.append(torch.stack([geom.center[:, 0] + cx + co * lx - so * ly,
                                            geom.center[:, 1] + cy + so * lx + co * ly], -1))
            verts[:, m] = torch.stack(corners, dim=1)
            continue
        verts[:, m] = torch.stack([torch.stack([xs[ar, pi], ys[ar, pj]], -1) for pi, pj in pts],
                                  dim=1)
    if cw:
        verts = verts.flip(-2)
    if nan and M:
        verts[torch.tensor(rng.random(B) < 0.1), 0, 2, 1] = float("nan")
    active = torch.tensor(rng.random((B, M)) < active_share)
    return tuple(t.to(device) for t in (xs, ys, bounds, verts, active))


def world_terms(dtype, obs: dict, B: int = 5):
    """The build's own per-scenario terms on the 152x104 frame (corridor
    geometry, cell positions, ``obstacle_corners``) for B egos along a plan,
    with the obstacles ``obs`` (xy (M, 2), size (M, 2), yaw (M,), mask (M,))."""
    cp = CostmapParams()
    s = np.linspace(0.0, 119.0, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s], axis=1)
    plan, n = rp.pad_global_plan(SolverParams(), plan_np, dtype=dtype, device=DEV)
    rng = np.random.default_rng(21)
    egos = torch.tensor(np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.3, (B, 4)),
                        dtype=dtype)
    center, _, bounds = costmap.corridor_geometry(cp, plan, n, egos[:, :2], egos[:, 3])
    geom = costmap.vehicle_geom(cp, center)
    xs, ys = gridmap.cell_positions(geom, cp.rows, cp.cols)
    t = lambda k: torch.tensor(np.asarray(obs[k], np.float64), dtype=dtype)
    verts, active = costmap.obstacle_corners(cp, t("xy"), t("size"), t("yaw"), t("mask"),
                                             egos[:, :2], egos[:, 3], dtype)
    return xs, ys, torch.stack(bounds, dim=-1), verts, active


NEAR = dict(xy=[[104.0, -305.0], [101.5, -304.0]], size=[[3.63, 1.84], [2.0, 1.0]],
            yaw=[0.0, 0.6], mask=[1.0, 1.0])
# one masked off, one 300 m away, one inside the frame
GATED = dict(xy=[[104.0, -305.0], [400.0, 0.0], [101.5, -304.0]],
             size=[[3.63, 1.84], [3.0, 1.5], [2.0, 1.0]], yaw=[0.0, 0.1, 0.6],
             mask=[0.0, 1.0, 1.0])
CASES = {
    "world_m0": lambda dt: world_terms(dt, dict(xy=np.zeros((0, 2)), size=np.zeros((0, 2)),
                                                yaw=np.zeros(0), mask=np.zeros(0))),
    "world_m1": lambda dt: world_terms(dt, {k: v[:1] for k, v in NEAR.items()}),
    "world_m2": lambda dt: world_terms(dt, NEAR),
    "world_gated": lambda dt: world_terms(dt, GATED),
    "ties_m1": lambda dt: planted_terms(16, 24, 16, 1, dt, DEV, seed=1, active_share=1.0),
    "ties_m8_ccw": lambda dt: planted_terms(16, 24, 16, 8, dt, DEV, seed=2),
    "ties_m8_cw": lambda dt: planted_terms(16, 24, 16, 8, dt, DEV, seed=2, cw=True),
    "ties_m8_nan": lambda dt: planted_terms(32, 20, 10, 8, dt, DEV, seed=3, nan=True),
    "ties_m0": lambda dt: planted_terms(4, 24, 16, 0, dt, DEV, seed=4),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_layers_op_on_the_cpu_is_the_plain_build(case, dtype):
    """The op's CPU implementation (``costmap_cuda.costmap_layers`` on CPU
    tensors) equals ``reference_layers`` bit for bit, and so does the plain
    version the oracle route calls; the cases are not empty (cells on both
    sides of the corridor and, with an active obstacle, of a box)."""
    terms = CASES[case](dtype)
    want = reference_layers(*terms)
    got = costmap_cuda.costmap_layers(*terms)
    assert all(g.dtype == dtype and g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(costmap_cuda.costmap_layers_plain(*terms), want))
    corridor, bbox = want
    assert 0 < int(corridor.sum()) < corridor.numel()
    assert bool(((bbox == 0) | (bbox == 100)).all())
    if bool(terms[4].any()):
        assert 0 < int((bbox == 100).sum()) < bbox.numel()
    if case.startswith("ties"):
        assert torch.isin(terms[2], terms[0]).any()  # corridor bounds on cell centres


def test_planted_ties_are_exact_zero_cross_products():
    """The planted boxes put cells on their edges: some cross product of the
    plain test is exactly 0 (the ``>=`` / ``<=`` knife-edge)."""
    xs, ys, _, verts, _ = planted_terms(8, 24, 16, 3, torch.float32, DEV, seed=5)
    v, vn = verts, verts.roll(-1, dims=-2)
    ex, ey = (vn - v).unbind(-1)  # (B, M, 4)
    rx = xs[:, None, None, :, None] - v[..., 0, None, None]
    ry = ys[:, None, None, None, :] - v[..., 1, None, None]
    cross = ex[..., None, None] * ry - ey[..., None, None] * rx
    assert int((cross == 0).sum()) > 0


@pytest.mark.parametrize("M", [0, 2])
def test_opcheck_costmap_layers(M):
    """``torch.library.opcheck`` on the op (B=3 frames of 16x12 cells), and
    its fake: the shapes and dtype of the real outputs, unbatched too."""
    terms = planted_terms(3, 16, 12, M, torch.float32, DEV, seed=6)
    torch.library.opcheck(torch.ops.cilqr_torch.costmap_layers.default, terms)
    for args in (terms, tuple(t[0] for t in terms)):
        real = torch.ops.cilqr_torch.costmap_layers(*args)
        with FakeTensorMode() as mode:
            fake = torch.ops.cilqr_torch.costmap_layers(*(mode.from_tensor(t) for t in args))
        assert [(f.shape, f.dtype) for f in fake] == [(r.shape, r.dtype) for r in real]


def test_the_launch_refuses_more_obstacles_than_the_kernel_stages():
    """More than ``MAX_OBSTACLES`` obstacles per frame are refused before
    any other check, with the limit in the message; the plain version takes
    them."""
    terms = planted_terms(1, 8, 8, costmap_cuda.MAX_OBSTACLES + 1, torch.float32, DEV, seed=7)
    with pytest.raises(ValueError, match=f"at most {costmap_cuda.MAX_OBSTACLES}"):
        costmap_cuda._launch(*terms)
    corridor, bbox = costmap_cuda.costmap_layers(*terms)
    assert bbox.shape == corridor.shape == (1, 8, 8)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_builds_give_the_same_layers_with_and_without_kernels(dtype):
    """``build_local_costmap_batched`` and ``build_local_costmap`` with
    ``use_kernels`` (the op) give the corridor mask and the box layer of
    ``use_kernels=False`` (the plain version, no op), bit for bit; the
    batched build's vehicle map before K5 is the box layer."""
    cp = dataclasses.replace(CostmapParams(), window_radius=2)
    s = np.linspace(0.0, 119.0, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s)], axis=1)
    plan, n = rp.pad_global_plan(SolverParams(), plan_np, dtype=dtype, device=DEV)
    rng = np.random.default_rng(8)
    gm = torch.tensor(rng.uniform(0.0, 100.0, (40, 36)), dtype=dtype)
    gg = gridmap.make_geom([104.0, -304.0], 0.5, 40, 36, dtype=dtype, device=DEV)
    egos = torch.tensor(np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.3, (6, 4)),
                        dtype=dtype)
    t = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype)
    obs = (t(GATED["xy"]), t(GATED["size"]), t(GATED["yaw"]), t([1.0, 1.0, 1.0]))
    fast = costmap.build_local_costmap_batched(cp, gm, gg, plan, n, egos, *obs)
    plain = costmap.build_local_costmap_batched(cp, gm, gg, plan, n, egos, *obs,
                                                use_kernels=False)
    assert torch.equal(fast.corridor_mask, plain.corridor_mask)
    assert torch.equal(fast.bounding_box_map, plain.bounding_box_map)
    assert int((fast.bounding_box_map == 100).sum()) > 0
    pre = costmap._costmap_pre(cp, gm, gg, plan, n, egos, *obs, use_kernels=True,
                               skip_prior=True)
    assert torch.equal(pre[0], plain.bounding_box_map)
    for b in (0, 3):
        one = costmap.build_local_costmap(cp, gm, gg, plan, n, egos[b], *obs, use_kernels=True)
        ref = costmap.build_local_costmap(cp, gm, gg, plan, n, egos[b], *obs)
        assert torch.equal(one.corridor_mask, ref.corridor_mask)
        assert torch.equal(one.bounding_box_map, ref.bounding_box_map)
        assert torch.equal(one.vehicle_map, ref.vehicle_map)
        assert torch.equal(one.corridor_mask, plain.corridor_mask[b])


def test_the_kernel_launches_only_inside_its_op():
    """By the source: the entry point ``lib.cilqr_costmap_layers`` is called
    in the op's CUDA implementation only, the op from ``_op`` only, and
    ``_op`` from the launch function and the CPU route; no other file of the
    port, nor ``chip_smoke.py``, calls the entry point, the op or its
    implementations."""
    calls = calls_by_function(PORT / "ops" / "costmap_cuda.py")
    assert calls["lib.cilqr_costmap_layers"] == ["_layers_kernel"]
    assert calls["torch.ops.cilqr_torch.costmap_layers"] == ["_op"]
    assert sorted(calls["_op"]) == ["_launch", "costmap_layers"]
    for path in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]:
        if path.name != "costmap_cuda.py":
            called = calls_by_function(path)
            assert not any(name.endswith(("cilqr_costmap_layers", "cilqr_torch.costmap_layers",
                                          "_layers_kernel", "costmap_cuda._layers"))
                           for name in called), path


# ------------------------------------------------------------- on the card
def _equal_on_the_card(terms) -> None:
    got = costmap_cuda.costmap_layers(*terms)
    want = costmap_cuda.costmap_layers_plain(*terms)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w), int((g != w).sum())


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("B", [1, 1024, 8192])
def test_kernel_equals_its_plain_version_on_the_card(B):
    """The kernel equals its plain version on every cell of both layers at
    152x104 frames with M=8 (planted ties, both vertex orders, inactive
    obstacles, NaN corners), one launch per call; at B=1 also unbatched
    (no leading dim), and at B=64 on 150x102 frames (the scalar stores)."""
    dev = torch.device("cuda", 0)
    before = costmap_cuda.LAUNCHES
    for cw in (False, True):
        terms = planted_terms(B, 152, 104, 8, torch.float32, dev, seed=B + cw, cw=cw, nan=True)
        _equal_on_the_card(terms)
        if B == 1:
            _equal_on_the_card(tuple(t[0] for t in terms))
    _equal_on_the_card(planted_terms(64, 150, 102, 8, torch.float32, dev, seed=9))
    _equal_on_the_card(planted_terms(64, 152, 104, 0, torch.float32, dev, seed=10))
    assert costmap_cuda.LAUNCHES - before == (6 if B == 1 else 4)


def _full_stack_setup(dev, B: int, cycles: int):
    from tests.test_torch_graph_ops import card_world

    p, plan, n, egos, U, obstacles, unc = card_world(dev, B, seed=90)
    gm = torch.tensor(np.random.default_rng(91).uniform(0, 100, (256, 256)),
                      dtype=torch.float32, device=dev)
    gg = gridmap.make_geom([110.0, -300.0], 0.5, 256, 256, device=dev)
    obs = (torch.tensor([[115.0, -305.0, 0.0]], device=dev),
           torch.tensor([[3.63, 1.84]], device=dev), torch.ones(1, device=dev))
    draws = torch.tensor(np.random.default_rng(92).normal(size=(cycles, B, 3)),
                         dtype=torch.float32, device=dev)
    return p, plan, n, egos, obstacles, gm, gg, obs, draws


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_layers_launch_once_per_full_stack_cycle(monkeypatch):
    """The graphed full stack launches the kernel once per start-graph
    replay: 20 in a 20-cycle call (B=64), the same on a second call that
    replays without a capture; ``monte_carlo(impl="fast")`` never."""
    from cilqr_tpu_torch.models import solver
    from cilqr_tpu_torch.parallel import monte_carlo as mc
    from cilqr_tpu_torch.sim import plant
    from cilqr_tpu_torch.utils import graphs
    from cilqr_tpu_torch.utils.params import NoiseParams
    from cilqr_tpu_torch.ops import uncertainty_cuda
    from cilqr_tpu_torch.models import uncertainty as unc_mod

    monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
    monkeypatch.setattr(solver, "GRAPHS", True)
    dev = torch.device("cuda", 0)
    p, plan, n, egos, obstacles, gm, gg, obs, draws = _full_stack_setup(dev, 64, 20)
    cp, noise = CostmapParams(), NoiseParams(0.05, 0.05, 0.005)
    for _ in range(2):
        before = costmap_cuda.LAUNCHES
        plant.closed_loop_full_stack_batched(p, cp, noise, gm, gg, plan, n, egos, None, 20,
                                             obstacles, *obs, noise_draws=draws)
        torch.cuda.synchronize()
        assert costmap_cuda.LAUNCHES - before == 20
    cpm = dataclasses.replace(cp, window_radius=1)
    gen = torch.Generator(device=dev).manual_seed(93)
    s = mc.sample_scenarios(gen, 64, egos[0], sigma_hi=(0.16, 0.16, 0.017), device=dev)
    band = uncertainty_cuda.make_band_plan(cpm, cp.rows, cp.cols, (2.0, 0.0), (0.16, 0.16, 0.017))
    umap = unc_mod.make_uncertainty_map(np.random.default_rng(94).uniform(0, 100, (152, 104)),
                                        [2.0, 0.0], 0.2, egos[0, :2], 0.05, device=dev)
    before = costmap_cuda.LAUNCHES
    mc.monte_carlo(p, cpm, umap.values, umap.geom, umap.origin_xy, umap.origin_yaw, plan, n, s,
                   obstacles, sigma_hi=(0.16, 0.16, 0.017), impl="fast", band_plan=band)
    torch.cuda.synchronize()
    assert costmap_cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_full_stack_equals_the_plain_layers_route_on_the_card(monkeypatch):
    """The graphed full stack (B=256 x 3 cycles) gives every record bit for
    bit as the same graphed loop with the layers formed in plain PyTorch
    (the kernel's launch function swapped for its plain version, the stages
    still captured)."""
    from torch.utils._pytree import tree_flatten

    from cilqr_tpu_torch.models import solver
    from cilqr_tpu_torch.sim import plant
    from cilqr_tpu_torch.utils import graphs
    from cilqr_tpu_torch.utils.params import NoiseParams

    monkeypatch.setattr(solver, "GRAPHS", True)
    dev = torch.device("cuda", 0)
    p, plan, n, egos, obstacles, gm, gg, obs, draws = _full_stack_setup(dev, 256, 3)
    cp, noise = CostmapParams(), NoiseParams(0.05, 0.05, 0.005)

    def run():
        monkeypatch.setattr(solver, "CAPTURED", graphs.GraphCache())
        out = plant.closed_loop_full_stack_batched(p, cp, noise, gm, gg, plan, n, egos, None, 3,
                                                   obstacles, *obs, noise_draws=draws)
        torch.cuda.synchronize()
        return out

    before = costmap_cuda.LAUNCHES
    fused = run()
    assert costmap_cuda.LAUNCHES - before == 3
    monkeypatch.setattr(costmap_cuda, "_launch", costmap_cuda.costmap_layers_plain)
    monkeypatch.setattr(graphs, "LAUNCHERS", [
        (m, name, costmap_cuda.costmap_layers_plain if m is costmap_cuda else fn)
        for m, name, fn in graphs.LAUNCHERS])
    assert graphs.on_kernels()
    plain = run()
    assert costmap_cuda.LAUNCHES - before == 3
    la, sa = tree_flatten(fused)
    lb, sb = tree_flatten(plain)
    assert sa == sb
    for x, y in zip(la, lb):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
