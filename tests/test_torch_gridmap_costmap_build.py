"""The costmap build (cilqr_tpu_torch/ops/gridmap, costmap, sample_cuda: kernel
K5) vs the JAX package.

The same float64 inputs, made with numpy from a seed, go through each JAX
function and its port.  Continuous outputs (corridor geometry, ellipses,
propagated maps) are held at 1e-10 of scale: the same algebra in float64.
Masks and gathers (``rasterize_*``, ``submap_mask``, ``ellipse_mask``,
``sample_nearest``, ``sample_prior``) are held exactly.  K5's plain version
is held exactly to the TPU kernels in the Pallas interpreter (float32, both
the shear and the window form), as tests/test_costmap.py runs them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import reference_path as jrp
from cilqr_tpu.ops import costmap as jcm, gridmap as jgrid, sample_pallas
from cilqr_tpu.utils.params import CostmapParams, SolverParams
from cilqr_tpu_torch.models import reference_path as trp
from cilqr_tpu_torch.ops import costmap as tcm, gridmap as tgrid, sample_cuda
from cilqr_tpu_torch.ops import uncertainty_cuda as tuc
from cilqr_tpu_torch.utils import interop

DEV = "cpu"  # the port allocates on the card unless told otherwise
REL = 1e-10
YAWS = [0.0, 0.7, np.pi / 2, 2.2, np.pi, -np.pi / 2, -3.0, -0.3]  # every quadrant, the axes


def close(got, want, rel=REL):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(1.0, float(np.abs(w).max())))


def exact(got, want):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def tgeom_of(jgeom, dtype=torch.float64):
    return interop.grid_geom_from_numpy(jgeom, dtype=dtype, device=DEV)


@pytest.fixture(scope="module")
def small():
    """A 24x16 vehicle grid, a 40x36 global map at 0.5 m, the test plan."""
    cp_j = dataclasses.replace(CostmapParams(), rows=24, cols=16, window_radius=3,
                               look_ahead_waypoints=10)
    cp = interop.costmap_params_from_reference(cp_j)
    p_j = SolverParams()
    rng = np.random.default_rng(21)
    gmap = rng.uniform(0.0, 100.0, (40, 36))
    jgg = jgrid.make_geom([104.0, -304.0], 0.5, 40, 36, dtype=jnp.float64)
    s = np.linspace(0.0, 119.0, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s], axis=1)
    jplan, jn = jrp.pad_global_plan(p_j, plan_np, dtype=jnp.float64)
    tplan, tn = trp.pad_global_plan(interop.solver_params_from_reference(p_j), plan_np,
                                    dtype=torch.float64, device=DEV)
    egos = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.3, (4, 4))
    egos[3] = [207.5, -303.0, 3.0, 0.3]  # next to the end of the plan: the repeated-tail headings
    obs = dict(xy=np.array([[106.0, -305.0], [101.5, -304.0], [400.0, 0.0]]),
               size=np.array([[3.63, 1.84], [2.0, 1.0], [3.0, 1.5]]),
               yaw=np.array([0.0, 0.6, 0.1]), mask=np.array([1.0, 1.0, 1.0]))
    return dict(cp_j=cp_j, cp=cp, gmap=gmap, jgg=jgg, tgg=tgeom_of(jgg), jplan=jplan, jn=jn,
                tplan=tplan, tn=tn, egos=egos, obs=obs)


def test_sample_nearest_matches_jax_exactly():
    """Positions inside, on the border and far outside the map."""
    rng = np.random.default_rng(3)
    data = rng.uniform(0.0, 100.0, (12, 9))
    jg = jgrid.make_geom([4.0, -2.0], 0.5, 12, 9, dtype=jnp.float64)
    top = np.array([4.0 + 3.0, -2.0 + 2.25])
    pos = np.concatenate([rng.uniform(-2.0, 10.0, (200, 2)),
                          top - np.array([[0.0, 0.0], [6.0, 4.5], [0.5, 0.5], [3.0, 0.0]]),
                          [[1e4, -1e4], [-1e4, 1e4], [4.0, 300.0]]])
    exact(tgrid.sample_nearest(t64(data), tgeom_of(jg), t64(pos)),
          jgrid.sample_nearest(jnp.asarray(data), jg, jnp.asarray(pos)))


@pytest.mark.parametrize("reverse", [False, True])
def test_rasterize_polygon_matches_jax_exactly(reverse):
    """CCW and CW quads; one per scenario against the vmapped JAX call."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(-1.0, 1.0, (3, 2))
    verts = (np.array([[1.2, 0.7], [1.0, -0.8], [-0.9, -0.6], [-1.1, 0.9]])
             + rng.normal(0, 0.1, (3, 4, 2)))
    if reverse:
        verts = verts[:, ::-1].copy()
    jgs = jax.vmap(lambda c: jgrid.make_geom(c, 0.2, 14, 10, dtype=jnp.float64))(
        jnp.asarray(centers))
    want = jax.vmap(lambda g, v: jgrid.rasterize_polygon(g, 14, 10, v))(jgs, jnp.asarray(verts))
    got = tgrid.rasterize_polygon(tgeom_of(jgs), 14, 10, t64(verts))
    exact(got, want)
    assert 0 < float(got.sum()) < got.numel()
    exact(tgrid.rasterize_polygon(tgeom_of(jgrid.make_geom(centers[0], 0.2, 14, 10, jnp.float64)),
                                  14, 10, t64(verts[0])), want[0])


def test_submap_and_ellipse_masks_match_jax():
    start, size = np.array([[3, 2], [-2, 5], [10, 0]]), np.array([[4, 3], [6, 20], [0, 4]])
    want = jax.vmap(lambda s, n: jgrid.submap_mask(12, 9, s, n, dtype=jnp.float64))(
        jnp.asarray(start), jnp.asarray(size))
    exact(tgrid.submap_mask(12, 9, torch.tensor(start), torch.tensor(size), dtype=torch.float64),
          want)

    rng = np.random.default_rng(8)
    A = rng.normal(0, 1, (5, 2, 2))
    cov = A @ np.swapaxes(A, 1, 2)
    cov[4] = np.diag([0.3, 0.3])  # the degenerate (isotropic) branch of the eigensolver
    want_e = jgrid.confidence_ellipse(jnp.asarray(cov), 2.4477)
    got_e = tgrid.confidence_ellipse(t64(cov), 2.4477)
    for g, w in zip(got_e, want_e):
        close(g, w)
    jg = jgrid.make_geom([0.5, -0.2], 0.2, 30, 24, dtype=jnp.float64)
    ctr, axes = rng.uniform(-0.5, 0.5, (5, 2)), np.stack([np.asarray(want_e[0]),
                                                          np.asarray(want_e[1])], -1) * 0.5 + 0.2
    want_m = jax.vmap(lambda c, a, r: jgrid.ellipse_mask(jg, 30, 24, c, a, r))(
        jnp.asarray(ctr), jnp.asarray(axes), want_e[2])
    got_m = tgrid.ellipse_mask(tgeom_of(jg), 30, 24, t64(ctr), t64(axes), t64(want_e[2]))
    exact(got_m, want_m)
    assert bool(got_m.any()) and not bool(got_m.all())


def test_corridor_geometry_matches_jax(small):
    """Per scenario against the vmapped JAX call, the plan's repeated tail
    included; and one scenario alone."""
    cp_j, cp, egos = small["cp_j"], small["cp"], small["egos"]
    want = jax.vmap(lambda e: jcm.corridor_geometry(cp_j, small["jplan"], small["jn"], e[:2], e[3]))(
        jnp.asarray(egos))
    got = tcm.corridor_geometry(cp, small["tplan"], small["tn"], t64(egos[:, :2]), t64(egos[:, 3]))
    close(got[0], want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        close(g, w)
    one = tcm.corridor_geometry(cp, small["tplan"], small["tn"], t64(egos[0, :2]), t64(egos[0, 3]))
    close(one[0], want[0][0])
    idx = np.arange(110, 120)
    close(tcm._path_headings(small["tplan"], torch.tensor(idx), small["tn"], t64(0.4)),
          jcm._path_headings(small["jplan"], jnp.asarray(idx), small["jn"], jnp.asarray(0.4)))
    # a plan of one repeated point: no valid tangent anywhere, the fallback yaw
    flat_j = jnp.ones((8, 2))
    close(tcm._path_headings(torch.ones((8, 2), dtype=torch.float64), torch.arange(4), 8, t64(0.4)),
          jcm._path_headings(flat_j, jnp.arange(4), jnp.asarray(8), jnp.asarray(0.4)))


def test_corridor_center_bounds_match_jax(small):
    kw = dict(lateral_offsets=(-2.0, 1.0), max_yaw_dev=0.9, n_yaw=3)
    want = jcm.corridor_center_bounds(small["cp_j"], small["jplan"], small["jn"], **kw)
    got = tcm.corridor_center_bounds(small["cp"], small["tplan"], small["tn"], **kw)
    close(np.array(got), np.array(want), rel=1e-9)
    with pytest.raises(ValueError, match="at least one waypoint"):
        tcm.corridor_center_bounds(small["cp"], small["tplan"], 0)


def test_rasterize_obstacles_and_tracked_bbox_match_jax_exactly(small):
    cp_j, cp, egos, obs = small["cp_j"], small["cp"], small["egos"], small["obs"]
    jg = jax.vmap(lambda c: jgrid.make_geom(c, cp_j.resolution, 24, 16, dtype=jnp.float64))(
        jnp.asarray(np.array([[2.0, 0.0], [3.0, 0.5], [2.5, -0.5], [2.0, 0.2]])))
    jobs = tuple(jnp.asarray(obs[k]) for k in ("xy", "size", "yaw", "mask"))
    want = jax.vmap(lambda g, e: jcm.rasterize_obstacles(cp_j, g, 24, 16, *jobs, e[:2], e[3]))(
        jg, jnp.asarray(egos))
    got = tcm.rasterize_obstacles(cp, tgeom_of(jg), 24, 16, *(t64(obs[k]) for k in
                                                               ("xy", "size", "yaw", "mask")),
                                  t64(egos[:, :2]), t64(egos[:, 3]))
    exact(got, want)
    assert float(got[0].max()) == 100.0  # an obstacle is inside lane 0's grid

    boxes = np.array([[-40.0, 135.0, 6.4, 9.7], [-45.2, 140.3, 3.0, 2.0], [10.0, 10.0, 5.0, 5.0],
                      [-40.0, 135.0, 6.4, 9.7]])
    valid = np.array([True, True, True, False])
    want_b = jax.vmap(lambda g, b, v: jcm.rasterize_tracked_bbox(g, 24, 16, b, v))(
        jg, jnp.asarray(boxes), jnp.asarray(valid))
    got_b = tcm.rasterize_tracked_bbox(tgeom_of(jg), 24, 16, t64(boxes), torch.tensor(valid))
    exact(got_b, want_b)
    assert float(got_b[0].max()) == 100.0 and float(got_b[3].max()) == 0.0


def _sample_prior_case(dtype_j, rows, cols, res_v, H, W, map_center, poses, seed):
    rng = np.random.default_rng(seed)
    gmap = rng.uniform(0.0, 100.0, (H, W))
    jgg = jgrid.make_geom(list(map_center), 0.5, H, W, dtype=dtype_j)
    xy = np.array([[x, y] for (x, y) in poses for _ in YAWS])
    yaw = np.array([y for _ in poses for y in YAWS])
    centers = np.stack([rng.uniform(-2, 10, len(yaw)), rng.uniform(-3, 3, len(yaw))], -1)
    jgs = jax.vmap(lambda c: jgrid.make_geom(c, res_v, rows, cols, dtype=dtype_j))(
        jnp.asarray(centers, dtype_j))
    return gmap, jgg, jgs, xy, yaw


def test_sample_prior_matches_jax_exactly():
    """Poses centred, on the border, partly and wholly outside the map, at
    yaws in every quadrant; batched against the vmapped JAX call, and one
    pose alone."""
    rows, cols = 24, 16
    poses = [(50.0, -80.0), (56.0, -74.0), (59.5, -80.0), (50.0, -91.0), (120.0, -80.0),
             (50.0, -200.0), (1e4, 1e4)]
    gmap, jgg, jgs, xy, yaw = _sample_prior_case(jnp.float64, rows, cols, 0.2, 40, 44,
                                                 (50.0, -80.0), poses, seed=12)
    want = jax.vmap(lambda g, e, y: jcm.sample_prior(g, rows, cols, jnp.asarray(gmap), jgg, e, y))(
        jgs, jnp.asarray(xy), jnp.asarray(yaw))
    tgs = tgeom_of(jgs)
    got = tcm.sample_prior(tgs, rows, cols, t64(gmap), tgeom_of(jgg), t64(xy), t64(yaw))
    exact(got, want)
    before = sample_cuda.LAUNCHES
    exact(sample_cuda.sample_prior_batched(tgs, rows, cols, t64(gmap), tgeom_of(jgg), t64(xy),
                                           t64(yaw)), want)
    assert sample_cuda.LAUNCHES == before  # CPU tensors take the plain version
    one = tcm.sample_prior(type(tgs)(*(t[3] for t in tgs)), rows, cols, t64(gmap), tgeom_of(jgg),
                           t64(xy[3]), t64(yaw[3]))
    exact(one, want[3])


@pytest.mark.parametrize("algo", ["shear", "window"])
def test_k5_plain_version_matches_pallas_kernels_interpret(algo):
    """The kernel's plain version against the TPU kernels in the Pallas
    interpreter, float32: a pure gather, equal on every cell."""
    rows, cols, res_v, H, W = 64, 56, 0.2, 136, 132
    assert sample_pallas.supports_shear(rows, cols, res_v, 0.5, H, W)
    poses = [(50.0, -80.0), (78.0, -80.0), (120.0, -80.0), (50.0, -200.0)]
    gmap, jgg, jgs, xy, yaw = _sample_prior_case(jnp.float32, rows, cols, res_v, H, W,
                                                 (50.0, -80.0), poses, seed=7)
    gmap32 = jnp.asarray(gmap, jnp.float32)
    want = sample_pallas.sample_prior_batched_tpu(
        jgs, rows, cols, res_v, 0.5, gmap32, jgg, jnp.asarray(xy, jnp.float32),
        jnp.asarray(yaw, jnp.float32), interpret=True, algo=algo)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    got = sample_cuda.sample_prior_batched(
        tgeom_of(jgs, torch.float32), rows, cols, f32(gmap32), tgeom_of(jgg, torch.float32),
        f32(xy), f32(yaw))
    assert got.dtype == torch.float32
    exact(got, want)


OVERRIDE_VALUES = [0.0, 50.0, 89.99, 90.0, np.nextafter(90.0, 100.0), 100.0, np.nan, np.inf,
                   -np.inf]


def _override_layers(rng, shape, with_semantic):
    """bbox / semantic frames of values below, at and above 90, NaN and
    +-inf, drawn cell by cell."""
    pick = lambda: rng.choice(np.array(OVERRIDE_VALUES), size=shape)
    return pick(), (pick() if with_semantic else None)


@pytest.mark.parametrize("with_semantic", [False, True])
def test_vehicle_map_plain_applies_the_overrides_in_order(with_semantic):
    """K5 with the overrides, plain version (and the wrapper on CPU tensors,
    which launches nothing) against the JAX resample with the build's two
    selects in numpy: bbox where bbox > 90, then semantic where semantic >
    90 (costmap.py:497, 502; a NaN keeps the value below it)."""
    rows, cols = 12, 10
    gmap, jgg, jgs, xy, yaw = _sample_prior_case(jnp.float64, rows, cols, 0.2, 40, 44,
                                                 (50.0, -80.0), [(50.0, -80.0), (59.5, -80.0)],
                                                 seed=13)
    prior = np.asarray(jax.vmap(lambda g, e, y: jcm.sample_prior(
        g, rows, cols, jnp.asarray(gmap), jgg, e, y))(jgs, jnp.asarray(xy), jnp.asarray(yaw)))
    bbox, sem = _override_layers(np.random.default_rng(14), prior.shape, with_semantic)
    want = np.where(bbox > 90.0, bbox, prior)
    if with_semantic:
        want = np.where(sem > 90.0, sem, want)
    args = (tgeom_of(jgs), rows, cols, t64(gmap), tgeom_of(jgg), t64(xy), t64(yaw), t64(bbox),
            None if sem is None else t64(sem))
    exact(sample_cuda.vehicle_map_batched_plain(*args), want)
    before = sample_cuda.LAUNCHES
    exact(sample_cuda.vehicle_map_batched(*args), want)
    assert sample_cuda.LAUNCHES == before


@pytest.mark.parametrize("tracked", [False, True])
def test_batched_build_vehicle_map_is_the_overridden_prior(small, tracked):
    """The kernel route of the batched build on CPU tensors: its vehicle
    map is still sample_prior overridden by the bbox layer, then by the
    semantic layer, computed here from the build's own layers."""
    cp = small["cp"]
    _, targs, _, tobs = _build_inputs(small)
    boxes = np.array([[-40.0, 135.0, 6.4, 9.7]] * 4) + np.arange(4)[:, None] * 0.7
    tkw = dict(tracked_boxes=t64(boxes),
               tracked_valid=torch.tensor([True, False, True, True])) if tracked else {}
    egos = t64(small["egos"])
    got = tcm.build_local_costmap_batched(cp, *targs, egos, *tobs, **tkw)
    prior = tcm.sample_prior(got.geom, cp.rows, cp.cols, targs[0], targs[1], egos[:, :2],
                             egos[:, 3])
    want = torch.where(got.bounding_box_map > 90.0, got.bounding_box_map, prior)
    if tracked:
        want = torch.where(got.semantic_lidar_map > 90.0, got.semantic_lidar_map, want)
        assert bool((got.semantic_lidar_map > 90.0).any())
    assert bool((got.bounding_box_map > 90.0).any())
    exact(got.vehicle_map, want)


def _build_inputs(small, jnp_dtype=jnp.float64):
    obs = small["obs"]
    jargs = (jnp.asarray(small["gmap"]), small["jgg"], small["jplan"], small["jn"])
    targs = (t64(small["gmap"]), small["tgg"], small["tplan"], small["tn"])
    jobs = tuple(jnp.asarray(obs[k]) for k in ("xy", "size", "yaw", "mask"))
    tobs = tuple(t64(obs[k]) for k in ("xy", "size", "yaw", "mask"))
    return jargs, targs, jobs, tobs


LAYERS = ("vehicle_map", "bounding_box_map", "corridor_mask")


def _compare_costmaps(got, want, with_semantic):
    for f in LAYERS + (("semantic_lidar_map",) if with_semantic else ()):
        exact(getattr(got, f), getattr(want, f))  # gathers, masks and overrides
    close(got.uncertainty_map, want.uncertainty_map, rel=1e-9)
    close(got.geom.center, want.geom.center)
    exact(got.origin_xy, want.origin_xy)
    exact(got.origin_yaw, want.origin_yaw)
    if not with_semantic:
        assert got.semantic_lidar_map is None and want.semantic_lidar_map is None


@pytest.mark.parametrize("tracked,sigmas", [(False, None), (True, None), (False, (0.05, 0.02, 0.02))])
def test_build_local_costmap_matches_jax(small, tracked, sigmas):
    """One scenario, reference propagation; with the ellipse layer."""
    cp_j, cp, ego = small["cp_j"], small["cp"], small["egos"][0]
    jargs, targs, jobs, tobs = _build_inputs(small)
    box, valid = np.array([-40.0, 135.0, 6.4, 9.7]), np.array(True)
    jkw = dict(tracked_box=jnp.asarray(box), tracked_valid=jnp.asarray(valid)) if tracked else {}
    tkw = dict(tracked_box=t64(box), tracked_valid=torch.tensor(True)) if tracked else {}
    want = jcm.build_local_costmap(cp_j, *jargs, jnp.asarray(ego), *jobs, with_ellipse_layer=True,
                                   sigmas=None if sigmas is None else jnp.asarray(sigmas), **jkw)
    got = tcm.build_local_costmap(cp, *targs, t64(ego), *tobs, with_ellipse_layer=True,
                                  sigmas=None if sigmas is None else t64(sigmas), **tkw)
    _compare_costmaps(got, want, tracked)
    exact(got.ellipse_map, want.ellipse_map)
    back = interop.local_costmap_from_numpy(want, dtype=torch.float64, device=DEV)
    exact(back.vehicle_map, got.vehicle_map)
    assert (back.semantic_lidar_map is None) == (not tracked)
    # the kernel wrappers on CPU tensors: the plain versions, the same maps
    fast = tcm.build_local_costmap(cp, *targs, t64(ego), *tobs, use_kernels=True,
                                   sigmas=None if sigmas is None else t64(sigmas), **tkw)
    close(fast.uncertainty_map, want.uncertainty_map, rel=1e-9)


@pytest.mark.parametrize("tracked,sigmas", [(False, None), (True, None),
                                            (False, (0.05, 0.02, 0.02))])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_build_local_costmap_batched_matches_jax(small, tracked, sigmas, use_kernels):
    """B=4 against the JAX batched build with ``use_pallas=False``; the
    port's kernel route (on CPU tensors: the plain versions of K5 and K4,
    banded) gives the same maps."""
    cp_j, cp, egos = small["cp_j"], small["cp"], small["egos"]
    jargs, targs, jobs, tobs = _build_inputs(small)
    boxes = np.array([[-40.0, 135.0, 6.4, 9.7]] * 4) + np.arange(4)[:, None] * 0.7
    valid = np.array([True, False, True, True])
    jkw = dict(tracked_boxes=jnp.asarray(boxes), tracked_valid=jnp.asarray(valid)) if tracked else {}
    tkw = dict(tracked_boxes=t64(boxes), tracked_valid=torch.tensor(valid)) if tracked else {}
    want = jcm.build_local_costmap_batched(
        cp_j, *jargs, jnp.asarray(egos), *jobs, use_pallas=False,
        sigmas=None if sigmas is None else jnp.asarray(sigmas), **jkw)
    sig_hi = sigmas or (cp.sigma_x, cp.sigma_y, cp.sigma_theta)
    xr, yr = tcm.corridor_center_bounds(cp, small["tplan"], small["tn"])
    band = tuc.make_band_plan_bounds(cp, cp.rows, cp.cols, xr, yr, sig_hi, max_bands=3)
    got = tcm.build_local_costmap_batched(
        cp, *targs, t64(egos), *tobs, use_kernels=use_kernels, band_plan=band, global_res=0.5,
        sigmas=None if sigmas is None else t64(sigmas), **tkw)
    _compare_costmaps(got, want, tracked)
    assert got.uncertainty_map.shape == (4, cp.rows, cp.cols)
    assert float((got.vehicle_map[0] - got.vehicle_map[1]).abs().max()) > 0  # per-scenario frames


def test_band_plan_sigma_guard(small):
    cp = small["cp"]
    _, targs, _, tobs = _build_inputs(small)
    band = tuc.make_band_plan_bounds(cp, cp.rows, cp.cols, (0.0, 5.0), (-1.0, 1.0),
                                     (cp.sigma_x / 2, cp.sigma_y, cp.sigma_theta))
    with pytest.raises(ValueError, match="band plan sized for sigma_hi"):
        tcm.build_local_costmap_batched(cp, *targs, t64(small["egos"]), *tobs, band_plan=band)
    # with sigmas given the caller owns the bound
    tcm.build_local_costmap_batched(cp, *targs, t64(small["egos"]), *tobs, band_plan=band,
                                    sigmas=t64([0.001, 0.001, 0.001]))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_k5_kernel_matches_plain_on_card():
    """The CUDA kernel vs its plain version on the card, float32, alone and
    with the overrides (bbox, and bbox then semantic, of values below, at and
    above 90, NaN and +-inf): equal on every cell.  Poses inside the map,
    across its border and wholly outside it beyond each corner and one edge
    (chip_smoke.py's edge poses), at every quadrant's yaw; a width that is a
    multiple of 4 (16-byte accesses), one that is not (scalar accesses), and
    overrides that do not start on 16 bytes; batches of odd sizes.
    chip_smoke.py phase 11 is the full-size check."""
    dev = torch.device("cuda")
    poses = [(50.0, -80.0), (78.0, -80.0), (120.0, -80.0), (50.0, -200.0), (1e4, 1e4),
             (-1e4, -1e4), (1e4, -1e4), (-1e4, 1e4), (1e4, -80.0), (50.0, 1e5)]
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(15)
    for rows, cols, B in ((64, 56, len(poses) * len(YAWS)), (24, 13, 7), (9, 4, 3)):
        gmap, jgg, jgs, xy, yaw = _sample_prior_case(jnp.float32, rows, cols, 0.2, 136, 132,
                                                     (50.0, -80.0), poses, seed=7)
        jgs = jax.tree.map(lambda a: a[:B], jgs)
        args = (interop.grid_geom_from_numpy(jgs, device=dev), rows, cols, f32(gmap),
                interop.grid_geom_from_numpy(jgg, device=dev), f32(xy[:B]), f32(yaw[:B]))
        before = sample_cuda.LAUNCHES
        got = sample_cuda.sample_prior_batched(*args)
        torch.cuda.synchronize()
        assert sample_cuda.LAUNCHES == before + 1
        assert torch.equal(got, sample_cuda.sample_prior_batched_plain(*args))
        for with_semantic in (False, True):
            for offset in (0, 1):  # 1: the layers start 4 bytes past a 16-byte boundary
                layers = []
                for layer in _override_layers(rng, (B, rows, cols), with_semantic):
                    if layer is not None:
                        flat = torch.empty(layer.size + offset, dtype=torch.float32, device=dev)
                        layer = flat[offset:].view(B, rows, cols).copy_(f32(layer))
                    layers.append(layer)
                before = sample_cuda.LAUNCHES
                fused = sample_cuda.vehicle_map_batched(*args, *layers)
                torch.cuda.synchronize()
                assert sample_cuda.LAUNCHES == before + 1
                want = sample_cuda.vehicle_map_batched_plain(*args, *layers)
                assert torch.equal(fused.isnan(), want.isnan())
                assert torch.equal(fused.nan_to_num(), want.nan_to_num()), (rows, cols, offset)
    with pytest.raises(TypeError, match="float32"):
        sample_cuda.sample_prior_batched(args[0], rows, cols, f32(gmap).double(), *args[4:])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_costmap_build_on_card_matches_reference_route(small):
    """The batched build through K5 and K4 on the card (float32) against the
    reference route there: the vehicle map exactly, the uncertainty map at
    2e-3 of its scale of 100 (the kernel multiplies by reciprocals where the
    oracle divides; on this smooth 24x16 case no offset sits on an ellipse
    boundary)."""
    dev = torch.device("cuda")
    cp = small["cp"]
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    obs = small["obs"]
    args = (cp, f32(small["gmap"]), interop.grid_geom_from_numpy(small["jgg"], device=dev),
            small["tplan"].to(dev, torch.float32), small["tn"].to(dev), f32(small["egos"]),
            *(f32(obs[k]) for k in ("xy", "size", "yaw", "mask")))
    before = (sample_cuda.LAUNCHES, tuc.LAUNCHES)
    got = tcm.build_local_costmap_batched(*args)
    torch.cuda.synchronize()
    assert (sample_cuda.LAUNCHES, tuc.LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = tcm.build_local_costmap_batched(*args, use_kernels=False)
    assert torch.equal(got.vehicle_map, want.vehicle_map)
    torch.testing.assert_close(got.uncertainty_map, want.uncertainty_map, rtol=0, atol=0.2)
