"""utils/prng (JAX's threefry2x32 in PyTorch) vs ``jax.random``, bit for bit.

Keys, ``fold_in``, ``split``, 32-bit random bits, ``uniform`` and
``randint`` over many seeds and data, in both of NRB-RRT's regimes: float64
states with x64 on (64-bit uniforms, int64 ``randint``), as this test tier
runs, and float32 states with x64 off (32-bit uniforms, int32 ``randint``),
as the JAX CLI runs.  The last test holds the whole (lanes, iterations)
block of draws that ``models/nrb_rrt.py`` makes before its tree grows to the
draws JAX's ``plan_step`` makes inside its loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu_torch.models import nrb_rrt as tnrb
from cilqr_tpu_torch.utils import prng
from cilqr_tpu_torch.utils.params import SolverParams

SEEDS = [0, 1, 7, 4242, 2**31 - 1, 2**32 + 5, 2**40 + 3]
DATA = [0, 1, 5, 96, 2**31 - 1, -1, -3, -2**31]
REGIMES = [(True, torch.float64, jnp.float64, 64), (False, torch.float32, jnp.float32, 32)]
IDS = ["x64-float64", "x32-float32"]


def words(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def many_keys(n: int):
    """n JAX keys and the same n keys in the port's form."""
    k = jax.random.split(jax.random.key(11), n)
    return k, torch.tensor(words(k))


def test_key_fold_in_split_match_jax():
    for seed in SEEDS:
        k, t = jax.random.key(seed), prng.key(seed)
        np.testing.assert_array_equal(t.numpy(), words(k))
        for d in DATA:
            np.testing.assert_array_equal(prng.fold_in(t, d).numpy(),
                                          words(jax.random.fold_in(k, jnp.asarray(d, jnp.int32))))
        for n in (1, 2, 4, 7):
            np.testing.assert_array_equal(prng.split(t, n).numpy(), words(jax.random.split(k, n)))
    # vectorised over keys and data at once
    ks, ts = many_keys(64)
    data = np.arange(-32, 32, dtype=np.int32) * 977
    np.testing.assert_array_equal(
        prng.fold_in(ts, torch.tensor(data)).numpy(),
        words(jax.vmap(jax.random.fold_in)(ks, jnp.asarray(data))))
    np.testing.assert_array_equal(prng.split(ts, 4).numpy(),
                                  words(jax.vmap(lambda k: jax.random.split(k, 4))(ks)))
    with pytest.raises(ValueError, match="non-negative"):
        prng.key(-1)


def test_random_bits32_match_jax():
    ks, ts = many_keys(500)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(ks)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits32(ts).numpy(), want)


@pytest.mark.parametrize("x64,tdt,jdt,bits", REGIMES, ids=IDS)
def test_uniform_matches_jax(x64, tdt, jdt, bits):
    """Every bit, including the rounding of JAX's fused multiply-add in
    ``floats * (maxval - minval) + minval`` (2,000 keys per range)."""
    with jax.enable_x64(x64):
        ks, ts = many_keys(2000)
        for lo, hi in ((0.0, 1.0), (-2.1, 3.0), (-1.25, 3.0), (0.0, 6.0), (-3.0, 3.0)):
            want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jdt, lo, hi))(ks))
            got = prng.uniform(ts, tdt, lo, hi).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.view(f"int{bits}"), want.view(f"int{bits}"))
    with pytest.raises(TypeError, match="float32 or float64"):
        prng.uniform(ts, torch.float16)


@pytest.mark.parametrize("x64,tdt,jdt,bits", REGIMES, ids=IDS)
def test_randint_matches_jax(x64, tdt, jdt, bits):
    """JAX's default integer width: int64 with x64 on, int32 with it off."""
    with jax.enable_x64(x64):
        ks, ts = many_keys(1000)
        for lo, hi in ((0, 1), (0, 7), (0, 8), (0, 13), (3, 40), (0, 3), (5, 5)):
            want = jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(ks)
            assert want.dtype == (jnp.int64 if x64 else jnp.int32)
            np.testing.assert_array_equal(prng.randint(ts, lo, hi, bits).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="32 or 64"):
        prng.randint(ts, 0, 4, 16)


@pytest.mark.parametrize("x64,tdt,jdt,bits", REGIMES, ids=IDS)
def test_nrb_draws_match_jax(x64, tdt, jdt, bits):
    """NRB-RRT's draws for 24 ego states (the key from their float32 bit
    patterns, then per iteration fold_in / split / randint / uniform): the
    JAX package's loop body, iteration by iteration, against the port's one
    block; with and without a corridor band."""
    p = SolverParams()
    rng = np.random.default_rng(3)
    egos = np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, [30.0, 3.0, 2.0, 1.0], (24, 4))
    egos[0] = [0.0, -0.0, 0.0, 0.0]
    W = 8
    for np_ in (tnrb.NRBParams(n_iters=12), tnrb.NRBParams(n_iters=12, lat_lo=-0.8, lat_hi=3.0,
                                                           seed=5)):
        with jax.enable_x64(x64):
            e = jnp.asarray(egos, jdt)
            lat_lo = -np_.lat_max if np_.lat_lo is None else np_.lat_lo
            lat_hi = np_.lat_max if np_.lat_hi is None else np_.lat_hi

            def lane(ego):
                b = jax.lax.bitcast_convert_type(ego.astype(jnp.float32), jnp.int32)
                key = jax.random.fold_in(jax.random.fold_in(jax.random.key(np_.seed), b[0] ^ b[2]),
                                         b[1] ^ b[3])

                def one(i):
                    k_goal, k_s, k_lat, k_v = jax.random.split(jax.random.fold_in(key, i), 4)
                    return (jax.random.randint(k_s, (), 0, W),
                            jax.random.uniform(k_lat, (), jdt, lat_lo, lat_hi),
                            jax.random.uniform(k_goal, (), jdt) < np_.goal_bias,
                            jax.random.uniform(k_v, (), jdt, 0.0, p.desired_speed * 1.2))

                return jax.vmap(one)(jnp.arange(np_.n_iters))

            want = [np.asarray(w) for w in jax.vmap(lane)(e)]
        c = tnrb.constants(p, np_, tdt, "cpu")
        got = [g.numpy() for g in tnrb._draws(p, np_, c, torch.tensor(egos, dtype=tdt), W)]
        for g, w in zip(got, want):
            assert g.shape == w.shape == (24, np_.n_iters)
            if g.dtype.kind == "f":  # every bit of the floats
                assert g.dtype == w.dtype
                g, w = g.view(f"int{bits}"), w.view(f"int{bits}")
            np.testing.assert_array_equal(g, w)
