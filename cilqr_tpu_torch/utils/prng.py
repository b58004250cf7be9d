"""JAX's threefry2x32 counter-based PRNG, bit for bit, in PyTorch.

The NRB-RRT baseline (``models/nrb_rrt.py``) derives its randomness from
the ego state it plans from (``fold_in`` of the state's float32 bits into a
fixed key), so its draws depend on the states a closed loop visits and
cannot be drawn ahead of the loop.  This module computes the same numbers
as ``jax.random`` with ``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True`` (JAX's default): ``key``, ``fold_in``,
``split``, 32- and 64-bit ``random_bits``, ``uniform`` and ``randint``.

A key is an int64 tensor (..., 2) holding two unsigned 32-bit words; every
function takes any leading shape of keys and works elementwise over it, so
one call draws for a whole (lanes, iterations) block.  Words live in int64
masked to 32 bits: PyTorch has no unsigned 32-bit arithmetic, and no
intermediate here leaves 63 bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k0, k1); all int64 in [0, 2^32), broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for a non-negative integer seed: the words
    (seed >> 32, seed & 0xFFFFFFFF)."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2) with integer data (broadcast
    against the keys' leading shape) taken as uint32 (two's complement for
    negative values)."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK32
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([b0, b1], dim=-1)


def stream_seed(seed: int, stream: int) -> int:
    """The seed of a ``torch.Generator`` for stream ``stream`` under
    ``seed``: the two words of ``fold_in(key(seed), stream)`` as one 64-bit
    integer, the first word high.  The scale-out layer seeds each shard's
    and each campaign round's generator by this one rule (the counterpart of
    the JAX package's ``fold_in(key, axis_index)`` / ``fold_in(key, r)``)."""
    w = fold_in(key(seed), stream)
    return (int(w[0]) << 32) | int(w[1])


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for keys (..., 2) -> (..., num, 2)."""
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(counts),
                          counts)
    return torch.stack([b0, b1], dim=-1)


def _words(keys: torch.Tensor):
    """The two output words of ``random_bits`` for one value per key (a
    scalar draw: counter (0, 0))."""
    z = torch.zeros_like(keys[..., 0])
    return threefry2x32(keys[..., 0], keys[..., 1], z, z)


def random_bits32(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(key, (), uint32)`` per key: int64 in [0, 2^32)."""
    b0, b1 = _words(keys)
    return b0 ^ b1


def uniform(keys: torch.Tensor, dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (), dtype, minval, maxval)`` per key: the
    random bits fill the mantissa of a number in [1, 2), minus 1, then
    scaled; float32 from 32 random bits, float64 from 64."""
    b0, b1 = _words(keys)
    if dtype == torch.float32:
        fbits = ((b0 ^ b1) >> 9) | 0x3F800000
        floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        # the top 52 of the 64 bits (b0 << 32 | b1) >> 12, without leaving int64
        fbits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        floats = fbits.view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform takes float32 or float64, got {dtype}")
    lo = torch.as_tensor(minval, dtype=dtype, device=keys.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=keys.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as XLA's fused multiply-add computes JAX's
    ``floats * (maxval - minval) + minval``.  float32: the product of two
    float32 numbers is exact in float64, so one float64 sum and the cast
    round it (a second rounding could only matter on a float32 tie of the
    float64 sum).  float64: the product's rounding error (Dekker's split)
    and the sum's (Knuth's two-sum) are added back before the last rounding;
    this is off only where the exact result lies within 2^-53 of an ulp of
    a rounding boundary."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bp = s - p
    t = (p - (s - bp)) + (c - bp)
    return s + (t + e)


def _split(a: torch.Tensor):
    """Veltkamp's split of float64 a into a high part of 26 bits and the rest."""
    big = a * 134217729.0  # 2^27 + 1
    hi = big - (big - a)
    return hi, a - hi


def randint(keys: torch.Tensor, minval: int, maxval: int, bits: int = 32) -> torch.Tensor:
    """``jax.random.randint(key, (), minval, maxval)`` per key with JAX's
    default integer dtype: int32 (``bits=32``, x64 off) or int64
    (``bits=64``, x64 on).  Values in [minval, maxval) from two draws of
    ``bits`` random bits and JAX's modulus reduction.  Returns int64."""
    if bits not in (32, 64):
        raise ValueError(f"bits must be 32 or 64, got {bits}")
    span = max(int(maxval) - int(minval), 1)
    halves = split(keys, 2)
    w0, w1 = _words(halves)                    # (..., 2) each
    if bits == 32:
        rem = (w0 ^ w1) % span
    else:
        # (hi * 2^32 + lo) mod span, with hi and lo the 32-bit words
        rem = ((w0 % span) * ((1 << 32) % span) + w1 % span) % span
    multiplier = ((1 << (bits // 2)) % span) ** 2 % span
    offset = (rem[..., 0] * multiplier + rem[..., 1]) % span
    return int(minval) + offset
