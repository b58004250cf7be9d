"""Riccati kernel module (cilqr_tpu_torch/ops/riccati_cuda, kernel K2) vs JAX.

On the CPU the wrappers run the plain PyTorch version; it is held against
the JAX solver's backward_from_derivs + forward_pass under vmap in float64
(bar 1e-9 of the array's scale: the same recursion, summation order
differing, amplified along the horizon).  The CUDA kernel itself is compared
with the plain version on the card (marked ``cuda``; chip_smoke.py does the
same at the main-path shapes).
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.models import costs as jcosts, dynamics as jdyn, reference_path as jrp
from cilqr_tpu.models import solver as jsolver
from cilqr_tpu_torch.models.costs import CostDerivs
from cilqr_tpu_torch.ops import riccati_cuda

CSRC = Path(riccati_cuda.__file__).resolve().parent.parent / "csrc"


def _problem(params, global_plan, B, horizon, seed, dtype=jnp.float64):
    """Derivatives at a random rollout, from the JAX package."""
    p = dataclasses.replace(params, horizon=horizon, num_of_local_wpts=8,
                            closest_point_samples_per_wpt=5)
    plan, n = jrp.pad_global_plan(p, global_plan, dtype=dtype)
    rng = np.random.default_rng(seed)
    egos = jnp.asarray(np.array([100.0, -305.6, 4.0, 0.05]) + rng.normal(0, 0.5, (B, 4)), dtype)
    U = jnp.asarray(rng.normal(0, 0.5, (B, horizon, 2)), dtype)
    lamb = jnp.asarray(rng.uniform(0.1, 10.0, (B,)), dtype)

    @jax.jit
    def derivs(egos, U):
        plans = jax.vmap(lambda e: jrp.get_local_plan(p, plan, n, e))(egos)
        X = jax.vmap(lambda e, u: jdyn.rollout(p, e, u))(egos, U)
        return jax.vmap(lambda pl, x, u: jcosts.all_cost_derivs(p, pl, x, u))(plans, X, U), X

    d, X = derivs(egos, U)
    return p, d, X, U, lamb


def _torch(d, X, U, lamb):
    t = lambda a: torch.as_tensor(np.array(a))
    return CostDerivs(*(t(a) for a in d)), t(X), t(U), t(lamb)


@pytest.fixture(scope="module")
def problem(params, global_plan):
    return _problem(params, global_plan, B=16, horizon=8, seed=3)


def _close(got, want, rel):
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=rel * max(1.0, np.abs(w).max()))


def test_backward_forward_plain_matches_jax(problem):
    p, d, X, U, lamb = problem

    def ref(di, x, u, lam):
        k, K = jsolver.backward_from_derivs(p, di, x, u, lam)
        return jsolver.forward_pass(p, x, u, k, K)

    want = jax.jit(jax.vmap(ref))(d, X, U, lamb)
    got = riccati_cuda.backward_forward_plain(p, *_torch(d, X, U, lamb))
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


def test_backward_plain_matches_jax(problem):
    p, d, X, U, lamb = problem
    want = jax.jit(jax.vmap(lambda *a: jsolver.backward_from_derivs(p, *a)))(d, X, U, lamb)
    got = riccati_cuda.backward_plain(p, *_torch(d, X, U, lamb))
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


@pytest.mark.parametrize("fn", ["backward_batched", "backward_forward_batched"])
def test_cpu_tensors_take_the_plain_version(problem, fn):
    """For CPU tensors the public wrappers run the plain version and launch
    nothing: the launch counter stays put."""
    p, d, X, U, lamb = problem
    args = _torch(d, X, U, lamb)
    before = riccati_cuda.LAUNCHES
    got = getattr(riccati_cuda, fn)(p, *args)
    plain = (riccati_cuda.backward_plain if fn == "backward_batched"
             else riccati_cuda.backward_forward_plain)(p, *args)
    assert riccati_cuda.LAUNCHES == before
    for g, w in zip(got, plain):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_input_checks_raise():
    with pytest.raises(ValueError, match="CUDA"):
        riccati_cuda.check_cuda_f32("X", torch.zeros(2, 3, 4), (2, 3, 4))


def test_scenario_minor_layout_round_trip():
    x = torch.arange(5 * 3 * 2 * 4, dtype=torch.float32).reshape(5, 3, 2, 4)
    y = riccati_cuda.to_scenario_minor(x)
    assert y.shape == (3, 8, 5) and y.is_contiguous()
    assert float(y[2, 4 + 3, 1]) == float(x[1, 2, 1, 3])  # [step][component][B]
    torch.testing.assert_close(riccati_cuda.from_scenario_minor(y, (2, 4)), x)


def test_config_struct_mirrors_cuda_source():
    """ctypes mirror of RiccatiConfig: same fields, order and C types."""
    src = (CSRC / "riccati.cu").read_text()
    body = re.search(r"struct RiccatiConfig \{(.*?)\};", src, re.S).group(1)
    want = []
    for ctype, names in re.findall(r"(int|float) ([^;]+);", body):
        want += [(n.strip(), ctype) for n in names.split(",")]
    got = [(n, "int" if t is ctypes.c_int else "float")
           for n, t in riccati_cuda._RiccatiConfig._fields_]
    assert got == want


@pytest.mark.slow
def test_plain_matches_pallas_kernel_interpret(params, global_plan):
    """Against the TPU kernel itself, run by the Pallas interpreter (float32,
    one 1024-scenario tile), at the bar of tests/test_riccati_pallas.py."""
    from cilqr_tpu.ops import riccati_pallas

    p, d, X, U, lamb = _problem(params, global_plan, B=riccati_pallas.TILE, horizon=4,
                                seed=5, dtype=jnp.float32)
    Xn, Un = riccati_pallas.backward_forward_batched(p, d, X, U, lamb, True)
    k, K = riccati_pallas.backward_batched(p, d, X, U, lamb, None, True)
    args = _torch(d, X, U, lamb)
    for got, want in zip(riccati_cuda.backward_forward_plain(p, *args) +
                         riccati_cuda.backward_plain(p, *args), (Xn, Un, k, K)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_kernel_matches_plain_on_card(params, global_plan):
    """The CUDA kernel vs the plain version on the card, float32: gains within
    1e-4 relative + 1e-5 absolute (operation order and FMA contraction)."""
    p, d, X, U, lamb = _problem(params, global_plan, B=512, horizon=50, seed=7,
                                dtype=jnp.float32)
    d_t, *rest = _torch(d, X, U, lamb)
    args = (CostDerivs(*(t.cuda() for t in d_t)), *(t.cuda() for t in rest))
    before = riccati_cuda.LAUNCHES
    k, K = riccati_cuda.backward_batched(p, *args)
    torch.cuda.synchronize()
    assert riccati_cuda.LAUNCHES == before + 1
    k_w, K_w = riccati_cuda.backward_plain(p, *args)
    torch.testing.assert_close(k, k_w, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(K, K_w, rtol=1e-4, atol=1e-5)
