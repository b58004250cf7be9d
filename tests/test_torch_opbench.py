"""The op-throughput probe (cilqr_tpu_torch/utils/opbench: kernel K6): the
plain version of every body against a numpy loop written from the kernel's
description, float32, exactly (the same operations in the same order; numpy
and PyTorch round each float32 operation alike).  The exp body is held at
1e-6 relative instead: the two libraries' float32 exp may differ in the
last place."""

import numpy as np
import pytest
import torch

from cilqr_tpu_torch.utils import opbench

DEV = "cpu"  # the port allocates on the card unless told otherwise
ROUNDS = 6
N = 512


def numpy_chain(body: str, rounds: int, x: np.ndarray) -> np.ndarray:
    f = np.float32
    a, b = x[0].copy(), x[1].copy()
    c, s = f(np.cos(0.7)), f(np.sin(0.7))
    for r in range(rounds):
        if body == "mul":
            a = a * f(1.0000001)
            continue
        if body == "fma":
            a = a * f(0.9999999) + f(1e-7)
            continue
        a, b = a * c - b * s, a * s + b * c
        if body == "sel":
            a = np.where(b > f(0.01 * r - 2.5), a, -a)
        elif body == "exp":
            a = a + np.exp(b * f(1e-3)) * f(1e-6)
        elif body == "gather":
            out = np.empty_like(b)
            for w in range(0, len(b), 32):  # one warp: lane l reads lane int(b_l) & 31
                src = b[w:w + 32].astype(np.int32) & 31
                out[w:w + 32] = b[w:w + 32][src]
            a = a + out * f(1e-6)
        elif body == "roll":
            amt = (r + 1) & 31
            out = np.empty_like(b)
            for w in range(0, len(b), 32):  # lane l reads lane (l - amt) mod 32
                out[w:w + 32] = b[w:w + 32][(np.arange(32) - amt) % 32]
            a = a + out * f(1e-6)
        elif body == "tpose":
            out = np.empty_like(b)
            for blk in range(0, len(b), 256):  # thread (ty, tx) reads tile[tx][ty]
                out[blk:blk + 256] = b[blk:blk + 256].reshape(16, 16).T.reshape(-1)
            a = a + out * f(1e-6)
    return np.stack([a, b])


@pytest.mark.parametrize("body", opbench.BODIES)
def test_plain_bodies_match_a_numpy_loop(body):
    x = opbench.probe_input(N, seed=3, device=DEV)
    assert x.shape == (2, N) and x.dtype == torch.float32 and float(x.abs().max()) <= 2.0
    before = opbench.LAUNCHES
    got = opbench.opchain(body, ROUNDS, x).numpy()
    assert opbench.LAUNCHES == before  # a CPU tensor takes the plain version
    want = numpy_chain(body, ROUNDS, x.numpy())
    if body == "exp":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 2.0 * np.sqrt(2.0) * 1.001  # the rotation keeps the pair bounded
    if body not in ("mul", "fma"):
        assert np.abs(got[1] - x.numpy()[1]).max() > 0.1


def test_sel_margin_and_argument_checks():
    x = opbench.probe_input(N, seed=3, device=DEV)
    margin = opbench.sel_margin(ROUNDS, x)
    assert margin.shape == (N,) and float(margin.min()) >= 0.0
    # an element put on the first threshold has no margin
    a0, b0 = -1.0, (0.01 * 0 - 2.5)  # (a, b) after the first rotation
    c, s = np.cos(0.7), np.sin(0.7)
    on_edge = torch.tensor([[a0 * c + b0 * s], [-a0 * s + b0 * c]], dtype=torch.float32).repeat(1, 256)
    assert float(opbench.sel_margin(1, on_edge).max()) < 1e-6
    with pytest.raises(ValueError, match="body must be one of"):
        opbench.opchain("div", 1, x)
    with pytest.raises(ValueError, match="multiple of 256"):
        opbench.opchain("mul", 1, x[:, :100])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            opbench.measure()


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("body", opbench.BODIES)
def test_kernel_matches_plain_on_card(body):
    """The CUDA kernel vs its plain version on the card at 1e-5 rel + 1e-5
    abs (exp: 1e-4): the kernel contracts multiply-adds that PyTorch rounds
    twice.  Elements within 1e-4 of a select threshold are left out."""
    x = opbench.probe_input(65536, seed=4)
    before = opbench.LAUNCHES
    got = opbench.opchain(body, 8, x)
    torch.cuda.synchronize()
    assert opbench.LAUNCHES == before + 1
    want = opbench.opchain_plain(body, 8, x)
    if body == "sel":
        keep = opbench.sel_margin(8, x) > 1e-4
        got, want = got[:, keep], want[:, keep]
    tol = 1e-4 if body == "exp" else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
