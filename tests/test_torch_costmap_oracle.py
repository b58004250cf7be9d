"""The port's oracle propagation (``costmap.propagate_uncertainty_reference``)
held to the EllipseIterator oracle (``oracle/oracle_costmap.propagate``),
as tests/test_costmap.py holds the JAX package's: the fixed masked window
against exact EllipseIterator semantics, for the corrected-PSD and the
reference-faithful rho formulas, at three yaws, float64, 1e-9."""

import dataclasses

import numpy as np
import pytest
import torch

from cilqr_tpu.utils.params import CostmapParams as JCostmapParams
from cilqr_tpu_torch.ops import costmap, gridmap
from cilqr_tpu_torch.utils import interop
from oracle import oracle_costmap

DEV = "cpu"  # the port allocates on the card unless told otherwise


@pytest.mark.parametrize("yaw", [0.0, 0.9, 3.5])
@pytest.mark.parametrize("faithful", [False, True])
def test_propagation_matches_ellipse_iterator_oracle(yaw, faithful):
    cp_j = dataclasses.replace(JCostmapParams(), rows=24, cols=16, window_radius=8,
                               sigma_x=0.08, sigma_y=0.06, sigma_theta=0.05)
    cp = interop.costmap_params_from_reference(cp_j)
    prior = np.random.default_rng(9).uniform(0, 100, (cp.rows, cp.cols))
    center = np.array([1.2, -0.4])
    assert costmap.required_window_radius(cp, cp.rows, cp.cols, center) <= cp.window_radius
    geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols, dtype=torch.float64,
                             device=DEV)
    got = costmap.propagate_uncertainty_reference(
        cp, torch.tensor(prior), geom, torch.tensor(yaw, dtype=torch.float64),
        faithful_rho=faithful)
    want = oracle_costmap.propagate(cp_j, prior, center, yaw, faithful_rho=faithful)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    if faithful and yaw == 0.9:
        assert np.any(got.numpy() == prior)  # non-PSD cells keep the prior
