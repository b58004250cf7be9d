"""The JAX package's analysis and production programs, on the port.

    python -m cilqr_tpu_torch.scripts.classify_failure_modes
    python -m cilqr_tpu_torch.scripts.nrb_budget_sensitivity
    python -m cilqr_tpu_torch.scripts.production_sweeps

They run on the card unless ``--device cpu`` says otherwise, and feed the
closed loops the JAX package's own localization noise (``jax_noise``), so
that their worlds are the published results' worlds.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from cilqr_tpu_torch.utils.device import resolve

#: The JAX package's standard-normal noise block of seed 0, (160, 50, 3)
#: float32: run r's cycle-t draw is ``normal(split(split(key(0), 50)[r],
#: 160)[t], (3,))``, the key discipline of its sweeps and experiment
#: batches (``per_run_keys``), drawn once with JAX 0.9 on the CPU.
NOISE_FILE = pathlib.Path(__file__).resolve().parent.parent / "data" / "noise_seed0_160x50.npy"


def jax_noise(n_cycles: int, n_runs: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The (n_cycles, n_runs, 3) noise block of seed 0 that the JAX package
    draws for ``n_runs`` runs of ``n_cycles`` cycles.  JAX's threefry keys
    split by counter (``jax_threefry_partitionable``, its default since
    0.5): ``split(key, n)[i]`` does not depend on n, so a smaller block is
    the leading corner of the committed one."""
    block = np.load(NOISE_FILE)
    if n_cycles > block.shape[0] or n_runs > block.shape[1]:
        raise ValueError(f"the committed noise block is {block.shape[:2]}, asked for "
                         f"({n_cycles}, {n_runs})")
    return torch.as_tensor(block[:n_cycles, :n_runs], device=resolve(device)).to(dtype)
