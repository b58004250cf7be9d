"""The port's own parameter dataclasses (cilqr_tpu_torch/utils/params.py), the
functions that carry a JAX-side parameter set across (utils/interop.py), the
default-device rule (utils/device.py) and the port's independence from the
JAX package: no file of the port and not chip_smoke.py imports jax, oracle
or anything of cilqr_tpu."""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from cilqr_tpu.utils import params as jparams
from cilqr_tpu_torch.utils import device as tdevice, interop, params as tparams

ROOT = Path(__file__).resolve().parent.parent
PAIRS = [("SolverParams", interop.solver_params_from_reference),
         ("CostmapParams", interop.costmap_params_from_reference),
         ("NoiseParams", interop.noise_params_from_reference)]


@pytest.mark.parametrize("name", [n for n, _ in PAIRS])
def test_fields_and_defaults_equal_the_jax_package(name):
    """Every field, in order, with its type and default."""
    jf = dataclasses.fields(getattr(jparams, name))
    tf = dataclasses.fields(getattr(tparams, name))
    assert [(f.name, f.type, f.default) for f in tf] == [(f.name, f.type, f.default) for f in jf]
    assert getattr(tparams, name) is not getattr(jparams, name)


def test_properties_equal_the_jax_package():
    jp, tp = jparams.SolverParams(horizon=33, steer_angle_max=0.6), tparams.SolverParams(
        horizon=33, steer_angle_max=0.6)
    assert tp.n_closest_samples == jp.n_closest_samples == 200
    assert tp.yawrate_gain == jp.yawrate_gain
    assert tparams.CostmapParams(window_radius=7).window == jparams.CostmapParams(
        window_radius=7).window == 15
    assert hash(tparams.SolverParams()) == hash(tparams.DEFAULT_PARAMS)  # frozen, hashable


@pytest.mark.parametrize("name,carry", PAIRS)
def test_from_reference_round_trips(name, carry):
    """A non-default JAX-side set carries across field by field, from the
    dataclass or from a dict; an unknown or a missing field fails loudly."""
    jcls, tcls = getattr(jparams, name), getattr(tparams, name)
    first = dataclasses.fields(jcls)[0].name
    src = dataclasses.replace(jcls(), **{first: getattr(jcls(), first) * 2 + 1})
    got = carry(src)
    assert type(got) is tcls
    assert dataclasses.asdict(got) == dataclasses.asdict(src)
    assert carry(dataclasses.asdict(src)) == got
    assert jcls(**dataclasses.asdict(got)) == src  # and back
    with pytest.raises(ValueError, match="unknown fields \\['bogus'\\]"):
        carry({**dataclasses.asdict(src), "bogus": 1})
    short = dataclasses.asdict(src)
    del short[first]
    with pytest.raises(ValueError, match=f"missing fields \\['{first}'\\]"):
        carry(short)
    with pytest.raises(TypeError):
        carry(3.0)


def test_resolve_device():
    """None means the card; anything else is taken as given; nothing looks
    for a card."""
    assert tdevice.resolve(None) == torch.device("cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tdevice.resolve(torch.device("cuda", 1)) == torch.device("cuda", 1)
    src = (ROOT / "cilqr_tpu_torch" / "utils" / "device.py").read_text()
    assert "is_available" not in src


def test_constructors_default_to_the_card():
    """With ``device`` unset a constructor allocates on cuda: here, without
    a card, that fails in PyTorch's own allocation."""
    from cilqr_tpu_torch.models import solver
    from cilqr_tpu_torch.ops import gridmap
    from cilqr_tpu_torch.sim.example_scenario import example_scenario

    if torch.cuda.is_available():
        assert gridmap.make_geom([0.0, 0.0], 0.2, 4, 4).center.is_cuda
        assert example_scenario(tparams.SolverParams())[0].is_cuda
        return
    for make in (lambda: gridmap.make_geom([0.0, 0.0], 0.2, 4, 4),
                 lambda: solver.initial_controls(tparams.SolverParams()),
                 lambda: example_scenario(tparams.SolverParams()),
                 lambda: interop.tensor_from_numpy([1.0])):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            make()
    assert gridmap.make_geom([0.0, 0.0], 0.2, 4, 4, device="cpu").center.device.type == "cpu"


FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|oracle|cilqr_tpu)\b(?!_)|from\s+(?:jax|oracle|cilqr_tpu)\b(?!_))",
    re.MULTILINE)


def test_port_sources_import_nothing_of_the_jax_package():
    files = sorted((ROOT / "cilqr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [str(f.relative_to(ROOT)) for f in files if FORBIDDEN.search(f.read_text())]
    assert bad == []
    assert FORBIDDEN.search("from cilqr_tpu.utils.params import X")
    assert FORBIDDEN.search("    import jax.numpy as jnp")
    assert not FORBIDDEN.search("from cilqr_tpu_torch.utils import params")
