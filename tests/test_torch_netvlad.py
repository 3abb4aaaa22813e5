"""The port's NetVLAD descriptors against the reference, on the CPU.

- ``NetVLADDescriptor``: the reference's default params (flax,
  PRNGKey(0)) carried across by ``convert.netvlad_state_dict``; the
  descriptors agree to 1e-5 at even, odd and mixed image sizes (flax's
  stride-2 "SAME" pads (0, 1) on an even side and (1, 1) on an odd one).
- ``scripts/deep_front_end_reference.netvlad_params``, which gives the
  reference the port's seeded init (its registry drops ``weights_path``),
  round-trips through ``convert.netvlad_state_dict`` and gives the same
  descriptors.
- ``HlocNetVLADDescriptor``: the reference's ``NetVLADVGG16`` params
  carried across by ``convert.hloc_netvlad_state_dict``, grayscale at even
  and odd sizes and RGB, to 1e-5; an hloc-layout checkpoint in
  ``tmp_path`` loaded by both registries.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.global_descriptors import descriptors as j_desc
from gtsfm_tpu.frontend.registry import build_global_descriptor as j_build
from gtsfm_tpu_torch.frontend import registry
from gtsfm_tpu_torch.frontend.global_descriptors import descriptors as t_desc
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

TOL = 1e-5
SIZES = [(64, 64), (61, 77), (48, 63)]


def reference_script():
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "deep_front_end_reference.py")
    spec = importlib.util.spec_from_file_location("deep_front_end_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("hw", SIZES)
def test_netvlad_matches_reference(hw):
    j = j_desc.NetVLADDescriptor()
    t = t_desc.NetVLADDescriptor(state_dict=convert.netvlad_state_dict(jax.tree.map(np.asarray, j.params)))
    x = _images((2,) + hw, 0)
    np.testing.assert_allclose(t.describe_batch(torch.as_tensor(x)), j.describe_batch(x), rtol=0, atol=TOL)


def test_reference_script_converter_gives_the_port_init_to_the_reference():
    ref = reference_script()
    t = t_desc.NetVLADDescriptor()
    params = ref.netvlad_params(t.net.state_dict())
    back = convert.netvlad_state_dict(params)
    for k, v in t.net.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    j = j_desc.NetVLADDescriptor(params=jax.tree.map(jnp.asarray, params))
    x = _images((2, 61, 77), 1)
    np.testing.assert_allclose(t.describe_batch(x), j.describe_batch(x), rtol=0, atol=TOL)
    # the registry drops weights_path for netvlad in both packages
    d = registry.build_global_descriptor({"name": "netvlad", "weights_path": "/nonexistent"})
    assert isinstance(d, t_desc.NetVLADDescriptor)
    assert isinstance(j_build({"name": "netvlad", "weights_path": "/nonexistent"}), j_desc.NetVLADDescriptor)


@pytest.fixture(scope="module")
def hloc_pair():
    net = j_desc.NetVLADVGG16()
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    j = j_desc.HlocNetVLADDescriptor(params=params)
    sd = convert.hloc_netvlad_state_dict(jax.tree.map(np.asarray, params))
    return j, t_desc.HlocNetVLADDescriptor(state_dict=sd), sd


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 45, 59), (2, 40, 56, 3)])
def test_hloc_netvlad_matches_reference(hloc_pair, shape):
    j, t, _sd = hloc_pair
    x = _images(shape, 2)
    np.testing.assert_allclose(t.describe_batch(torch.as_tensor(x)), j.describe_batch(x), rtol=0, atol=TOL)


def test_hloc_checkpoint_loads_in_both_registries(hloc_pair, tmp_path):
    _j, _t, sd = hloc_pair
    path = str(tmp_path / "Pitts30K_struct.pth")
    torch.save(sd, path)
    cfg = {"name": "hloc_netvlad", "weights_path": path}
    j, t = j_build(dict(cfg)), registry.build_global_descriptor(dict(cfg))
    x = _images((1, 48, 64), 3)
    np.testing.assert_allclose(t.describe_batch(x), j.describe_batch(x), rtol=0, atol=TOL)
