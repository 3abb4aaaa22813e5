"""The port's MegaLoc against the reference, on the CPU, at the reduced
dims of tests/frontend/test_megaloc_exact.py (``test_small``: 32-d, 2
heads, 2 blocks, a 5x5 pretrain grid, 8 clusters).

- The reference's ``init_params`` (PRNGKey(0)) carried across by
  ``convert.megaloc_state_dict``; ``megaloc_forward`` against the port's
  net at the native grid (70x70, the position embedding used as is) and at
  an interpolated one (42x42: the bicubic resample 5x5 -> 3x3, torch's with
  a = -0.75, to 1e-5), to 1e-4 (the reference test's own tolerance).
- ``describe_batch`` on grayscale images that are upsampled (48x64) and
  downsampled (100x120, the antialiased bilinear) to 70x70, to 1e-4.
- A reduced megaloc.torch-layout checkpoint (``chip_smoke.megaloc_fixture``)
  in ``tmp_path`` through both registries' ``weights_path``: the same dims
  read off the tensors and the same descriptors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.frontend.global_descriptors import megaloc as j_ml
from gtsfm_tpu.frontend.registry import build_global_descriptor as j_build
from gtsfm_tpu_torch.frontend import registry
from gtsfm_tpu_torch.frontend.global_descriptors import megaloc as t_ml
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

SMALL = dict(embed_dim=32, depth=2, num_heads=2, pretrain_grid=5, num_clusters=8, cluster_dim=16, token_dim=16,
             mlp_dim=32, feat_dim=64, image_size=70)
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    opts = j_ml.MegaLocOptions(**SMALL)
    params = j_ml.init_params(jax.random.PRNGKey(0), opts)
    t = t_ml.MegaLocDescriptor(t_ml.MegaLocOptions(**SMALL),
                               state_dict=convert.megaloc_state_dict(jax.tree.map(np.asarray, params)))
    return params, opts, t


def test_options_read_off_the_state_dict(pair):
    _params, opts, t = pair
    assert tuple(t.options) == tuple(opts)


@pytest.mark.parametrize("hw", [70, 42])
def test_forward_matches_reference(pair, hw):
    params, opts, t = pair
    x = np.random.default_rng(hw).normal(size=(2, 3, hw, hw)).astype(np.float32)
    want = np.asarray(j_ml.megaloc_forward(params, jnp.asarray(x.transpose(0, 2, 3, 1)), opts))
    with torch.no_grad():
        got = t.net(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_position_embedding_interpolation_matches_reference(pair):
    params, _opts, t = pair
    _cls, want = j_ml.interpolate_pos_embed(params["backbone"]["pos_embed"], 3, 3)
    _cls, got = t_ml.interpolate_pos_embed(t.net.backbone.model.pos_embed.detach(), 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(48, 64), (100, 120)])
def test_describe_batch_matches_reference(pair, hw):
    params, opts, t = pair
    j = j_ml.MegaLocDescriptor(opts, params=params)
    x = np.random.default_rng(7).uniform(0, 1, (3,) + hw).astype(np.float32)
    got = t.describe_batch(torch.as_tensor(x))
    np.testing.assert_allclose(got, j.describe_batch(x), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_checkpoint_through_both_registries(tmp_path):
    sd = chip_smoke.megaloc_fixture(0, t_ml.MegaLocOptions(**SMALL))
    path = str(tmp_path / "megaloc.torch")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    cfg = {"name": "megaloc", "weights_path": path, "image_size": 70}
    j, t = j_build(dict(cfg)), registry.build_global_descriptor(dict(cfg))
    assert tuple(t.options) == tuple(j.options)
    x = np.random.default_rng(8).uniform(0, 1, (2, 60, 80)).astype(np.float32)
    np.testing.assert_allclose(t.describe_batch(x), j.describe_batch(x), rtol=TOL, atol=TOL)
