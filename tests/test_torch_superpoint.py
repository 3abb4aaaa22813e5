"""The port's SuperPoint against the reference, on the CPU.

- The net: the reference's default params (flax, PRNGKey(0)) carried
  across by ``convert.superpoint_state_dict``; scores and unit descriptors
  of the coarse grid to 1e-5 (float32 convolutions in another order).
- The post-processing on one set of net outputs, fed to both packages'
  ``_postprocess``: equal keypoints, masks and responses, descriptors to
  1e-6.
- The whole detector at 64x96 and 72x104: every heatmap maximum above the
  threshold is valid (fewer than K), so the valid keypoints are compared as
  sets of pixels; equal sets, responses to 1e-6, descriptors to 1e-5.
- A MagicLeap-layout checkpoint written to ``tmp_path``
  (``chip_smoke.superpoint_fixture``) loaded by both packages' loaders.
- The registry's adapter: an image whose sides are not multiples of 8 is
  padded at the bottom and right, as the reference pads it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.frontend.detectors import superpoint as j_sp
from gtsfm_tpu.frontend.registry import build_detector as j_build_detector
from gtsfm_tpu_torch.frontend import registry
from gtsfm_tpu_torch.frontend.detectors import superpoint as t_sp
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

NET_TOL = 1e-5


def _images(shape, seed):
    """Smooth random images (blurred noise): the heatmap has isolated maxima."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, shape).astype(np.float32))
    x = torch.nn.functional.avg_pool2d(x[:, None], 5, stride=1, padding=2, count_include_pad=False)[:, 0]
    return x.numpy()


@pytest.fixture(scope="module")
def pair():
    j = j_sp.SuperPoint()
    t = t_sp.SuperPoint(state_dict=convert.superpoint_state_dict(j.params))
    return j, t


def _valid(kps, descs, b):
    m = np.asarray(kps.mask)[b]
    xy = np.asarray(kps.coordinates)[b][m]
    order = np.lexsort((xy[:, 0], xy[:, 1]))
    return xy[order], np.asarray(kps.responses)[b][m][order], np.asarray(descs)[b][m][order]


def _hold_detections(jk, jd, tk, td, desc_tol):
    assert np.asarray(jk.mask).sum() > 0
    for b in range(np.asarray(jk.mask).shape[0]):
        jxy, jr, jdd = _valid(jk, jd, b)
        txy, tr, tdd = _valid(tk, td, b)
        np.testing.assert_array_equal(txy, jxy)
        np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tdd, jdd, rtol=0, atol=desc_tol)


@pytest.mark.parametrize("hw", [(64, 96), (72, 104)])
def test_net_matches_reference(pair, hw):
    j, t = pair
    x = _images((2,) + hw, 1)
    js, jd = (np.array(a) for a in j._fwd(j.params, jnp.asarray(x)[..., None]))
    with torch.no_grad():
        ts, td = t.net(torch.as_tensor(x)[:, None])
    np.testing.assert_allclose(ts.permute(0, 2, 3, 1).numpy(), js, rtol=0, atol=NET_TOL)
    np.testing.assert_allclose(td.permute(0, 2, 3, 1).numpy(), jd, rtol=0, atol=NET_TOL)


@pytest.mark.parametrize("hw", [(64, 96), (72, 104)])
def test_postprocess_matches_reference(pair, hw):
    j, _t = pair
    x = _images((2,) + hw, 2)
    js, jd = (np.array(a) for a in j._fwd(j.params, jnp.asarray(x)[..., None]))
    opts = t_sp.SuperPointOptions(max_keypoints=512)
    jk, jdesc = j_sp._postprocess(jnp.asarray(js), jnp.asarray(jd), j_sp.SuperPointOptions(*opts))
    tk, tdesc = t_sp._postprocess(torch.as_tensor(js).permute(0, 3, 1, 2), torch.as_tensor(jd).permute(0, 3, 1, 2),
                                  opts)
    np.testing.assert_array_equal(tk.coordinates.numpy(), np.asarray(jk.coordinates))
    np.testing.assert_array_equal(tk.mask.numpy(), np.asarray(jk.mask))
    np.testing.assert_allclose(tk.responses.numpy(), np.asarray(jk.responses), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdesc.numpy(), np.asarray(jdesc), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 96), (72, 104)])
def test_detector_matches_reference(pair, hw):
    j, t = pair
    x = _images((2,) + hw, 3)
    jk, jd = j(jnp.asarray(x))
    tk, td = t(torch.as_tensor(x))
    assert np.asarray(jk.mask).sum(axis=1).max() < j.options.max_keypoints  # no cut at K
    _hold_detections(jk, jd, tk, td, NET_TOL)


def test_magicleap_checkpoint_loads_in_both(tmp_path):
    path = tmp_path / "superpoint_v1.pth"
    torch.save({k: torch.as_tensor(v) for k, v in chip_smoke.superpoint_fixture(0).items()}, path)
    j = j_sp.SuperPoint(weights_path=str(path))
    t = t_sp.SuperPoint(weights_path=str(path))
    x = _images((1, 64, 96), 4)
    jk, jd = j(jnp.asarray(x))
    tk, td = t(torch.as_tensor(x))
    _hold_detections(jk, jd, tk, td, NET_TOL)


def test_registry_pads_to_the_stride(tmp_path):
    path = tmp_path / "superpoint_v1.pth"
    torch.save({k: torch.as_tensor(v) for k, v in chip_smoke.superpoint_fixture(1).items()}, path)
    cfg = {"name": "superpoint", "max_keypoints": 256, "weights_path": str(path)}
    j, t = j_build_detector(dict(cfg)), registry.build_detector(dict(cfg))
    assert t.max_keypoints == 256 and t.stride == 8
    x = _images((2, 61, 90), 5)
    jxy, jm, jd = j.detect_batch(x)
    txy, tm, td = t.detect_batch(torch.as_tensor(x))
    assert txy.shape == jxy.shape == (2, 256, 2) and td.shape == (2, 256, 256)
    for b in range(2):
        a, c = np.lexsort((jxy[b, jm[b], 0], jxy[b, jm[b], 1])), np.lexsort((txy[b, tm[b], 0], txy[b, tm[b], 1]))
        np.testing.assert_array_equal(txy[b, tm[b]][c], jxy[b, jm[b]][a])
        np.testing.assert_allclose(td[b, tm[b]][c], jd[b, jm[b]][a], rtol=0, atol=NET_TOL)


def test_keypoints_container_matches_reference():
    """common/keypoints.py against the reference's Keypoints: create's
    defaults, get_top_k (ties in index order, invalid entries last),
    extract, filter_by_mask, pad_to and the valid coordinates."""
    from gtsfm_tpu.common.keypoints import Keypoints as JKeypoints
    from gtsfm_tpu_torch.common.keypoints import Keypoints

    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 100, (2, 12, 2)).astype(np.float32)
    resp = rng.integers(0, 4, (2, 12)).astype(np.float32)  # many ties
    mask = rng.random((2, 12)) > 0.3
    j = JKeypoints.create(jnp.asarray(xy), responses=jnp.asarray(resp), mask=jnp.asarray(mask))
    t = Keypoints.create(torch.as_tensor(xy), responses=torch.as_tensor(resp), mask=torch.as_tensor(mask))
    assert len(t) == len(j) and t.max_keypoints == j.max_keypoints == 12
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))

    def same(a, b):
        for f in ("coordinates", "scales", "responses", "mask"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))

    same(t.get_top_k(5), j.get_top_k(5))
    idx = rng.integers(0, 12, (2, 4))
    same(t.extract(torch.as_tensor(idx)), j.extract(jnp.asarray(idx)))
    keep = rng.random((2, 12)) > 0.5
    same(t.filter_by_mask(torch.as_tensor(keep)), j.filter_by_mask(jnp.asarray(keep)))
    same(t.pad_to(16), j.pad_to(16))
    assert t.pad_to(8) is t
    first = t.map(lambda a: a[0]).valid_coordinates_np()
    np.testing.assert_array_equal(first, j.valid_coordinates_np()[: mask[0].sum()])
