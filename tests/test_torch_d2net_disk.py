"""The port's D2-Net and DISK against the reference, on the CPU, at 64x64
and 96x128.

- D2-Net: the reference's default params (flax, PRNGKey(0)) carried across
  by ``convert.d2net_state_dict``; the trunk's dense features to 1e-5
  relative to their largest value (ten float32 convolutions in another
  order); ``hard_detection`` and ``handcrafted_localization`` on one set
  of features fed to both: equal masks, steps to 1e-5; the detector's valid
  keypoints equal as sets of sub-pixel positions (to 1e-3 px: the Newton
  step divides by the Hessian's determinant, which magnifies the
  features' float32 differences), descriptors
  to 1e-5.
- DISK: the reference's ``init_params`` (PRNGKey(0)) carried across by
  ``convert.disk_state_dict``; the U-Net's output to 1e-5 relative; the
  detector's valid keypoints equal as pixel sets, responses and descriptors
  to 1e-5 relative.
- Both through the registries, with a checkpoint file in ``tmp_path`` and
  images whose sides are not multiples of the nets' strides (4 and 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.detectors import d2net as j_d2, disk as j_disk
from gtsfm_tpu.frontend.registry import build_detector as j_build
from gtsfm_tpu_torch.frontend import registry
from gtsfm_tpu_torch.frontend.detectors import d2net as t_d2, disk as t_disk
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

SIZES = [(64, 64), (96, 128)]
TOL = 1e-5


def _images(shape, seed):
    """Smooth random images (blurred noise)."""
    x = torch.as_tensor(np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32))
    return torch.nn.functional.avg_pool2d(x[:, None], 5, stride=1, padding=2, count_include_pad=False)[:, 0].numpy()


def _valid_sorted(xy, mask, *rest):
    xy, rest = xy[mask], [r[mask] for r in rest]
    order = np.lexsort((xy[:, 0], xy[:, 1]))
    return [xy[order]] + [r[order] for r in rest]


def _hold_keypoints(jk, jd, tk, td, xy_tol):
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert jm.sum() > 0
    np.testing.assert_array_equal(tm.sum(axis=1), jm.sum(axis=1))
    for b in range(jm.shape[0]):
        jxy, jr, jdd = _valid_sorted(np.asarray(jk.coordinates)[b], jm[b], np.asarray(jk.responses)[b],
                                     np.asarray(jd)[b])
        txy, tr, tdd = _valid_sorted(tk.coordinates.numpy()[b], tm[b], tk.responses.numpy()[b], td.numpy()[b])
        np.testing.assert_allclose(txy, jxy, rtol=0, atol=xy_tol)
        np.testing.assert_allclose(tr, jr, rtol=TOL, atol=TOL * np.abs(jr).max())
        np.testing.assert_allclose(tdd, jdd, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def d2():
    j = j_d2.D2Net()
    return j, t_d2.D2Net(state_dict=convert.d2net_state_dict(jax.tree.map(np.asarray, j.params)))


@pytest.mark.parametrize("hw", SIZES)
def test_d2net_trunk_and_stages_match_reference(d2, hw):
    j, t = d2
    x = _images((2,) + hw, 0)
    want = np.array(j.net.apply({"params": j.params}, jnp.repeat(jnp.asarray(x)[..., None], 3, axis=-1)))
    with torch.no_grad():
        got = t.net(torch.as_tensor(x)[:, None].expand(-1, 3, -1, -1)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    f = torch.as_tensor(want).permute(0, 3, 1, 2)
    det_j = np.asarray(j_d2.hard_detection(jnp.asarray(want), 5.0))
    det_t = t_d2.hard_detection(f, 5.0).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(det_t, det_j)
    assert det_j.any()
    loc_j = np.asarray(j_d2.handcrafted_localization(jnp.asarray(want)))
    loc_t = t_d2.handcrafted_localization(f).permute(0, 2, 3, 1, 4).numpy()
    step = det_j[..., None] & np.ones(2, bool)
    np.testing.assert_allclose(loc_t[step], loc_j[step], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw", SIZES)
def test_d2net_detector_matches_reference(d2, hw):
    j, t = d2
    x = _images((2,) + hw, 1)
    jk, jd = j(jnp.asarray(x))
    tk, td = t(torch.as_tensor(x))
    _hold_keypoints(jk, jd, tk, td, 1e-3)


@pytest.fixture(scope="module")
def disk():
    params = j_disk.init_params(jax.random.PRNGKey(0))
    j = j_disk.DISK(params=params)
    return j, t_disk.DISK(state_dict=convert.disk_state_dict(jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("hw", SIZES)
def test_disk_unet_and_detector_match_reference(disk, hw):
    j, t = disk
    x = _images((2,) + hw, 2)
    want = np.asarray(j_disk.unet_forward(j.params, jnp.repeat(jnp.asarray(x)[..., None], 3, axis=-1)))
    with torch.no_grad():
        got = t.net.unet(torch.as_tensor(x)[:, None].expand(-1, 3, -1, -1)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    jk, jd = j(jnp.asarray(x))
    tk, td = t(torch.as_tensor(x))
    _hold_keypoints(jk, jd, tk, td, 0)


@pytest.mark.parametrize("name,stride", [("d2net", 4), ("disk", 16)])
def test_registry_loads_a_checkpoint_and_pads(d2, disk, tmp_path, name, stride):
    t_net = (d2 if name == "d2net" else disk)[1].net
    path = str(tmp_path / f"{name}.pth")
    torch.save(t_net.state_dict(), path)
    cfg = {"name": name, "max_keypoints": 128, "weights_path": path}
    j, t = j_build(dict(cfg)), registry.build_detector(dict(cfg))
    assert t.stride == stride and t.max_keypoints == 128
    x = _images((2, 61, 83), 3)
    jxy, jm, jd = j.detect_batch(x)
    txy, tm, td = t.detect_batch(torch.as_tensor(x))
    assert txy.shape == jxy.shape and td.shape == jd.shape
    for b in range(2):
        jv, jdd = _valid_sorted(jxy[b], jm[b], jd[b])
        tv, tdd = _valid_sorted(txy[b], tm[b], td[b])
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-3)
        np.testing.assert_allclose(tdd, jdd, rtol=0, atol=TOL)
