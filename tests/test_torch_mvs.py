"""The port's plane-sweep MVS against the reference, on the CPU.

- ``plane_sweep_depth`` at 48x64, D=16, S=2, window 5 on a textured plane
  seen by a four-camera rig and on smooth random images: depth and
  confidence within 1e-4 relative on >= 99% of the pixels (float32 sums
  in another order; a pixel whose best plane is a near tie may take the
  other one);
- ``select_source_views``: equal; ``_depth_range_per_view``: within 1e-6
  relative (the same float32 rotation, summed in another order);
- ``fuse_depth_maps`` on one set of depth maps: the same points, colors
  and metrics (both host numpy);
- ``PlaneSweepMVS.run`` on ``make_synthetic_scene`` with random images:
  the same views, depth maps as above, dense point counts within 1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.common.sfm_data import SfmData as JSfmData
from gtsfm_tpu.densify import mvs as j_mvs
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3_S2 as JCal3_S2
from gtsfm_tpu_torch.densify import mvs
from gtsfm_tpu_torch.utils import convert
from tests.common.test_sfm_data import make_synthetic_scene
from tests.densify.test_mvs import _make_rig
from tests.torch_threads import cap_threads

cap_threads()

HW = (48, 64)
DEPTH_TOL = 1e-4  # relative, on >= PIXEL_SHARE of the pixels
PIXEL_SHARE = 0.99
RANGE_TOL = 1e-6


def _port(data) -> "mvs.SfmData":
    return convert.sfm_data(jax.tree.map(np.asarray, data))


def _close_share(a, b, tol=DEPTH_TOL) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1e-3)))


def _smooth_images(n, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 1) + HW).astype(np.float32))
    return torch.nn.functional.avg_pool2d(x, 3, stride=1, padding=1)[:, 0].numpy()


def _sweep_inputs(kind: str):
    Ks, Rs, ts, imgs = _make_rig(n_cams=4, H=HW[0], W=HW[1], f=50.0)
    if kind == "random":
        imgs = _smooth_images(4, 3)
    cTw_R = Rs.transpose(0, 2, 1)
    cTw_t = -np.einsum("nij,nj->ni", cTw_R, ts)
    ref, src = 1, [0, 2]
    return (imgs[ref], imgs[src], Ks[ref], Ks[src], cTw_R[ref], cTw_t[ref], cTw_R[src], cTw_t[src],
            np.float32(3.0), np.float32(8.0))


@pytest.mark.parametrize("kind", ["plane", "random"])
def test_plane_sweep_depth_matches_reference(kind):
    args = _sweep_inputs(kind)
    jd, jc = j_mvs.plane_sweep_depth(*(jnp.asarray(a) for a in args), num_depths=16, window=5)
    td, tc = mvs.plane_sweep_depth(*(torch.as_tensor(a) for a in args[:-2]), float(args[-2]), float(args[-1]),
                                   num_depths=16, window=5)
    assert _close_share(td.numpy(), jd) >= PIXEL_SHARE
    assert _close_share(tc.numpy(), jc) >= PIXEL_SHARE
    if kind == "plane":  # the sweep finds the plane at depth 5
        good = np.asarray(jc) > 0.5
        assert np.median(np.abs(td.numpy()[good] - 5.0)) < 0.1


def _rig_scene():
    """The plane rig with sparse tracks on the plane (the reference test's
    fusion scene at 48x64)."""
    Ks, Rs, ts, imgs = _make_rig(n_cams=4, H=HW[0], W=HW[1], f=50.0)
    n, H, W = imgs.shape
    cal = JCal3_S2.create(jnp.full(n, 50.0), jnp.full(n, 50.0), jnp.zeros(n), jnp.full(n, W / 2),
                          jnp.full(n, H / 2))
    rng = np.random.default_rng(0)
    tracks = []
    for _ in range(24):
        X = np.array([rng.uniform(-1, 1), rng.uniform(-0.5, 0.5), 5.0], np.float32)
        obs = [(i, (Ks[i] @ ((X - ts[i]) / 5.0))[:2].astype(np.float32)) for i in range(n)]
        tracks.append((X, [(i, uv) for i, uv in obs if 0 <= uv[0] < W and 0 <= uv[1] < H]))
    data = JSfmData.from_cameras_and_tracks(JSE3(R=jnp.asarray(Rs), t=jnp.asarray(ts)), cal, tracks,
                                            num_cameras=n)
    return data, imgs


def test_source_views_and_depth_ranges_match_reference():
    for data in (make_synthetic_scene(n_cams=6, n_tracks=80, seed=2), _rig_scene()[0]):
        t_data = _port(data)
        for S in (2, 4):
            opts = j_mvs.MVSOptions(num_source_views=S)
            np.testing.assert_array_equal(mvs.select_source_views(t_data, mvs.MVSOptions(num_source_views=S)),
                                          j_mvs.select_source_views(data, opts))
        want = j_mvs._depth_range_per_view(data, 1.3)
        got = mvs._depth_range_per_view(t_data, 1.3)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RANGE_TOL)


def test_fuse_depth_maps_matches_reference():
    data, imgs = _rig_scene()
    opts = j_mvs.MVSOptions(num_depths=16, num_source_views=3)
    depths, confs = j_mvs.PlaneSweepMVS(opts).compute_depths(data, imgs)
    want = j_mvs.fuse_depth_maps(depths, confs, data, imgs, opts)
    got = mvs.fuse_depth_maps(depths, confs, _port(data), imgs, mvs.MVSOptions(num_depths=16, num_source_views=3))
    assert want[2]["num_dense_points"] > 500
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_plane_sweep_mvs_run_matches_reference():
    data = make_synthetic_scene(n_cams=4, n_tracks=60)
    images = _smooth_images(4, 0)
    opts = dict(num_depths=16, num_source_views=2)
    j_depths, _ = j_mvs.PlaneSweepMVS(j_mvs.MVSOptions(**opts)).compute_depths(data, images)
    jp, _jc, jm = j_mvs.PlaneSweepMVS(j_mvs.MVSOptions(**opts)).run(data, images)
    t_mvs = mvs.PlaneSweepMVS(mvs.MVSOptions(**opts), device="cpu")
    t_depths, _ = t_mvs.compute_depths(_port(data), images)
    tp, _tc, tm = t_mvs.run(_port(data), images)
    assert sorted(t_depths) == sorted(j_depths) and len(j_depths) >= 2
    for i in j_depths:
        assert _close_share(t_depths[i], j_depths[i]) >= PIXEL_SHARE
    assert tm["num_views_with_depth"] == jm["num_views_with_depth"]
    assert abs(tm["num_dense_points"] - jm["num_dense_points"]) <= 0.01 * jm["num_dense_points"]
    assert {"source_selection_sec", "depth_sec", "fusion_sec"} <= set(tm)
    assert tp.shape[1] == 3 and len(jp) == jm["num_dense_points"]


def test_plane_sweep_mvs_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mvs.PlaneSweepMVS()
