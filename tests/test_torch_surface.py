"""The port's public surface against the JAX package, on the CPU.

Each helper runs in both packages on the same seeded numpy inputs:

- geometry: SE3 ``between`` / ``matrix`` / ``from_matrix`` / ``local`` /
  ``batch_shape``, Sim3 ``identity`` / ``compose`` / ``inverse``, ``vee``
  and ``from_quat`` at 1e-6; ``so3.random`` orthonormal with determinant 1
  to 1e-5; ``PinholeCamera.center``; the rotation, translation and pose
  comparisons (booleans equal, angles to 1e-5 degrees);
- scene data, exact: the padded ``from_cameras_and_tracks``, ``compact``,
  the largest connected component, ``downsample``, ``Image.extract_patch``,
  ``LoaderBase.valid_pairs`` and ``load_grayscale_batch(pad_to=)``,
  ``matches_to_pairs``;
- caches: ``enabled=False`` writes nothing and calls through every time;
  ``get_or_compute`` and ``DetectorCacher`` call once and replay;
- numerics: ``nullvec_pinned_from_rows`` to 1e-5 (the exact null space of
  the reference's test and generic rows) against JAX's and the port's
  ``nullvec_pinned_scalarized``, ``smallest_eigvec_power`` to 1e-4 up to
  sign, ``einsum``; ``match_descriptors`` without bf16 (indices and masks
  equal, scores 1e-6) and without the ratio test; MegaLoc's ``test_small``.

``test_every_public_name_has_a_counterpart`` walks both packages' ASTs:
every public function, class, method, field and parameter of a JAX module
must exist in its port file, unless ``ALLOWED`` lists it with its reason.
"""

import ast
import fnmatch
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.common.image import Image as JImage
from gtsfm_tpu.common.sfm_data import SfmData as JSfmData
from gtsfm_tpu.frontend.matchers import mutual_nn as j_mnn
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal, PinholeCamera as JCam, so3 as jso3
from gtsfm_tpu.geometry.sim3 import Sim3 as JSim3
from gtsfm_tpu.loader.base import LoaderBase as JLoaderBase
from gtsfm_tpu.products.types import OneViewData as JOneViewData
from gtsfm_tpu.utils import geometry_comparisons as jgc
from gtsfm_tpu.utils import numerics as jnum
from gtsfm_tpu_torch.common.image import Image
from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.frontend.cachers import GlobalDescriptorCacher, MatcherCacher
from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSift, DoGSiftOptions
from gtsfm_tpu_torch.frontend.matchers import mutual_nn
from gtsfm_tpu_torch.frontend.two_view_cacher import TwoViewEstimatorCacher
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler, PinholeCamera, so3
from gtsfm_tpu_torch.geometry.sim3 import Sim3
from gtsfm_tpu_torch.loader.base import LoaderBase
from gtsfm_tpu_torch.products.types import OneViewData
from gtsfm_tpu_torch.utils import geometry_comparisons as gc
from gtsfm_tpu_torch.utils import numerics
from gtsfm_tpu_torch.utils.cache import DetectorCacher, DiskCache
from tests.torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


def _quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def _poses(rng, n, scale=1.0):
    R = np.array(jso3.from_quat(jnp.asarray(_quats(rng, n))))
    t = (scale * rng.normal(size=(n, 3))).astype(np.float32)
    return R, t


# ---- geometry ---------------------------------------------------------------

def test_se3_sim3_vee_and_from_quat_match_reference():
    rng = np.random.default_rng(0)
    q = _quats(rng, 16)
    _close(so3.from_quat(torch.as_tensor(q)), jso3.from_quat(jnp.asarray(q)))
    W = rng.normal(size=(16, 3, 3)).astype(np.float32)
    _close(so3.vee(torch.as_tensor(W)), jso3.vee(jnp.asarray(W)))

    Ra, ta = _poses(rng, 16)
    Rb, tb = _poses(rng, 16)
    a, b = SE3(R=torch.as_tensor(Ra), t=torch.as_tensor(ta)), SE3(R=torch.as_tensor(Rb), t=torch.as_tensor(tb))
    ja, jb = JSE3(R=jnp.asarray(Ra), t=jnp.asarray(ta)), JSE3(R=jnp.asarray(Rb), t=jnp.asarray(tb))
    ab, jab = a.between(b), ja.between(jb)
    _close(ab.R, jab.R)
    _close(ab.t, jab.t)
    _close((a * b).t, (ja * jb).t)
    _close(a.matrix(), ja.matrix())
    back = SE3.from_matrix(a.matrix())
    _close(back.R, JSE3.from_matrix(ja.matrix()).R)
    _close(back.t, JSE3.from_matrix(ja.matrix()).t)
    assert a.batch_shape == ja.batch_shape == (16,)
    assert SE3.identity().batch_shape == JSE3.identity().batch_shape == ()
    # local, the inverse of retract, on nearby poses (where the optimizers use it)
    xi = (0.2 * rng.normal(size=(16, 6))).astype(np.float32)
    near, jnear = a.retract(torch.as_tensor(xi)), ja.retract(jnp.asarray(xi))
    _close(a.local(near), ja.local(jnear))
    _close(a.local(near), xi, 1e-5)

    s = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    S = Sim3(R=torch.as_tensor(Ra), t=torch.as_tensor(ta), s=torch.as_tensor(s))
    T = Sim3(R=torch.as_tensor(Rb), t=torch.as_tensor(tb), s=torch.as_tensor(s[::-1].copy()))
    jS = JSim3(R=jnp.asarray(Ra), t=jnp.asarray(ta), s=jnp.asarray(s))
    jT = JSim3(R=jnp.asarray(Rb), t=jnp.asarray(tb), s=jnp.asarray(s[::-1].copy()))
    for got, want in ((S.compose(T), jS.compose(jT)), (S.inverse(), jS.inverse()),
                      (Sim3.identity((2, 3)), JSim3.identity((2, 3)))):
        for f in ("R", "t", "s"):
            _close(getattr(got, f), getattr(want, f))
    ident = Sim3.identity((4,), device="cpu")
    assert ident.R.device == torch.device("cpu") and ident.s.shape == (4,)

    cam = PinholeCamera(pose=a, cal=Cal3Bundler.create(torch.ones(16), torch.zeros(16), torch.zeros(16),
                                                       torch.zeros(16), torch.zeros(16)))
    jcam = JCam(pose=ja, cal=JCal.create(jnp.ones(16), jnp.zeros(16), jnp.zeros(16), jnp.zeros(16), jnp.zeros(16)))
    _close(cam.center(), jcam.center())


def test_so3_random_is_a_rotation_from_the_generators_normals():
    R = so3.random(torch.Generator().manual_seed(0), (64,))
    assert R.shape == (64, 3, 3) and R.dtype == torch.float32
    Rn = R.double().numpy()
    np.testing.assert_allclose(Rn @ np.swapaxes(Rn, -1, -2), np.broadcast_to(np.eye(3), Rn.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rn), 1.0, atol=1e-5)
    normals = torch.randn((64, 4), generator=torch.Generator().manual_seed(0)).numpy()
    _close(R, jso3.from_quat(jnp.asarray(normals)))
    assert so3.random(torch.Generator().manual_seed(1)).shape == (3, 3)


def test_geometry_comparisons_match_reference():
    rng = np.random.default_rng(1)
    R, t = _poses(rng, 8, scale=3.0)
    for i in range(7):
        got = gc.compute_relative_rotation_angle(R[i], R[i + 1])
        want = jgc.compute_relative_rotation_angle(R[i], R[i + 1])
        assert abs(got - want) < 1e-5 and got > 1.0
        u1, u2 = t[i], t[i + 1]
        assert abs(gc.compute_relative_unit_translation_angle(torch.as_tensor(u1), u2)
                   - jgc.compute_relative_unit_translation_angle(u1, u2)) < 1e-5
    pa, pb = SE3(R=torch.as_tensor(R[0]), t=torch.as_tensor(t[0])), SE3(R=torch.as_tensor(R[3]), t=torch.as_tensor(t[3]))
    jpa, jpb = JSE3(R=jnp.asarray(R[0]), t=jnp.asarray(t[0])), JSE3(R=jnp.asarray(R[3]), t=jnp.asarray(t[3]))
    (gr, gt), (wr, wt) = gc.pose_distance(pa, pb), jgc.pose_distance(jpa, jpb)
    assert abs(gr - wr) < 1e-5 and abs(gt - wt) < 1e-5

    G = np.asarray(jso3.expmap(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    noisy = np.asarray(jso3.expmap(jnp.asarray(rng.normal(scale=0.03, size=(8, 3)).astype(np.float32))))
    for k, Rb in enumerate((G @ R, noisy @ G @ R, R[::-1].copy())):
        Rb = Rb.astype(np.float32)
        for thr in (0.5, 5.0):
            want = jgc.compare_rotations(R, Rb, thr)
            assert gc.compare_rotations(torch.as_tensor(R), Rb, thr) == want
            assert want == (k == 0 or (k == 1 and thr == 5.0))


# ---- scene data -------------------------------------------------------------

def _tracks(rng):
    """Cameras 0-3 and 5-6 co-observe tracks in two components, camera 4
    sees nothing and camera 7 is unposed."""
    tracks = []
    for cams in ([0, 1], [1, 2, 3], [0, 3], [2, 3], [0, 1, 2], [5, 6], [5, 6], [1], [7, 0]):
        obs = [(c, rng.uniform(0, 100, 2).astype(np.float32)) for c in cams]
        tracks.append((rng.normal(size=3).astype(np.float32), obs))
    return tracks


def _scene_pair(pad_tracks_to=16, pad_meas_to=32):
    rng = np.random.default_rng(2)
    R, t = _poses(rng, 8)
    tracks = _tracks(rng)
    pose_mask = np.arange(8) != 7
    z = np.zeros(8, np.float32)
    jd = JSfmData.from_cameras_and_tracks(JSE3(R=jnp.asarray(R), t=jnp.asarray(t)),
                                          JCal.create(jnp.ones(8), z, z, z, z), tracks, pose_mask=pose_mask,
                                          pad_tracks_to=pad_tracks_to, pad_meas_to=pad_meas_to)
    zt = torch.zeros(8)
    td = SfmData.from_cameras_and_tracks(SE3(R=torch.as_tensor(R), t=torch.as_tensor(t)),
                                         Cal3Bundler.create(torch.ones(8), zt, zt, zt, zt), tracks,
                                         pose_mask=pose_mask, pad_tracks_to=pad_tracks_to, pad_meas_to=pad_meas_to)
    return td, jd


SCENE_FIELDS = ("pose_mask", "points", "track_mask", "meas_cam", "meas_track", "meas_uv", "meas_mask")


def _same_scene(got: SfmData, want: JSfmData):
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.max_measurements == want.max_measurements


def test_scene_data_host_ops_match_reference():
    td, jd = _scene_pair()
    assert (td.max_tracks, td.max_measurements) == (16, 32)
    _same_scene(td, jd)
    _same_scene(*_scene_pair(None, None))
    with pytest.raises(ValueError, match="pad_tracks_to"):  # the reference asserts
        SfmData.from_cameras_and_tracks(td.poses, td.cal, _tracks(np.random.default_rng(2)), pad_tracks_to=4)
    # drop a track and a measurement, then compact
    drop_t, drop_m = np.arange(16) == 2, np.arange(32) == 1
    td = td.replace(track_mask=td.track_mask & torch.as_tensor(~drop_t), meas_mask=td.meas_mask & torch.as_tensor(~drop_m))
    jd = jd.replace(track_mask=jd.track_mask & ~drop_t, meas_mask=jd.meas_mask & ~drop_m)
    _same_scene(td.compact(), jd.compact())
    lcc = td.select_largest_connected_component()
    _same_scene(lcc, jd.select_largest_connected_component())
    assert lcc.pose_mask.numpy().tolist() == [True] * 4 + [False] * 4
    for n, seed in ((3, 0), (5, 7), (100, 0)):
        _same_scene(td.downsample(n, seed=seed), jd.downsample(n, seed=seed))


def test_image_loader_and_view_record_match_reference():
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 255, (9, 13, 3), dtype=np.uint8)
    mask = rng.random((9, 13)) > 0.5
    img, jimg = Image(arr, mask=mask), JImage(arr, mask=mask)
    assert img.shape == jimg.shape and img.mask is mask
    for x, y, size in ((0, 0, 5), (12, 8, 4), (6, 4, 7), (-3, 20, 6)):
        np.testing.assert_array_equal(img.extract_patch(x, y, size), jimg.extract_patch(x, y, size))

    grays = [rng.uniform(size=s).astype(np.float32) for s in ((20, 30), (24, 18), (10, 10), (16, 16))]

    def loader(base):
        class Tiny(base):
            def __len__(self):
                return len(grays)

            def _get_image_full_res(self, index):
                return (Image if base is LoaderBase else JImage)(grays[index])

            def is_valid_pair(self, i1, i2):
                return super().is_valid_pair(i1, i2) and i2 - i1 <= 2

        return Tiny()

    port, ref = loader(LoaderBase), loader(JLoaderBase)
    np.testing.assert_array_equal(port.valid_pairs(), ref.valid_pairs())
    assert port.valid_pairs().dtype == np.int32 and len(port.valid_pairs()) == 5
    for pad_to in (None, (32, 8), (8, 40)):
        (b, s), (jb, js) = port.load_grayscale_batch(pad_to=pad_to), ref.load_grayscale_batch(pad_to=pad_to)
        np.testing.assert_array_equal(b, jb)
        assert s == js
    view = dict(index=3, fname="a.png", intrinsics=1.0, absolute_pose_prior=None, gt_camera=None, gt_pose=2.0)
    assert vars(OneViewData(**view)) == vars(JOneViewData(**view))


# ---- caches -----------------------------------------------------------------

class _Counting:
    def __init__(self, fn, options=None):
        self.fn, self.n, self.options = fn, 0, options

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


def test_disabled_caches_write_nothing_and_call_through(tmp_path):
    root = str(tmp_path / "cache")
    cache = DiskCache("x", root=root, enabled=False)
    cache.put("k", 1)
    assert cache.get("k") is None
    fn = _Counting(lambda: 42)
    assert cache.get_or_compute("k", fn) == cache.get_or_compute("k", fn) == 42 and fn.n == 2

    class Matcher:
        match_batch = _Counting(lambda *a: (torch.zeros(1, 4, dtype=torch.int32),) * 3)

    class Descriptor:
        describe_batch = _Counting(lambda images: np.ones((len(images), 8), np.float32))

    d = torch.zeros(1, 4, 8)
    c, m = torch.zeros(1, 4, 2), torch.ones(1, 4, dtype=torch.bool)
    matcher = MatcherCacher(Matcher(), root=root, enabled=False)
    desc = GlobalDescriptorCacher(Descriptor(), root=root, enabled=False)
    two_view = TwoViewEstimatorCacher(_Counting(lambda *a: "tvr"), root=root, enabled=False)
    detector = DetectorCacher(_Counting(lambda img, device: ("kps", "desc")), root=root, enabled=False)
    z = torch.zeros(2)
    cal = Cal3Bundler.create(torch.ones(2), z, z, z, z)
    img = np.zeros((16, 16), np.float32)
    for _ in range(2):
        matcher.match_batch(d, d, c, c, m, m)
        desc.describe_batch(np.zeros((2, 16, 16), np.float32))
        assert two_view.run(np.array([[0, 1]]), np.zeros((2, 4, 2)), np.ones((2, 4), bool),
                            np.zeros((2, 4, 8)), cal) == "tvr"
        detector(img, device="cpu")
    assert Matcher.match_batch.n == Descriptor.describe_batch.n == two_view.run_fn.n == detector.detector.n == 2
    assert not os.path.exists(root)


def test_get_or_compute_and_detector_cacher_replay(tmp_path):
    cache = DiskCache("test", root=str(tmp_path))
    fn = _Counting(lambda: {"a": np.arange(5)})
    first, again = cache.get_or_compute("k", fn), cache.get_or_compute("k", fn)
    np.testing.assert_array_equal(first["a"], again["a"])
    assert fn.n == 1

    det = DoGSift(DoGSiftOptions(max_keypoints=64, num_octaves=2))
    counting = _Counting(det, options=det.options)
    cached = DetectorCacher(counting, root=str(tmp_path))
    img = torch.as_tensor(np.random.default_rng(0).uniform(size=(96, 96)).astype(np.float32))
    k1, d1 = cached(img, device="cpu")
    k2, d2 = cached(img, device="cpu")
    assert counting.n == 1 and int(k1.mask.sum()) > 0
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    for f in ("coordinates", "scales", "responses", "mask"):
        np.testing.assert_array_equal(getattr(k1, f).numpy(), getattr(k2, f).numpy(), err_msg=f)
    assert d2.device == img.device
    # another detector's options key another entry
    other = _Counting(det, options=det.options._replace(max_keypoints=32))
    DetectorCacher(other, root=str(tmp_path))(img, device="cpu")
    assert other.n == 1


# ---- numerics and matching --------------------------------------------------

def _align(e, ref):
    s = np.sign(np.sum(e * ref, axis=-1, keepdims=True))
    s[s == 0] = 1
    return e * s


def test_nullvec_pinned_from_rows_matches_reference_and_scalarized():
    # the exact null space of the reference's test
    rng = np.random.default_rng(1)
    null = rng.normal(size=(512, 9)).astype(np.float32)
    null /= np.linalg.norm(null, axis=-1, keepdims=True)
    rows = rng.normal(size=(512, 8, 9)).astype(np.float32)
    rows -= np.einsum("hkj,hj->hk", rows, null)[..., None] * null[:, None, :]
    good = np.abs(null[:, 8]) > 0.05
    got = numerics.nullvec_pinned_from_rows(torch.as_tensor(rows)).numpy()
    want = np.asarray(jnum.nullvec_pinned_from_rows(jnp.asarray(rows)))
    _close(got[good], want[good], 1e-5)
    assert np.abs(np.sum(got * null, axis=-1))[good].min() > 0.999
    # generic rows, against JAX's and the port's scalarized solve
    A8 = np.random.default_rng(2).normal(size=(1024, 8, 9)).astype(np.float32)
    got = numerics.nullvec_pinned_from_rows(torch.as_tensor(A8)).numpy()
    _close(got, np.asarray(jnum.nullvec_pinned_from_rows(jnp.asarray(A8))), 1e-5)
    scal = numerics.nullvec_pinned_scalarized(torch.einsum("hkr,hks->hrs", torch.as_tensor(A8), torch.as_tensor(A8)))
    d = np.abs(_align(scal.numpy(), got) - got).max(axis=-1)
    assert np.median(d) < 1e-5 and (d > 1e-3).mean() < 0.01


def test_smallest_eigvec_power_and_einsum_match_reference():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(64, 6, 6)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2) + 0.01 * np.eye(6, dtype=np.float32)
    got = numerics.smallest_eigvec_power(torch.as_tensor(A)).numpy()
    want = np.asarray(jnum.smallest_eigvec_power(jnp.asarray(A)))
    _close(_align(got, want), want, 1e-4)
    x, y = rng.normal(size=(5, 3, 4)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32)
    _close(numerics.einsum("bij,bj->bi", torch.as_tensor(x), torch.as_tensor(y)),
           jnum.einsum("bij,bj->bi", jnp.asarray(x), jnp.asarray(y)))


def _normed(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_match_descriptors_options_and_matches_to_pairs_match_reference():
    rng = np.random.default_rng(4)
    d1 = _normed(rng.normal(size=(100, 32))).astype(np.float32)
    d2 = np.concatenate([d1[:60] + 0.05 * rng.normal(size=(60, 32)), rng.normal(size=(50, 32))]).astype(np.float32)
    d2 = _normed(d2).astype(np.float32)
    m1, m2 = rng.random(100) > 0.1, rng.random(110) > 0.1
    t_in = [torch.as_tensor(a) for a in (d1, d2, m1, m2)]
    j_in = [jnp.asarray(a) for a in (d1, d2, m1, m2)]
    for ratio_test, use_bf16 in ((True, False), (False, True), (False, False), (True, True)):
        gi, gm, gs = mutual_nn.match_descriptors(*t_in, ratio_test=ratio_test, use_bf16=use_bf16)
        wi, wm, ws = j_mnn.match_descriptors(*j_in, ratio_test=ratio_test, use_bf16=use_bf16)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        if not use_bf16:
            _close(gs, ws)
        assert int(gm.sum()) > 30
    idx, mask = gi.numpy(), gm.numpy()
    for max_matches in (8, 64, 100):
        got = mutual_nn.matches_to_pairs(torch.as_tensor(idx), torch.as_tensor(mask), max_matches)
        want = j_mnn.matches_to_pairs(jnp.asarray(idx), jnp.asarray(mask), max_matches)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    single, _ = mutual_nn.matches_to_pairs(torch.as_tensor(idx), torch.as_tensor(mask), 64)
    batched, _ = mutual_nn.matches_to_pairs(torch.as_tensor(np.stack([idx, idx])),
                                            torch.as_tensor(np.stack([mask, mask])), 64)
    for row in batched:
        np.testing.assert_array_equal(row.numpy(), single.numpy())


def test_megaloc_test_small_matches_reference_options():
    from gtsfm_tpu.frontend.global_descriptors.megaloc import MegaLocDescriptor as JMegaLoc
    from gtsfm_tpu_torch.frontend.global_descriptors.megaloc import MegaLocDescriptor

    port = MegaLocDescriptor(test_small=True)
    assert port.options == JMegaLoc(test_small=True).options
    assert port.describe_batch(np.zeros((1, 70, 70), np.float32)).shape == (1, port.options.feat_dim)


# ---- the public surface -----------------------------------------------------

FLAX = ("Flax functional form: the reference's params trees and its init_params / *_forward / "
        "convert_torch_state_dict functions are the port's nn.Modules (forward, state_dict in the public "
        "layout), with utils/convert.py carrying the reference's params across")
PARAMS = "a Flax params tree: the port's constructor takes a state_dict in the public checkpoint layout"
KEY = ("a JAX PRNG key: torch cannot replay threefry, so the port takes the draws themselves "
       "(sample_idx, uniforms, t0), a seed or a torch.Generator")
PAD_HWM = ("pad_hwm pads to the reference's pow2 high-water marks so that XLA reuses one executable; the "
           "port compacts to exact counts (ROADMAP.md queue 3)")

# (JAX module path, name pattern or None for the whole file, reason)
ALLOWED = [
    ("frontend/matchers/pallas_attention.py", None,
     "a Pallas file: its kernels are frontend/matchers/fused_attention.py and csrc/fused_attention.cu"),
    ("frontend/matchers/pallas_matcher.py", None,
     "a Pallas file: its kernel is frontend/matchers/fused_matcher.py and csrc/fused_matcher.cu"),
    ("utils/compile_cache.py", None,
     "XLA's persistent compile cache: its counterpart is utils/cuda_build.py's kernel build directory"),
    ("*", "*.__init__(params)", PARAMS),
    ("frontend/mast3r.py", "decode*", FLAX),
    ("frontend/mast3r.py", "encode*", FLAX),
    ("frontend/mast3r.py", "init_params*", FLAX),
    ("frontend/mast3r.py", "local_features*", FLAX),
    ("frontend/mast3r.py", "symmetric_inference*", FLAX),
    ("frontend/vggt.py", "*_forward*", FLAX),
    ("frontend/vggt.py", "init_params*", FLAX),
    ("frontend/vggt.py", "convert_torch_state_dict*", FLAX),
    ("frontend/vggt_track.py", "*_forward*", FLAX),
    ("frontend/vggt_track.py", "init_track_params*", FLAX),
    ("frontend/vggt_track.py", "convert_torch_track_state_dict*", FLAX),
    ("frontend/vggt_track.py", "track_options_from_params*",
     FLAX + "; the port reads the track options off the state_dict (vggt.options_from_state_dict)"),
    ("frontend/detectors/disk.py", "init_params*", FLAX),
    ("frontend/detectors/disk.py", "unet_forward*", FLAX),
    ("frontend/global_descriptors/megaloc.py", "init_params*", FLAX),
    ("frontend/global_descriptors/megaloc.py", "*_forward*", FLAX),
    ("densify/patchmatchnet.py", "patchmatchnet_forward*", FLAX),
    ("densify/patchmatchnet.py", "feature_net*", FLAX),
    ("densify/patchmatchnet.py", "convert_torch_state_dict*", FLAX),
    ("frontend/matchers/lightglue.py", "convert_torch_state_dict*", FLAX),
    ("frontend/matchers/lightglue.py", "*Block.dtype",
     "a Flax field choosing the blocks' compute dtype: the port's blocks run in their inputs' dtype"),
    ("frontend/matchers/lightglue.py", "*Block.use_pallas",
     "a Flax field choosing the Pallas kernel: the port launches the CUDA kernel on a CUDA tensor"),
    ("frontend/matchers/loftr.py", "convert_torch_state_dict*", FLAX),
    ("frontend/matchers/loftr.py", "load_torch_weights(opts)", FLAX + "; the port returns the state_dict"),
    ("frontend/matchers/loftr.py", "LoFTRNet.setup", FLAX + "; the port builds its submodules in __init__"),
    ("frontend/matchers/loftr.py", "ResNetFPN_8_2.opts", FLAX + "; the port's takes initial_dim and block_dims"),
    ("frontend/matchers/*.py", "*.__init__(example_hw)", "the example shape of the Flax init"),
    ("frontend/matchers/superglue.py", "convert_torch_state_dict*", FLAX),
    ("frontend/matchers/superglue.py", "load_torch_weights(opts)", FLAX + "; the port returns the state_dict"),
    ("frontend/matchers/superglue.py", "AttentionalPropagationSG*",
     "SuperGlue's official class name, AttentionalPropagation, whose state_dict keys are the checkpoint's"),
    ("frontend/matchers/superglue.py", "KeypointEncoderSG*",
     "SuperGlue's official class name, KeypointEncoder, whose state_dict keys are the checkpoint's"),
    ("frontend/matchers/superglue.py", "SuperGlueMatcher.__init__(kp_scores)",
     "unused by the reference's constructor; the port takes keypoint scores per call (kp_scores0/1)"),
    ("frontend/matchers/superglue.py", "log_optimal_transport(?_count)",
     "the port's takes row and column masks rather than counts"),
    ("frontend/anysplat.py", "AnySplatModel.__init__(options)",
     "the port's AnySplatModel takes a built VGGTModel rather than its options"),
    ("frontend/anysplat.py", "init_gaussian_head(key)", KEY),
    ("frontend/detectors/dog_sift.py", "detect_and_describe(image)",
     "the port's detect_and_describe is batched over (B, H, W) images; DoGSift.__call__ keeps the one-image form"),
    ("bundle/triangulation.py", "*(key)", KEY),
    ("frontend/two_view.py", "run_two_view_batch(key)", KEY),
    ("frontend/verifiers/*.py", "*(key)", KEY),
    ("geometry/so3.py", "random(key)", KEY),
    ("bundle/ba.py", "*(pad_hwm)", PAD_HWM),
    ("scene/mvo.py", "*(pad_hwm)", PAD_HWM),
    ("merging/merge.py", "*(pad_hwm)", PAD_HWM),
    ("utils/numerics.py", "HIGHEST",
     "JAX's matmul precision constant has no torch counterpart: the port turns TF32 off under precise()"),
    ("utils/numerics.py", "precise(fn)",
     "the reference's precise decorates fn; the port's precise() is a context manager, a decorator as @precise()"),
]


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _classes(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _members(node, classes, seen=()):
    """({method name: def}, field names) of a class and of its bases that
    are classes of the package (a Flax struct's or NamedTuple's fields are
    its annotated names)."""
    methods, fields = {}, set()
    for b in node.bases:
        name = b.id if isinstance(b, ast.Name) else getattr(b, "attr", None)
        if name in classes and name not in seen:
            m, f = _members(classes[name], classes, seen + (node.name,))
            methods.update(m)
            fields |= f
    for b in node.body:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[b.name] = b
        elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
            fields.add(b.target.id)
    return methods, fields


def _surface(path, classes, port):
    """The public names of a module: functions, classes, methods (with
    __init__ and __call__), fields and module-level names, and each
    parameter as ``name(param)``. In the port an nn.Module's ``forward`` is
    its ``__call__``, and its constructor's parameters are its fields (a
    Flax module's fields are its constructor's arguments)."""
    tree = ast.parse(open(path).read())
    classes = {**classes, **_classes(tree)}
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out.add(node.name)
            out |= {f"{node.name}({p})" for p in _params(node)}
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.add(node.name)
            methods, fields = _members(node, classes)
            if port and "forward" in methods:
                methods.setdefault("__call__", methods["forward"])
            if port and "__init__" in methods:
                fields |= set(_params(methods["__init__"]))
            for name, fn in methods.items():
                if not name.startswith("_") or name in ("__init__", "__call__"):
                    out.add(f"{node.name}.{name}")
                    out |= {f"{node.name}.{name}({p})" for p in _params(fn)}
            out |= {f"{node.name}.{f}" for f in fields if not f.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out.add(t.id)
    return out


def _py_files(root):
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), root)


def _allowed(rel, name):
    return [i for i, (mod, pat, _why) in enumerate(ALLOWED)
            if fnmatch.fnmatch(rel, mod) and (pat is None) == (name is None) and (pat is None or fnmatch.fnmatch(name, pat))]


def test_every_public_name_has_a_counterpart():
    ref_root, port_root = os.path.join(REPO, "gtsfm_tpu"), os.path.join(REPO, "gtsfm_tpu_torch")
    port_classes = {}
    for rel in _py_files(port_root):
        port_classes.update(_classes(ast.parse(open(os.path.join(port_root, rel)).read())))
    missing, used = [], set()
    for rel in _py_files(ref_root):
        port_path = os.path.join(port_root, rel)
        if not os.path.exists(port_path):
            hits = _allowed(rel, None)
            used.update(hits)
            if not hits:
                missing.append(f"{rel}: no port file")
            continue
        gap = _surface(os.path.join(ref_root, rel), {}, port=False) - _surface(port_path, port_classes, port=True)
        for name in sorted(gap):
            hits = _allowed(rel, name)
            used.update(hits)
            if not hits:
                missing.append(f"{rel}: {name}")
    assert not missing, "public names of the JAX package missing from the port:\n" + "\n".join(missing)
    stale = [ALLOWED[i][:2] for i in range(len(ALLOWED)) if i not in used]
    assert not stale, f"allow-list entries that match nothing: {stale}"
    assert all(len(why) > 20 for _m, _p, why in ALLOWED)


def test_no_port_entry_point_defaults_to_the_cpu():
    """Entry points run on the card unless the caller asks for the CPU: no
    ``device`` parameter of the port defaults to "cpu", and none of a
    constructor or a ``__call__`` defaults to None (which would leave the
    choice to torch's default device, the CPU). The tensor builders
    (``SE3.identity``, ``Sim3.identity``, ``Cal3*.create``, ``convert.*``,
    ...) keep ``device=None`` as torch's factories do: they build on the
    device they are given, and the entry points give them theirs."""
    root = os.path.join(REPO, "gtsfm_tpu_torch")
    found = []
    for rel in _py_files(root):
        for node in ast.walk(ast.parse(open(os.path.join(root, rel)).read())):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
            for arg, default in pairs:
                if "device" not in arg.arg or not isinstance(default, ast.Constant):
                    continue
                if default.value == "cpu" or (default.value is None and node.name in ("__init__", "__call__")):
                    found.append(f"{rel}:{node.lineno} {node.name}({arg.arg}={default.value!r})")
    assert not found, found


@pytest.mark.parametrize("cached", [False, True], ids=["DoGSift", "DetectorCacher"])
def test_per_image_detector_calls_default_to_the_card(cached, tmp_path, monkeypatch):
    """``DoGSift.__call__`` and ``DetectorCacher.__call__`` put a numpy
    image on the card unless asked for the CPU, and raise without a card
    (a miss and a replay alike)."""
    det = DoGSift(DoGSiftOptions(max_keypoints=32, num_octaves=2))
    call = DetectorCacher(det, root=str(tmp_path)) if cached else det
    img = np.random.default_rng(1).uniform(size=(64, 64)).astype(np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(img)
        kps, desc = call(img, device="cpu")
        assert kps.coordinates.device == desc.device == torch.device("cpu")
