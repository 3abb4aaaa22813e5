"""The port's disk caches and chunked loading against the JAX reference,
on the CPU.

- ``content_key`` gives the reference's SHA1 on the same numpy parts.
- ``DiskCache`` round-trips host arrays and CPU tensors, treats a missing
  or corrupt entry as a miss and refuses a tensor off the CPU.
- ``MatcherCacher``, ``GlobalDescriptorCacher``, ``TwoViewEstimatorCacher``
  and the hierarchical cluster cache: the wrapped call runs once over two
  calls and the replay equals the first result; the matcher, descriptor
  and two-view keys equal the reference cachers' keys on the same inputs.
- The detector cache keys a batched CNN detector by the net inside its
  adapter: two nets on the same images get two entries, each its own.
- ``_load_detect_chunked`` at chunks of 3 gives ``_detect_batch``'s
  keypoints, masks and descriptors and the global descriptors bit for bit,
  and keeps the images only when asked, as one chunk of the whole scene.
- The runner twice with ``--use_cache`` on a rendered ring folder: the
  replay writes the same poses and points and never calls the mutual-NN
  matcher's plain version.
"""

import os

import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.cachers import GlobalDescriptorCacher as JGlobalDescriptorCacher
from gtsfm_tpu.frontend.cachers import MatcherCacher as JMatcherCacher
from gtsfm_tpu.frontend.global_descriptors.descriptors import TinyImageDescriptor as JTinyImageDescriptor
from gtsfm_tpu.frontend.two_view_cacher import TwoViewEstimatorCacher as JTwoViewEstimatorCacher
from gtsfm_tpu.utils.cache import content_key as j_content_key
from gtsfm_tpu_torch import runner
from gtsfm_tpu_torch.configs import config
from gtsfm_tpu_torch.common.keypoints import Keypoints
from gtsfm_tpu_torch.frontend.cachers import GlobalDescriptorCacher, MatcherCacher
from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import TinyImageDescriptor
from gtsfm_tpu_torch.frontend.matchers import fused_matcher
from gtsfm_tpu_torch.frontend.registry import _BatchedCNNDetectorAdapter
from gtsfm_tpu_torch.frontend.two_view import TwoViewResult
from gtsfm_tpu_torch.frontend.two_view_cacher import TwoViewEstimatorCacher
from gtsfm_tpu_torch.geometry import Cal3Bundler
from gtsfm_tpu_torch.io import colmap
from gtsfm_tpu_torch.loader.olsson import OlssonLoader
from gtsfm_tpu_torch.scene import hierarchical
from gtsfm_tpu_torch.scene.hierarchical import HierarchicalOptions, HierarchicalReconstruction
from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
from gtsfm_tpu_torch.utils import convert
from gtsfm_tpu_torch.utils.cache import DEFAULT_CACHE_ROOT, DiskCache, content_key
from tests.test_torch_runner import VIEWS, ring_folder  # noqa: F401  (the runner tests' rendered ring folder)
from tests.torch_threads import cap_threads, threads

cap_threads()

def test_content_key_matches_reference():
    rng = np.random.default_rng(0)
    parts = (rng.normal(size=(3, 4)).astype(np.float32), rng.integers(0, 9, 7).astype(np.int64),
             np.zeros((2, 0), bool), b"\x00\x01bytes", "DoGSift", 1024, 0.5, (32, 480, 640), None)
    assert content_key(*parts) == j_content_key(*parts)
    assert content_key(*parts[:-1]) != content_key(*parts)
    assert DEFAULT_CACHE_ROOT.endswith(os.path.join(".cache", "gtsfm_tpu_torch"))


def test_disk_cache_round_trip(tmp_path):
    cache = DiskCache("stage", root=str(tmp_path))
    value = (np.arange(6, dtype=np.float32).reshape(2, 3), {"t": torch.arange(4)}, "tag")
    assert cache.get("k") is None
    cache.put("k", value)
    back = cache.get("k")
    np.testing.assert_array_equal(back[0], value[0])
    assert torch.equal(back[1]["t"], value[1]["t"]) and back[2] == "tag"
    with open(cache._path("bad"), "wb") as f:
        f.write(b"not a pickle")
    assert cache.get("bad") is None
    with pytest.raises(ValueError, match="host arrays only"):
        cache.put("off_host", {"x": [torch.empty(2, device="meta")]})
    assert not os.path.exists(cache._path("off_host"))
    assert DiskCache("stage", root=str(tmp_path)).get("k")[2] == "tag"  # another instance, same entry


class _CountingMatcher:
    """A learned-matcher stand-in: mutual nearest neighbours by dot product."""

    def __init__(self):
        self.calls = 0

    def match_batch(self, desc0, desc1, coords0, coords1, mask0, mask1, image_size=None):
        self.calls += 1
        sim = torch.einsum("pkd,pld->pkl", desc0, desc1)
        idx = sim.argmax(dim=-1)
        return idx.to(torch.int32), mask0 & (sim.max(dim=-1).values > 0), sim.max(dim=-1).values


def _matcher_inputs(rng, P=3, K=70, D=16):
    d0, d1 = (rng.normal(size=(P, K, D)).astype(np.float32) for _ in range(2))
    c0, c1 = (rng.uniform(0, 300, (P, K, 2)).astype(np.float32) for _ in range(2))
    m0, m1 = (rng.random((P, K)) > 0.2 for _ in range(2))
    return d0, d1, c0, c1, m0, m1


def test_matcher_cacher_replays_and_keys_as_reference(tmp_path):
    inputs = _matcher_inputs(np.random.default_rng(1))
    inner = _CountingMatcher()
    cacher = MatcherCacher(inner, root=str(tmp_path / "port"))
    t = [torch.as_tensor(a) for a in inputs]
    first = cacher.match_batch(*t, image_size=(640, 480))
    second = cacher.match_batch(*t, image_size=(640, 480))
    assert inner.calls == 1
    for a, b in zip(first, second):
        assert torch.equal(a, b) and a.dtype == b.dtype
    j_cacher = JMatcherCacher(type("_CountingMatcher", (), {})(), root=str(tmp_path / "jax"))
    assert os.listdir(tmp_path / "port" / "matcher") == [j_cacher._key(*inputs) + ".pkl"]


def test_global_descriptor_cacher_replays_and_keys_as_reference(tmp_path):
    images = np.random.default_rng(2).uniform(0, 1, (3, 48, 64)).astype(np.float32)
    desc = TinyImageDescriptor()
    calls = []
    orig = desc.describe_batch
    desc.describe_batch = lambda x: calls.append(1) or orig(x)
    cacher = GlobalDescriptorCacher(desc, root=str(tmp_path / "port"))
    first = cacher.describe_batch(torch.as_tensor(images))
    second = cacher.describe_batch(torch.as_tensor(images))
    assert len(calls) == 1 and isinstance(second, np.ndarray)
    np.testing.assert_array_equal(first, second)
    j_out = JGlobalDescriptorCacher(JTinyImageDescriptor(), root=str(tmp_path / "jax")).describe_batch(images)
    keys = lambda tag: [os.path.splitext(p)[0] for p in os.listdir(tmp_path / tag / "global_descriptor")]  # noqa: E731
    assert keys("port") == keys("jax") and len(keys("port")) == 1
    np.testing.assert_allclose(first, np.asarray(j_out), atol=1e-5)


def _two_view_result(rng, P, K) -> TwoViewResult:
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return TwoViewResult(
        i2Ri1=f32(P, 3, 3), i2Ui1=f32(P, 3), corr_i1=torch.as_tensor(rng.integers(0, K, (P, K)), dtype=torch.int32),
        corr_i2=torch.as_tensor(rng.integers(0, K, (P, K)), dtype=torch.int32),
        corr_mask=torch.as_tensor(rng.random((P, K)) > 0.5), num_matches=torch.full((P,), 9, dtype=torch.int32),
        num_inliers=torch.full((P,), 7, dtype=torch.int32), inlier_ratio=f32(P), valid=torch.ones(P, dtype=torch.bool),
        hf_ratio=f32(P), eig_ratio=f32(P))


def test_two_view_cacher_replays_and_keys_as_reference(tmp_path):
    rng = np.random.default_rng(3)
    n, K, D = 4, 40, 16
    pairs = np.array([[0, 1], [1, 2], [2, 3]], np.int64)
    kp_xy = rng.uniform(0, 300, (n, K, 2)).astype(np.float32)
    kp_mask = rng.random((n, K)) > 0.1
    descs = rng.normal(size=(n, K, D)).astype(np.float32)
    cal = Cal3Bundler.create(np.full(n, 300.0), 0.0, 0.0, 160.0, 120.0)
    result = _two_view_result(rng, len(pairs), K)
    calls = []
    cacher = TwoViewEstimatorCacher(lambda *a: calls.append(a) or result, options_repr="opts",
                                    root=str(tmp_path / "port"))
    first = cacher.run(pairs, kp_xy, kp_mask, descs, cal, (320, 240))
    second = cacher.run(pairs, kp_xy, kp_mask, descs, cal, (320, 240))
    assert len(calls) == 1 and calls[0][-1] == (320, 240) and first is result
    for k in TwoViewResult.__dataclass_fields__:
        a, b = getattr(result, k), getattr(second, k)
        assert torch.equal(a, b) and a.dtype == b.dtype, k
    j_key = JTwoViewEstimatorCacher(None, options_repr="opts")._key(pairs, kp_xy, kp_mask, descs)
    assert os.listdir(tmp_path / "port" / "two_view") == [j_key + ".pkl"]


@threads(4)
def test_cluster_cache_replays_every_leaf(tmp_path, monkeypatch):
    """The hierarchical back end on the reference hierarchical test's
    inputs (10 cameras, max_cluster_size 4), through the port's two-view
    batch, twice with one cluster cache: the second run replays every leaf
    and gives the same scene."""
    from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions, run_two_view_batch
    from gtsfm_tpu_torch.frontend.verifiers.essential import RansacOptions
    from tests.frontend.test_two_view import make_pair_batch

    import jax

    n_cams = 10
    scene, pairs, batch = make_pair_batch(n_cams=n_cams, n_pts=200, desc_noise=0.01, seed=11)
    b = {k: (convert.cal3_bundler(jax.tree.map(np.asarray, v)) if k.startswith("cal") else torch.as_tensor(np.asarray(v)))
         for k, v in batch.items()}
    res = run_two_view_batch(b["kp_xy1"], b["kp_xy2"], b["desc1"], b["desc2"], b["kp_mask1"], b["kp_mask2"],
                             b["cal1"], b["cal2"], b["pair_mask"], opts=TwoViewOptions(ransac=RansacOptions(256)))
    kp_xy = np.zeros((n_cams, 200, 2), np.float32)
    for e, (i, j) in enumerate(pairs):
        kp_xy[i], kp_xy[j] = np.asarray(batch["kp_xy1"][e]), np.asarray(batch["kp_xy2"][e])
    tvr = {k: getattr(res, k) for k in ("i2Ri1", "i2Ui1", "valid", "num_inliers", "corr_i1", "corr_i2", "corr_mask")}
    cal = convert.cal3_bundler(jax.tree.map(np.asarray, scene.cal))
    mvo_calls = []
    orig = hierarchical.MultiViewOptimizer.run
    monkeypatch.setattr(hierarchical.MultiViewOptimizer, "run",
                        lambda self, **kw: mvo_calls.append(1) or orig(self, **kw))
    cache = DiskCache("cluster", root=str(tmp_path))
    opts = HierarchicalOptions(max_depth=1, max_cluster_size=4)
    data_a, m_a = HierarchicalReconstruction(opts, cluster_cache=cache).run(n_cams, pairs, tvr, kp_xy, cal)
    leaves = len(mvo_calls)
    data_b, m_b = HierarchicalReconstruction(opts, cluster_cache=cache).run(n_cams, pairs, tvr, kp_xy, cal)
    assert leaves == m_a["num_clusters"] >= 2 and len(mvo_calls) == leaves
    assert len(os.listdir(tmp_path / "cluster")) == leaves
    assert all(cm.get("cache_hit") for cm in m_b["cluster_metrics"]) and len(m_b["cluster_metrics"]) == leaves
    assert data_b.number_images() == data_a.number_images() >= n_cams - 1
    for k in ("points", "track_mask", "pose_mask"):
        assert torch.equal(getattr(data_a, k), getattr(data_b, k)), k
    assert torch.equal(data_a.poses.R, data_b.poses.R) and torch.equal(data_a.poses.t, data_b.poses.t)


class _GridNet:
    """A batched CNN detector stand-in: keypoints on a fixed grid, each
    descriptor the image's mean in every channel plus the net's offset."""

    def __init__(self, dim: int, offset: float, k: int = 16):
        self.dim, self.offset, self.k = dim, offset, k
        self.calls = 0

    def __call__(self, images):
        self.calls += 1
        B = images.shape[0]
        g = torch.arange(self.k, dtype=torch.float32)
        xy = torch.stack([8 + (g % 4) * 8, 8 + (g // 4) * 8], dim=-1).expand(B, self.k, 2)
        zeros = torch.zeros((B, self.k))
        kps = Keypoints(coordinates=xy, scales=zeros, responses=zeros, mask=torch.ones((B, self.k), dtype=torch.bool))
        return kps, images.mean(dim=(1, 2))[:, None, None].expand(B, self.k, self.dim) + self.offset


class _SuperPointLike(_GridNet):
    pass


class _DiskLike(_GridNet):
    pass


def test_detector_cache_keys_the_net_inside_the_adapter(tmp_path):
    images = torch.as_tensor(np.random.default_rng(0).random((2, 48, 40)), dtype=torch.float32)
    sizes = [(48, 40)] * 2
    opts = SceneOptimizerOptions(use_cache=True, cache_root=str(tmp_path), device="cpu")

    def detect(net):
        so = SceneOptimizer(opts, detector=_BatchedCNNDetectorAdapter(net, net.k, 8))
        return so._detect_batch(images, sizes)

    sp, disk = _SuperPointLike(256, 1.0), _DiskLike(128, 2.0)
    a, b = detect(sp), detect(disk)
    assert sp.calls == disk.calls == 1  # the second net detected, not replayed the first's entry
    assert len(os.listdir(tmp_path / "detector")) == 2
    assert a[2].shape == (2, 16, 256) and b[2].shape == (2, 16, 128)
    again = detect(_DiskLike(128, 2.0))  # a new instance of the same net replays its own entry
    assert len(os.listdir(tmp_path / "detector")) == 2
    for got, want in zip(again, b):
        assert np.array_equal(got, want)


@threads(8)
def test_chunked_load_detects_as_the_whole_batch(ring_folder):
    cfg = config.load_config("unified", ["detector.max_keypoints=512", "scene_optimizer.device=cpu",
                                         "scene_optimizer.load_chunk_size=3"])
    so = config.build_scene_optimizer(cfg)
    loader = OlssonLoader(ring_folder)
    kp_xy, kp_mask, descs, gdescs, sizes, kept = so._load_detect_chunked(loader, True)
    images, sizes_all = loader.load_grayscale_batch()
    assert kept is None
    whole = so._load_detect_chunked(loader, False, detect=False, keep_images=True)
    assert whole[:4] == (None, None, None, None) and whole[4] == sizes_all and np.array_equal(whole[5], images)
    want = so._detect_batch(torch.as_tensor(images), sizes_all)
    assert sizes == sizes_all
    for got, exp in zip((kp_xy, kp_mask, descs), want):
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
    assert np.array_equal(gdescs, TinyImageDescriptor().describe_batch(torch.as_tensor(images)))
    assert kp_mask.sum() > VIEWS * 100


@threads(8)
def test_runner_replays_from_the_cache(tmp_path, ring_folder, monkeypatch):
    calls = []
    plain = fused_matcher.match_descriptors
    monkeypatch.setattr(fused_matcher, "match_descriptors", lambda *a, **k: calls.append(1) or plain(*a, **k))
    args = ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", ring_folder, "--use_cache",
            "--cache_root", str(tmp_path / "cache"), "detector.max_keypoints=512", "scene_optimizer.device=cpu",
            "--output_root"]
    assert runner.main(args + [str(tmp_path / "a")]) == 0
    cold = len(calls)
    assert runner.main(args + [str(tmp_path / "b")]) == 0
    assert cold >= 1 and len(calls) == cold  # the replay never matched
    assert sorted(os.listdir(tmp_path / "cache")) == ["cluster", "detector", "global_descriptor", "two_view"]
    for name in ("images.txt", "points3D.txt", "cameras.txt"):
        a = (tmp_path / "a" / "results" / "ba_output" / name).read_text()
        assert a == (tmp_path / "b" / "results" / "ba_output" / name).read_text(), name
    back = colmap.read_scene(str(tmp_path / "b" / "results" / "ba_output"))
    assert back.number_images() == VIEWS and back.number_tracks() > 0
