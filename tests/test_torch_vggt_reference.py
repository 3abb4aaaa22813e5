"""The port's VGGT (frontend/vggt.py, vggt_track.py) against the plain
float32 reference of the benchmark (perfbench/reference/vggt.py), on the
CPU, on seeded public-layout weights (perfbench/vggt_weights.py) at the
slot's reduced sizes (``REDUCED_VGGT``, ``REDUCED_TRACK`` with the 4
iterations the port reads off a checkpoint).

Three frames of 56 x 75, padded by the slot to 64 x 80, which the stride-14
patch embed crops to 4 x 5 patches: global attention crosses the frames.
The depth head's last convolution is scaled by 1e5 so that log-depth
spreads by about 0.2 (at the init scale it spreads by 2e-6 and depth
rounds to 1). The numbers are the benchmark check's
(perfbench/pipelines/feedforward.py ``compare``), each within float32
rounding of two summation orders: the pose encoding to 1e-5 (an
aggregator of 2 layer pairs, the camera trunk; 2.0e-6 read), depth and
confidence to 1e-5 relative (5e-7 read), tracks to 2e-2 px (the seeded
track head amplifies rounding about 20 times an iteration over 4
iterations, as tests/test_torch_vggt.py found; 0 read: at the init scale
the tracks move from the queries by far less than a pixel), visibility
times confidence to 1e-4 (3e-8 read). Global attention limited to one
frame, or RoPE left out, fails them (the pose encoding 2.3e-3 and more
off, depth 5e-5).

Also: the slot on the ``vggt1b`` config records the feed-forward spans
with their units under a CPU profiler, and one run with tracking counts
two aggregator passes.
"""

import numpy as np
import pytest
import torch

from gtsfm_tpu_torch.frontend import vggt
from gtsfm_tpu_torch.scene import cluster_feedforward as cf
from gtsfm_tpu_torch.utils import numerics, tracing
from perfbench import vggt_weights
from perfbench.pipelines.feedforward import compare
from perfbench.reference import vggt as reference
from tests.torch_threads import cap_threads

cap_threads()

MODEL = {**cf.REDUCED_VGGT, "track": {**cf.REDUCED_TRACK, "iters": 4}, "layer_scale": 0.01, "init_std": 0.02,
         "conf_bias": 1.0}
TOL = {"pose_gap": 1e-5, "depth_gap": 1e-5, "conf_gap": 1e-5, "track_gap_px": 2e-2, "vis_gap": 1e-4}
DEPTH_SCALE = 1e5


@pytest.fixture(scope="module")
def models():
    sd = vggt_weights.draw(MODEL, 2**31 + 11, "cpu")
    sd["depth_head.scratch.output_conv2.2.weight"] *= DEPTH_SCALE
    port = vggt.VGGTModel(vggt.VGGTOptions(**cf.REDUCED_VGGT), state_dict={k: v.numpy() for k, v in sd.items()},
                          device="cpu")
    net = reference.VGGT(reference.dims_from(MODEL))
    net.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(3)
    gray = cf.pad_to_patch_grid(rng.uniform(size=(3, 56, 75)).astype(np.float32), 16)
    images = np.repeat(gray[..., None], 3, axis=-1)
    queries = np.stack([rng.uniform(0, 70, 10), rng.uniform(0, 56, 10)], -1).astype(np.float32)
    return port, net.eval().requires_grad_(False), images, queries


def _port(port, images, queries) -> dict:
    out = {**port.run(images), **port.track(images, queries)}
    return {k: v.numpy() for k, v in out.items()}


def test_port_matches_the_plain_reference(models):
    port, net, images, queries = models
    assert images.shape == (3, 64, 80, 3)
    ref = reference.run(net, images, queries)
    assert ref["depth"].shape == (3, 56, 70) and np.log(ref["depth"]).std() > 0.05
    nums = compare(_port(port, images, queries), ref, images.shape[1:3])
    assert all(nums[k] <= TOL[k] for k in TOL), nums


def _one_frame_global(port, monkeypatch):
    S, C = 3, port.options.embed_dim
    for blk in port.net.aggregator.global_blocks:
        inner = blk.forward
        monkeypatch.setattr(blk, "forward", lambda x, pos, freq, inner=inner: inner(
            x.reshape(S, -1, C), pos[: x.shape[1] // S], freq).reshape(1, -1, C))


def _rope_off(port, monkeypatch):
    monkeypatch.setattr(vggt, "apply_rope2d", lambda tokens, positions, base: tokens)


@pytest.mark.parametrize("fault", [_one_frame_global, _rope_off], ids=["global_attention_in_one_frame", "rope_off"])
def test_a_planted_fault_fails_the_comparison(models, fault, monkeypatch):
    port, net, images, queries = models
    ref = reference.run(net, images, queries)
    fault(port, monkeypatch)
    nums = compare(_port(port, images, queries), ref, images.shape[1:3])
    assert any(nums[k] > TOL[k] for k in TOL), nums


@pytest.fixture
def restore_cache():
    saved = dict(cf._MODEL_CACHE)
    yield
    cf._MODEL_CACHE.clear()
    cf._MODEL_CACHE.update(saved)


def test_slot_records_spans_and_counts_two_aggregator_passes(tmp_path, restore_cache):
    from gtsfm_tpu_torch.configs.config import build_scene_optimizer, load_config
    from gtsfm_tpu_torch.loader.olsson import OlssonLoader
    from perfbench import run, scene

    traffic = {**run.load_json(run.HERE, "traffic", "cluster16.json"), "views": 3, "width": 96, "height": 72,
               "focal_px": 84.0, "supersample": 1}
    scene.write_olsson(str(tmp_path), scene.render(traffic, 5, "cpu"))
    cfg = load_config("vggt1b", ["scene_optimizer.device=cpu"])  # no weights path: the seeded reduced VGGT
    so = build_scene_optimizer(cfg)
    loader = OlssonLoader(str(tmp_path), max_resolution=56)
    tracing.reset()
    passes, chunks = vggt.VGGT_AGGREGATOR_PASSES, numerics.ATTENTION_CHUNKS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        data, _ = so.run(loader)
    records = tracing.spans()
    tracing.reset()
    assert vggt.VGGT_AGGREGATOR_PASSES - passes == 2 and numerics.ATTENTION_CHUNKS > chunks
    by_name = {}
    for r in records:
        by_name.setdefault(r["name"], []).append(r)
    ids = {r["id"]: r for r in records}
    S, depth = 3, cf.REDUCED_VGGT["depth"]
    (root,) = by_name["feedforward"]
    assert root["parent"] is None and root["units"] == S
    assert [r["units"] for r in by_name["feedforward.vggt"]] == [S]
    for name, count in (("vggt.aggregator", 2), ("vggt.dino", 2), ("vggt.frame", 2 * depth),
                        ("vggt.global", 2 * depth), ("vggt.camera_head", 1), ("vggt.depth_head", 1)):
        assert [r["units"] for r in by_name[name]] == [S] * count, name
    L = 1 + 4 + (64 // 14) * (80 // 14)  # camera and register tokens, 4 x 5 patches
    attn = by_name["vggt.attention"]
    assert len(attn) == 4 * depth and {r["units"] for r in attn} == {S * L}
    assert {ids[r["parent"]]["name"] for r in attn} == {"vggt.frame", "vggt.global"}
    (head,) = by_name["vggt.track_head"]
    (conv,) = by_name["feedforward.tracks"]
    assert 0 < head["units"] == conv["units"] <= 3 * 4  # frame 0's confident patches, of 3 x 4 of 16 px
    (ba,) = by_name["feedforward.ba"]
    assert ba["units"] > 4
    assert all(r["root"] == root["id"] for r in records if r["name"].startswith(("vggt", "feedforward")))
    assert data.number_tracks() > 0
