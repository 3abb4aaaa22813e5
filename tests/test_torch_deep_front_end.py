"""The deep front end through the port's registry and runner, against the
JAX package, on the CPU.

- Every config of the port that names a deep component
  (``deep_front_end``, ``onedsfm_front_end``, ``megaloc_sift_frontend``)
  loads as the reference's does and builds the same components with the
  same options (MegaLoc at the reference's test dims, by override, to keep
  the build small); the registries build ``superpoint``, ``d2net``,
  ``disk``, ``netvlad``, ``hloc_netvlad`` and ``megaloc``, and none of the
  six is left among the unported names.
- Both runners' ``main`` with ``deep_front_end`` on the first DEEP_VIEWS of
  the views of tests/test_torch_runner.py's end-to-end test (neighbouring
  ring views of chip_smoke.runner_scene at 480x640; 6 of its 8 to keep the
  file near a minute serial), with the config's K=2048,
  ``matcher.num_layers=2``, ``scene_optimizer.pair_batch_size=8`` and the
  same weights: SuperPoint ``chip_smoke.superpoint_fixture(0)`` and
  LightGlue ``chip_smoke.glue_fixture(0, num_layers=2)`` by
  ``weights_path``, NetVLAD the port's seeded init given to the reference
  by ``scripts/deep_front_end_reference.netvlad_params``. Retrieval is
  deterministic: the same pairs (tests/test_torch_superpoint.py holds the
  keypoints). LightGlue runs in bf16 in both, RANSAC and the back end draw from
  different random streams: the same valid-pair count, registered >= the
  reference's - 1 and AUC@5 >= its - 0.02 (PERF.md's bars). The seeded
  SuperPoint is built to match (chip_smoke.superpoint_fixture), a fixture,
  not a photo result; at K=256 its pairs sit at the inlier threshold and
  neither package registers a camera, so the test keeps the config's K.
- chip_smoke.py's checks of the deep phases: ``tf32_allowed`` turns TF32
  on in every ``precise()`` of the port and puts ``precise`` back after;
  ``_hold_to_reference`` passes the JAX package's own runs at seeds 0-2
  against its medians (scripts/deep_front_end_reference.json), and fails
  when a pair is swapped out, one pair's or every pair's match count
  moves past its tolerance, or a median falls below its bar.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu import runner as j_runner
from gtsfm_tpu.configs import config as j_config
from gtsfm_tpu_torch import runner
from gtsfm_tpu_torch.configs import config
from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup
from gtsfm_tpu_torch.frontend import registry
from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import NetVLADDescriptor
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses
from tests.test_torch_netvlad import reference_script
from tests.test_torch_runner import _options_equal
from tests.torch_threads import cap_threads, threads

cap_threads()

CONFIGS = ("deep_front_end", "onedsfm_front_end", "megaloc_sift_frontend")
DEEP_VIEWS = 6
SMALL_MEGALOC = ["global_descriptor.embed_dim=32", "global_descriptor.depth=2", "global_descriptor.num_heads=2",
                 "global_descriptor.pretrain_grid=5", "global_descriptor.num_clusters=8",
                 "global_descriptor.cluster_dim=16", "global_descriptor.token_dim=16", "global_descriptor.mlp_dim=32",
                 "global_descriptor.feat_dim=64", "global_descriptor.image_size=70"]


def _inner(component):
    """The component behind a registry adapter (the reference wraps every
    detector; the port wraps the CNN detectors)."""
    return getattr(component, "detector", component)


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build_as_the_reference(name):
    ov = SMALL_MEGALOC if name == "megaloc_sift_frontend" else []
    cfg_t = config.load_config(name, ov + ["scene_optimizer.device=cpu"])
    cfg_j = j_config.load_config(name, ov)
    cfg_t["scene_optimizer"].pop("device")
    assert cfg_t == cfg_j
    so_t = config.build_scene_optimizer(config.load_config(name, ov + ["scene_optimizer.device=cpu"]))
    so_j = j_config.build_scene_optimizer(cfg_j)
    _options_equal(so_t.options, so_j.options, "scene_optimizer")
    assert so_t.options.pair_batch_size == 256
    assert type(so_t.retriever).__name__ == type(so_j.retriever).__name__
    _options_equal(so_t.retriever.options, so_j.retriever.options, "retriever")
    det_t, det_j = _inner(so_t.detector), _inner(so_j.detector)
    assert type(det_t).__name__ == type(det_j).__name__
    assert tuple(det_t.options) == tuple(det_j.options)
    assert type(so_t.matcher).__name__ == type(so_j.matcher).__name__
    if so_j.matcher is not None:
        assert tuple(so_t.matcher.options) == tuple(so_j.matcher.options)
    assert type(so_t.global_descriptor).__name__ == type(so_j.global_descriptor).__name__
    if hasattr(so_j.global_descriptor, "options"):
        assert tuple(so_t.global_descriptor.options) == tuple(so_j.global_descriptor.options)


def test_registry_builds_the_deep_components():
    for name, stride in (("superpoint", 8), ("d2net", 4), ("disk", 16)):
        det = registry.build_detector({"name": name, "max_keypoints": 64})
        assert det.stride == stride and det.max_keypoints == 64
        xy, mask, d = det.detect_batch(torch.rand(1, 70, 90, generator=torch.Generator().manual_seed(0)))
        assert xy.shape == (1, 64, 2) and mask.shape == (1, 64) and d.shape[:2] == (1, 64)
    for name, cfg in (("netvlad", {}), ("hloc_netvlad", {}),
                      ("megaloc", {k.split(".")[1].split("=")[0]: int(k.split("=")[1]) for k in SMALL_MEGALOC})):
        out = registry.build_global_descriptor({"name": name, **cfg}).describe_batch(np.full((2, 48, 64), 0.5,
                                                                                             np.float32))
        assert out.shape[0] == 2 and np.isfinite(out).all()
    # no component of the reference's registry is listed as still to port
    assert not hasattr(registry, "_UNPORTED")


def _scalars(output_root):
    mdir = os.path.join(output_root, "results", "metrics")
    return {g.name: {m.name: (m.scalar if m.dist is None else m.dist) for m in g.metrics}
            for g in (MetricsGroup.from_json(os.path.join(mdir, f)) for f in sorted(os.listdir(mdir)))}


@threads(8)
def test_runners_end_to_end_with_deep_front_end(tmp_path, monkeypatch):
    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[:DEEP_VIEWS]
    views = chip_smoke.ring_views(R, t, torch.device("cpu"), chip_smoke.runner_scene(t.mean(axis=0)),
                                  indices=order, per_tile_cap=256)
    chip_smoke.write_olsson(str(tmp_path / "data"), views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
    sp, lg = str(tmp_path / "superpoint_v1.pth"), str(tmp_path / "superpoint_lightglue.pth")
    torch.save({k: torch.from_numpy(v) for k, v in chip_smoke.superpoint_fixture(0).items()}, sp)
    torch.save({k: torch.from_numpy(v) for k, v in chip_smoke.glue_fixture(0, num_layers=2).items()}, lg)

    from gtsfm_tpu.frontend.global_descriptors import descriptors as j_descriptors

    ref = reference_script()
    monkeypatch.setattr(j_descriptors, "NetVLADDescriptor", j_descriptors.NetVLADDescriptor)  # restored after
    ref.use_port_netvlad(NetVLADDescriptor().net.state_dict())

    args = ["--config_name", "deep_front_end", "--loader", "olsson", "--dataset_dirpath", str(tmp_path / "data"),
            f"detector.weights_path={sp}", f"matcher.weights_path={lg}", "matcher.num_layers=2",
            "scene_optimizer.pair_batch_size=8"]
    assert j_runner.main(args + ["--output_root", str(tmp_path / "jax")]) == 0
    assert runner.main(args + ["scene_optimizer.device=cpu", "--output_root", str(tmp_path / "port")]) == 0
    mj, mt = _scalars(str(tmp_path / "jax")), _scalars(str(tmp_path / "port"))
    fj, ft = mj["frontend_summary"], mt["frontend_summary"]
    assert ft["num_pairs"] == fj["num_pairs"] == DEEP_VIEWS * (DEEP_VIEWS - 1) / 2
    assert (np.asarray(ft["num_keypoints_per_image"]) > 0).all()
    assert ft["num_valid_pairs"] == fj["num_valid_pairs"]
    assert fj["num_valid_pairs"] > DEEP_VIEWS  # the fixture matches
    reg_j, reg_t = len(mj["ba_pose_metrics"]["rotation_error_deg"]), len(mt["ba_pose_metrics"]["rotation_error_deg"])
    assert reg_t >= reg_j - 1 and reg_j >= DEEP_VIEWS - 1, (reg_t, reg_j)
    auc_j, auc_t = mj["ba_pose_metrics"]["pose_auc_@5.0_deg"], mt["ba_pose_metrics"]["pose_auc_@5.0_deg"]
    assert auc_t >= auc_j - 0.02, (auc_t, auc_j)
    assert "total_summary" in mt


def test_tf32_allowed_turns_tf32_on_and_restores_precise():
    from gtsfm_tpu_torch.frontend.detectors import superpoint
    from gtsfm_tpu_torch.utils import numerics

    strict = numerics.precise
    with chip_smoke.tf32_allowed():
        assert superpoint.precise is not strict and numerics.precise is not strict
        with superpoint.precise():
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert superpoint.precise is strict and numerics.precise is strict
    with superpoint.precise():
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def _reference_as_port_runs(config: str) -> list:
    """The JAX package's runs of ``config`` at chip_smoke.DEEP_SEEDS, in the
    shape chip_smoke._runner_once gives the port's."""
    import json

    with open(os.path.join(os.path.dirname(chip_smoke.__file__), chip_smoke.DEEP_REFERENCE)) as f:
        runs = [r for r in json.load(f)["runs"] if r["config"] == config]
    by_seed = {int(o.split("=")[1]): r for r in runs for o in r["overrides"] if o.startswith("scene_optimizer.seed=")}
    return [{"registered": r["registered"], "auc5": r["pose_auc_@5.0_deg"], "valid": r["num_valid_pairs"],
             "pair_list": r["pairs"], "matches_per_pair": list(r["num_matches_per_pair"])}
            for r in (by_seed[s] for s in chip_smoke.DEEP_SEEDS)]


@pytest.mark.parametrize("name", ["deep_front_end", "megaloc_sift_frontend"])
def test_hold_to_reference_passes_the_reference_and_fails_its_faults(name):
    ref = chip_smoke.deep_reference(name)
    runs = _reference_as_port_runs(name)
    held = chip_smoke._hold_to_reference(name, runs, ref)
    assert held["pair_share"] == 1.0 and held["match_share_of_tol"] == 0.0 and held["match_rel_total"] == 0.0

    def fails(edit):
        bad = [dict(r) for r in runs]
        edit(bad[0])
        with pytest.raises(AssertionError):
            chip_smoke._hold_to_reference(name, bad, ref)

    def swap_pairs(r):  # fewer than DEEP_PAIR_SHARE of the pairs in common
        r["pair_list"] = [[a, b + 100] for a, b in r["pair_list"][:5]] + r["pair_list"][5:]

    def one_pair(r):  # one pair just past DEEP_MATCH_ABS + DEEP_MATCH_TOL
        m = list(r["matches_per_pair"])
        m[0] += int(chip_smoke.DEEP_MATCH_ABS + chip_smoke.DEEP_MATCH_TOL * m[0]) + 1
        r["matches_per_pair"] = m

    def every_pair(r):  # each within its own tolerance, the sum not
        r["matches_per_pair"] = [m + max(1, int(0.01 * m)) for m in r["matches_per_pair"]]

    for edit in (swap_pairs, one_pair, every_pair):
        fails(edit)
    for key, drop in (("registered", 2), ("auc5", 0.5), ("valid", 20)):
        low = [dict(r, **{key: r[key] - drop}) for r in runs]
        with pytest.raises(AssertionError):
            chip_smoke._hold_to_reference(name, low, ref)
