"""SceneOptimizer: top-level orchestration of a reconstruction.

Port of gtsfm_tpu/scene/scene_optimizer.py, ``_run_impl`` and
``_finalize``: load -> detect (the default DoG-SIFT, or the detector slot:
SuperPoint, D2-Net, DISK) and describe globally (the tiny descriptor, or
the global-descriptor slot: NetVLAD, hloc NetVLAD, MegaLoc, when the
retriever ranks by similarity), or generate correspondences (the synthetic direct branch) ->
retrieve pairs -> chunked batched two-view estimation -> bridge
reconnection -> MultiViewOptimizer, or with ``hierarchical`` the
partitioned back end (METIS partition, per-cluster MVO, Sim3 merges with
parent BAs) -> without GT an axis alignment, with GT the evaluation (the
``verifier_summary``, ``ba_pose_metrics``, ``track_classification_metrics``
and ``intrinsics_metrics`` groups) -> with ``run_gs`` the Gaussian-splat
trainer (``gaussian_splatting_metrics``) -> under ``output_root``, the
reconstruction as COLMAP text in ``results/ba_output/`` and each metrics
group as ``results/metrics/<group>.json``.

The reconstruction runs on ``SceneOptimizerOptions.device``, the CUDA card
by default (``device="cpu"`` for a CPU run): the loader's images,
calibrations and GT poses are moved there, and the detector and the global
descriptor run on the image batch there. Without a retriever the
``SequentialRetriever`` picks the pairs. A correspondence generator with
``requires_gt`` (the synthetic generator) replaces the detector: its
matches go into the two-view batch as precomputed matches, so the
mutual-NN matcher does not run. The matcher slot takes a learned matcher
(LightGlue, ``frontend/registry.build_matcher``); ``None`` keeps the fused
mutual-NN matcher inside the two-view batch.

Not ported: image-correspondence generators (the keypoint aggregator), the
feed-forward branch, chunked loading, caches, telemetry, the retrieval
metrics group, MVS, the splat video and feed-forward ``gs_init``, and of
the export the HTML report, the process graph, the viewer, the plots, the
PLY files and the per-cluster ``SceneTree`` (ROADMAP queue 1 items 3, 5, 9
and 10).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SceneMeta
from gtsfm_tpu_torch.evaluation.metrics import (
    Metric,
    MetricsGroup,
    intrinsics_error_metrics,
    pose_auc,
    relative_pose_errors,
)
from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSift, DoGSiftOptions
from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import TinyImageDescriptor
from gtsfm_tpu_torch.frontend.reports import aggregate_frontend_metrics, make_reports
from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions, TwoViewResult, run_two_view_batch
from gtsfm_tpu_torch.io import colmap as colmap_io
from gtsfm_tpu_torch.loader.base import LoaderBase, batch_calibrations
from gtsfm_tpu_torch.retriever.bridge import find_bridge_pairs
from gtsfm_tpu_torch.retriever.retrievers import (
    JointSimilaritySequentialRetriever,
    SequentialRetriever,
    SimilarityRetriever,
)
from gtsfm_tpu_torch.scene.hierarchical import HierarchicalOptions, HierarchicalReconstruction
from gtsfm_tpu_torch.scene.mvo import MultiViewOptimizer, MVOOptions
from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions
from gtsfm_tpu_torch.utils.ellipsoid import align_scene_to_axes
from gtsfm_tpu_torch.utils.geometry_comparisons import compare_global_poses
from gtsfm_tpu_torch.utils.numerics import resolve_device
from gtsfm_tpu_torch.utils.tracks import tracks_from_sfm_data


class SceneOptimizerOptions(NamedTuple):
    detector: DoGSiftOptions = DoGSiftOptions(max_keypoints=1024)  # the default detector's options
    two_view: TwoViewOptions = TwoViewOptions()
    mvo: MVOOptions = MVOOptions()
    pair_batch_size: int = 256  # pairs per two-view call
    image_batch_size: int = 4  # images per detector call
    seed: int = 0
    output_root: Optional[str] = None  # write results/ba_output and results/metrics there
    save_colmap: bool = True
    # reconnect a view graph that split into islands through its most
    # similar cross-component pairs
    reconnect_bridges: bool = True
    # hierarchical mode: partition + per-cluster MVO + Sim3 merge
    hierarchical: bool = False
    max_cluster_size: int = 40
    # the splat back end (the reference's --run_gs)
    run_gs: bool = False
    gs_iterations: int = 800
    # without GT, rotate the scene so that the point cloud's principal axes
    # lie along the world axes
    axis_align_when_no_gt: bool = True
    device: str = "cuda"


class SceneOptimizer:
    def __init__(self, options: SceneOptimizerOptions = SceneOptimizerOptions(), retriever=None,
                 detector=None, matcher=None, global_descriptor=None, correspondence=None):
        """retriever: ``get_image_pairs(num_images, global_descriptors=None,
        loader=None) -> (E, 2)``, ``SequentialRetriever()`` when None;
        detector: ``detect_batch(images) -> (kp_xy (B, K, 2), kp_mask
        (B, K), descs (B, K, D))`` numpy, with ``max_keypoints``, given the
        images as a tensor on the run's device; DoG-SIFT with
        ``options.detector`` when None (none in the direct branch);
        matcher: None (the fused mutual-NN matcher of the two-view batch)
        or ``match_batch(desc1, desc2, kp_xy1, kp_xy2, kp_mask1, kp_mask2,
        image_size) -> (match_idx, match_mask, match_score)`` on device
        tensors; global_descriptor:
        ``describe_batch(images) -> (N, D)`` numpy, the tiny descriptor when
        None and the retriever needs one; correspondence: a generator with
        ``requires_gt`` and ``generate(gt_poses, cal, pairs, image_sizes)``
        (the synthetic generator), in place of the detector and matcher.
        Raises when ``options.device`` is the default ``"cuda"`` and there
        is no CUDA device."""
        if correspondence is not None and not getattr(correspondence, "requires_gt", False):
            raise NotImplementedError("image-correspondence generators (the keypoint aggregator) are not ported "
                                      "(ROADMAP queue 1 item 10)")
        self.options = options
        self.device = resolve_device(options.device)
        self.retriever = retriever or SequentialRetriever()
        if detector is None and correspondence is None:
            detector = DoGSift(options.detector)
        self.detector = detector
        self.matcher = matcher
        self.global_descriptor = global_descriptor
        self.correspondence = correspondence
        self.backend_metrics: dict = {}  # the back end's metrics dict of the last run
        self.node_results: list = []  # [(cluster path, SfmData)] of the last hierarchical run

    def run(self, loader: LoaderBase) -> tuple:
        """-> (SfmData, list of MetricsGroup)."""
        opts = self.options
        t_start = time.perf_counter()
        n = len(loader)
        groups = []
        direct = self.correspondence is not None

        t0 = time.perf_counter()
        cal = batch_calibrations(loader.get_all_intrinsics()).map(lambda a: a.to(self.device))
        images, sizes = loader.load_grayscale_batch()
        images_dev = torch.as_tensor(images, device=self.device)
        if not direct:
            kp_xy, kp_mask, descs = self._detect_batch(images_dev, sizes)
        global_descs = None
        if isinstance(self.retriever, (SimilarityRetriever, JointSimilaritySequentialRetriever)):
            if self.global_descriptor is None:
                self.global_descriptor = TinyImageDescriptor()
            global_descs = self.global_descriptor.describe_batch(images_dev)
        detect_sec = time.perf_counter() - t0

        t0 = time.perf_counter()
        pairs = np.asarray(self.retriever.get_image_pairs(n, global_descriptors=global_descs, loader=loader),
                           np.int64).reshape(-1, 2)
        retriever_sec = time.perf_counter() - t0

        t0 = time.perf_counter()
        gt = loader.get_gt_poses()
        if gt is not None:
            gt = gt.map(lambda a: a.to(self.device))
        pair_matches = None
        if direct:
            # synthetic correspondences from GT geometry through the
            # production two-view and back-end path
            if gt is None:
                raise ValueError("the synthetic correspondence generator needs the loader's GT poses")
            syn = self.correspondence.generate(gt, cal, pairs, [(w, h) for (h, w) in sizes])
            kp_xy, kp_mask = syn["keypoints_xy"], syn["kp_mask"]
            pair_matches = (syn["corr_i1"], syn["corr_i2"], syn["corr_mask"])
            descs = np.zeros((n, kp_xy.shape[1], 4), np.float32)
        image_wh = (max(w for (_h, w) in sizes), max(h for (h, _w) in sizes))
        tvr = self._run_two_view(pairs, kp_xy, kp_mask, descs, cal, image_wh, pair_matches)

        # bridge reconnection: if the valid graph split into islands, add the
        # most similar cross-component pairs (by the retriever's similarity
        # matrix) and estimate them too (not in the direct branch: new pairs
        # would need new correspondences)
        sim = None if direct else getattr(self.retriever, "latest_similarity_matrix", None)
        if opts.reconnect_bridges and sim is not None:
            bridges = find_bridge_pairs(n, pairs[tvr.valid.cpu().numpy()], sim)
            existing = {tuple(p) for p in pairs.tolist()}
            bridges = np.asarray([b for b in bridges.tolist() if tuple(b) not in existing], np.int64).reshape(-1, 2)
            if len(bridges):
                tvr_b = self._run_two_view(bridges, kp_xy, kp_mask, descs, cal, image_wh)
                pairs = np.concatenate([pairs, bridges])
                tvr = TwoViewResult(**{k: torch.cat([getattr(tvr, k), getattr(tvr_b, k)])
                                       for k in TwoViewResult.__dataclass_fields__})
        host = {k: getattr(tvr, k).cpu().numpy() for k in TwoViewResult.__dataclass_fields__}
        frontend_sec = time.perf_counter() - t0
        groups.append(MetricsGroup("frontend_summary", [
            Metric("num_input_images", n),
            Metric("num_keypoints_per_image", np.asarray(kp_mask).sum(axis=1)),
            Metric("num_pairs", len(pairs)),
            Metric("num_valid_pairs", int(host["valid"].sum())),
            Metric("num_matches_per_pair", host["num_matches"]),
            Metric("num_inliers_per_pair", host["num_inliers"]),
            Metric("inlier_ratio_per_pair", host["inlier_ratio"]),
            Metric("detect_describe_sec", detect_sec),
            Metric("retriever_duration_sec", retriever_sec),
            Metric("two_view_sec", frontend_sec),
        ]))
        if gt is not None:
            groups.append(aggregate_frontend_metrics(make_reports(pairs, host, gt)))

        meta = SceneMeta(image_names=loader.image_filenames(), image_sizes=[(w, h) for (h, w) in sizes])
        t_mvo = time.perf_counter()
        self.node_results = []
        if opts.hierarchical:
            hier = HierarchicalReconstruction(
                HierarchicalOptions(mvo=opts.mvo, max_cluster_size=opts.max_cluster_size))
            tvr_h = dict(host, i2Ri1=tvr.i2Ri1, i2Ui1=tvr.i2Ui1)
            data, mvo_metrics = hier.run(n, pairs, tvr_h, kp_xy, cal, meta=meta)
            self.node_results = hier.node_results
        else:
            data, mvo_metrics = MultiViewOptimizer(opts.mvo).run(
                num_images=n, pairs=pairs, i2Ri1=tvr.i2Ri1, i2Ui1=tvr.i2Ui1,
                pair_valid=host["valid"], num_inliers=host["num_inliers"],
                corr_i1=host["corr_i1"], corr_i2=host["corr_i2"], corr_mask=host["corr_mask"],
                keypoints_xy=kp_xy, cal=cal, meta=meta,
            )
        mvo_metrics["backend_sec"] = time.perf_counter() - t_mvo
        self.backend_metrics = mvo_metrics
        groups.append(MetricsGroup("multiview_optimizer_metrics", [
            Metric(k, v) for k, v in mvo_metrics.items() if isinstance(v, (int, float))
        ]))
        return self._finalize(loader, data, mvo_metrics, groups, t_start, images, gt)

    def _finalize(self, loader, data, mvo_metrics, groups, t_start, images, gt):
        """Evaluation (with ``gt`` on the device: the scene moved into the GT
        frame; without: the axis alignment), the splat trainer on the
        grayscale images when ``run_gs`` is set, run time, and the results
        under ``output_root``."""
        opts = self.options
        failed = bool(mvo_metrics.get("failed"))
        if gt is None and opts.axis_align_when_no_gt and not failed:
            data = align_scene_to_axes(data)
        if gt is not None and not failed:
            est_mask = data.pose_mask.cpu().numpy()
            rot_err, t_err, sim = relative_pose_errors(data.poses, gt, est_mask)
            data = data.transform(sim)
            auc = pose_auc(rot_err[est_mask])
            est_idx = torch.as_tensor(np.flatnonzero(est_mask), device=data.points.device)
            crit = compare_global_poses(
                data.poses.map(lambda a: a[est_idx]), gt.map(lambda a: a[est_idx])
            ) if len(est_idx) >= 3 else False
            groups.append(MetricsGroup(
                "ba_pose_metrics",
                [
                    Metric("rotation_error_deg", rot_err[est_mask]),
                    Metric("translation_error", t_err[est_mask]),
                    Metric("poses_match_gt_criterion", float(crit)),
                ] + [Metric(k, v) for k, v in auc.items()],
            ))
            if data.number_tracks() > 0:
                correct, _errs = tracks_from_sfm_data(data, gt)
                groups.append(MetricsGroup("track_classification_metrics", [
                    Metric("num_tracks_classified", int(correct.size)),
                    Metric("fraction_tracks_gt_consistent", float(correct.mean()) if correct.size else 0.0),
                ]))
            cal0 = batch_calibrations(loader.get_all_intrinsics()).map(lambda a: a.to(self.device))
            groups.append(intrinsics_error_metrics(data.cal, cal0, valid_mask=est_mask))
        if opts.run_gs and not failed and data.number_tracks() > 0:
            t0 = time.perf_counter()
            trainer = GaussianSplatting(GSTrainOptions(iterations=opts.gs_iterations), device=self.device)
            _splats, gs_metrics = trainer.train(data, images)
            gs_metrics["gs_sec"] = time.perf_counter() - t0
            groups.append(MetricsGroup("gaussian_splatting_metrics",
                                       [Metric(k, v) for k, v in gs_metrics.items()]))
        groups.append(MetricsGroup("total_summary",
                                   [Metric("total_runtime_sec", time.perf_counter() - t_start)]))
        if opts.output_root:
            results_dir = os.path.join(opts.output_root, "results")
            os.makedirs(results_dir, exist_ok=True)
            if opts.save_colmap and data.number_tracks() > 0:
                colmap_io.write_scene(data, os.path.join(results_dir, "ba_output"))
            for g in groups:
                g.save_json(os.path.join(results_dir, "metrics"))
        return data, groups

    def _detect_batch(self, images: torch.Tensor, sizes):
        """Chunked detection of the (n, H, W) batch on the run's device
        through the detector, with the reference's 4-pixel border-validity
        mask."""
        B = self.options.image_batch_size
        n = images.shape[0]
        K = self.detector.max_keypoints
        kp_xy = np.zeros((n, K, 2), np.float32)
        kp_mask = np.zeros((n, K), bool)
        descs = None
        for s in range(0, n, B):
            coords, mask, d = (np.asarray(a) for a in self.detector.detect_batch(images[s : s + B]))
            if descs is None:
                descs = np.zeros((n, K, d.shape[-1]), np.float32)
            for b in range(coords.shape[0]):
                h, w = sizes[s + b]
                inb = (
                    (coords[b, :, 0] < w - 4) & (coords[b, :, 1] < h - 4)
                    & (coords[b, :, 0] >= 4) & (coords[b, :, 1] >= 4)
                )
                kp_xy[s + b] = coords[b]
                kp_mask[s + b] = mask[b] & inb
                descs[s + b] = d[b]
        return kp_xy, kp_mask, descs

    def _run_two_view(self, pairs, kp_xy, kp_mask, descs, cal, image_wh, pair_matches=None) -> TwoViewResult:
        """Two-view estimation over chunks of ``pair_batch_size`` pairs with
        the scene's keypoints and descriptors resident on the device. With
        ``pair_matches`` (the direct branch's (E, K) corr_i1 / corr_i2 /
        corr_mask) each chunk verifies those matches; else a matcher, if
        any, matches each chunk first (``image_wh``: the scene's largest
        width and height, for its keypoint normalization). The last chunk
        is not padded: each pair's random stream is keyed by its global
        index, so chunking does not change the result."""
        opts = self.options
        dev = cal.u0.device  # a field of every calibration model
        kp_dev = torch.as_tensor(kp_xy, dtype=torch.float32, device=dev)
        kpm_dev = torch.as_tensor(kp_mask, dtype=torch.bool, device=dev)
        d_dev = torch.as_tensor(descs, dtype=torch.float32, device=dev)
        pairs_dev = torch.as_tensor(pairs, dtype=torch.int64, device=dev)
        if pair_matches is not None:
            midx, mmask = self._match_table(pair_matches, kp_xy.shape[1])
            midx_dev = torch.as_tensor(midx, device=dev)
            mmask_dev = torch.as_tensor(mmask, device=dev)
        chunks = []
        for s in range(0, len(pairs), opts.pair_batch_size):
            i1 = pairs_dev[s : s + opts.pair_batch_size, 0]
            i2 = pairs_dev[s : s + opts.pair_batch_size, 1]
            batch = xy1, xy2, d1, d2, m1, m2 = (
                kp_dev[i1], kp_dev[i2], d_dev[i1], d_dev[i2], kpm_dev[i1], kpm_dev[i2])
            matches = {}
            if pair_matches is not None:
                mm_ = mmask_dev[s : s + len(i1)]
                matches = dict(match_idx=midx_dev[s : s + len(i1)], match_mask=mm_, match_score=mm_.to(torch.float32))
            elif self.matcher is not None:
                midx_c, mmask_c, mscore = self.matcher.match_batch(d1, d2, xy1, xy2, m1, m2, image_size=image_wh)
                matches = dict(match_idx=midx_c, match_mask=mmask_c, match_score=mscore)
            chunks.append(run_two_view_batch(
                *batch, cal.map(lambda a: a[i1]), cal.map(lambda a: a[i2]),
                torch.ones(len(i1), dtype=torch.bool, device=dev),
                seed=opts.seed, opts=opts.two_view,
                pair_ids=torch.arange(s, s + len(i1), device=dev), **matches,
            ))
        return TwoViewResult(**{
            k: torch.cat([getattr(c, k) for c in chunks]) for k in TwoViewResult.__dataclass_fields__
        })

    @staticmethod
    def _match_table(pair_matches, K: int) -> tuple:
        """(E, K) match_idx / match_mask tables (match_idx[p, k1] = k2) from
        an (E, K) corr_i1 / corr_i2 / corr_mask triple."""
        ci1, ci2, cm = (np.asarray(x) for x in pair_matches)
        midx = np.zeros((cm.shape[0], K), np.int32)
        mmask = np.zeros((cm.shape[0], K), bool)
        r, k = np.nonzero(cm)
        midx[r, ci1[r, k]] = ci2[r, k]
        mmask[r, ci1[r, k]] = True
        return midx, mmask
