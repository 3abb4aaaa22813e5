"""SceneOptimizer: top-level orchestration of a reconstruction.

Port of gtsfm_tpu/scene/scene_optimizer.py, the production path of
``_run_impl``: load -> detect (the detector slot) or generate
correspondences (the synthetic direct branch) -> retrieve pairs ->
chunked batched two-view estimation -> MultiViewOptimizer, or with
``hierarchical`` the partitioned back end (METIS partition, per-cluster
MVO, Sim3 merges with parent BAs) -> GT pose evaluation (the
``verifier_summary`` and ``ba_pose_metrics`` groups of the reference).

With ``run_gs`` the Gaussian-splat trainer follows GT alignment and
appends the ``gaussian_splatting_metrics`` group (the reference's splat back
end, ``--run_gs``).

The reconstruction runs on ``SceneOptimizerOptions.device``, the CUDA card
by default (``device="cpu"`` for a CPU run); the loader's calibrations and
GT poses are moved there. Without a retriever the ``SequentialRetriever``
picks the pairs. A correspondence generator with ``requires_gt`` (the
synthetic generator) replaces the detector: its matches go into the
two-view batch as precomputed matches, so the mutual-NN matcher does not
run. Otherwise the detector is required (DoG-SIFT is not ported). The
matcher slot takes a learned matcher (LightGlue,
``frontend/registry.build_matcher``); ``None`` keeps the fused mutual-NN
matcher inside the two-view batch. Not ported: image-correspondence
generators (the keypoint aggregator), the feed-forward branch, bridge
reconnection, caches, telemetry, MVS, the splat video and feed-forward
``gs_init``, and export.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SceneMeta
from gtsfm_tpu_torch.evaluation.metrics import Metric, MetricsGroup, pose_auc, relative_pose_errors
from gtsfm_tpu_torch.frontend.reports import aggregate_frontend_metrics, make_reports
from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions, TwoViewResult, run_two_view_batch
from gtsfm_tpu_torch.loader.base import LoaderBase, batch_calibrations
from gtsfm_tpu_torch.retriever.retrievers import SequentialRetriever
from gtsfm_tpu_torch.scene.hierarchical import HierarchicalOptions, HierarchicalReconstruction
from gtsfm_tpu_torch.scene.mvo import MultiViewOptimizer, MVOOptions
from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions
from gtsfm_tpu_torch.utils.geometry_comparisons import compare_global_poses
from gtsfm_tpu_torch.utils.numerics import resolve_device


class SceneOptimizerOptions(NamedTuple):
    two_view: TwoViewOptions = TwoViewOptions()
    mvo: MVOOptions = MVOOptions()
    pair_batch_size: int = 256  # pairs per two-view call
    image_batch_size: int = 4  # images per detector call
    seed: int = 0
    # hierarchical mode: partition + per-cluster MVO + Sim3 merge
    hierarchical: bool = False
    max_cluster_size: int = 40
    # the splat back end (the reference's --run_gs)
    run_gs: bool = False
    gs_iterations: int = 800
    device: str = "cuda"


class SceneOptimizer:
    def __init__(self, options: SceneOptimizerOptions = SceneOptimizerOptions(), retriever=None,
                 detector=None, matcher=None, correspondence=None):
        """retriever: ``get_image_pairs(num_images, global_descriptors=None,
        loader=None) -> (E, 2)``, ``SequentialRetriever()`` when None;
        detector: ``detect_batch(images) -> (kp_xy (B, K, 2), kp_mask
        (B, K), descs (B, K, D))`` numpy, with ``max_keypoints``; matcher:
        None (the fused mutual-NN matcher of the two-view batch) or
        ``match_batch(desc1, desc2, kp_xy1, kp_xy2, kp_mask1, kp_mask2,
        image_size) -> (match_idx, match_mask, match_score)`` on device
        tensors; correspondence: a generator with ``requires_gt`` and
        ``generate(gt_poses, cal, pairs, image_sizes)`` (the synthetic
        generator), in place of the detector and matcher. Raises when
        ``options.device`` is the default ``"cuda"`` and there is no CUDA
        device."""
        if correspondence is not None and not getattr(correspondence, "requires_gt", False):
            raise NotImplementedError("image-correspondence generators (the keypoint aggregator) are not ported")
        if detector is None and correspondence is None:
            raise ValueError("the port needs a detector or a correspondence generator (DoG-SIFT is not ported)")
        self.options = options
        self.device = resolve_device(options.device)
        self.retriever = retriever or SequentialRetriever()
        self.detector = detector
        self.matcher = matcher
        self.correspondence = correspondence
        self.backend_metrics: dict = {}  # the back end's metrics dict of the last run
        self.node_results: list = []  # [(cluster path, SfmData)] of the last hierarchical run

    def run(self, loader: LoaderBase) -> tuple:
        """-> (SfmData, list of MetricsGroup)."""
        opts = self.options
        t_start = time.perf_counter()
        n = len(loader)
        groups = []

        t0 = time.perf_counter()
        cal = batch_calibrations(loader.get_all_intrinsics()).map(lambda a: a.to(self.device))
        images, sizes = loader.load_grayscale_batch()
        if self.correspondence is None:
            kp_xy, kp_mask, descs = self._detect_batch(images, sizes)
        detect_sec = time.perf_counter() - t0

        t0 = time.perf_counter()
        pairs = np.asarray(self.retriever.get_image_pairs(n, global_descriptors=None, loader=loader),
                           np.int64).reshape(-1, 2)
        retriever_sec = time.perf_counter() - t0

        t0 = time.perf_counter()
        gt = loader.get_gt_poses()
        if gt is not None:
            gt = gt.map(lambda a: a.to(self.device))
        pair_matches = None
        if self.correspondence is not None:
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
        host = {k: getattr(tvr, k).cpu().numpy() for k in TwoViewResult.__dataclass_fields__}
        frontend_sec = time.perf_counter() - t0
        groups.append(MetricsGroup("frontend_summary", [
            Metric("num_input_images", n),
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
        """GT pose evaluation (scene moved into the GT frame; ``gt`` on the
        device or None), the splat trainer on the grayscale images when
        ``run_gs`` is set, run time."""
        opts = self.options
        if gt is not None and not mvo_metrics.get("failed"):
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
        if opts.run_gs and not mvo_metrics.get("failed") and data.number_tracks() > 0:
            t0 = time.perf_counter()
            trainer = GaussianSplatting(GSTrainOptions(iterations=opts.gs_iterations), device=self.device)
            _splats, gs_metrics = trainer.train(data, images)
            gs_metrics["gs_sec"] = time.perf_counter() - t0
            groups.append(MetricsGroup("gaussian_splatting_metrics",
                                       [Metric(k, v) for k, v in gs_metrics.items()]))
        groups.append(MetricsGroup("total_summary",
                                   [Metric("total_runtime_sec", time.perf_counter() - t_start)]))
        return data, groups

    def _detect_batch(self, images: np.ndarray, sizes):
        """Chunked detection through the detector slot, with the reference's
        4-pixel border-validity mask."""
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
        dev = cal.f.device
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
