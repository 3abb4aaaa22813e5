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
and ``intrinsics_metrics`` groups) -> with ``run_mvs`` the dense back end
(densify/: the plane sweep, or PatchmatchNet with ``mvs_backend``;
``mvs_metrics``) -> with ``run_gs`` the Gaussian-splat trainer
(``gaussian_splatting_metrics``) -> under ``output_root``, the
reconstruction as COLMAP text in ``results/ba_output/``, a hierarchical
run's cluster results as a SceneTree (``results/C_1/C_1_2/...``), each
metrics group as ``results/metrics/<group>.json``, the HTML report
``results/gtsfm_metrics_report.html``, the process graph
``results/process_graph.dot``, the orbit viewer ``results/viewer.html`` and
``results/plots/scene_3d.png``, the dense points as
``results/dense_points.ply``, the splats as ``results/splats.ply`` and
``results/gaussian_points.ply``, and with ``gs_video_frames`` the splats'
fly-through along a B-spline through the registered cameras
(``results/splat_video/frame_%04d.png``, ``results/splat_flythrough.gif``
and, where OpenCV writes it, ``.mp4``; every frame composites through the
CUDA kernel on the card). With a similarity retriever and GT poses the
metrics carry the ``retrieval_metrics`` group.

With ``use_cache`` the detector, the global descriptor, the learned
matcher, the two-view stage and each hierarchical leaf replay from disk
caches under ``cache_root`` (utils/cache.py, the port's own default root)
on a re-run with the same inputs. With ``load_chunk_size`` (and neither
``run_mvs`` nor ``run_gs``, which need the images afterwards) the images
are loaded and detected a chunk at a time, so host memory holds one
chunk.

With ``cluster_optimizer`` vggt, fastvggt or anysplat the feed-forward
slot (scene/cluster_feedforward.py: the compact model or VGGT, by
``feedforward_backbone``) replaces the front end and the back end
(``feedforward_metrics``); the anysplat slot's gaussians start the
trainer, or are exported as they are without ``run_gs``.

The reconstruction runs on ``SceneOptimizerOptions.device``, the CUDA card
by default (``device="cpu"`` for a CPU run): the loader's images,
calibrations and GT poses are moved there, and the detector and the global
descriptor run on the image batch there. Without a retriever the
``SequentialRetriever`` picks the pairs. The matcher slot takes a learned
matcher (LightGlue, SuperGlue: ``frontend/registry.build_matcher``);
``None`` keeps the fused mutual-NN matcher inside the two-view batch.

A correspondence generator replaces the detector and the matcher (the
direct branch). The synthetic one (``requires_gt``) makes matches from GT
geometry; an image-correspondence generator (the COLMAP replay, LoFTR, the
compact dense matcher, MASt3R) matches the retrieved pairs' images, always
loaded whole (``load_chunk_size`` does not apply), and
``KeypointAggregatorDedup`` merges its per-pair keypoints into
``direct_max_keypoints`` global keypoints per image. Either way the
matches go into the two-view batch as precomputed matches (no mutual-NN
matcher, no two-view cache, no bridge reconnection).

With ``telemetry_db`` the per-pair two-view results, the stage timings and
the run's metadata go to a sqlite file (common/telemetry.py). ``run`` is
traced with ``torch.profiler`` when ``GTSFM_TPU_TRACE`` names a directory
(utils/tracing.py): ``<dir>/scene_optimizer_run/trace.json`` holds the
device's activity with the host spans below, ``spans.json`` beside it the
spans alone. Stage times are logged (utils/logger.py) and come from the
spans ``stage.detect_describe``, ``stage.retriever`` and
``stage.two_view``.

The front end marks its host stages with spans (utils/tracing.py), which
record only while a ``torch.profiler`` records in the process:
``load_detect`` (a root per call: the loader's ``load`` with
``load.pool``, where its thread pool runs, and one ``load.read`` /
``load.resize`` / ``load.gray`` a view, the image upload, ``detect``
with one ``detect.net`` per detector batch, and ``global_descriptor``)
and ``two_view`` (a root per call: the upload, one ``two_view.chunk`` per
chunk with the learned matcher's ``match`` and the verifier's ``verify``,
whose stages two_view.py and verifiers/essential.py mark).

In a ``torch.distributed`` world of more than one rank (the runner's
``--distributed_*`` flags) with ``use_mesh``, the ranks form a (data, model)
mesh (parallel/sharding.py) and every rank runs the same program: each
two-view chunk whose length divides by ``data`` is split over the data
ranks (and desc1's rows inside the matcher over the model ranks), its
results gathered in pair order on every rank; a chunk that does not divide
runs whole on every rank, as the reference's does. The back end's BA shards
its measurements over ``data`` (bundle/ba.py); every other stage runs
replicated, so every rank ends with the same reconstruction.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gtsfm_tpu_torch.common.sfm_data import SceneMeta
from gtsfm_tpu_torch.common.telemetry import TelemetryDB
from gtsfm_tpu_torch.densify.mvs import MVSOptions, PlaneSweepMVS
from gtsfm_tpu_torch.densify.patchmatchnet import PatchmatchNetMVS, load_torch_weights as load_pmnet_weights
from gtsfm_tpu_torch.evaluation.metrics import (
    Metric,
    MetricsGroup,
    intrinsics_error_metrics,
    pose_auc,
    relative_pose_errors,
)
from gtsfm_tpu_torch.evaluation.report import generate_html_report
from gtsfm_tpu_torch.evaluation.retrieval_metrics import retrieval_metrics
from gtsfm_tpu_torch.frontend.anysplat import AnySplatModel, AnySplatOptions, gaussian_means_as_tracks
from gtsfm_tpu_torch.frontend.cachers import GlobalDescriptorCacher, MatcherCacher
from gtsfm_tpu_torch.frontend.correspondence import AggregatorOptions, KeypointAggregatorDedup
from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSift, DoGSiftOptions
from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import TinyImageDescriptor
from gtsfm_tpu_torch.frontend.reports import aggregate_frontend_metrics, make_reports
from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions, TwoViewResult, run_two_view_batch
from gtsfm_tpu_torch.frontend.two_view_cacher import TwoViewEstimatorCacher
from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.io import colmap as colmap_io
from gtsfm_tpu_torch.io.ply import write_ply
from gtsfm_tpu_torch.loader.base import LoaderBase, batch_calibrations
from gtsfm_tpu_torch.parallel.sharding import gather, make_mesh, shard_pair_batch
from gtsfm_tpu_torch.products.scene_tree import SceneTree
from gtsfm_tpu_torch.retriever.bridge import find_bridge_pairs
from gtsfm_tpu_torch.retriever.retrievers import (
    JointSimilaritySequentialRetriever,
    SequentialRetriever,
    SimilarityRetriever,
)
from gtsfm_tpu_torch.scene.cluster_feedforward import (
    ClusterFastFeedforward,
    ClusterFeedforward,
    ClusterFeedforwardOptions,
    depth_to_splats,
    pad_to_patch_grid,
)
from gtsfm_tpu_torch.scene.hierarchical import HierarchicalOptions, HierarchicalReconstruction
from gtsfm_tpu_torch.scene.mvo import MultiViewOptimizer, MVOOptions
from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions
from gtsfm_tpu_torch.splat.gs_data import export_ply
from gtsfm_tpu_torch.splat.merge import transform_splats
from gtsfm_tpu_torch.splat.rendering import bspline_camera_path, render_tiled
from gtsfm_tpu_torch.ui.registry import ProcessGraphGenerator
from gtsfm_tpu_torch.utils.cache import DiskCache, content_key
from gtsfm_tpu_torch.utils.ellipsoid import align_scene_to_axes
from gtsfm_tpu_torch.utils.geometry_comparisons import compare_global_poses
from gtsfm_tpu_torch.utils.logger import get_logger
from gtsfm_tpu_torch.utils.numerics import precise, resolve_device
from gtsfm_tpu_torch.utils.tracing import Span, device_trace, span
from gtsfm_tpu_torch.utils.tracks import tracks_from_sfm_data
from gtsfm_tpu_torch.visualization.viewer import export_scene_html
from gtsfm_tpu_torch.visualization.viz import plot_scene_3d

logger = get_logger("scene")


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
    # the dense and splat back ends (the reference's --run_mvs, --run_gs)
    run_mvs: bool = False
    run_gs: bool = False
    gs_iterations: int = 800
    # frames of the splats' fly-through (0: none)
    gs_video_frames: int = 0
    mvs_num_depths: int = 64
    mvs_num_source_views: int = 4
    # "plane_sweep" or "patchmatchnet" (learned: needs mvs_weights_path, a
    # checkpoint in the official model_000007.ckpt layout)
    mvs_backend: str = "plane_sweep"
    mvs_weights_path: Optional[str] = None
    # the reconstruction engine: mvo (the front end and back end) or a
    # feed-forward slot (scene/cluster_feedforward.py)
    cluster_optimizer: str = "mvo"  # mvo | vggt | fastvggt | anysplat
    feedforward_post_ba: bool = True
    # the feed-forward model: "compact" or "vggt_exact" (the public VGGT-1B
    # layout, with the weights of vggt_weights_path)
    feedforward_backbone: str = "compact"
    vggt_weights_path: Optional[str] = None
    # disk caches of the detector, global descriptor, learned matcher,
    # two-view and cluster stages (root: utils/cache.DEFAULT_CACHE_ROOT)
    use_cache: bool = False
    cache_root: Optional[str] = None
    # shard two-view chunks and BA over a (data, model) mesh of the
    # torch.distributed ranks when there are more than one (the reference's
    # mesh over its devices); a world of one builds no mesh
    use_mesh: bool = True
    # images per load-and-detect chunk (0: the whole scene at once)
    load_chunk_size: int = 0
    # the direct branch: global keypoints per image after the aggregation
    direct_max_keypoints: int = 2048
    # a sqlite file for the per-pair results, stage timings and metadata
    telemetry_db: Optional[str] = None
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
        None and the retriever needs one; correspondence, in place of the
        detector and matcher: a generator with ``requires_gt`` and
        ``generate(gt_poses, cal, pairs, image_sizes)`` (the synthetic
        generator), or one with ``generate(images, pairs) -> {(i1, i2):
        (uv1, uv2)}`` (frontend/registry.build_correspondence).
        Raises when ``options.device`` is the default ``"cuda"`` and there
        is no CUDA device, and before any work when ``run_mvs`` asks for the
        patchmatchnet back end without ``mvs_weights_path``."""
        if options.mvs_backend not in ("plane_sweep", "patchmatchnet"):
            raise ValueError(f"unknown mvs_backend {options.mvs_backend!r}")
        if options.run_mvs and options.mvs_backend == "patchmatchnet" and not options.mvs_weights_path:
            raise RuntimeError("the patchmatchnet MVS back end requires weights: set mvs_weights_path to a checkpoint "
                               "in the official model_000007.ckpt layout")
        self.options = options
        self.device = resolve_device(options.device)
        self.retriever = retriever or SequentialRetriever()
        if detector is None and correspondence is None:
            detector = DoGSift(options.detector)
        self.detector = detector
        self.matcher = matcher
        self.global_descriptor = global_descriptor
        self.correspondence = correspondence
        self._telemetry = TelemetryDB(options.telemetry_db) if options.telemetry_db else None
        self._mesh = None
        if options.use_mesh and dist.is_initialized() and dist.get_world_size() > 1:
            self._mesh = make_mesh()
        self.backend_metrics: dict = {}  # the back end's metrics dict of the last run
        self.node_results: list = []  # [(cluster path, SfmData)] of the last hierarchical run
        self._detect_cache = self._two_view_cacher = self._cluster_cache = None
        if options.use_cache:
            self._detect_cache = DiskCache("detector", root=options.cache_root)
            # the seed is in the key: the two-view result depends on it
            self._two_view_cacher = TwoViewEstimatorCacher(
                self._run_two_view_uncached, root=options.cache_root,
                options_repr=repr((options.two_view, type(self.matcher).__name__, options.seed)))
            if self.matcher is not None:
                self.matcher = MatcherCacher(self.matcher, root=options.cache_root)
            self._cluster_cache = DiskCache("cluster", root=options.cache_root)

    def run(self, loader: LoaderBase) -> tuple:
        """-> (SfmData, list of MetricsGroup)."""
        with device_trace("scene_optimizer_run"):
            return self._run_impl(loader)

    def _run_impl(self, loader: LoaderBase) -> tuple:
        opts = self.options
        t_start = time.perf_counter()
        n = len(loader)
        groups = []
        if opts.cluster_optimizer != "mvo":
            return self._run_feedforward(loader, t_start, groups)
        direct = self.correspondence is not None
        synthetic = direct and getattr(self.correspondence, "requires_gt", False)

        with Span("stage.detect_describe", n) as clock:
            cal = batch_calibrations(loader.get_all_intrinsics()).map(lambda a: a.to(self.device))
            want_global = isinstance(self.retriever, (SimilarityRetriever, JointSimilaritySequentialRetriever))
            kp_xy, kp_mask, descs, global_descs, sizes, images = self._load_detect_chunked(
                loader, want_global, detect=not direct,
                keep_images=opts.run_mvs or opts.run_gs or (direct and not synthetic))
        detect_sec = clock.seconds
        logger.info("detect+describe: %d images in %.1fs", n, detect_sec)

        with Span("stage.retriever") as clock:
            pairs = np.asarray(self.retriever.get_image_pairs(n, global_descriptors=global_descs, loader=loader),
                               np.int64).reshape(-1, 2)
        retriever_sec = clock.seconds

        with Span("stage.two_view") as clock:
            gt = loader.get_gt_poses()
            if gt is not None:
                gt = gt.map(lambda a: a.to(self.device))
            pair_matches = None
            if synthetic:
                # synthetic correspondences from GT geometry through the
                # production two-view and back-end path
                if gt is None:
                    raise ValueError("the synthetic correspondence generator needs the loader's GT poses")
                syn = self.correspondence.generate(gt, cal, pairs, [(w, h) for (h, w) in sizes])
                kp_xy, kp_mask = syn["keypoints_xy"], syn["kp_mask"]
                pair_matches = (syn["corr_i1"], syn["corr_i2"], syn["corr_mask"])
                descs = np.zeros((n, kp_xy.shape[1], 4), np.float32)
            elif direct:
                # per-pair correspondences of the pairs' images, merged into
                # global keypoints; the matches are the aggregator's per-pair
                # index triples
                pair_corrs = self.correspondence.generate(
                    [images[i][:h, :w] for i, (h, w) in enumerate(sizes)], pairs)
                agg = KeypointAggregatorDedup(AggregatorOptions(max_keypoints_per_image=opts.direct_max_keypoints))
                kp_xy, kp_mask, pair_matches = agg.aggregate(n, pair_corrs)
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
                bridges = np.asarray([b for b in bridges.tolist() if tuple(b) not in existing],
                                     np.int64).reshape(-1, 2)
                if len(bridges):
                    tvr_b = self._run_two_view(bridges, kp_xy, kp_mask, descs, cal, image_wh)
                    pairs = np.concatenate([pairs, bridges])
                    tvr = TwoViewResult(**{k: torch.cat([getattr(tvr, k), getattr(tvr_b, k)])
                                           for k in TwoViewResult.__dataclass_fields__})
            host = {k: getattr(tvr, k).cpu().numpy() for k in TwoViewResult.__dataclass_fields__}
        frontend_sec = clock.seconds
        logger.info("two-view: %d pairs (%d valid) in %.1fs", len(pairs), int(host["valid"].sum()), frontend_sec)
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
        reports = make_reports(pairs, host, gt) if gt is not None or self._telemetry is not None else None
        if gt is not None:
            groups.append(aggregate_frontend_metrics(reports))
        if self._telemetry is not None:
            self._telemetry.log_metadata(num_images=n, num_pairs=len(pairs))
            self._telemetry.log_two_view_results(reports)
            self._telemetry.log_stage("detect_describe", detect_sec)
            self._telemetry.log_stage("retriever", retriever_sec)
            self._telemetry.log_stage("two_view", frontend_sec)
        if sim is not None and gt is not None and len(pairs):
            groups.append(retrieval_metrics(pairs, np.asarray(sim), gt))

        meta = SceneMeta(image_names=loader.image_filenames(), image_sizes=[(w, h) for (h, w) in sizes])
        t_mvo = time.perf_counter()
        self.node_results = []
        if opts.hierarchical:
            hier = HierarchicalReconstruction(
                HierarchicalOptions(mvo=opts.mvo, max_cluster_size=opts.max_cluster_size), mesh=self._mesh,
                cluster_cache=self._cluster_cache)
            tvr_h = dict(host, i2Ri1=tvr.i2Ri1, i2Ui1=tvr.i2Ui1)
            data, mvo_metrics = hier.run(n, pairs, tvr_h, kp_xy, cal, meta=meta)
            self.node_results = hier.node_results
        else:
            data, mvo_metrics = MultiViewOptimizer(opts.mvo, mesh=self._mesh).run(
                num_images=n, pairs=pairs, i2Ri1=tvr.i2Ri1, i2Ui1=tvr.i2Ui1,
                pair_valid=host["valid"], num_inliers=host["num_inliers"],
                corr_i1=host["corr_i1"], corr_i2=host["corr_i2"], corr_mask=host["corr_mask"],
                keypoints_xy=kp_xy, cal=cal, meta=meta,
            )
        mvo_metrics["backend_sec"] = time.perf_counter() - t_mvo
        logger.info("back-end: %d cameras, %d tracks in %.1fs", data.number_images(), data.number_tracks(),
                    mvo_metrics["backend_sec"])
        self.backend_metrics = mvo_metrics
        groups.append(MetricsGroup("multiview_optimizer_metrics", [
            Metric(k, v) for k, v in mvo_metrics.items() if isinstance(v, (int, float))
        ]))
        return self._finalize(loader, data, mvo_metrics, groups, t_start, images, gt)

    def _run_feedforward(self, loader: LoaderBase, t_start: float, groups: list) -> tuple:
        """The whole scene through the feed-forward slot
        (scene/cluster_feedforward.py) in place of the front end and back
        end, then the common tail; the anysplat slot's gaussians start the
        trainer (or are exported as they are). Inside the root span
        ``feedforward`` (views)."""
        with span("feedforward", len(loader)):
            opts = self.options
            t0 = time.perf_counter()
            images, sizes = loader.load_grayscale_batch()
            cal = batch_calibrations(loader.get_all_intrinsics()).map(lambda a: a.to(self.device))
            ff_opts = ClusterFeedforwardOptions(run_post_ba=opts.feedforward_post_ba,
                                                backbone=opts.feedforward_backbone,
                                                vggt_weights_path=opts.vggt_weights_path or "")
            cls = ClusterFastFeedforward if opts.cluster_optimizer == "fastvggt" else ClusterFeedforward
            ff = cls(ff_opts, device=self.device)
            data, ff_metrics, (poses, depth, conf) = ff.run_raw(images, cal)
            data = data.replace(meta=SceneMeta(image_names=loader.image_filenames(),
                                               image_sizes=[(w, h) for (h, w) in sizes]))
            ff_metrics["feedforward_sec"] = time.perf_counter() - t0
            self.backend_metrics = ff_metrics
            groups.append(MetricsGroup("feedforward_metrics", [
                Metric(k, v) for k, v in ff_metrics.items() if isinstance(v, (int, float))]))
            gs_init = None
            if opts.cluster_optimizer == "anysplat":
                gs_init = self._feedforward_splats(ff, images, depth, conf, cal, data.poses, ff_opts)
            gt = loader.get_gt_poses()
            if gt is not None:
                gt = gt.map(lambda a: a.to(self.device))
            return self._finalize(loader, data, ff_metrics, groups, t_start, images, gt, gs_init=gs_init)

    @staticmethod
    def _feedforward_splats(ff, images, depth, conf, cal, poses, ff_opts):
        """The anysplat slot's gaussians: with the vggt_exact backbone VGGT
        runs again (a third aggregator pass, after the slot's forward and
        its track head) and the AnySplat-class model on a fourth
        (frontend/anysplat.py), as in the reference; else the depth maps
        lifted by depth_to_splats."""
        if ff_opts.backbone != "vggt_exact":
            return depth_to_splats(poses, depth, conf, cal, images=images, conf_threshold=ff_opts.conf_threshold)
        padded = pad_to_patch_grid(images, ff_opts.model.patch_size)
        vggt_model = ff._run_vggt_exact(padded, cal)[-1]
        model = AnySplatModel.from_vggt(vggt_model, AnySplatOptions(conf_threshold=ff_opts.conf_threshold))
        return model.run(np.repeat(padded[..., None], 3, axis=-1))["gaussians"]

    def _finalize(self, loader, data, mvo_metrics, groups, t_start, images, gt, gs_init=None):
        """Evaluation (with ``gt`` on the device: the scene moved into the GT
        frame, with ``gs_init``, the feed-forward gaussians; without: the
        axis alignment, unless there are feed-forward gaussians), the dense
        back end on the grayscale images when ``run_mvs`` is set, the splat
        trainer on them when ``run_gs`` is set (from ``gs_init`` when
        given), run time, and the results under ``output_root`` (see the
        module's docstring)."""
        opts = self.options
        failed = bool(mvo_metrics.get("failed"))
        if gt is None and opts.axis_align_when_no_gt and gs_init is None and not failed:
            data = align_scene_to_axes(data)
        if gt is not None and not failed:
            est_mask = data.pose_mask.cpu().numpy()
            rot_err, t_err, sim = relative_pose_errors(data.poses, gt, est_mask)
            data = data.transform(sim)
            if gs_init is not None:
                gs_init = transform_splats(gs_init, sim)
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
        dense = None
        if opts.run_mvs and not failed and data.number_tracks() > 0:
            t0 = time.perf_counter()
            mvs_opts = MVSOptions(num_depths=opts.mvs_num_depths, num_source_views=opts.mvs_num_source_views)
            if opts.mvs_backend == "patchmatchnet":
                mvs = PatchmatchNetMVS(mvs_opts, state_dict=load_pmnet_weights(opts.mvs_weights_path),
                                       device=self.device)
            else:
                mvs = PlaneSweepMVS(mvs_opts, device=self.device)
            *dense, mvs_metrics = mvs.run(data, images)
            mvs_metrics["mvs_sec"] = time.perf_counter() - t0
            groups.append(MetricsGroup("mvs_metrics", [Metric(k, v) for k, v in mvs_metrics.items()]))
        gs_result = None
        if opts.run_gs and not failed and data.number_tracks() > 0:
            t0 = time.perf_counter()
            trainer = GaussianSplatting(GSTrainOptions(iterations=opts.gs_iterations), device=self.device)
            gs_result, gs_metrics = trainer.train(data, images, gs_init=gs_init)
            gs_metrics["gs_sec"] = time.perf_counter() - t0
            groups.append(MetricsGroup("gaussian_splatting_metrics",
                                       [Metric(k, v) for k, v in gs_metrics.items()]))
        elif gs_init is not None:
            gs_result = gs_init
        total_sec = time.perf_counter() - t_start
        groups.append(MetricsGroup("total_summary", [Metric("total_runtime_sec", total_sec)]))
        if self._telemetry is not None:
            self._telemetry.log_stage("total", total_sec)
        if opts.output_root:
            results_dir = os.path.join(opts.output_root, "results")
            os.makedirs(results_dir, exist_ok=True)
            if opts.save_colmap and data.number_tracks() > 0:
                colmap_io.write_scene(data, os.path.join(results_dir, "ba_output"))
            if opts.save_colmap and self.node_results:
                self._write_scene_tree(results_dir)
            for g in groups:
                g.save_json(os.path.join(results_dir, "metrics"))
            generate_html_report(groups, os.path.join(results_dir, "gtsfm_metrics_report.html"))
            ProcessGraphGenerator().save_graph(os.path.join(results_dir, "process_graph.dot"))
            if data.number_tracks() > 0:
                export_scene_html(data, os.path.join(results_dir, "viewer.html"))
                os.makedirs(os.path.join(results_dir, "plots"), exist_ok=True)
                plot_scene_3d(data, os.path.join(results_dir, "plots", "scene_3d.png"))
            if dense is not None and len(dense[0]):
                write_ply(os.path.join(results_dir, "dense_points.ply"), *dense)
            if gs_result is not None:
                export_ply(gs_result, os.path.join(results_dir, "splats.ply"))
                write_ply(os.path.join(results_dir, "gaussian_points.ply"), *gaussian_means_as_tracks(data, gs_result))
                if opts.gs_video_frames > 0:
                    self._export_splat_video(gs_result, data, results_dir, opts.gs_video_frames)
        return data, groups

    def _write_scene_tree(self, results_dir: str) -> None:
        """The hierarchical run's cluster results (all but the root, which
        is ba_output/) as a SceneTree: path (1, 2) in results/C_1/C_1_2."""
        nodes = {}
        for path, node_data in self.node_results:
            if path:
                d = os.path.join(results_dir, *[f"C_{'_'.join(map(str, path[: k + 1]))}" for k in range(len(path))])
                nodes[path] = SceneTree(directory=d, scene=node_data)
        for path, node in sorted(nodes.items(), key=lambda kv: len(kv[0])):
            parent = nodes.get(path[:-1])
            if parent is not None:
                parent.children.append(node)
        for path, node in nodes.items():
            if len(path) == 1:
                node.write()

    def _export_splat_video(self, gs_result, data, results_dir: str, n_frames: int) -> None:
        """The splats rendered along a B-spline path through the registered
        cameras (``bspline_camera_path``), at the first registered camera's
        calibration and an image of twice its principal point:
        results/splat_video/frame_%04d.png, results/splat_flythrough.gif
        and, where OpenCV can write it, results/splat_flythrough.mp4."""
        from PIL import Image

        est = np.flatnonzero(data.pose_mask.cpu().numpy())
        if len(est) < 2:
            return
        idx = torch.as_tensor(est, device=data.poses.t.device)
        K = data.cal.K()[int(est[0])]
        H = int(round(float(K[1, 2]) * 2)) or 480
        W = int(round(float(K[0, 2]) * 2)) or 640
        out_dir = os.path.join(results_dir, "splat_video")
        os.makedirs(out_dir, exist_ok=True)
        frames = []
        with torch.no_grad(), precise():
            path = bspline_camera_path(data.poses.map(lambda a: a[idx]), n_frames)
            for f in range(n_frames):
                img, _ = render_tiled(gs_result, SE3(R=path.R[f], t=path.t[f]), K, H, W)
                frame = Image.fromarray(np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8))
                frame.save(os.path.join(out_dir, f"frame_{f:04d}.png"))
                frames.append(frame)
        frames[0].save(os.path.join(results_dir, "splat_flythrough.gif"), save_all=True, append_images=frames[1:],
                       duration=max(1000 // 24, 20), loop=0)
        try:
            import cv2
        except ImportError:  # no OpenCV: the GIF alone
            return
        vw = cv2.VideoWriter(os.path.join(results_dir, "splat_flythrough.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                             24.0, (W, H))
        if vw.isOpened():
            for frame in frames:
                vw.write(np.asarray(frame)[:, :, ::-1])  # RGB -> BGR
            vw.release()

    def _global_descriptor(self):
        """The global descriptor (the tiny descriptor when none was given),
        behind its disk cache with ``use_cache``."""
        if self.global_descriptor is None:
            self.global_descriptor = TinyImageDescriptor()
        if self.options.use_cache and not isinstance(self.global_descriptor, GlobalDescriptorCacher):
            self.global_descriptor = GlobalDescriptorCacher(self.global_descriptor, root=self.options.cache_root)
        return self.global_descriptor

    def _load_detect_chunked(self, loader: LoaderBase, want_global_descs: bool, detect: bool = True,
                             keep_images: bool = False):
        """Load, detect and describe the images ``C`` at a time, dropping
        each chunk's images after it, so host memory holds one chunk of
        images. ``C`` is ``load_chunk_size`` when it is set and the images
        are not kept for a later stage, else the whole scene. -> (kp_xy,
        kp_mask, descs (each None without ``detect``), global descriptors
        or None, sizes, the (n, H, W) images with ``keep_images`` else
        None)."""
        n = len(loader)
        C = self.options.load_chunk_size if self.options.load_chunk_size and not keep_images else n
        detections, gdescs, sizes, kept = [], [], [], None
        with span("load_detect", n):
            for s in range(0, n, C):
                images, csizes = loader.load_grayscale_batch(indices=range(s, min(s + C, n)))
                with span("load_detect.upload", len(csizes)):
                    images_dev = torch.as_tensor(images, device=self.device)
                kept = images if keep_images else None
                del images
                if detect:
                    detections.append(self._detect_batch(images_dev, csizes))
                if want_global_descs:
                    with span("global_descriptor", len(csizes)):
                        gdescs.append(self._global_descriptor().describe_batch(images_dev))
                sizes += csizes
                del images_dev
            kp_xy, kp_mask, descs = (np.concatenate(a) for a in zip(*detections)) if detect else (None, None, None)
            gdescs = np.concatenate(gdescs) if gdescs else None
        return kp_xy, kp_mask, descs, gdescs, sizes, kept

    def _detect_batch(self, images: torch.Tensor, sizes):
        """Chunked detection of the (n, H, W) batch on the run's device
        through the detector, with the reference's 4-pixel border-validity
        mask; with ``use_cache`` replayed from the detector cache, keyed on
        a host copy of the images subsampled by 8, the sizes, the detector's
        class (the net's, inside a batched CNN adapter) and its keypoint
        count."""
        n = images.shape[0]
        with span("detect", n):
            if self._detect_cache is not None:
                # a batched CNN detector's adapter is keyed by the net inside it
                net = getattr(self.detector, "detector", self.detector)
                key = content_key(images[:, ::8, ::8].cpu().numpy(), np.asarray(sizes), type(net).__name__,
                                  self.detector.max_keypoints)
                hit = self._detect_cache.get(key)
                if hit is not None:
                    return hit
            B = self.options.image_batch_size
            K = self.detector.max_keypoints
            kp_xy = np.zeros((n, K, 2), np.float32)
            kp_mask = np.zeros((n, K), bool)
            descs = None
            for s in range(0, n, B):
                with span("detect.net", min(B, n - s)):
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
            if self._detect_cache is not None:
                self._detect_cache.put(key, (kp_xy, kp_mask, descs))
        return kp_xy, kp_mask, descs

    def _run_two_view(self, pairs, kp_xy, kp_mask, descs, cal, image_wh, pair_matches=None) -> TwoViewResult:
        """Two-view estimation, through the two-view disk cache with
        ``use_cache`` (not for precomputed matches: the key covers the
        descriptors, not the match lists)."""
        if self._two_view_cacher is not None and pair_matches is None:
            return self._two_view_cacher.run(pairs, kp_xy, kp_mask, descs, cal, image_wh)
        return self._run_two_view_uncached(pairs, kp_xy, kp_mask, descs, cal, image_wh, pair_matches)

    def _run_two_view_uncached(self, pairs, kp_xy, kp_mask, descs, cal, image_wh,
                               pair_matches=None) -> TwoViewResult:
        """Two-view estimation over chunks of ``pair_batch_size`` pairs with
        the scene's keypoints and descriptors resident on the device. With
        ``pair_matches`` (the direct branch's matches, see _match_table)
        each chunk verifies those matches; else a matcher, if
        any, matches each chunk first (``image_wh``: the scene's largest
        width and height, for its keypoint normalization). The last chunk
        is not padded: each pair's random stream is keyed by its global
        index, so chunking does not change the result. On a mesh, a chunk
        whose length divides by ``data`` is split over the data ranks
        (``shard_pair_batch``, the global pair indices with it, so no draw
        changes) and the ranks' results are gathered in pair order."""
        opts = self.options
        dev = cal.u0.device  # a field of every calibration model
        mesh = self._mesh
        with span("two_view", len(pairs)):
            with span("two_view.upload"):
                kp_dev = torch.as_tensor(kp_xy, dtype=torch.float32, device=dev)
                kpm_dev = torch.as_tensor(kp_mask, dtype=torch.bool, device=dev)
                d_dev = torch.as_tensor(descs, dtype=torch.float32, device=dev)
                pairs_dev = torch.as_tensor(pairs, dtype=torch.int64, device=dev)
                if pair_matches is not None:
                    midx, mmask = self._match_table(pairs, pair_matches, kp_xy.shape[1])
                    midx_dev = torch.as_tensor(midx, device=dev)
                    mmask_dev = torch.as_tensor(mmask, device=dev)
            chunks = []
            for s in range(0, len(pairs), opts.pair_batch_size):
                e = min(s + opts.pair_batch_size, len(pairs))
                with span("two_view.chunk", e - s):
                    part = dict(i1=pairs_dev[s:e, 0], i2=pairs_dev[s:e, 1],
                                pair_ids=torch.arange(s, e, device=dev),
                                pair_mask=torch.ones(e - s, dtype=torch.bool, device=dev))
                    if pair_matches is not None:
                        part.update(match_idx=midx_dev[s:e], match_mask=mmask_dev[s:e])
                    sharded = mesh is not None and (e - s) % mesh.shape["data"] == 0
                    if sharded:
                        part = shard_pair_batch(mesh, part)
                    i1, i2, pair_mask = part.pop("i1"), part.pop("i2"), part.pop("pair_mask")
                    batch = xy1, xy2, d1, d2, m1, m2 = (
                        kp_dev[i1], kp_dev[i2], d_dev[i1], d_dev[i2], kpm_dev[i1], kpm_dev[i2])
                    if pair_matches is not None:
                        part["match_score"] = part["match_mask"].to(torch.float32)
                    elif self.matcher is not None:
                        with span("match", e - s):
                            midx_c, mmask_c, mscore = self.matcher.match_batch(d1, d2, xy1, xy2, m1, m2,
                                                                               image_size=image_wh)
                        part.update(match_idx=midx_c, match_mask=mmask_c, match_score=mscore)
                    res = run_two_view_batch(
                        *batch, cal.map(lambda a: a[i1]), cal.map(lambda a: a[i2]), pair_mask, seed=opts.seed,
                        opts=opts.two_view, mesh=mesh if sharded else None, **part)
                    if sharded:
                        lo = mesh.coord["data"] * ((e - s) // mesh.shape["data"])  # this rank's place in the chunk
                        res = TwoViewResult(**{k: gather(mesh, "data", getattr(res, k), lo, e - s)
                                               for k in TwoViewResult.__dataclass_fields__})
                    chunks.append(res)
            return TwoViewResult(**{
                k: torch.cat([getattr(c, k) for c in chunks]) for k in TwoViewResult.__dataclass_fields__
            })

    @staticmethod
    def _match_table(pairs, pair_matches, K: int) -> tuple:
        """(E, K) match_idx / match_mask tables (match_idx[p, k1] = k2) from
        an (E, K) corr_i1 / corr_i2 / corr_mask triple aligned with
        ``pairs`` (the synthetic generator's) or the aggregator's dict
        {(i1, i2): (idx1, idx2, keep)} (a keypoint of image 1 matched twice
        keeps its last match, as numpy's assignment in the reference)."""
        midx = np.zeros((len(pairs), K), np.int32)
        mmask = np.zeros((len(pairs), K), bool)
        if isinstance(pair_matches, tuple):
            ci1, ci2, cm = (np.asarray(x) for x in pair_matches)
            r, k = np.nonzero(cm[: len(pairs)])
            midx[r, ci1[r, k]] = ci2[r, k]
            mmask[r, ci1[r, k]] = True
            return midx, mmask
        for p, (a, b) in enumerate(np.asarray(pairs).tolist()):
            e = pair_matches.get((a, b))
            if e is None:
                continue
            idx1, idx2, keep = e
            midx[p, idx1[keep]] = idx2[keep]
            mmask[p, idx1[keep]] = True
        return midx, mmask
