#!/usr/bin/env python3
"""Drive the PyTorch port (gtsfm_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each printing one or more lines:

1. device: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every csrc/*.cu from the checkout (one nvcc per source,
   all at once, sm_90a);
3. kernel: the fused mutual-NN matcher kernel against its plain PyTorch
   version on the card, at the two-view shape of the slice (P=96 pairs,
   K=1024, D=128), plus an all-masked pair, a K=1000 pair and the tiling's
   edges (K1 = 127 and 129, K2 = 63 and 65, D = 136, one pair); two
   launches must be bitwise equal and the finish kernel must equal its
   plain version (fused_matcher._finish); the HMMA and FFMA counts of its SASS
   (cuobjdump); both timed (median of 20 samples of back-to-back calls,
   CUDA events), the kernels also as a CUDA graph (their device time alone)
   and by the host's clock (the wrapper's host time per call), with its
   TFLOP/s and share of the bound; then the same checks and timings at the
   runner phase's shape, P=64 pairs, K=2048, D=128 (the unified config's
   pair_batch_size and max_keypoints), on the descriptor feed at K=2048;
4. attention: the fused attention kernel through all four entries against
   their plain versions: LightGlue's shape (P=96 pairs, K=2048, 4 heads of
   64, masked keys), a fully masked key set, K=1000, K=384, K0 != K1 and
   the tiling's edges (Kk = 1, Kk = 129, Kq = 1, Kq = 129, P = 2 at
   K = 2048); each entry timed at LightGlue's shape (median of 20 samples
   of back-to-back calls, CUDA events) in turns with its plain version and with
   scaled_dot_product_attention (once per direction) as the yardstick,
   with its TFLOP/s and share of the bound;
5. composite: the splat tile-compositing kernel against its plain version
   on the tiles of a seeded 50,000-gaussian scene (the splat scene below)
   seen by one ring camera at 480x640, f=600, binned by the port's
   render_tiled: a low-opacity copy where no tile stops early (|d| <=
   1e-5), the full scene (|d| <= 1/255 + 1e-5, the early stop's bound), an
   all-empty tile set (exact), a ragged tile count, and the kernel's
   edges: every count cut to 256 and to 257 (the stop boundary), indices
   -1 and G among the faint copy's slots, and cap 100 (only 64 slots
   composited); TiledComposite's gradient on the card against the plain
   path's; kernel and plain timed (median of 20 samples, CUDA events), the
   kernel also as a CUDA graph of 5 calls (its device time alone), with
   its share of the bound;
6. slice: SceneOptimizer.run on a 32-camera ring fed through the detector
   slot with synthetic keypoints and descriptors (the descriptor feed
   below), on `cuda`, with the splat trainer after it (run_gs, 400 steps on
   the loader's flat gray images); 32/32 cameras registered, pose AUC@5 >=
   0.978, a falling splat L1, and launches of the matcher and compositing
   kernels during the run required;
7. lightglue: the same ring through SceneOptimizer.run with the LightGlue
   matcher at full width (dim 256, 9 layers, 4 heads, bf16) on the glue
   fixture below, K=2048 keypoints with D=256 descriptors; 32/32
   registered, AUC@5 >= 0.978 and attention launches during the run
   required, and the matches through the kernel must agree with a forward
   through the plain attention on every decisive row;
8. gate: the twin of tests/scene/test_accuracy_gate_32.py on `cuda`: the
   32-camera ring through SceneOptimizer.run with the synthetic
   correspondence generator (600 points, 0.4 px noise) in the direct
   branch, flat; 32/32 registered and compare_reconstructions' pose AUC@5
   >= 0.978 required, and no matcher launch (the two-view batch verifies
   the generator's matches);
9. hierarchical: bench.py's palace-281 configuration through the port on
   `cuda`: 281 cameras, 4,095 pairs from the default SequentialRetriever,
   GT on a spectral ring over them, the synthetic generator (800 points,
   0.4 px), SceneOptimizerOptions(hierarchical=True, max_cluster_size=40):
   the METIS partition, per-cluster MVO, Sim3 merges with parent BAs; run
   once, cold (the warm run cut for time), requiring the METIS partitioner, >= 4
   clusters, no merge failure, no matcher launch, registered >= 278 (the
   JAX reference's 281 - 3, above test_scale_synthetic.py's 0.95 n), AUC@5
   >= the reference's 0.9739 - 0.02, and median rotation and translation
   errors after a Sim3 alignment to GT < 0.5 deg and < 0.3; prints the
   cluster tree and the stage seconds with the card's name and power limit;
10. ba_layouts: BundleAdjustment on `cuda` on ba_scene below, palace-281's
   281 cameras with 20,000 points on tracks of 2-15 views (1 px noise, a
   perturbed start, plain least squares), once in each layout (dense,
   entry, scatter; 30 LM steps, 40 PCG steps): each must run in its own
   layout (bundle.ba.layout_counts), end below 1e-2 of its initial cost,
   and entry and scatter within 5% of dense's final cost; then the scene
   plus one track seen by 200 cameras with layout="dense" must run in
   entry (the dense layout holds 128 views at most); prints each solve's
   seconds and costs;
11. runner and 12. colmap_runner: the default entry point,
   gtsfm_tpu_torch.runner.main with the unified config (DoG-SIFT K=2048,
   the joint retriever with the tiny descriptor, the two-view batch at
   P=64 through the matcher kernel, bridges, MVO, evaluation, COLMAP
   export), in this process, cold and then warm, first on an Olsson folder
   of the 32 ring views of runner_scene below, rendered by the port at
   480x640, f=600, then with --loader colmap on a COLMAP folder of the same
   views resampled through a known OPENCV camera (OPENCV_CAMERA: fx 600,
   fy 606, k1 -0.05, k2 0.01, p1 5e-4, p2 -3e-4; the resampling map from
   this file's own float64 Newton inversion of the model), whose Cal3DS2
   sends MVO's dense BA to the entry layout; each run requires DoG-SIFT on
   `cuda` only, a matcher launch per 64 pairs, registered >= the JAX
   reference's - 1 and AUC@5 >= its - 0.02 (scripts/runner_reference.py and
   scripts/colmap_runner_reference.py), the metrics JSON and a COLMAP
   export that reads back with every registered camera; the colmap run
   also at least one BA solve in entry and none in dense, and cameras.txt
   exported as OPENCV with the distortion within 1e-3 of the truth; prints
   the stage seconds, the pair count and the keypoints per image;
   between the two, runner_options: the Olsson folder again with
   RUNNER_OPTIONS (the homography and indeterminacy checks, LMedS scoring,
   top-K-baseline triangulation, one cycle-filter pass, uniform rotation
   weights, measurement-seeded MFAS directions), cold and warm, against
   scripts/runner_options_reference.py's bars, with the pairs each check
   rejected; then the first chunk's first 16 pairs through the two-view
   batch on `cuda` and on the CPU with the same matches and draws (made on
   the card): valid equal on every pair away from the thresholds;
13. splat: GaussianSplatting.train at full width, 50,000 gaussian slots at
   480x640 for 400 steps, on the 32 ring views of the splat scene rendered
   by the port; final L1 < 0.7 of the initial and >= 400 compositing
   launches required; seconds per step and peak device memory printed;
14. deep_front_end: gtsfm_tpu_torch.runner.main with the deep_front_end
   config (SuperPoint at K=2048, LightGlue at full width, NetVLAD, the
   joint retriever, pair_batch_size 256) on the runner phase's Olsson
   folder, with seeded SuperPoint and LightGlue checkpoints (NetVLAD on its
   seeded init), cold and then warm at RANSAC seed 0, then warm at seeds 1
   and 2: 36 attention launches per LightGlue forward, no matcher launch,
   peak device memory; the pairs and each pair's LightGlue match count
   against the JAX package's, the medians over the seeds of registered,
   AUC@5 and valid pairs within its bars (DEEP_REFERENCE, from
   scripts/deep_front_end_reference.py); the attention kernel on the inputs
   LightGlue gave its merged self and cross entries in the warm run,
   against the plain version and timed with scaled_dot_product_attention;
   the card against the CPU: SuperPoint on 4 views and NetVLAD on 32 (each
   also with TF32 on, where the check must fail), LightGlue on 4 pairs;
15. megaloc_sift: the runner with megaloc_sift_frontend (MegaLoc ViT-B/14 at
   322x322 from a seeded megaloc.torch, DoG-SIFT at K=5000, the similarity
   retriever at 10) at seeds 0, 1, 2: DoG-SIFT on `cuda`, matcher
   launches, the pairs, match counts and medians held as for
   deep_front_end; the matcher kernel on the run's first chunk at K=5000
   against its plain version and timed on 32 of its pairs, and alone on
   the whole chunk; MegaLoc on the card against the CPU on 4 views (and
   with TF32 on);
16. deep_components: D2-Net, DISK and hloc's VGG16-NetVLAD at 480x640 (their
   seeded inits) on 2 views, the card against the CPU (and with TF32 on);
17. feedforward: the runner with the vggt, fastvggt and anysplat --run_gs
   configs (the feed-forward cluster slots, the compact model at its full
   width on feedforward_fixture's seeded weights), first on FF_VIEWS
   numpy-made views (feedforward_views) held to the JAX package's runs on
   the same weights and views (FEEDFORWARD_REFERENCE, written by
   scripts/feedforward_reference.py on the CPU): the forward's poses,
   depth, confidences and track features, the feed-forward track count,
   registered cameras, AUC@5, the post-BA cost and the anysplat trainer's
   L1; then on the runner phase's 32 rendered views, timed, anysplat's
   trainer at 100 steps through the compositing kernel (its launches join
   the kernels line as feedforward_launches); no matcher or attention
   launch in any of these runs;
18. vggt_full: VGGT at the public VGGT-1B widths (VGGTOptions(),
   TrackOptions()): with the depth cut (VGGT_CHECK_DEPTH) its forward and
   track head on 2 views at 392x518 against the same file; then the full
   model's seeded weights in the public layout (vggt_fixture, LayerScale
   0.01, about 5 GB) through the runner with anysplat and post-BA on
   (scene_optimizer.feedforward_post_ba=true, so that the one run drives
   the vggt slot's path too: the vggt slot's own run is cut for time) and
   scene_optimizer.feedforward_backbone=vggt_exact on the 32 rendered
   views: each aggregator pass, head, the tracker and post-BA timed (each
   must have run), the attention's share of the aggregator, peak memory;
   every camera registered with finite poses;
19. mvs: the dense back ends on the card held to the JAX package
   (MVS_REFERENCE, written by scripts/mvs_reference.py on the CPU) on the
   FF_VIEWS feedforward_views at 480x640 with their GT poses and
   MVS_TRACKS GT points (mvs_tracks): equal source views, depth ranges
   within 1e-5; PlaneSweepMVS at MVSOptions() (its confident depths, see
   MVS_SWEEP_*) and PatchmatchNetMVS on the seeded pmnet_fixture
   (>= 99% of the depths held every 8 pixels within 1e-3, dense count
   within 1%), cold and warm, with each backend's median error against
   the analytic depth beside the JAX package's; one plane-sweep view
   timed at 960x1280;
20. mvs_runner: the runner with --run_mvs on the runner phase's 32 views,
   cold and warm, then with --mvs_backend patchmatchnet: the runner's bars,
   an mvs_metrics group with a depth map for every registered view but
   one at most, a plane-sweep dense_points.ply with points, matcher
   launches (they join the kernels line); mvs_sec and its three parts;
21. bal: the BAL tool mode, runner.main(["--bal", ...]), on a seeded
   problem at the public Trafalgar-257 problem's counts (bal_problem):
   the final cost at most 1.05 times the cost at the generating
   parameters, 257 cameras exported;
22. correspondence (on the runner phase's folder): the direct image-
   correspondence front ends, SuperGlue and the OpenCV detectors through
   gtsfm_tpu_torch.runner.main on `cuda`. Run A: colmap_front_end on a
   COLMAP text model of the folder's views with CORR_GT_POINTS GT points
   (mvs_tracks, written by write_colmap_tracks): registered >= the JAX
   package's - 1 and AUC@5 >= its - 0.02 (CORR_REFERENCE, from
   scripts/correspondence_reference.py on the CPU); E on the same run:
   scene_optimizer.telemetry_db holds one two-view row per pair and
   GTSFM_TPU_TRACE's directory a torch.profiler trace. Runs B-D on seeded
   checkpoints in the public layouts (write_correspondence_weights):
   skydio_front_end with LoFTR at its published widths, mast3r at its
   published widths (ViT-L encoder, base decoders, long edge 512) and
   deep_front_end with matcher.name=superglue; recorded, not held (seeded
   nets make no photo result): correspondences per pair, valid pairs,
   registered, AUC@5, the stage seconds, the generator's seconds, the
   keypoint aggregator's host seconds and the peak device memory; no
   kernel launch in A-D. Run F: the unified config with OpenCV's SIFT in
   the detector slot (the card's machine has OpenCV), whose matches go
   through kernel #1 (its launches join the kernels line). Then LoFTR,
   MASt3R and SuperGlue of runs B-D on the card on CORR_HOLD_PAIRS (the
   runs' first four pairs) against the JAX package's outputs on the same
   weights and views (CORR_REFERENCE_NPZ; SuperGlue on corr_glue_feed's
   keypoints): >= 99% of the matches identical per pair, LoFTR's refined
   coordinates within CORR_FINE_TOL_PX (4e-3 px);
23. runner_outputs (last, on the runner phase's folder, so that its runs
   warm no later phase's cold run): the runner's
   remaining flags and what every run writes. Run A: unified with
   --use_cache, --load_chunk_size 8, --prewarm and --compare_to the
   folder's GT poses as COLMAP text (write_gt_colmap): the runner's bars,
   every file the reference writes (ba_output/, metrics/ with
   retrieval_metrics, the HTML report, process_graph.dot, viewer.html,
   plots/scene_3d.png, comparison/); run B, A's argv again: poses, points
   and measurements bit-identical to A's and no matcher launch; the
   chunked detection on the card against the whole batch's, both
   detected afresh with run A's detector cache off (keypoints_agree >=
   0.99); run C: --hierarchical --run_gs
   --gs_video_frames 24 --use_cache at 100 trainer steps and
   max_cluster_size 16: one C_* directory per cluster result, 24 frames
   and the GIF, exactly 100 + 24 compositing launches; runs D and E:
   deep_front_end with --use_cache, cold then replayed: 36 attention
   launches per LightGlue forward in D, none in E, E bit-identical to D;
   the comparison dashboard over A and B. Prints A's and B's stage
   seconds, the prewarm's seconds by name and A's total beside the runner
   phase's cold total; its launches join the kernels line.

The seconds of each phase are printed as it ends. The line before the last
is the kernel table as JSON; the last line is {"ok": true, "device":
{...}}. Any failure exits non-zero with no result.
There is no CPU mode: without a CUDA device the script stops.

The descriptor feed, the glue fixture, the SuperPoint, MegaLoc, LoFTR,
SuperGlue and MASt3R fixtures, the feed-forward views and weights, the PatchmatchNet weights,
the MVS tracks, the splat scene, the runner scene, the OPENCV resampling,
the BA scene and the BAL problem are defined here once, with
numpy only (VGGT's key layout read off the port's module; ring_views,
write_olsson, write_colmap_opencv and ba_sfm_data render, write and load
them through the port); the CPU tests and the reference scripts
(scripts/*_reference.py) import them from this file.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_CAMERAS = 32
IMAGE_HW = (240, 320)
FOCAL = 300.0
NUM_KEYPOINTS = 1024
DESC_DIM = 128
AUC5_BAR = 0.978  # the 32-camera gate's bar (tests/scene/test_accuracy_gate_32.py)
KERNEL_TOL_BEST = 1e-5  # |best| agreement; sums of exact bf16 products, f32 order only
KERNEL_GAP = 1e-4  # idx/ok must agree where best and second differ by more
# attention kernel vs plain version, both bf16 out: |got - want| <=
# ATTN_TOL_V * max|v| + ATTN_TOL_OUT * |want|. Two bf16 roundings differ:
# the probabilities (the kernel rounds exp(s - running max) and divides by
# the float32 sum at the end, the plain version rounds the normalized
# softmax; each is within 2^-9 of exact, so the outputs differ by at most
# 2^-8 * sum p|v| <= 2^-8 max|v|) and the outputs (each rounded to bf16, at
# most one ulp, 2^-7 relative, apart).
ATTN_TOL_V = 2.0**-8
ATTN_TOL_OUT = 2.0**-7

GLUE_KEYPOINTS = 2048  # max_keypoints of gtsfm_tpu/configs/deep_front_end.yaml
GLUE_DESC_DIM = 256  # SuperPoint's descriptor width, LightGlue's input_dim
GLUE_SIGMA = 0.05 * (DESC_DIM / GLUE_DESC_DIM) ** 0.5  # the feed's noise norm at D=128
# matches through the kernel and through the plain attention must agree on
# every row whose log-assignment top-2 margin (row and matched column) and
# distance to the match threshold exceed this: bf16 forwards that round
# attention at different places drift apart (0.33 max after two layers,
# port against reference on the CPU; 0.76 max after nine layers at K=2048,
# kernel against plain on an H100)
GLUE_GAP = 1.0

GATE_POINTS = 600  # the 32-camera gate's SyntheticOptions (tests/scene/test_accuracy_gate_32.py)
# the hierarchical phase: palace-281's size and bench.py's _palace_bench
# configuration, its visibility graph replaced by the default
# SequentialRetriever's (lookahead 15: 4,095 pairs, palace has 4,139)
HIER_CAMERAS = 281
HIER_POINTS = 800
HIER_CLUSTER_SIZE = 40
HIER_MIN_CLUSTERS = 4
# the JAX package on the CPU on the same inputs (scripts/hierarchical_reference.py):
# 281/281 registered, compare_reconstructions' pose AUC@5 0.97389
HIER_REF_REGISTERED = 281
HIER_REF_AUC5 = 0.9738916772552285
HIER_REGISTERED_SLACK = 3  # the port may register up to 3 fewer cameras
HIER_AUC5_SLACK = 0.02
HIER_MIN_REGISTERED = 0.95  # tests/scene/test_scale_synthetic.py:122-123
HIER_MEDIAN_ROT_DEG = 0.5  # test_scale_synthetic.py:128-131, after a Sim3 alignment to GT
HIER_MEDIAN_TRANS = 0.3

# the runner phase: the unified config on the 32 ring views of runner_scene;
# the JAX package on the CPU on the same views (scripts/runner_reference.py,
# JAX 0.9.0): 31 of 32 registered, pose AUC@5 0.72510 (156 of 360 pairs
# valid, 114 of them with the GT pose; the cycle filter keeps 108 edges)
RUNNER_REF_REGISTERED = 31
RUNNER_REF_AUC5 = 0.725103081450347
RUNNER_REGISTERED_SLACK = 1  # the port may register one camera fewer
RUNNER_AUC5_SLACK = 0.02
RUNNER_PAIR_BATCH = 64  # pair_batch_size of the unified config: pairs per matcher launch
RUNNER_METRICS = ("frontend_summary", "verifier_summary", "multiview_optimizer_metrics", "ba_pose_metrics",
                  "track_classification_metrics", "intrinsics_metrics", "total_summary")

# the colmap_runner phase: the runner phase's views resampled through a
# known OPENCV camera (the principal point at the image center), written as
# a COLMAP folder; the JAX package on the CPU on the same folder
# (scripts/colmap_runner_reference.py, JAX 0.9.0): 32 of 32 registered,
# pose AUC@5 0.66694 (165 of 360 pairs valid), with the runner phase's slack
OPENCV_CAMERA = {"fx": 600.0, "fy": 606.0, "cx": 320.0, "cy": 240.0, "k1": -0.05, "k2": 0.01, "p1": 5e-4,
                 "p2": -3e-4}
COLMAP_REF_REGISTERED = 32
COLMAP_REF_AUC5 = 0.6669446383602917
OPENCV_EXPORT_TOL = 1e-3  # the exported distortion against OPENCV_CAMERA

# the runner_options phase: the runner phase's folder with the two-view and
# back-end options below (0.85 and 1e-5 are the values of the reference's
# tests/frontend/test_two_view.py; YAML reads 1e-5 as a string, 1.0e-5 as a
# float); the JAX package on the CPU with the same overrides
# (scripts/runner_options_reference.py, JAX 0.9.0): 32 of 32 registered,
# pose AUC@5 0.72535 (154 of 360 pairs valid), with the runner phase's slack
RUNNER_OPTIONS_REF_REGISTERED = 32
RUNNER_OPTIONS_REF_AUC5 = 0.7253539224853739
RUNNER_OPTIONS = [
    "scene_optimizer.two_view.homography_degeneracy_ratio=0.85",
    "scene_optimizer.two_view.indeterminacy_eig_ratio=1.0e-5",
    "scene_optimizer.two_view.ransac.scoring=lmeds",
    "scene_optimizer.mvo.triangulation_mode=RANSAC_TOPK_BASELINES",
    "scene_optimizer.mvo.run_view_graph_two_passes=false",
    "scene_optimizer.mvo.rotation.weight_by_inliers=false",
    "scene_optimizer.mvo.translation.mfas_uniform_sampling=false",
]
OPTIONS_CHECK_PAIRS = 16  # the card-against-CPU check of the first chunk's first pairs
OPTIONS_CHECK_MARGIN = 1e-3  # decisive ratios this close (relative) to a threshold are not held

# the ba_layouts phase: palace-281's camera count, BA_POINTS points on
# tracks of BA_TRACK_LEN views, 1 px noise, a perturbed start; every layout
# must bring the cost below BA_COST_RATIO of the initial, entry and scatter
# within BA_LAYOUT_GAP of dense; then one track seen by BA_LONG_TRACK
# cameras, which the dense layout cannot hold (128 at most)
BA_CAMERAS = 281
BA_POINTS = 20_000
BA_TRACK_LEN = (2, 15)
BA_COST_RATIO = 1e-2
BA_LAYOUT_GAP = 0.05
BA_LONG_TRACK = 200

# the deep_front_end and megaloc_sift phases: the runner with the deep
# configs on the runner phase's views and the seeded checkpoints of
# write_deep_weights, once for each of DEEP_SEEDS (scene_optimizer.seed).
# On these seeded nets the registered count, AUC@5 and valid pairs of both
# runners move with RANSAC's draws, in both packages (PERF.md section 6,
# PR 13), so each phase holds its medians over DEEP_SEEDS to the JAX
# package's medians over the seeds of DEEP_REFERENCE (written by
# scripts/deep_front_end_reference.py on the CPU: JAX 0.9.0, the same
# folder and weights, pair_batch_size 16) with the runner phase's slack,
# and DEEP_VALID_SLACK on the valid pairs. The seed does not move the front
# end: at least DEEP_PAIR_SHARE of the retrieved pairs must be the
# reference's (the card and XLA on the CPU order a near-tie of NetVLAD's
# similarities their own way: 1 of deep_front_end's 390 pairs in a first
# run; megaloc_sift's 213 were all equal), and on the common pairs each
# pair's match count (LightGlue's, or the matcher kernel's) within
# DEEP_MATCH_ABS + DEEP_MATCH_TOL of the reference's and their sum within
# DEEP_MATCH_TOTAL_TOL of it (sums of bf16 products in another order move
# the matches at the thresholds: in that run LightGlue's counts were 12
# apart at worst, of 499, and 25 of 204,916 in sum; the matcher kernel's
# 1 at worst, of 18, and 3 of 22,121)
DEEP_REFERENCE = "scripts/deep_front_end_reference.json"
DEEP_SEEDS = (0, 1, 2)
# the correspondence phase: colmap_front_end (run A) on a COLMAP model of
# CORR_GT_POINTS GT points (mvs_tracks) of the runner phase's 32 views, held
# to the JAX package's run (CORR_REFERENCE, from
# scripts/correspondence_reference.py on the CPU) with the runner phase's
# slack; skydio_front_end (LoFTR), mast3r and deep_front_end with SuperGlue
# (runs B-D) on seeded weights in the public layouts, recorded, and each
# generator on the card held on CORR_HOLD_PAIRS (the runs' first pairs) to
# the JAX package's outputs on the same weights and views (CORR_REFERENCE_NPZ)
CORR_REFERENCE = "scripts/correspondence_reference.json"
CORR_REFERENCE_NPZ = "scripts/correspondence_reference.npz"
CORR_GT_POINTS = 4000
CORR_HOLD_PAIRS = ((0, 1), (0, 2), (0, 3), (0, 4))
CORR_MATCH_SHARE = 0.99  # of the reference's matches identical, per generator
# LoFTR's refined coordinates of the common matches: at the published
# widths float32 order alone moves one of pair (0, 1)'s by 1.5e-3 px on the
# CPU (scripts/loftr_cpu_order.py prints it), over the CPU tests' 1e-3 at
# reduced widths
CORR_FINE_TOL_PX = 4e-3
LOFTR_COARSE_GAIN = 2.0  # loftr_fixture's coarse output gain
DEEP_VALID_SLACK = 0.05  # of the reference's median valid pairs
DEEP_PAIR_SHARE = 0.99
DEEP_MATCH_ABS = 2
DEEP_MATCH_TOL = 0.03
DEEP_MATCH_TOTAL_TOL = 0.005
LIGHTGLUE_HEADS = 4
GLUE_LAUNCHES_PER_FORWARD = 36  # 9 layers x (2 self entries + 1 cross entry of 2 launches)
DEEP_CPU_VIEWS = 4  # card against CPU: SuperPoint and MegaLoc on 4 views
DEEP_CPU_PAIRS = 4  # and LightGlue on 4 pairs
DEEP_COMPONENT_VIEWS = 2  # D2-Net, DISK and hloc NetVLAD on 2 views
# card against CPU: the share of each image's valid keypoints found on both
# (NMS ties, the top-K cut and D2-Net's equality tests on float32 features
# move with the order of the sums: 2 of D2-Net's 327 keypoints of one view
# in a first run on the card), and descriptor values (unit rows) to 4e-6:
# float32 order alone left 3.8e-8 to 8.8e-7 (SuperPoint, NetVLAD, MegaLoc,
# D2-Net, DISK, hloc NetVLAD), TF32 in cuDNN and matmuls 1.3e-5 (hloc
# NetVLAD) to 4.0e-4 (DISK); each check also runs with TF32 on
# (tf32_allowed), where it must fail
DEEP_KEYPOINT_SHARE = 0.98
DEEP_DESC_TOL = 4e-6
MATCHER_SUBSET = 32  # pairs of the megaloc_sift chunk held against the plain matcher

SPLAT_HW = (480, 640)  # the synthetic loader's default image size
SPLAT_FOCAL = 600.0  # and focal length
SPLAT_GAUSSIANS = 50_000  # GSTrainOptions.max_gaussians
SPLAT_POINTS = 12_500  # SfM points of the trainer phase: G = min(50,000, 4 * 12,500)
SPLAT_STEPS = 400  # trainer steps of the slice and the trainer phase (one densify, at 300)
SPLAT_L1_RATIO = 0.7  # the reference's trainer bar (tests/splat/test_splat.py:133)
COMPOSITE_TOL = 1e-5  # kernel vs plain where no tile stops early: float32 order only
# with the early stop: a tile stops once every pixel has T <= 1/255, and the
# skipped tail adds at most T * max(rgb) <= 1/255 to any output
COMPOSITE_TOL_STOP = 1.0 / 255.0 + 1e-5
# float32 operations per pixel and slot of the compositing function, counted
# from its plain version (splat/rendering.py composite_tiles_plain) and the
# reference's _composite_kernel (gtsfm_tpu/splat/rendering.py:420), not from
# any implementation, so the bound stays one yardstick: dx, dy 2; q 9;
# clamp 1; -q/2 1; exp 1; alpha * exp 1; min 1; cutoff select 1; w = a T 1;
# three color FMAs 6; 1 - a 1; T update 1
COMPOSITE_FLOPS = 26
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, float32
# outside them, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# calls per timed sample (_median_ms); the plain versions, at tens of ms a
# call, take one
TIMING_BATCH = 5

# the feedforward and vggt_full phases (the feed-forward cluster slots).
# The feedforward phase holds the port's runner with the vggt, fastvggt and
# anysplat --run_gs configs, on FF_VIEWS numpy-made views
# (feedforward_views) and the seeded compact model (feedforward_fixture),
# to the JAX package's runs in FEEDFORWARD_REFERENCE (written by
# scripts/feedforward_reference.py on the CPU, where the global block's
# scores over 32 views of 480x640 would take 24 GB); then it times all 32
# rendered views of the runner phase. The vggt_full phase holds VGGT at
# the public widths (VGGTOptions(), TrackOptions()) with its depth cut
# (VGGT_CHECK_DEPTH) on VGGT_CHECK_VIEWS views at the public 518-pixel
# width to the same file, then runs VGGT-1B at full depth through the
# runner on the 32 views.
FEEDFORWARD_REFERENCE = "scripts/feedforward_reference.json"
FF_VIEWS = 8
FF_SEED = 0
FF_GS_STEPS = 40  # the held anysplat --run_gs run's trainer steps (its L1: the first and the last 20)
# the timed anysplat --run_gs run's trainer steps on the 32 rendered views
# (the trainer's 400 steps with a densify run in the slice and splat phases)
FF_TIMED_GS_STEPS = 100
FF_NEAR_CELLS = (24, 48)  # feedforward_views' checkers, latitude x longitude
FF_FAR_CELLS = (36, 72)
FF_DEPTH_STEP = 16  # the depth held every 16 pixels (the compact patch)
FF_FEAT_STEP = 5  # the track features held every 5 patches, their first 16 channels
FF_FEAT_CHANNELS = 16
VGGT_CHECK_VIEWS = 2
VGGT_CHECK_HW = (392, 518)  # 480x640 at VGGT's public width, the height on the 14-pixel grid
VGGT_CHECK_FOCAL = SPLAT_FOCAL * 518.0 / 640.0
VGGT_CHECK_QUERIES = 64
VGGT_CHECK_DEPTH = {"depth": 2, "dino_depth": 2, "camera_trunk_depth": 1, "intermediate_layer_idx": (0, 0, 1, 1)}
VGGT_CHECK_TRACK_DEPTH = 2
VGGT_SEED = 0
# the feedforward phase's bars against the JAX package: forward values
# (poses, focal ratios, patch confidences, unit track features) to the
# aggregator tolerance of tests/frontend/test_vggt_exact.py, depth (an exp)
# relative to its depth tolerance; the post-BA initial cost relative (one
# set of tracks); the anysplat trainer's initial L1 relative
FF_TOL = 2e-4
FF_TOL_DEPTH = 5e-4
FF_COST_TOL = 1e-3
FF_TRACK_SLACK = 2  # feed-forward tracks: queries at the 0.5 and 0.6 thresholds may flip
FF_L1_TOL = 1e-2
# the vggt_full check: cameras and depth as the reference test's tolerances
# (relative); the tracker after 1 iteration as test_vggt_track_exact.py's
# (px, and visibility and confidence); after 4 iterations the seeded
# tracker amplifies float32 rounding 50-100 times an iteration (the port
# against the JAX package on the CPU: 3e-5, 1.6e-3, 0.23 and 0.67 px after
# iterations 1-4, visibility and confidence 7e-3 apart)
VGGT_TOL_CAM = 2e-4
VGGT_TOL_DEPTH = 5e-4
VGGT_TOL_TRACK_1 = 5e-3
VGGT_TOL_VIS_1 = 1e-4
VGGT_TOL_TRACK = 2.0
VGGT_TOL_VIS = 0.02
# the mvs phase: PlaneSweepMVS and PatchmatchNetMVS at MVSOptions() on
# the FF_VIEWS feedforward_views with GT poses and MVS_TRACKS GT tracks,
# held to scripts/mvs_reference.py's file (the JAX package on the CPU)
MVS_REFERENCE = "scripts/mvs_reference.npz"
MVS_TRACKS = 2000
MVS_SEED = 0  # mvs_tracks, pmnet_fixture and PatchmatchNetMVS's draw
MVS_DEPTH_STEP = 8  # depth maps held every 8 pixels
MVS_DEPTH_TOL = 1e-3  # relative, on >= MVS_DEPTH_SHARE of the held depths
MVS_DEPTH_SHARE = 0.99
MVS_RANGE_TOL = 1e-5  # the depth ranges, relative
MVS_COUNT_TOL = 0.01  # dense point counts, relative
# The plane sweep's argmax is a float32 rounding decision on this scene's
# flat checker cells (52% of the pixels: every plane scores ~0) and where a
# cell edge runs along the epipolar line (equal scores over many planes):
# there its depth is held only where the reference's confidence exceeds
# MVS_SWEEP_CONF (the pixels fusion keeps), its dense count to
# MVS_SWEEP_COUNT_TOL, and its median error against the analytic depth on
# those pixels to MVS_SWEEP_TRUTH_TOL of the reference's. On the CPU the
# port held 0.968 of those depths and its count was 3.3% above (a second
# rounding of the port's box filter: 0.965 and 3.8%).
MVS_SWEEP_CONF = 0.3
MVS_SWEEP_SHARE = 0.95
MVS_SWEEP_COUNT_TOL = 0.10
MVS_SWEEP_TRUTH_TOL = 0.01
MVS_BIG_HW = (960, 1280)  # one plane-sweep view timed alone at twice the fixture's size
# the bal phase: the public BAL Trafalgar-257 problem's counts, seeded
BAL_CAMERAS = 257
BAL_POINTS = 65_132
BAL_OBSERVATIONS = 225_911  # Trafalgar-257's; the seeded problem's is close
BAL_SEED = 0
BAL_NOISE_PX = 0.5
BAL_ROT_PERTURB = 0.01  # rad
BAL_SCALE_PERTURB = 0.01  # of the translations' and the points' RMS norm
BAL_COST_SLACK = 0.05  # the final cost <= (1 + slack) x the cost at the generating parameters


# ---------------------------------------------------------------------------
# the descriptor feed (numpy only)
# ---------------------------------------------------------------------------
def ring_pairs(n: int) -> np.ndarray:
    """(i, i+1..3) mod n as sorted unique (i1 < i2) pairs: 3n pairs."""
    ring = [(i, (i + k) % n) for i in range(n) for k in (1, 2, 3)]
    return np.asarray(sorted({(min(a, b), max(a, b)) for a, b in ring}), np.int32)


def descriptor_feed(
    R: np.ndarray,
    t: np.ndarray,
    focal: float,
    image_hw: tuple,
    num_points: int,
    dim: int = DESC_DIM,
    noise_px: float = 0.4,
    desc_sigma: float = 0.05,
    distractor_fraction: float = 0.1,
    seed: int = 0,
):
    """Keypoints and descriptors of a synthetic scene, per image.

    R (N, 3, 3), t (N, 3): camera-to-world GT poses; the calibration is a
    distortion-free Cal3Bundler with the principal point at the image
    center. ``num_points`` 3D points are sampled as frontend/synthetic.py
    samples them; keypoint k of every image is the projection of point k
    (0.4 px noise) and is masked in where the point is in view. Each point
    has one random unit descriptor; each view adds N(0, 0.05^2) per
    dimension and renormalizes. In each image a random 10% of the keypoints
    are distractors with fresh random descriptors.

    Returns kp_xy f32 (N, K, 2), kp_mask bool (N, K), descs f32 (N, K, D).
    """
    rng = np.random.default_rng(seed)
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    n = len(t)
    h, w = image_hw
    fwd = R[:, :, 2]
    target = (t + fwd * np.linalg.norm(np.ptp(t, 0)) * 0.8).mean(0)
    spread = max(np.ptp(t, axis=0).max() * 0.4, 1.0)
    pts = target + rng.uniform(-spread, spread, (num_points, 3))

    p_cam = np.einsum("nji,nkj->nki", R, pts[None] - t[:, None, :])  # R^T (X - t)
    z = p_cam[..., 2]
    z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    uv = focal * p_cam[..., :2] / z_safe[..., None] + np.array([w / 2.0, h / 2.0])
    kp_mask = (z > 1e-6) & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    uv = uv + rng.normal(0, noise_px, uv.shape)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    base = unit(rng.normal(size=(num_points, dim)))
    descs = unit(base[None] + desc_sigma * rng.normal(size=(n, num_points, dim)))
    n_dis = int(round(distractor_fraction * num_points))
    for i in range(n):
        idx = rng.permutation(num_points)[:n_dis]
        descs[i, idx] = unit(rng.normal(size=(n_dis, dim)))
    return uv.astype(np.float32), kp_mask, descs.astype(np.float32)


def glue_fixture(seed: int = 0, dim: int = 256, num_layers: int = 9, num_heads: int = 4,
                 input_dim: int = 256) -> dict:
    """A LightGlue state_dict in the official layout (numpy float32) that
    matches the descriptor feed: a test input, not a trained model.

    Every linear weight and bias is drawn as PyTorch's default nn.Linear
    init draws them (uniform +-1/sqrt(fan_in)) and posenc.Wr from N(0, 1),
    except: input_proj = alpha * I with alpha^2 = 200 (a descriptor's
    projection dominates the random residual updates), the last
    log_assignment head's final_proj = I (the assignment scores the
    transformed descriptors' similarity), its matchability weight 0 and
    bias +8 (every keypoint matchable), and LayerNorms at weight 1, bias 0.
    The attention still moves the assignment: the 9 random layers sit in
    the residual stream between the projection and the head."""
    rng = np.random.default_rng(seed)
    head_dim = dim // num_heads
    sd = {}

    def linear(key, fan_in, fan_out, bias=True):
        b = 1.0 / np.sqrt(fan_in)
        sd[f"{key}.weight"] = rng.uniform(-b, b, (fan_out, fan_in)).astype(np.float32)
        if bias:
            sd[f"{key}.bias"] = rng.uniform(-b, b, fan_out).astype(np.float32)

    def ffn(key):
        linear(f"{key}.0", 2 * dim, 2 * dim)
        sd[f"{key}.1.weight"] = np.ones(2 * dim, np.float32)
        sd[f"{key}.1.bias"] = np.zeros(2 * dim, np.float32)
        linear(f"{key}.3", 2 * dim, dim)

    sd["input_proj.weight"] = (np.sqrt(200.0) * np.eye(dim, input_dim)).astype(np.float32)
    sd["input_proj.bias"] = np.zeros(dim, np.float32)
    sd["posenc.Wr.weight"] = rng.normal(size=(head_dim // 2, 2)).astype(np.float32)
    for i in range(num_layers):
        sa, ca = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        linear(f"{sa}.Wqkv", dim, 3 * dim)
        linear(f"{sa}.out_proj", dim, dim)
        ffn(f"{sa}.ffn")
        for name in ("to_qk", "to_v", "to_out"):
            linear(f"{ca}.{name}", dim, dim)
        ffn(f"{ca}.ffn")
        la = f"log_assignment.{i}"
        if i < num_layers - 1:
            linear(f"{la}.matchability", dim, 1)
            linear(f"{la}.final_proj", dim, dim)
        else:
            sd[f"{la}.matchability.weight"] = np.zeros((1, dim), np.float32)
            sd[f"{la}.matchability.bias"] = np.full(1, 8.0, np.float32)
            sd[f"{la}.final_proj.weight"] = np.eye(dim, dtype=np.float32)
            sd[f"{la}.final_proj.bias"] = np.zeros(dim, np.float32)
    return sd


def superpoint_fixture(seed: int = 0) -> dict:
    """A SuperPoint state_dict in the MagicLeap layout (numpy float32) built
    to act as a detector and descriptor without training: a test input,
    not a trained model. PyTorch's default init gives every keypoint nearly
    the same descriptor (the ReLU features share one positive mean), so
    nothing matches; this one matches the runner's rendered views.

    Every layer carries each feature twice, as itself and its negative
    (2n channels for n features), so that the ReLU keeps its sign in one
    half or the other: conv1a holds 32 zero-mean random 3x3 filters and
    their negatives; every later 3x3 conv reads its input's features f =
    (first half) - (second half) over the 3x3 neighbourhood through a
    random Gaussian map (variance 1 / fan-in) and writes [g, -g]; convDb
    projects convDa's 128 features to 256 dimensions, convPb scores them
    into the 64 cell positions (gain 8) beside a zero dustbin. Every bias
    is 0. The net is then blind to a brightness offset and to contrast
    (the descriptors are unit rows) and odd in the image: its descriptors
    are random projections of a neighbourhood's structure."""
    from gtsfm_tpu_torch.frontend.detectors.superpoint import LAYERS

    rng = np.random.default_rng(seed)

    def signed(w):  # features (n_out, n_in, k, k) -> channels [g, -g] of inputs [f, -f]
        return np.concatenate([np.concatenate([w, -w], axis=1), np.concatenate([-w, w], axis=1)])

    def conv(n_in, n_out, k=3):
        return signed(rng.standard_normal((n_out, n_in, k, k)) / np.sqrt(n_in * k * k))

    f1 = rng.standard_normal((32, 1, 3, 3))
    f1 = (f1 - f1.mean(axis=(1, 2, 3), keepdims=True)) / 3.0
    w = {"conv1a": np.concatenate([f1, -f1]), "conv1b": conv(32, 32), "conv2a": conv(32, 32),
         "conv2b": conv(32, 32), "conv3a": conv(32, 64), "conv3b": conv(64, 64), "conv4a": conv(64, 64),
         "conv4b": conv(64, 64), "convDa": conv(64, 128)}
    w["convDb"] = signed(rng.standard_normal((256, 128, 1, 1)) / np.sqrt(128))[:256]
    w["convPa"] = conv(64, 128)
    score = rng.standard_normal((65, 128, 1, 1)) * (8.0 / np.sqrt(128))
    score[64] = 0.0
    w["convPb"] = signed(score)[:65]
    sd = {}
    for name in LAYERS:
        sd[f"{name}.weight"] = w[name].astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(w[name].shape[0], np.float32)
    return sd


def megaloc_fixture(seed: int = 0, options=None) -> dict:
    """A MegaLoc state_dict in the megaloc.torch layout (numpy float32) at
    ``options``' dims (MegaLocOptions() when None: ViT-B/14 at full width),
    with the reference's ``init_params`` scales: linear and 1x1 weights
    N(0, 1/fan_in), biases 0, norms and layer scales 1, the patch kernel,
    class token and position embedding N(0, 0.02^2), dustbin 1. A test
    input, not a trained model."""
    import torch

    from gtsfm_tpu_torch.frontend.global_descriptors.megaloc import MegaLocNet, MegaLocOptions

    rng = np.random.default_rng(seed)
    with torch.device("meta"):  # shapes without storage
        shapes = {k: tuple(v.shape) for k, v in MegaLocNet(options or MegaLocOptions()).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("bias"):
            sd[name] = np.zeros(shape, np.float32)
        elif "norm" in name or name.endswith("gamma") or name.endswith("dust_bin"):
            sd[name] = np.ones(shape, np.float32)
        elif name.endswith(("cls_token", "pos_embed", "patch_embed.proj.weight")):
            sd[name] = (rng.standard_normal(shape, np.float32) * 0.02).astype(np.float32)
        else:
            sd[name] = (rng.standard_normal(shape, np.float32) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
    return sd


def write_deep_weights(dirpath: str, names: tuple = ("superpoint", "lightglue", "megaloc")) -> dict:
    """Write the deep front end's seeded checkpoints named in ``names``
    under ``dirpath``: SuperPoint (``superpoint_fixture(0)``, the MagicLeap
    layout), LightGlue (``glue_fixture(0)``, the official layout) and
    MegaLoc (``megaloc_fixture(0)``, ViT-B/14 at full width, 915 MB).
    Returns {name: path, "sumsq": {name: the sum of the squares of the
    state_dict's values (float64)}, a checksum to print}."""
    import os

    import torch

    out = {"sumsq": {}}
    for name, fixture, file in (("superpoint", superpoint_fixture, "superpoint_v1.pth"),
                                ("lightglue", glue_fixture, "superpoint_lightglue.pth"),
                                ("megaloc", megaloc_fixture, "megaloc.torch")):
        if name not in names:
            continue
        sd = fixture(0)
        out[name] = os.path.join(dirpath, file)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, out[name])
        out["sumsq"][name] = float(sum(np.square(v, dtype=np.float64).sum() for v in sd.values()))
    return out


def _shapes(module_fn) -> dict:
    """A module's state_dict shapes, built on the meta device (no storage)."""
    import torch

    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in module_fn().state_dict().items()}


def _seeded_state(shapes: dict, rng, gain=lambda name: 1.0) -> dict:
    """Seeded numpy float32 values for a state_dict's shapes: weights
    N(0, gain(name)^2 / fan_in), biases 0, norm and BatchNorm weights and
    running variances 1, running means 0."""
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("num_batches_tracked"):
            sd[name] = np.zeros(shape, np.int64)
        elif name.endswith(("bias", "running_mean")):
            sd[name] = np.zeros(shape, np.float32)
        elif name.endswith("running_var") or (len(shape) == 1 and name.endswith("weight")):
            sd[name] = np.ones(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            sd[name] = (rng.standard_normal(shape, np.float32) * (gain(name) / np.sqrt(fan_in))).astype(np.float32)
    return sd


def _signed(w: np.ndarray) -> np.ndarray:
    """Features (n_out, n_in, ...) -> channels [g, -g] read from inputs
    [f, -f]: the map carries each feature with its negative, so that a
    ReLU keeps its sign in one half or the other (superpoint_fixture's
    construction)."""
    return np.concatenate([np.concatenate([w, -w], axis=1), np.concatenate([-w, w], axis=1)])


def loftr_fixture(seed: int = 0, coarse_gain: float = LOFTR_COARSE_GAIN) -> dict:
    """A LoFTR state_dict in the official outdoor_ds.ckpt layout (numpy,
    without the checkpoint's ``matcher.`` prefix) at the published widths
    (LoFTROptions()), built to match without training: a test input, not a
    trained model. The backbone is superpoint_fixture's signed net: conv1
    holds 64 zero-mean random 7x7 filters and their negatives, every later
    conv reads its input's features (first half minus second) through a
    random Gaussian map (variance 1 / fan-in) and writes [g, -g], so the
    features are random projections of the neighbourhood's structure with
    no common positive mean (PyTorch-style random ReLU features share one
    and collapse the dual softmax onto a single match); the coarse output
    conv has gain ``coarse_gain``. BatchNorms are at identity; the
    transformers' linear weights are N(0, 1/fan_in) with the MLP's
    LayerNorm at 0.1, so their updates leave the backbone's features in
    charge; fine_preprocess N(0, 1/fan_in)."""
    from gtsfm_tpu_torch.frontend.matchers.loftr import LoFTRNet

    rng = np.random.default_rng(seed)
    shapes = _shapes(LoFTRNet)
    sd = _seeded_state(shapes, rng)
    for name, shape in shapes.items():
        if name.startswith("backbone.") and len(shape) == 4:
            n_out, n_in, k, _ = shape
            if n_in == 1:
                f = rng.standard_normal((n_out // 2, 1, k, k))
                f -= f.mean(axis=(1, 2, 3), keepdims=True)
                w = np.concatenate([f, -f]) / k
            else:
                w = _signed(rng.standard_normal((n_out // 2, n_in // 2, k, k)) / np.sqrt(n_in // 2 * k * k))
            sd[name] = w.astype(np.float32)
        elif name.endswith("norm2.weight"):
            sd[name] = np.full(shape, 0.1, np.float32)
    sd["backbone.layer3_outconv.weight"] *= np.float32(coarse_gain)
    return sd


def superglue_fixture(seed: int = 0) -> dict:
    """A SuperGlue state_dict in the official superglue_outdoor.pth layout
    (numpy) at the published widths (SuperGlueOptions()), built to act as
    a matcher without training: the keypoint encoder's and every
    propagation MLP's last conv scaled by 0.1 (small residual updates of
    the descriptors), ``final_proj`` 30 I plus small noise (scores about
    56 cos between the descriptors: superpoint_fixture's best and second
    best cosines are about 0.05 apart) and a dustbin score of 40 (a row
    whose best cosine is below about 0.7 goes to the dustbin). A test
    input, not a trained model."""
    from gtsfm_tpu_torch.frontend.matchers.superglue import SuperGlueNet

    shapes = _shapes(SuperGlueNet)
    last = {"kenc.encoder.12.weight"} | {f"gnn.layers.{i}.mlp.3.weight" for i in range(18)}
    sd = _seeded_state(shapes, np.random.default_rng(seed),
                       lambda name: 0.1 if name in last or name == "final_proj.weight" else 1.0)
    sd["final_proj.weight"] += 30.0 * np.eye(shapes["final_proj.weight"][0], dtype=np.float32)[:, :, None]
    sd["bin_score"] = np.asarray(40.0, np.float32)
    return sd


def mast3r_fixture(seed: int = 0) -> dict:
    """A MASt3R state_dict in the public checkpoint's layout as the
    reference reads it (numpy; the DPT head left out) at the published
    widths (MASt3ROptions(): ViT-L encoder, base decoders, 24-d
    descriptors): weights N(0, 1/fan_in), biases 0, LayerNorms at
    identity. A test input, not a trained model; about 2.1 GB."""
    from gtsfm_tpu_torch.frontend.mast3r import MASt3RNet

    return _seeded_state(_shapes(MASt3RNet), np.random.default_rng(seed))


def write_correspondence_weights(dirpath: str, names: tuple = ("loftr", "superglue", "mast3r")) -> dict:
    """Write the correspondence phase's seeded checkpoints named in
    ``names`` under ``dirpath``, in the public files' layouts: LoFTR as
    outdoor_ds.ckpt ({"state_dict": ...} with ``matcher.`` prefixes),
    SuperGlue as superglue_outdoor.pth, MASt3R as
    MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth ({"model": ...}).
    Returns {name: path, "sumsq": {name: sum of squares (float64)}}."""
    import os

    import torch

    out = {"sumsq": {}}
    for name, fixture, file, wrap in (
            ("loftr", loftr_fixture, "outdoor_ds.ckpt", lambda sd: {"state_dict": {f"matcher.{k}": v
                                                                                    for k, v in sd.items()}}),
            ("superglue", superglue_fixture, "superglue_outdoor.pth", lambda sd: sd),
            ("mast3r", mast3r_fixture, "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth",
             lambda sd: {"model": sd})):
        if name not in names:
            continue
        sd = fixture(0)
        out[name] = os.path.join(dirpath, file)
        out["sumsq"][name] = float(sum(np.square(v, dtype=np.float64).sum() for v in sd.values()))
        torch.save(wrap({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}), out[name])
        del sd
    return out


def corr_hold_gray(views_rgb: np.ndarray) -> np.ndarray:
    """The correspondence phase's held views, (n, H, W, 3) uint8 as written
    to the Olsson folder, as the loader's gray images (the port's
    rgb_to_gray, the reference's copy)."""
    from gtsfm_tpu_torch.common.image import rgb_to_gray

    return np.stack([rgb_to_gray(v) for v in views_rgb])


def corr_glue_feed(R, t) -> tuple:
    """SuperGlue's held inputs: descriptor_feed of the ring cameras (R, t)
    (the first five in ring order: CORR_HOLD_PAIRS' views) at the runner
    phase's 480x640, f=600, K=2048, D=256. -> (kp_xy, kp_mask, descs) and
    the pair indices (i1, i2)."""
    xy, mask, desc = descriptor_feed(R, t, SPLAT_FOCAL, SPLAT_HW, GLUE_KEYPOINTS, dim=GLUE_DESC_DIM,
                                     desc_sigma=GLUE_SIGMA)
    i1, i2 = (np.asarray([p[k] for p in CORR_HOLD_PAIRS]) for k in (0, 1))
    return (xy, mask, desc), (i1, i2)


def corr_share(kind: str, got, want) -> dict:
    """How far the port's held correspondences are the reference's, for
    one pair. ``kind`` loftr: (uv1, uv2) with uv1 on the coarse grid, a
    match identical when uv1 is equal and uv2 in the same coarse cell (less
    than 4 px apart), and the fine uv2 of those apart by ``fine_err``;
    mast3r: (uv1, uv2) pixel pairs, identical when equal; superglue:
    (match_idx (K,), mask (K,)), identical rows with equal indices. Returns
    {"n_port", "n_ref", "common", "share" (common over the larger count),
    "fine_err"}."""
    fine = 0.0
    if kind == "superglue":
        (gi, gm), (wi, wm) = got, want
        common = int((gm & wm & (gi == wi)).sum())
        n_got, n_want = int(gm.sum()), int(wm.sum())
    elif kind == "mast3r":
        n_got, n_want = len(got[0]), len(want[0])
        common = len({tuple(a) + tuple(b) for a, b in zip(np.asarray(got[0]).tolist(), np.asarray(got[1]).tolist())}
                     & {tuple(a) + tuple(b) for a, b in zip(np.asarray(want[0]).tolist(),
                                                            np.asarray(want[1]).tolist())})
    else:
        g = {tuple(a): b for a, b in zip(np.asarray(got[0]).tolist(), np.asarray(got[1]))}
        w = {tuple(a): b for a, b in zip(np.asarray(want[0]).tolist(), np.asarray(want[1]))}
        n_got, n_want = len(got[0]), len(want[0])
        same = [k for k in w if k in g and np.abs(g[k] - w[k]).max() < 4.0]
        common = len(same)
        fine = max((float(np.abs(g[k] - w[k]).max()) for k in same), default=0.0)
    return {"n_port": n_got, "n_ref": n_want, "common": common,
            "share": common / max(n_got, n_want, 1), "fine_err": fine}


def deep_overrides(config_name: str, weights: dict) -> list:
    """The runner's overrides that give a config the seeded checkpoints of
    ``write_deep_weights`` (NetVLAD keeps its seeded init)."""
    if config_name == "deep_front_end":
        return [f"detector.weights_path={weights['superpoint']}", f"matcher.weights_path={weights['lightglue']}"]
    if config_name == "megaloc_sift_frontend":
        return [f"global_descriptor.weights_path={weights['megaloc']}"]
    return []


# ---------------------------------------------------------------------------
# the feed-forward phases' fixtures (numpy; VGGT's key layout is read off
# the port's module)
# ---------------------------------------------------------------------------


def feedforward_views(R, t, indices, hw: tuple = SPLAT_HW, focal: float = SPLAT_FOCAL,
                      seed: int = 0) -> np.ndarray:
    """Views of a seeded scene made by numpy alone, (n, H, W, 3) gray in
    [0.1, 0.9]: each ring camera's rays (camera-to-world R, center t, the
    principal point at the center of ``hw``) cast on a sphere of radius 4
    around the ring's center before an enclosing sphere of radius 40, each
    painted with a checker of gray cells (FF_NEAR_CELLS and FF_FAR_CELLS in
    latitude and longitude). Every pixel is one cell's level, so the 8-bit
    images are the same on any machine, whatever renders the runner's
    scene."""
    h, w = hw
    rng = np.random.default_rng(seed)
    tables = [rng.uniform(0.1, 0.9, cells) for cells in (FF_NEAR_CELLS, FF_FAR_CELLS)]
    center = np.asarray(t, np.float64).mean(axis=0)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(u - w / 2.0) / focal, (v - h / 2.0) / focal, np.ones_like(u)], axis=-1).reshape(-1, 3)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    out = []
    for i in indices:
        d = rays @ np.asarray(R[i], np.float64).T
        o = np.asarray(t[i], np.float64) - center
        b = d @ o
        gray = np.empty(len(d))
        hit = np.zeros(len(d), bool)
        for radius, table, near in ((4.0, tables[0], True), (40.0, tables[1], False)):
            disc = b * b - (o @ o - radius * radius)
            s = -b - np.sqrt(np.maximum(disc, 0.0)) if near else -b + np.sqrt(np.maximum(disc, 0.0))
            sel = ~hit & (disc >= 0) & (s > 0)
            p = o + s[sel, None] * d[sel]
            p /= np.linalg.norm(p, axis=1, keepdims=True)
            lat = np.minimum((np.arccos(np.clip(p[:, 2], -1.0, 1.0)) / np.pi * table.shape[0]).astype(int),
                             table.shape[0] - 1)
            lon = np.minimum(((np.arctan2(p[:, 1], p[:, 0]) + np.pi) / (2 * np.pi) * table.shape[1]).astype(int),
                             table.shape[1] - 1)
            gray[sel] = table[lat, lon]
            hit |= sel
        out.append(np.repeat(gray.reshape(h, w, 1), 3, axis=2).astype(np.float32))
    return np.stack(out)


def feedforward_depths(R, t, indices, hw: tuple = SPLAT_HW, focal: float = SPLAT_FOCAL) -> np.ndarray:
    """The analytic depth (camera z, float64) of every pixel of
    feedforward_views' views, (n, H, W): the same rays cast on the sphere
    of radius 4 and, past it, the enclosing one of radius 40."""
    h, w = hw
    center = np.asarray(t, np.float64).mean(axis=0)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(u - w / 2.0) / focal, (v - h / 2.0) / focal, np.ones_like(u)], axis=-1).reshape(-1, 3)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    out = []
    for i in indices:
        d = rays @ np.asarray(R[i], np.float64).T
        o = np.asarray(t[i], np.float64) - center
        b = d @ o
        dist = np.full(len(d), np.inf)
        for radius, near in ((4.0, True), (40.0, False)):
            disc = b * b - (o @ o - radius * radius)
            s = -b - np.sqrt(np.maximum(disc, 0.0)) if near else -b + np.sqrt(np.maximum(disc, 0.0))
            sel = np.isinf(dist) & (disc >= 0) & (s > 0)
            dist[sel] = s[sel]
        out.append((dist * rays[:, 2]).reshape(h, w))
    return np.stack(out)


def mvs_tracks(R, t, indices, n: int = MVS_TRACKS, hw: tuple = SPLAT_HW, focal: float = SPLAT_FOCAL,
               seed: int = MVS_SEED) -> list:
    """GT tracks of feedforward_views' scene for the views ``indices``:
    n seeded points, half on the sphere of radius 4 around the ring's
    center and half on the one of radius 40, each projected (exactly,
    float32) into the views that see it: in front, inside the image, and
    not hidden by the near sphere. -> [(xyz, [(view, uv), ...])] of the
    points seen by two views or more, views numbered in ``indices``."""
    h, w = hw
    rng = np.random.default_rng(seed)
    center = np.asarray(t, np.float64).mean(axis=0)
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = np.where(np.arange(n) < n // 2, 4.0, 40.0)
    X = center + radius[:, None] * dirs
    obs = [[] for _ in range(n)]
    for k, i in enumerate(indices):
        c = np.asarray(t[i], np.float64)
        p = (X - c) @ np.asarray(R[i], np.float64)  # camera frame
        z = np.maximum(p[:, 2], 1e-9)
        uv = focal * p[:, :2] / z[:, None] + np.array([w / 2.0, h / 2.0])
        seen = (p[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        # the near sphere hides its own far side and what lies behind it
        ray = X - c
        length = np.linalg.norm(ray, axis=1)
        d = ray / length[:, None]
        o = c - center
        b = d @ o
        disc = b * b - (o @ o - 16.0)
        s = -b - np.sqrt(np.maximum(disc, 0.0))
        seen &= ~((disc >= 0) & (s > 0) & (s < length - 1e-6))
        for j in np.flatnonzero(seen):
            obs[j].append((k, uv[j].astype(np.float32)))
    return [(X[j].astype(np.float32), o) for j, o in enumerate(obs) if len(o) >= 2]


def bal_problem(path: str, perturbed: bool, seed: int = BAL_SEED) -> dict:
    """A seeded BAL problem at the public Trafalgar-257 problem's counts
    (BAL_CAMERAS cameras, BAL_POINTS points, about BAL_OBSERVATIONS
    observations), written at ``path`` in tests/io/test_bal.py's
    convention (cameras look down -z, p = -P / P.z, f (1 + k1 r^2 + k2
    r^4) p): cameras on a circle of radius 30 at heights 1-3 looking at
    its center, f 800 + N(0, 50^2), k1 N(0, 0.01^2), k2 N(0, 0.001^2);
    points in a cylinder of radius 15 and height 10, each seen by 2 +
    Poisson(1.47) of the cameras where it projects within |p| < 0.6;
    BAL_NOISE_PX pixel noise. With ``perturbed`` the cameras and points
    are written moved from the truth (the observations stay): each
    rotation by BAL_ROT_PERTURB rad about a random axis, translations and
    points by N(0, (BAL_SCALE_PERTURB s)^2) with s their RMS norm. Returns
    the counts."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    n_cam, n_pts = BAL_CAMERAS, BAL_POINTS
    ang = rng.uniform(0, 2 * np.pi, n_cam)
    centers = np.stack([30 * np.cos(ang), 30 * np.sin(ang), rng.uniform(1, 3, n_cam)], 1)
    R_cw = np.zeros((n_cam, 3, 3))
    for i, c in enumerate(centers):  # +z looking at a point near the center
        zc = rng.normal(0, 1.0, 3) * [1, 1, 0.2] + [0, 0, 3] - c
        zc /= np.linalg.norm(zc)
        xc = np.cross(zc, [0.0, 0.0, 1.0])
        xc /= np.linalg.norm(xc)
        R_cw[i] = np.stack([xc, np.cross(zc, xc), zc])  # rows: the camera axes
    t_cw = -np.einsum("nij,nj->ni", R_cw, centers)
    F = np.diag([1.0, -1.0, -1.0])
    R_bal, t_bal = F @ R_cw, t_cw @ F
    f = 800.0 + rng.normal(0, 50, n_cam)
    k1, k2 = rng.normal(0, 0.01, n_cam), rng.normal(0, 0.001, n_cam)
    r = 15 * np.sqrt(rng.uniform(0, 1, n_pts))
    a = rng.uniform(0, 2 * np.pi, n_pts)
    X = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(0, 10, n_pts)], 1)
    want = 2 + rng.poisson(1.47, n_pts)
    cams, pts = [], []
    for s in range(0, n_pts, 4096):  # the cameras that see each point, in chunks of points
        P = np.einsum("nij,pj->pni", R_bal, X[s : s + 4096]) + t_bal
        p = -P[..., :2] / P[..., 2:]
        ok = (P[..., 2] < -0.1) & (np.linalg.norm(p, axis=-1) < 0.6)
        for q in range(ok.shape[0]):
            cand = np.flatnonzero(ok[q])
            pick = rng.choice(cand, size=min(want[s + q], len(cand)), replace=False) if len(cand) >= 2 else []
            cams += sorted(pick)
            pts += [s + q] * len(pick)
    cams, pts = np.asarray(cams), np.asarray(pts)
    P = np.einsum("nij,nj->ni", R_bal[cams], X[pts]) + t_bal[cams]
    p = -P[:, :2] / P[:, 2:]
    r2 = np.sum(p * p, axis=1)
    uv = (f[cams] * (1 + k1[cams] * r2 + k2[cams] * r2 * r2))[:, None] * p + rng.normal(0, BAL_NOISE_PX, (len(p), 2))
    w_bal = Rotation.from_matrix(R_bal).as_rotvec()
    if perturbed:
        axis = rng.standard_normal((n_cam, 3))
        axis *= BAL_ROT_PERTURB / np.linalg.norm(axis, axis=1, keepdims=True)
        w_bal = (Rotation.from_rotvec(axis) * Rotation.from_rotvec(w_bal)).as_rotvec()
        t_bal = t_bal + rng.normal(0, BAL_SCALE_PERTURB * np.sqrt(np.mean(np.sum(t_bal**2, 1))), t_bal.shape)
        X = X + rng.normal(0, BAL_SCALE_PERTURB * np.sqrt(np.mean(np.sum(X**2, 1))), X.shape)
    order = np.lexsort((cams, pts))  # BAL lists observations by point
    lines = [f"{n_cam} {n_pts} {len(cams)}"]
    lines += [f"{c} {q} {u:.6f} {v:.6f}" for c, q, (u, v) in zip(cams[order], pts[order], uv[order])]
    cam_rows = np.concatenate([w_bal, t_bal, f[:, None], k1[:, None], k2[:, None]], 1)
    lines += [f"{x:.12g}" for x in cam_rows.ravel()] + [f"{x:.12g}" for x in X.ravel()]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {"cameras": n_cam, "points": n_pts, "observations": len(cams)}


def feedforward_fixture(seed: int = 0, hw: tuple = SPLAT_HW, stride: int = 1) -> dict:
    """The compact FeedforwardNet's params at its default widths (dim 256,
    6 layer pairs, 4 heads, patch 16, track width 64) for frames of ``hw``,
    in the reference's Flax layout (numpy float32; with ``stride`` > 1 the
    FastVGGT global blocks): Dense and conv kernels N(0, 1/fan_in), biases,
    LayerNorm offsets and the three embeddings N(0, 0.02^2), LayerNorm
    scales 1 + N(0, 0.02^2); then two heads are set so that the slots'
    whole path runs: the depth head's kernel scaled by 0.1 and its bias
    raised by log 10 (depths near 10, where the unscaled head spans 1e-3
    to 1e3), the confidence head's bias raised by 1.3 (about half the
    patches pass the slots' 0.5, where 5% of them would)."""
    rng = np.random.default_rng(seed)
    D, P, depth = 256, 16, 6

    def normal(shape, sd):
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    def dense(cin, cout):
        return {"kernel": normal((cin, cout), cin**-0.5), "bias": normal((cout,), 0.02)}

    def norm():
        return {"scale": 1.0 + normal((D,), 0.02), "bias": normal((D,), 0.02)}

    def block(fast: bool):
        attn = ({"q": dense(D, D), "kv": dense(D, 2 * D), "proj": dense(D, D)} if fast
                else {"qkv": dense(D, 3 * D), "proj": dense(D, D)})
        p = {f"LayerNorm_{i}": norm() for i in range(3 if fast else 2)}
        return {**p, "attn": attn, "Dense_0": dense(D, 4 * D), "Dense_1": dense(4 * D, D)}

    params = {"patch_embed": {"kernel": normal((P, P, 1, D), P**-1.0), "bias": normal((D,), 0.02)},
              "pos_embed": normal((1, (hw[0] // P) * (hw[1] // P), D), 0.02),
              "camera_token": normal((1, 1, D), 0.02), "frame_embed": normal((32, D), 0.02)}
    for i in range(depth):
        params[f"frame_{i}"] = block(False)
        params[f"global_{i}"] = block(stride > 1)
    for name, cout in (("pose_head", 7), ("depth_head", P * P), ("conf_head", 1), ("track_head", 64)):
        params[name] = dense(D, cout)
    params["depth_head"]["kernel"] *= 0.1
    params["depth_head"]["bias"] += np.float32(np.log(10.0))
    params["conf_head"]["bias"] += np.float32(1.3)
    return params


def vggt_fixture(seed: int = 0, options=None, track_options=None) -> dict:
    """A state_dict (numpy float32) in the public facebook/VGGT-1B layout:
    the port's VGGTNet at ``options`` (VGGTOptions() with the public camera
    trunk, which has no qk norm, by default) with the point head and a
    track head at ``track_options`` (TrackOptions()), its keys and shapes
    read off the module on the meta device. Weights, tokens and embeddings
    N(0, 0.02^2), biases N(0, 0.02^2), norm scales 1 + N(0, 0.02^2),
    LayerScales 0.01 (the public init), the virtual tracks N(0, 1); drawn
    in the state_dict's key order."""
    import torch

    from gtsfm_tpu_torch.frontend.vggt import VGGTNet, VGGTOptions
    from gtsfm_tpu_torch.frontend.vggt_track import TrackOptions

    options = options or VGGTOptions(camera_qk_norm=False)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in VGGTNet(options, track_options or TrackOptions(),
                                                        point_head=True).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        parts = k.split(".")
        leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
        if leaf == "gamma":
            sd[k] = np.full(shape, 0.01, np.float32)
            continue
        v = rng.standard_normal(shape, dtype=np.float32)
        if k.endswith("virual_tracks"):
            sd[k] = v
        elif leaf == "weight" and "norm" in parent:
            sd[k] = 1.0 + 0.02 * v
        else:
            v *= 0.02
            sd[k] = v
    return sd


def ff_forward_record(R, t, focal, depth, conf, track_feat) -> dict:
    """The values of one compact forward (numpy) that the feedforward phase
    holds: the poses, focal ratios and patch confidences, the depth at the
    center of every FF_DEPTH_STEP-pixel cell, the track features of every
    FF_FEAT_STEP-th patch (their first FF_FEAT_CHANNELS channels)."""
    s, f = FF_DEPTH_STEP, FF_FEAT_STEP
    out = {"R": R, "t": t, "focal": focal, "depth": depth[:, s // 2 :: s, s // 2 :: s], "conf": conf,
           "track_feat": track_feat[:, ::f, ::f, :FF_FEAT_CHANNELS]}
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def vggt_check_options():
    """The vggt_full check's VGGT and track options: the public widths, the
    public camera trunk, the depth cut by VGGT_CHECK_DEPTH."""
    from gtsfm_tpu_torch.frontend.vggt import VGGTOptions
    from gtsfm_tpu_torch.frontend.vggt_track import TrackOptions

    return VGGTOptions(camera_qk_norm=False, **VGGT_CHECK_DEPTH), TrackOptions(depth=VGGT_CHECK_TRACK_DEPTH)


def vggt_check_inputs(R, t) -> tuple:
    """The vggt_full check's images, (VGGT_CHECK_VIEWS, 392, 518, 3): the
    first ring views by feedforward_views at VGGT_CHECK_HW, and its
    VGGT_CHECK_QUERIES seeded query points (pixel xy of frame 0)."""
    order = ring_order(t)[:VGGT_CHECK_VIEWS]
    images = feedforward_views(R, t, order, hw=VGGT_CHECK_HW, focal=VGGT_CHECK_FOCAL)
    h, w = VGGT_CHECK_HW
    qp = np.random.default_rng(VGGT_SEED).uniform((4.0, 4.0), (w - 4.0, h - 4.0), (VGGT_CHECK_QUERIES, 2))
    return images, qp.astype(np.float32)


def vggt_check_record(run: dict, track_1: dict, track: dict) -> dict:
    """The values of the check's forward and track head (numpy) that are
    held: cameras, the depth and its confidence at the patch centers and
    their sums, and the tracks, visibility and confidence after one
    iteration of the tracker (``track_1``) and after its 4 (``track``)."""
    s = 14
    out = {"extrinsic": run["extrinsic"], "intrinsic": run["intrinsic"],
           "depth": run["depth"][:, s // 2 :: s, s // 2 :: s],
           "depth_conf": run["depth_conf"][:, s // 2 :: s, s // 2 :: s],
           "depth_sum": np.sum(run["depth"], dtype=np.float64), "conf_sum": np.sum(run["depth_conf"], dtype=np.float64),
           "tracks_1": track_1["tracks"], "vis_1": track_1["vis"], "track_conf_1": track_1["conf"],
           "tracks": track["tracks"], "vis": track["vis"], "track_conf": track["conf"]}
    return {k: np.asarray(v) for k, v in out.items()}


def vggt_track_iters(model, images, qp, iters: int) -> dict:
    """The port's track head after ``iters`` iterations of its tracker
    (``VGGTModel.track`` runs the options' 4), numpy."""
    import torch

    from gtsfm_tpu_torch.frontend.vggt_track import track_options_from_state_dict
    from gtsfm_tpu_torch.utils.numerics import precise

    x = torch.as_tensor(images, device=model.device).permute(0, 3, 1, 2)
    with torch.no_grad(), precise():
        outputs, ps = model.net.aggregator(x, keep=model.net.heads_layers())
        coords, vis, conf = model.net.track_head(outputs, ps, x.shape[2:], torch.as_tensor(qp, device=model.device),
                                                 track_options_from_state_dict(model.net.state_dict()), iters=iters)
    return {"tracks": coords[-1].cpu().numpy(), "vis": vis.cpu().numpy(), "conf": conf.cpu().numpy()}


def write_vggt_weights(path: str, seed: int = 0, options=None, track_options=None) -> float:
    """``vggt_fixture`` saved as a torch checkpoint at ``path``; returns the
    sum of the squares of its values (float64), a checksum to print."""
    import torch

    sd = vggt_fixture(seed, options, track_options)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return float(sum(np.square(v, dtype=np.float64).sum() for v in sd.values()))


def pmnet_fixture(seed: int = 0) -> dict:
    """A PatchmatchNet state_dict (numpy; ``num_batches_tracked`` int64) in
    the official model_000007.ckpt layout, its keys and shapes read off the
    port's module: convolution kernels N(0, 2 / fan_in), biases
    N(0, 0.01^2), the offset convolutions (propa_conv, eval_conv; zero in
    the official init) N(0, (0.1 / fan_in)^2), so that the learned offsets
    move samples by about a tenth of a pixel; BatchNorm weights
    1 + N(0, 0.1^2), biases N(0, 0.1^2), running means U(-0.2, 0.2) and
    variances U(0.5, 2); drawn in the state_dict's key order."""
    import torch

    from gtsfm_tpu_torch.densify.patchmatchnet import PatchmatchNet

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in PatchmatchNet().state_dict().items():
        shape, leaf, parent = tuple(v.shape), k.split(".")[-1], k.split(".")[-2]
        if leaf == "num_batches_tracked":
            sd[k] = np.zeros((), np.int64)
        elif parent == "bn":
            sd[k] = {"weight": lambda: 1.0 + 0.1 * rng.standard_normal(shape),
                     "bias": lambda: 0.1 * rng.standard_normal(shape),
                     "running_mean": lambda: rng.uniform(-0.2, 0.2, shape),
                     "running_var": lambda: rng.uniform(0.5, 2.0, shape)}[leaf]().astype(np.float32)
        elif leaf == "bias":
            sd[k] = (0.01 * rng.standard_normal(shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            sd_w = 0.1 / fan_in if parent in ("propa_conv", "eval_conv") else (2.0 / fan_in) ** 0.5
            sd[k] = (sd_w * rng.standard_normal(shape)).astype(np.float32)
    return sd


def write_mvs_weights(path: str, seed: int = 0) -> float:
    """``pmnet_fixture`` saved as the official checkpoint is saved: a dict
    whose "model" holds the state_dict with DataParallel's ``module.``
    prefix. Returns the sum of the squares of its values (float64)."""
    import torch

    sd = pmnet_fixture(seed)
    torch.save({"epoch": 7, "model": {f"module.{k}": torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
    return float(sum(np.square(v, dtype=np.float64).sum() for v in sd.values()))


def splat_scene(center, n: int = SPLAT_GAUSSIANS, radius: float = 8.0, seed: int = 0) -> dict:
    """GSData fields (numpy float32; alive bool) of a seeded scene: n
    gaussians uniform in a ball of ``radius`` around ``center``, random
    orientations, per-axis scales 0.04-0.12, opacities from normal logits
    (about 70% mean opacity), and colors that vary smoothly with position
    (a wavelength of about 6 units per channel, plus a little noise), so a
    quarter of the means as SfM points can learn the views."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = np.asarray(center, np.float64) + d * radius * rng.random((n, 1)) ** (1.0 / 3.0)
    return {
        "means": means.astype(np.float32),
        "log_scales": np.log(rng.uniform(0.04, 0.12, (n, 3))).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logit": rng.normal(1.0, 1.0, n).astype(np.float32),
        "colors": (2.5 * np.sin((means - np.asarray(center)) @ rng.normal(0, 1.0, (3, 3)) + rng.uniform(0, 6.3, 3))
                   + rng.normal(0.0, 0.3, (n, 3))).astype(np.float32),
        "alive": np.ones(n, bool),
    }


def _mosaic_shell(rng, n: int, radius: float, cells: int, scales: tuple):
    """n gaussians on a sphere of ``radius`` around the origin, each with the
    gray level (a color logit in [-4, 4]) of the nearest of ``cells`` random
    sites on the sphere: a mosaic of gray patches. Returns (positions,
    levels, log scales)."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sites = rng.normal(size=(cells, 3))
    sites /= np.linalg.norm(sites, axis=1, keepdims=True)
    level = rng.uniform(-4.0, 4.0, cells)
    # the nearest site, over slices of 4096 gaussians
    gray = np.concatenate([level[np.argmax(d[s : s + 4096] @ sites.T, axis=1)] for s in range(0, n, 4096)])
    return d * radius, gray, np.log(rng.uniform(*scales, (n, 3)))


def runner_scene(center, n: int = SPLAT_GAUSSIANS, seed: int = 0) -> dict:
    """GSData fields (numpy float32; alive bool) of a seeded scene for the
    runner phase, nearly opaque gaussians painted with gray mosaics: half
    on a sphere of radius 4 around ``center`` (3,000 patches, scales
    0.04-0.1), half on an enclosing backdrop sphere of radius 40 (4,000
    patches, scales 0.3-0.6), plus a little color noise. Seen from the ring
    (radius 20), the backdrop fills the frame far away and the small sphere
    stands in front of it: corners and blobs that DoG-SIFT finds again from
    ring cameras up to 45 degrees apart, at depths from 16 to 60, which
    hold the two-view rotation."""
    rng = np.random.default_rng(seed)
    near = _mosaic_shell(rng, n // 2, 4.0, 3000, (0.04, 0.1))
    far = _mosaic_shell(rng, n - n // 2, 40.0, 4000, (0.3, 0.6))
    pos, gray, log_scales = (np.concatenate(x) for x in zip(near, far))
    return {
        "means": (np.asarray(center, np.float64) + pos).astype(np.float32),
        "log_scales": log_scales.astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logit": np.full(n, 4.0, np.float32),
        "colors": (gray[:, None] + rng.normal(0.0, 0.2, (n, 3))).astype(np.float32),
        "alive": np.ones(n, bool),
    }


def opencv_distort(x: np.ndarray, y: np.ndarray, cam: dict) -> tuple:
    """OpenCV's radial-tangential model (k1, k2, p1, p2) on normalized
    coordinates, float64."""
    r2 = x * x + y * y
    g = 1.0 + cam["k1"] * r2 + cam["k2"] * r2 * r2
    return (g * x + 2.0 * cam["p1"] * x * y + cam["p2"] * (r2 + 2.0 * x * x),
            g * y + cam["p1"] * (r2 + 2.0 * y * y) + 2.0 * cam["p2"] * x * y)


def opencv_undistort(xd: np.ndarray, yd: np.ndarray, cam: dict, iters: int = 8) -> tuple:
    """The inverse of opencv_distort by Newton's method on the 2x2 system
    (float64, from the distorted point): independent of the port's
    fixed-point ``Cal3DS2.calibrate``."""
    k1, k2, p1, p2 = cam["k1"], cam["k2"], cam["p1"], cam["p2"]
    x, y = xd.astype(np.float64), yd.astype(np.float64)
    for _ in range(iters):
        fx, fy = opencv_distort(x, y, cam)
        ex, ey = fx - xd, fy - yd
        r2 = x * x + y * y
        g = 1.0 + k1 * r2 + k2 * r2 * r2
        gp2 = 2.0 * (k1 + 2.0 * k2 * r2)
        a = g + gp2 * x * x + 2.0 * p1 * y + 6.0 * p2 * x
        b = gp2 * x * y + 2.0 * p1 * x + 2.0 * p2 * y
        d = g + gp2 * y * y + 6.0 * p1 * y + 2.0 * p2 * x
        det = a * d - b * b
        x, y = x - (d * ex - b * ey) / det, y - (a * ey - b * ex) / det
    return x, y


def resample_opencv(view: np.ndarray, focal: float, cam: dict) -> np.ndarray:
    """A view (H, W, 3) of a distortion-free camera (``focal``, principal
    point at the image center) as the OPENCV camera ``cam`` sees it: each
    output pixel's normalized point (undistorted by opencv_undistort) read
    bilinearly from the view."""
    from scipy import ndimage

    h, w = view.shape[:2]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = opencv_undistort((u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"], cam)
    coords = [focal * y + h / 2.0, focal * x + w / 2.0]
    return np.stack([ndimage.map_coordinates(view[..., c].astype(np.float64), coords, order=1, mode="nearest")
                     for c in range(view.shape[2])], -1).astype(np.float32)


def write_colmap_opencv(dirpath: str, views: np.ndarray, R, t, cam: dict) -> None:
    """A COLMAP text folder: views (n, H, W, 3) in [0, 1] as
    images/%02d.png (8-bit RGB), cameras.txt with one OPENCV camera
    ``cam`` that every image shares, and images.txt with the GT poses
    (camera-to-world (R_i, t_i) written as COLMAP's world-to-camera
    quaternion and translation) and empty point lists."""
    import os

    from PIL import Image

    from gtsfm_tpu_torch.io.colmap import _rotmat_to_quat_np

    h, w = views.shape[1:3]
    os.makedirs(os.path.join(dirpath, "images"), exist_ok=True)
    with open(os.path.join(dirpath, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"1 OPENCV {w} {h} " + " ".join(repr(float(cam[k])) for k in
                                                ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")) + "\n")
    lines = ["# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME", "# POINTS2D[] as (X, Y, POINT3D_ID)"]
    for i, v in enumerate(views):
        Image.fromarray(np.round(np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint8)).save(
            os.path.join(dirpath, "images", f"{i:02d}.png"))
        Rc = np.asarray(R[i], np.float64).T  # world to camera
        tc = -Rc @ np.asarray(t[i], np.float64)
        q = _rotmat_to_quat_np(Rc)
        lines += [f"{i + 1} " + " ".join(repr(float(a)) for a in (*q, *tc)) + f" 1 {i:02d}.png", ""]
    with open(os.path.join(dirpath, "images.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_colmap_tracks(dirpath: str, R, t, tracks: list, hw: tuple = SPLAT_HW, focal: float = SPLAT_FOCAL) -> None:
    """A COLMAP text model by the port's writer: the cameras (R_i, t_i),
    camera-to-world, as images %02d.png with one RADIAL camera of ``focal``
    each (no distortion, the principal point at the center of ``hw``), and
    ``tracks`` [(xyz, [(view, uv), ...])] (mvs_tracks' output) as the
    points: the colmap_front_end config's replay input."""
    import torch

    from gtsfm_tpu_torch.common.sfm_data import SceneMeta, SfmData
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
    from gtsfm_tpu_torch.io import colmap

    n = len(R)
    h, w = hw
    cal = Cal3Bundler.create(np.full(n, focal, np.float32), 0.0, 0.0, w / 2.0, h / 2.0)
    meta = SceneMeta(image_names=[f"{i:02d}.png" for i in range(n)], image_sizes=[(w, h)] * n)
    data = SfmData.from_cameras_and_tracks(SE3(R=torch.as_tensor(np.asarray(R, np.float32)),
                                               t=torch.as_tensor(np.asarray(t, np.float32))),
                                           cal, tracks, num_cameras=n, meta=meta)
    colmap.write_scene(data, dirpath)


def ba_scene(n_cams: int = BA_CAMERAS, n_points: int = BA_POINTS, track_len: tuple = BA_TRACK_LEN,
             noise_px: float = 1.0, long_track: int = 0, seed: int = 0) -> dict:
    """A seeded bundle-adjustment problem (numpy): n_cams cameras on a ring
    of radius 10 looking at its center (f = 600, 480x640, principal point
    at the center), n_points points in [-2, 2]^3, each seen by a run of
    consecutive ring cameras of a length drawn from ``track_len``, plus one
    point seen by the first ``long_track`` cameras; ``noise_px`` Gaussian
    pixel noise. The start: cameras 0 and 1 at the truth (the gauge), the
    others rotated by N(0, 0.01 rad) and moved by N(0, 0.1), the points
    moved by N(0, 0.1). Returns R0, t0, points0, meas_cam, meas_track,
    meas_uv and the truth R, t, points."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack([10 * np.cos(ang), 10 * np.sin(ang), np.zeros(n_cams)], 1)
    z = -centers / 10.0
    x = np.stack([-z[:, 1], z[:, 0], np.zeros(n_cams)], 1)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], 2)  # columns: the camera axes in the world
    X = rng.uniform(-2, 2, (n_points + (1 if long_track else 0), 3))
    lens = rng.integers(track_len[0], track_len[1] + 1, n_points)
    start = rng.integers(0, n_cams, n_points)
    meas_track = np.repeat(np.arange(n_points), lens)
    meas_cam = (np.repeat(start, lens) + np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)) % n_cams
    if long_track:
        meas_track = np.concatenate([meas_track, np.full(long_track, n_points)])
        meas_cam = np.concatenate([meas_cam, np.arange(long_track)])
    pc = np.einsum("mji,mj->mi", R[meas_cam], X[meas_track] - centers[meas_cam])
    uv = 600.0 * pc[:, :2] / pc[:, 2:] + np.array([320.0, 240.0]) + rng.normal(0, noise_px, (len(pc), 2))
    w = rng.normal(0, 0.01, (n_cams, 3))
    w[:2] = 0
    W = np.zeros((n_cams, 3, 3))
    W[:, 0, 1], W[:, 0, 2], W[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    W = W - W.transpose(0, 2, 1)
    th = np.linalg.norm(w, axis=1)[:, None, None]
    th_safe = np.where(th < 1e-12, 1.0, th)
    E = np.eye(3) + np.sin(th) / th_safe * W + (1 - np.cos(th)) / th_safe**2 * (W @ W)
    dt = rng.normal(0, 0.1, (n_cams, 3))
    dt[:2] = 0
    return {"R0": (R @ E).astype(np.float32), "t0": (centers + dt).astype(np.float32),
            "points0": (X + rng.normal(0, 0.1, X.shape)).astype(np.float32), "meas_cam": meas_cam,
            "meas_track": meas_track, "meas_uv": uv.astype(np.float32), "R": R, "t": centers, "points": X}


def ba_sfm_data(scene: dict, dev):
    """The port's SfmData of a ba_scene on ``dev`` (Cal3Bundler f = 600)."""
    import torch

    from gtsfm_tpu_torch.common.sfm_data import SfmData
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler

    n, T, M = len(scene["t0"]), len(scene["points0"]), len(scene["meas_cam"])
    z = torch.zeros(n)
    return SfmData(
        poses=SE3(R=torch.as_tensor(scene["R0"], device=dev), t=torch.as_tensor(scene["t0"], device=dev)),
        cal=Cal3Bundler.create(torch.full((n,), 600.0), z, z, torch.full((n,), 320.0), torch.full((n,), 240.0),
                               device=dev),
        pose_mask=torch.ones(n, dtype=torch.bool, device=dev),
        points=torch.as_tensor(scene["points0"], device=dev),
        track_mask=torch.ones(T, dtype=torch.bool, device=dev),
        meas_cam=torch.as_tensor(scene["meas_cam"], dtype=torch.int64, device=dev),
        meas_track=torch.as_tensor(scene["meas_track"], dtype=torch.int64, device=dev),
        meas_uv=torch.as_tensor(scene["meas_uv"], device=dev),
        meas_mask=torch.ones(M, dtype=torch.bool, device=dev),
    )


def rotation_error_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle of Ra^T Rb per rotation, in degrees, from float64 atan2 of the
    skew part and the trace (an arccos of the trace resolves no angle below
    about 0.02 deg from float32 matrices)."""
    M = np.einsum("nji,njk->nik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.degrees(np.arctan2(0.5 * np.linalg.norm(v, axis=-1), 0.5 * (np.trace(M, axis1=1, axis2=2) - 1.0)))


class FeedDetector:
    """Detector-slot stub (detect_batch(images) -> (kp_xy, kp_mask, descs))
    handing out the feed's per-image arrays in call order."""

    def __init__(self, kp_xy, kp_mask, descs):
        self.kp_xy, self.kp_mask, self.descs = kp_xy, kp_mask, descs
        self.max_keypoints = kp_xy.shape[1]
        self._next = 0

    def detect_batch(self, images):
        s = self._next
        self._next += images.shape[0]
        e = self._next
        return self.kp_xy[s:e], self.kp_mask[s:e], self.descs[s:e]


class FixedPairs:
    """Retriever returning a fixed pair list."""

    def __init__(self, pairs):
        self.pairs = pairs

    def get_image_pairs(self, num_images, global_descriptors=None, loader=None):
        return self.pairs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device found; this script runs the port on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    from gtsfm_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build(verbose=True)
    print(f"build: {', '.join(f'{n}.cu' for n in logs)} in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in logs.items():
        regs = " ".join(line.strip() for line in log.splitlines() if "registers" in line)
        print(f"build {name}.cu: {regs}", flush=True)


def _median_ms(fn, reps: int = 20, batch: int = TIMING_BATCH) -> float:
    """Device ms of one call of fn: the median over ``reps`` samples, each
    CUDA events around ``batch`` calls back to back (so the host's work
    between calls overlaps the device's), divided by ``batch``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def kernel_agrees(got, want, desc1, desc2, mask1, mask2):
    """Hold the kernel's (idx, ok, best) against the plain version's on the
    same inputs: ``best`` must agree to KERNEL_TOL_BEST, and ``idx`` / ``ok``
    exactly on every row whose best and second-best similarities differ by
    more than KERNEL_GAP (float32 sums of exact bf16 products in another
    order may swap nearer ties).

    Returns (max |best| error, decisive rows, decisive rows that differ);
    the kernel agrees when the error is within tolerance and none differ."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import NEG
    from gtsfm_tpu_torch.utils.numerics import precise

    with precise():
        a = desc1.to(torch.bfloat16).float()
        b = desc2.to(torch.bfloat16).float()
        sim = torch.where(mask1[..., :, None] & mask2[..., None, :], a @ b.transpose(-1, -2),
                          torch.full((), NEG, device=a.device))
    if sim.shape[-1] > 1:
        second = torch.topk(sim, 2, dim=-1).values[..., 1]
    else:  # no other column: the plain version's second best is the mask value
        second = torch.full_like(sim[..., 0], NEG)
    gi, gok, gb = got
    wi, wok, wb = want
    err = float((gb - wb).abs().max())
    decisive = (wb - second) > KERNEL_GAP
    bad = int((decisive & ((gi != wi) | (gok != wok))).sum())
    return err, int(decisive.sum()), bad


def matcher_sass(path: str, symbol: str = "fused_matcher_kernelILi8E") -> dict:
    """Instruction counts of the matcher kernel's main-path instantiation
    (D <= 128, fragments in registers) in the built library's SASS
    (cuobjdump -sass): the whole function, and its desc2 tile loop (the
    backward branch spanning the most instructions), by opcode."""
    import os
    import re

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = symbol in line
        elif inside:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*);", line)
            if m:
                body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if not body:
        raise AssertionError(f"no {symbol} in the SASS of {path}")
    loop = (0, 0)
    for i, (addr, op, rest) in enumerate(body):
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
            start = next(j for j, x in enumerate(body) if x[0] >= int(target.group(1), 16))
            if i - start > loop[1] - loop[0]:
                loop = (start, i + 1)

    def counts(ins):
        by = {}
        for _, op, _ in ins:
            key = op.split(".")[0]
            by[key] = by.get(key, 0) + 1
        return by

    return {"function": counts(body), "loop": counts(body[loop[0]:loop[1]]), "loop_len": loop[1] - loop[0]}


def _unit_rows(rng, shape):
    x = rng.normal(size=shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def phase_kernel(kp_mask, descs, pairs):
    """The matcher kernel against its plain version at the slice's shape
    and at the tiling's edges, then timed at the slice's shape in turns
    with the plain version, as a CUDA graph (device time alone) and by the
    host's clock (the wrapper's host time per call). Returns (worst max
    |best| error, {"kernel", "plain", "device", "wrapped", "host": ms},
    (bound ms, bound by)): "kernel" is 5 calls back to back through the
    wrapper, "device" the tile and finish kernels alone and "wrapped" the
    whole call (casts included) in a CUDA graph."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_matcher
    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
    from gtsfm_tpu_torch.utils import cuda_build
    from gtsfm_tpu_torch.utils.numerics import precise

    sass = matcher_sass(cuda_build.library_path("fused_matcher"))
    loop = sass["loop"]
    # per desc2 tile a warp holds 32 rows x 64 columns: 64 similarities a thread
    print(f"kernel SASS (D <= 128 instantiation): {sum(sass['function'].values())} instructions, "
          f"HMMA {sass['function'].get('HMMA', 0)}, FFMA {sass['function'].get('FFMA', 0)}; desc2 tile loop "
          f"{sass['loop_len']} instructions = {sass['loop_len'] / 64:.2f} per similarity a thread, HMMA "
          f"{loop.get('HMMA', 0)}, FFMA {loop.get('FFMA', 0)}, LDSM {loop.get('LDSM', 0)}, SHFL "
          f"{loop.get('SHFL', 0)} | loop by opcode {dict(sorted(loop.items(), key=lambda kv: -kv[1]))}",
          flush=True)
    if not loop.get("HMMA") or loop.get("FFMA"):
        raise AssertionError("the matcher's tile loop must multiply with HMMA and hold no FFMA")

    dev = torch.device("cuda")
    d = torch.as_tensor(descs, device=dev)
    m = torch.as_tensor(kp_mask, device=dev)
    i1 = torch.as_tensor(pairs[:, 0], device=dev, dtype=torch.int64)
    i2 = torch.as_tensor(pairs[:, 1], device=dev, dtype=torch.int64)
    cases = {"P96_K1024": (d[i1], d[i2], m[i1], m[i2])}
    masked = torch.zeros_like(m[:1])
    cases["all_masked"] = (d[:1], d[1:2], masked, masked)
    cases["K1000"] = (d[i1[:1], :1000], d[i2[:1], :1000], m[i1[:1], :1000], m[i2[:1], :1000])
    # the tiling's edges: 128 desc1 rows per block, 64 desc2 rows per tile
    # (32 above D = 128), D = 136 zero-padded to 144, one pair
    for name, k1, k2 in (("K1_127", 127, 1024), ("K1_129", 129, 1024), ("K2_63", 1024, 63), ("K2_65", 1024, 65)):
        cases[name] = (d[i1[:4], :k1], d[i2[:4], :k2], m[i1[:4], :k1], m[i2[:4], :k2])
    rng = np.random.default_rng(0)
    w1 = _unit_rows(rng, (2, 129, 136))
    w2 = _unit_rows(rng, (2, 33, 136))
    w2[:, :16] = _unit_rows(rng, (2, 16, 136)) * 0.05 + w1[:, :16]
    cases["D136"] = tuple(torch.as_tensor(x, device=dev) for x in (
        w1.astype(np.float32), (w2 / np.linalg.norm(w2, axis=-1, keepdims=True)).astype(np.float32),
        rng.random((2, 129)) > 0.1, rng.random((2, 33)) > 0.1))
    cases["P1"] = (d[i1[:1]], d[i2[:1]], m[i1[:1]], m[i2[:1]])

    worst = 0.0
    with precise():
        for name, (a, b, ma, mb) in cases.items():
            got = fused_matcher.fused_match_descriptors(a, b, ma, mb)
            want = match_descriptors(a, b, ma, mb)
            err, n_dec, bad = kernel_agrees(got, want, a, b, ma, mb)
            # the finish kernel against its plain version on the tile
            # kernel's own outputs: exactly
            (fi, fok, fb), rest = fused_matcher.match_tiles(a.to(torch.bfloat16), b.to(torch.bfloat16), ma, mb)
            pi, pok, _ = fused_matcher._finish(fb, *rest, ma, 0.8)
            if not (torch.equal(fi, pi) and torch.equal(fok, pok)):
                raise AssertionError(f"the finish kernel disagrees with _finish on {name}")
            if name == "all_masked" and bool(got[1].any()):
                raise AssertionError("all-masked pair produced matches")
            if err > KERNEL_TOL_BEST or bad:
                raise AssertionError(f"kernel disagrees on {name}: max|best| err {err:.3g}, "
                                     f"{bad}/{n_dec} decisive rows differ")
            worst = max(worst, err)
            print(f"kernel check {name} {tuple(a.shape)} x {tuple(b.shape)}: max|best| err {err:.3g}, {n_dec} "
                  f"decisive rows agree, {int(got[1].sum())} matches", flush=True)
    ms, bound = _time_matcher("P96_K1024", *cases["P96_K1024"])
    return worst, ms, bound


def _time_matcher(name, a, b, ma, mb):
    """Two launches on (a, b, ma, mb) must be bitwise equal; then the
    wrapper is timed in turns with the plain version, as a CUDA graph
    (device time alone: the whole call, and the tile and finish kernels on
    bf16 inputs) and by the host's clock. Returns ({"kernel", "plain",
    "device", "wrapped", "host": ms}, (bound ms, bound by))."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_matcher
    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
    from gtsfm_tpu_torch.utils.numerics import precise

    with precise():
        first = fused_matcher.fused_match_descriptors(a, b, ma, mb)
        again = fused_matcher.fused_match_descriptors(a, b, ma, mb)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"two matcher launches on the same inputs differ ({name})")
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        # "alone": the tile and finish kernels on bf16 inputs, no casts
        calls = {"plain": lambda: match_descriptors(a, b, ma, mb),
                 "kernel": lambda: fused_matcher.fused_match_descriptors(a, b, ma, mb),
                 "alone": lambda: fused_matcher.match_tiles(ab, bb, ma, mb)}
        order = [(which, _median_ms(calls[which], batch=1 if which == "plain" else TIMING_BATCH))
                 for which in ("plain", "kernel", "kernel", "plain")]
        ms = {wh: float(np.median([t for w, t in order if w == wh])) for wh in ("plain", "kernel")}
        # device time alone: the whole call (the two casts and the kernels)
        # and the kernels by themselves on bf16 inputs
        wrapped = [_graph_ms(calls["kernel"]) for _ in range(2)]
        device = [_graph_ms(calls["alone"]) for _ in range(2)]
        ms["wrapped"] = float(np.median(wrapped))
        ms["device"] = float(np.median(device))
        # host time: 20 calls without a synchronize (about 500 launches, well
        # inside the launch queue), the median of 5 such runs
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                calls["kernel"]()
            host.append((time.perf_counter() - t0) / 20 * 1e3)
            torch.cuda.synchronize()
        ms["host"] = float(np.median(host))
    P, K1, D = a.shape
    K2 = b.shape[1]
    flop = 2.0 * P * K1 * K2 * D
    bound = max((flop / PEAK_BF16 * 1e3, "operations"),
                ((a.nbytes + b.nbytes + ma.nbytes + mb.nbytes + P * K1 * (4 + 1 + 4)) / PEAK_BYTES * 1e3, "bytes"))
    print(f"kernel timing {name} (median of 20 samples, CUDA events): {ms['kernel']:.4f} ms through the "
          f"wrapper ({TIMING_BATCH} calls back to back), plain {ms['plain']:.4f} ms, kernel / plain "
          f"{ms['kernel'] / ms['plain']:.3f} | runs {order} | device alone (a CUDA graph of {TIMING_BATCH} calls): "
          f"the tile and finish kernels {ms['device']:.4f} ms (runs {[round(x, 4) for x in device]}), the whole call "
          f"{ms['wrapped']:.4f} ms (runs {[round(x, 4) for x in wrapped]}) | host {ms['host']:.4f} ms a call (runs "
          f"{[round(x, 4) for x in host]}) | {flop / ms['device'] * 1e-9:.1f} TFLOP/s device, "
          f"{flop / ms['kernel'] * 1e-9:.1f} back to back | bound {bound[0]:.4f} ms ({bound[1]}): "
          f"{bound[0] / ms['device']:.3f} of it device, {bound[0] / ms['kernel']:.3f} back to back", flush=True)
    return ms, bound


def phase_kernel_runner():
    """The matcher kernel at the runner phase's two-view shape, P=64 pairs
    (the unified config's pair_batch_size), K=2048 (its max_keypoints),
    D=128: the descriptor feed of the 32-camera ring at K=2048 over 64 of
    its pairs, held against the plain version (kernel_agrees), two launches
    bitwise equal, timed as at the slice's shape. Returns (max |best|
    error, ms, bound)."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_matcher
    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses
    from gtsfm_tpu_torch.utils.numerics import precise

    pairs = ring_pairs(NUM_CAMERAS)[:RUNNER_PAIR_BATCH]
    gt = spectral_ring_poses(ring_pairs(NUM_CAMERAS), NUM_CAMERAS)
    _xy, kp_mask, descs = descriptor_feed(gt.R.numpy(), gt.t.numpy(), SPLAT_FOCAL, SPLAT_HW, 2048, seed=1)
    dev = torch.device("cuda")
    d = torch.as_tensor(descs, device=dev)
    m = torch.as_tensor(kp_mask, device=dev)
    i1 = torch.as_tensor(pairs[:, 0], device=dev, dtype=torch.int64)
    i2 = torch.as_tensor(pairs[:, 1], device=dev, dtype=torch.int64)
    a, b, ma, mb = d[i1], d[i2], m[i1], m[i2]
    with precise():
        got = fused_matcher.fused_match_descriptors(a, b, ma, mb)
        want = match_descriptors(a, b, ma, mb)
        err, n_dec, bad = kernel_agrees(got, want, a, b, ma, mb)
    print(f"kernel check P64_K2048 {tuple(a.shape)} x {tuple(b.shape)}: max|best| err {err:.3g}, {n_dec} decisive "
          f"rows agree, {int(got[1].sum())} matches", flush=True)
    if err > KERNEL_TOL_BEST or bad:
        raise AssertionError(f"kernel disagrees on P64_K2048: max|best| err {err:.3g}, "
                             f"{bad}/{n_dec} decisive rows differ")
    ms, bound = _time_matcher("P64_K2048", a, b, ma, mb)
    del a, b, d
    torch.cuda.empty_cache()
    return err, ms, bound


def attention_agrees(got, want, v):
    """Hold the attention kernel's output against the plain version's on
    the same inputs: every element within ATTN_TOL_V * max|v| +
    ATTN_TOL_OUT * |want|. Returns (max abs error, worst error over its
    bound, finite); the kernel agrees when the ratio is <= 1 and every
    value is finite."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = ATTN_TOL_V * v.float().abs().max() + ATTN_TOL_OUT * w.abs()
    return float(err.max()), float((err / bound).max()), bool(torch.isfinite(g).all())


def attention_entries(q0, q1, v0, v1, m0, m1, heads):
    """The four entries of fused_attention on one image pair batch, each as
    (name, kernel call, plain call, v the output weighs, output index):
    self attention of image 0 over image 1's keys (split and merged
    layouts), and both directions of cross attention (split and merged)."""
    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa

    sp = [fa.split_heads(x, heads) for x in (q0, q1, v0, v1)]
    return [
        ("fused_attention", lambda: [fa.fused_attention(sp[0], sp[1], sp[3], m1)],
         lambda: [fa.attend(sp[0], sp[1], sp[3], m1)], [v1]),
        ("fused_attention_merged", lambda: [fa.fused_attention_merged(q0, q1, v1, heads, m1)],
         lambda: [fa.attend_merged(q0, q1, v1, heads, m1)], [v1]),
        ("fused_cross_attention", lambda: list(fa.fused_cross_attention(*sp, m0, m1)),
         lambda: list(fa.cross_attend(*sp, m0, m1)), [v1, v0]),
        ("fused_cross_attention_merged",
         lambda: list(fa.fused_cross_attention_merged(q0, q1, v0, v1, heads, m0, m1)),
         lambda: list(fa.cross_attend_merged(q0, q1, v0, v1, heads, m0, m1)), [v1, v0]),
    ]


def attention_library(q0, q1, v0, v1, m0, m1, heads):
    """The yardstick of each attention entry, never called by the port:
    scaled_dot_product_attention with the additive -1e9 mask on split-head
    views of the same inputs, once for a self entry and once per direction
    for a cross entry. Returns {entry: call}."""
    import torch

    P, K0, C = q0.shape
    K1 = q1.shape[1]
    sp0 = [x.view(P, K0, heads, C // heads).transpose(1, 2) for x in (q0, v0)]
    sp1 = [x.view(P, K1, heads, C // heads).transpose(1, 2) for x in (q1, v1)]
    add1 = torch.where(m1, 0.0, -1e9).to(torch.bfloat16)[:, None, None, :]
    add0 = torch.where(m0, 0.0, -1e9).to(torch.bfloat16)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def one():
        return sdpa(sp0[0], sp1[0], sp1[1], attn_mask=add1)

    def two():
        return one(), sdpa(sp1[0], sp0[0], sp0[1], attn_mask=add0)

    return {"fused_attention": one, "fused_attention_merged": one,
            "fused_cross_attention": two, "fused_cross_attention_merged": two}


def phase_attention(seed: int = 0):
    """All four attention entries against their plain versions, on
    LightGlue's shape and the kernel's tiling edges, then each timed at
    LightGlue's shape in turns with its plain version and its library
    yardstick. Returns (worst max abs error, {entry: {"kernel", "plain",
    "library": ms}}, (bound ms, bound by) of the merged self entry)."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa
    from gtsfm_tpu_torch.utils.numerics import precise

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    heads, dh = 4, 64

    def make(P, K0, K1, masked=0.2):
        """q/k and v of both images, bf16 (P, K, heads*dh); key masks."""
        def x(K):
            return torch.as_tensor(rng.normal(size=(P, K, heads * dh)).astype(np.float32),
                                   device=dev).to(torch.bfloat16)

        m0 = torch.as_tensor(rng.random((P, K0)) >= masked, device=dev)
        m1 = torch.as_tensor(rng.random((P, K1)) >= masked, device=dev)
        return x(K0), x(K1), x(K0), x(K1), m0, m1

    cases = {
        "P96_K2048": make(96, GLUE_KEYPOINTS, GLUE_KEYPOINTS),
        "all_masked": make(2, 256, 256, masked=1.0),
        "K1000": make(4, 1000, 1000),
        "K384": make(4, 384, 384),
        "K0_1000_K1_384": make(4, 1000, 384),
        # the tiling's edges: 128 query rows per block, 128 keys per tile;
        # a cross entry also runs the swapped direction (Kq <-> Kk)
        "Kk1": make(2, 200, 1),
        "Kk129": make(2, 300, 129),
        "Kq1": make(2, 1, 300),
        "Kq129": make(2, 129, 256),
        "P2_K2048": make(2, GLUE_KEYPOINTS, GLUE_KEYPOINTS),
    }
    worst = 0.0
    with precise():
        for name, (q0, q1, v0, v1, m0, m1) in cases.items():
            for entry, kern, plain, vs in attention_entries(q0, q1, v0, v1, m0, m1, heads):
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                res = [attention_agrees(g, w, v) for g, w, v in zip(got, want, vs)]
                err = max(r[0] for r in res)
                ratio = max(r[1] for r in res)
                if ratio > 1.0 or not all(r[2] for r in res):
                    raise AssertionError(f"attention kernel disagrees on {name} / {entry}: max abs err "
                                         f"{err:.4g}, {ratio:.3f} of the tolerance, finite {[r[2] for r in res]}")
                if name == "all_masked":  # the -1e9 fill gives the mean of v, not NaN
                    o = got[0] if got[0].dim() == 3 else fa.merge_heads(got[0])
                    mean_v = v1.float().mean(dim=1, keepdim=True).expand(o.shape)
                    if attention_agrees(o, mean_v, v1)[1] > 1.0:
                        raise AssertionError(f"{entry}: a fully masked key set did not give the mean of v")
                worst = max(worst, err)
                print(f"attention check {name} {entry}: max abs err {err:.4g} "
                      f"({ratio:.3f} of the tolerance)", flush=True)
        del got, want

        q0, q1, v0, v1, m0, m1 = cases["P96_K2048"]
        P, K, C = q0.shape
        flops = 4.0 * P * heads * K * K * (C // heads)  # one direction: q.k and p.v, 2 flops per product term
        bound = max((flops / PEAK_BF16 * 1e3, "operations"), ((4 * q0.nbytes + m1.nbytes) / PEAK_BYTES * 1e3, "bytes"))
        library = attention_library(q0, q1, v0, v1, m0, m1, heads)
        ms = {}
        for entry, kern, plain, _vs in attention_entries(q0, q1, v0, v1, m0, m1, heads):
            calls = {"kernel": kern, "plain": plain, "library": library[entry]}
            order = ("kernel", "library", "plain", "plain", "library", "kernel")
            runs = [(which, _median_ms(calls[which], batch=1 if which == "plain" else TIMING_BATCH)) for which in order]
            ms[entry] = {w: float(np.median([t for k, t in runs if k == w])) for w in calls}
            n_dir = 2 if "cross" in entry else 1
            k_ms = ms[entry]["kernel"]
            print(f"attention timing P96_K2048 {entry} (median of 20 samples, CUDA events, in turns): kernel {k_ms:.4f} ms, "
                  f"plain {ms[entry]['plain']:.4f} ms, scaled_dot_product_attention x{n_dir} "
                  f"{ms[entry]['library']:.4f} ms | {n_dir * flops / k_ms / 1e9:.1f} TFLOP/s, "
                  f"{n_dir * bound[0] / k_ms:.3f} of the bound {n_dir * bound[0]:.4f} ms ({bound[1]}) | "
                  f"kernel / library {k_ms / ms[entry]['library']:.3f} | runs {runs}", flush=True)
    del cases, library
    torch.cuda.empty_cache()
    return worst, ms, bound


def splat_camera(R, t, index: int, dev, hw: tuple = SPLAT_HW, focal: float = SPLAT_FOCAL):
    """Ring camera ``index`` (SE3) and intrinsics with the principal point
    at the center of ``hw`` and focal length ``focal`` (3x3 K), on
    ``dev``; by default the loader's defaults, SPLAT_HW and SPLAT_FOCAL."""
    import torch

    from gtsfm_tpu_torch.geometry import SE3

    h, w = hw
    K = torch.tensor([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], device=dev)
    return SE3(R=torch.as_tensor(R[index], device=dev), t=torch.as_tensor(t[index], device=dev)), K


def ring_order(t) -> np.ndarray:
    """The ring cameras' indices in the order of their angle around the
    ring's center."""
    c = np.asarray(t, np.float64) - np.asarray(t, np.float64).mean(axis=0)
    return np.argsort(np.arctan2(c[:, 1], c[:, 0]), kind="stable")


def ring_views(R, t, dev, fields: dict, indices=None, hw: tuple = SPLAT_HW, focal: float = SPLAT_FOCAL,
               per_tile_cap: int = 512) -> np.ndarray:
    """Views of a scene (GSData ``fields``, numpy) from the ring cameras
    (R, t) ``indices`` (all by default), rendered by the port's render_tiled
    (``per_tile_cap`` slots a tile) on ``dev``: (n, H, W, 3) float32 in
    [0, 1]."""
    import torch

    from gtsfm_tpu_torch.splat import rendering
    from gtsfm_tpu_torch.splat.gs_data import GSData

    h, w = hw
    scene = GSData(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})
    indices = range(len(t)) if indices is None else indices
    with torch.no_grad():
        return np.stack([rendering.render_tiled(scene, *splat_camera(R, t, i, dev, hw, focal), h, w,
                                                per_tile_cap=per_tile_cap)[0].cpu().numpy() for i in indices])


def write_olsson(dirpath: str, views: np.ndarray, R, t, focal: float) -> None:
    """An Olsson dataset folder: views (n, H, W, 3) in [0, 1] as
    images/%02d.png (8-bit RGB) and data.mat with P_i = K [R_i^T | -R_i^T
    t_i] for camera-to-world poses (R_i, t_i) and K of ``focal`` with the
    principal point at the image center."""
    import os

    import scipy.io
    from PIL import Image

    h, w = views.shape[1:3]
    os.makedirs(os.path.join(dirpath, "images"), exist_ok=True)
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]])
    P = np.empty((1, len(views)), object)
    for i, v in enumerate(views):
        Image.fromarray(np.round(np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint8)).save(
            os.path.join(dirpath, "images", f"{i:02d}.png"))
        Rt = np.asarray(R[i], np.float64).T
        P[0, i] = K @ np.concatenate([Rt, -Rt @ np.asarray(t[i], np.float64)[:, None]], axis=1)
    scipy.io.savemat(os.path.join(dirpath, "data.mat"), {"P": P})


def evaluated_slots(packed, gidx, counts, origins, batch: int = 256):
    """Slots per tile that the compositing kernel must evaluate on these
    inputs: all of a tile's live slots, except that a tile stops at the
    first batch boundary where every pixel has T <= 1/255 (transmittance
    from the plain version on the slots before the boundary)."""
    import torch

    from gtsfm_tpu_torch.splat import rendering

    counts = counts.long()
    need = counts.clone()
    stopped = torch.zeros_like(counts, dtype=torch.bool)
    for b in range(batch, gidx.shape[1], batch):
        clamp = torch.clamp(counts, max=b).to(torch.int32)
        _c, T = rendering.composite_tiles_plain(*rendering._gather_attrs_f32(packed, gidx, clamp), origins,
                                                rendering.KERNEL_TILE)
        stop = ~stopped & (counts > b) & (T.max(dim=1).values <= 1.0 / 255.0)
        need = torch.where(stop, torch.full_like(need, b), need)
        stopped |= stop
    return need


def composite_bound(packed, counts_needed, n_tiles: int):
    """(bound ms, "operations" or "bytes") of the compositing at these
    inputs: COMPOSITE_FLOPS per pixel and evaluated slot over the float32
    peak, against each evaluated slot's index and 9 attributes read once,
    the (G, 9) table, each tile's count and origin read and its color and
    transmittance written once, over the memory rate."""
    slots = int(counts_needed.sum())
    ops_ms = slots * 256 * COMPOSITE_FLOPS / PEAK_F32 * 1e3
    nbytes = slots * (4 + 36) + packed.numel() * 4 + n_tiles * (12 + 256 * 16)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def composite_plain(packed, gidx, counts, origins):
    """The plain compositing of these inputs, every slot index outside
    [0, G) sent to an added all-zero row (alpha 0: no contribution), which
    is what the kernel computes for such an index."""
    import torch

    from gtsfm_tpu_torch.splat import rendering

    G = packed.shape[0]
    ext = torch.cat([packed, torch.zeros_like(packed[:1])])
    inside = (gidx >= 0) & (gidx < G)
    gidx = torch.where(inside, gidx, torch.full_like(gidx, G))
    return rendering.composite_tiles_plain(*rendering._gather_attrs_f32(ext, gidx, counts), origins,
                                           rendering.KERNEL_TILE)


def _graph_ms(fn, calls: int = TIMING_BATCH, reps: int = 20) -> float:
    """Device ms of one call of fn alone: ``calls`` calls captured in one
    CUDA graph, the median of ``reps`` replays (CUDA events) over
    ``calls``. Unlike _median_ms, no host time is in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def phase_composite(R, t):
    """The compositing kernel against its plain version on the splat
    scene's tiles from ring camera 0, binned by the port's render_tiled,
    and on the kernel's edges. Returns (max abs error on the full scene,
    {"kernel": ms, "plain": ms, "device": ms}, (bound ms, bound by))."""
    import torch

    from gtsfm_tpu_torch.splat import rendering
    from gtsfm_tpu_torch.splat.gs_data import GSData
    from gtsfm_tpu_torch.utils.numerics import precise

    dev = torch.device("cuda")
    h, w = SPLAT_HW
    fields = splat_scene(np.asarray(t).mean(axis=0), n=SPLAT_GAUSSIANS)
    full = GSData(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})
    # alpha 0.004: T >= (1 - 0.004)^512 = 0.13 > 1/255, so no tile stops early
    faint = full.replace(opacity_logit=torch.full_like(full.opacity_logit, float(np.log(0.004 / 0.996))))
    pose, K = splat_camera(R, t, 0, dev)

    def plain(packed, gidx, counts, origins):
        return rendering.composite_tiles_plain(*rendering._gather_attrs_f32(packed, gidx, counts), origins,
                                               rendering.KERNEL_TILE)

    def kernel(packed, gidx, counts, origins):
        return rendering.composite_tiles(packed, gidx, counts, origins, rendering.KERNEL_TILE)

    with torch.no_grad(), precise():
        bins = {name: rendering.bin_tiles(g, pose, K, h, w) for name, g in (("faint", faint), ("full", full))}
        packed, gidx, counts, origins = bins["full"]
        p_f, gidx_f, counts_f, origins_f = bins["faint"]
        n_tiles = gidx.shape[0]
        G = packed.shape[0]
        bad = gidx_f.clone()
        bad[:, ::7] = -1
        bad[:, 3::11] = G
        cases = {
            "faint": (bins["faint"], COMPOSITE_TOL),
            "full": (bins["full"], COMPOSITE_TOL_STOP),
            "all_empty": ((packed, gidx, torch.zeros_like(counts), origins), 0.0),
            "ragged_997": (tuple(a[:997].contiguous() if a is not packed else a for a in bins["full"]),
                           COMPOSITE_TOL_STOP),
            # the stop boundary: at count 256 no tile checks (none stops
            # early), at 257 each checks once after 256 slots
            "count_256": ((packed, gidx, torch.clamp(counts, max=256), origins), COMPOSITE_TOL),
            "count_257": ((packed, gidx, torch.clamp(counts, max=257), origins), COMPOSITE_TOL_STOP),
            "out_of_range": ((p_f, bad, counts_f, origins_f), COMPOSITE_TOL),
            # cap 100: only composited_slots(100) = 64 slots are read
            "cap_100": ((p_f, gidx_f[:, :100].contiguous(), torch.clamp(counts_f, max=100), origins_f),
                        COMPOSITE_TOL),
        }
        errs = {}
        for name, (args, tol) in cases.items():
            got = kernel(*args)
            torch.cuda.synchronize()
            want = composite_plain(*args)
            err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
            stopped = int((want[1].max(dim=1).values <= 1.0 / 255.0).sum())
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            print(f"composite check {name}: {args[1].shape[0]} tiles, max abs err {err:.4g} (tolerance {tol:.4g}), "
                  f"{stopped} tiles saturated, live slots per tile median {float(args[2].float().median()):.0f} "
                  f"max {int(args[2].max())}", flush=True)
            if not finite or err > tol:
                raise AssertionError(f"composite kernel disagrees on {name}: max abs err {err:.4g} > {tol:.4g}")
            if name in ("faint", "out_of_range", "cap_100") and stopped:
                raise AssertionError(f"the {name} case saturated a tile; it must not")
            if name in ("count_256", "count_257") and not stopped:
                raise AssertionError(f"no tile of {name} saturates: the stop boundary is not exercised")
            if name == "all_empty" and not (bool((got[0] == 0).all()) and bool((got[1] == 1).all())):
                raise AssertionError("an empty tile is not black with T = 1")
            errs[name] = err
        need = evaluated_slots(packed, gidx, counts, origins)

    # the gradient: fixed upstream weights, so both sides see the same
    # cotangents; only the gather's scatter-add order (float atomics) differs
    gen = torch.Generator(device=dev).manual_seed(0)
    wc = torch.rand((n_tiles, 256, 3), generator=gen, device=dev)
    wt = torch.rand((n_tiles, 256), generator=gen, device=dev)
    grads = {}
    with precise():
        for which in ("kernel", "plain"):
            p = p_f.detach().clone().requires_grad_(True)
            if which == "kernel":
                c, T = rendering.TiledComposite.apply(p, gidx_f, counts_f, origins_f, rendering.KERNEL_TILE)
            else:
                c, T = plain(p, gidx_f, counts_f, origins_f)
            ((c * wc).sum() + (T * wt).sum()).backward()
            grads[which] = p.grad
    gerr = float((grads["kernel"] - grads["plain"]).norm() / grads["plain"].norm())
    print(f"composite gradient: |kernel path - plain path| / |plain path| {gerr:.3g} (tolerance 1e-5)", flush=True)
    if not gerr <= 1e-5:
        raise AssertionError(f"TiledComposite's gradient on the card differs from the plain path's: {gerr:.3g}")

    with torch.no_grad(), precise():
        calls = {"kernel": lambda: kernel(packed, gidx, counts, origins),
                 "plain": lambda: plain(packed, gidx, counts, origins)}
        runs = [(which, _median_ms(calls[which], batch=1 if which == "plain" else TIMING_BATCH))
                for which in ("plain", "kernel", "kernel", "plain")]
        device = [_graph_ms(calls["kernel"]) for _ in range(2)]
    ms = {wh: float(np.median([x for k, x in runs if k == wh])) for wh in ("kernel", "plain")}
    ms["device"] = float(np.median(device))
    bound = composite_bound(packed, need, n_tiles)
    print(f"composite timing {n_tiles} tiles x cap {gidx.shape[1]}, G {packed.shape[0]} (median of 20 samples, CUDA "
          f"events): kernel {ms['kernel']:.4f} ms ({TIMING_BATCH} calls back to back), {ms['device']:.4f} ms device "
          f"(a CUDA graph of {TIMING_BATCH} calls, runs {[round(x, 4) for x in device]}), plain {ms['plain']:.4f} ms "
          f"| runs {runs} | evaluated slots {int(need.sum())} of {int(counts.sum())} live | bound {bound[0]:.4f} ms "
          f"({bound[1]}): {bound[0] / ms['kernel']:.3f} of it back to back, {bound[0] / ms['device']:.3f} device",
          flush=True)
    del bins, cases, grads
    torch.cuda.empty_cache()
    return errs["full"], ms, bound


def _ring_slice(name, kp_xy, kp_mask, descs, pairs, R, t, matcher=None, options=None):
    """SceneOptimizer.run on the 32-camera ring on `cuda`, fed through the
    detector slot, with every kernel's launch count set to 0 just before
    the run and read just after. Requires 32/32 registered, pose AUC@5 >=
    AUC5_BAR and finite output. Returns ({"matcher": n, "attention": n,
    "composite": n}, stage seconds, metrics by group)."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
    from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
    from gtsfm_tpu_torch.splat import rendering

    dev = torch.device("cuda")
    n = NUM_CAMERAS
    poses = SE3(R=torch.as_tensor(R, device=dev), t=torch.as_tensor(t, device=dev))
    cal = Cal3Bundler.create(
        torch.full((n,), FOCAL), torch.zeros(n), torch.zeros(n),
        torch.full((n,), IMAGE_HW[1] / 2.0), torch.full((n,), IMAGE_HW[0] / 2.0), device=dev,
    )
    loader = SyntheticSceneLoader(poses, cal=cal, image_size=IMAGE_HW)
    so = SceneOptimizer(
        options or SceneOptimizerOptions(),
        retriever=FixedPairs(pairs),
        detector=FeedDetector(kp_xy, kp_mask, descs),
        matcher=matcher,
    )
    fused_matcher.launch_count = 0
    fused_attention.launch_count = 0
    rendering.launch_count = 0
    torch.cuda.synchronize()
    data, groups = so.run(loader)
    torch.cuda.synchronize()
    launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count,
                "composite": rendering.launch_count}

    metrics = {g.name: {m.name: m for m in g.metrics} for g in groups}
    registered = data.number_images()
    auc5 = metrics["ba_pose_metrics"]["pose_auc_@5.0_deg"].scalar
    pts = data.points[data.track_mask]
    if not bool(torch.isfinite(pts).all()) or not bool(torch.isfinite(data.poses.R).all()):
        raise AssertionError(f"{name}: non-finite poses or points")
    sec = {
        "two_view_sec": metrics["frontend_summary"]["two_view_sec"].scalar,
        "backend_sec": metrics["multiview_optimizer_metrics"]["backend_sec"].scalar,
        "total_runtime_sec": metrics["total_summary"]["total_runtime_sec"].scalar,
    }
    matches = metrics["frontend_summary"]["num_matches_per_pair"].dist
    print(f"{name}: {registered}/{n} registered, pose AUC@5 {auc5:.4f} (bar {AUC5_BAR}), "
          f"{data.number_tracks()} tracks, matches per pair median {float(np.median(matches)):.0f} "
          f"min {int(np.min(matches))}, launches {launches} | "
          + " ".join(f"{k} {v:.3f}" for k, v in sec.items()), flush=True)
    if registered != n:
        raise AssertionError(f"{name}: registered {registered}/{n} cameras")
    if auc5 < AUC5_BAR:
        raise AssertionError(f"{name}: pose AUC@5 {auc5:.4f} < {AUC5_BAR}")
    return launches, sec, metrics


def phase_slice(kp_xy, kp_mask, descs, pairs, R, t):
    """The mutual-NN slice with the splat trainer after it (run_gs,
    SPLAT_STEPS steps on the loader's flat gray images). Returns the
    matcher's and the compositing kernel's launches during the run."""
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizerOptions

    launches, _sec, metrics = _ring_slice("slice", kp_xy, kp_mask, descs, pairs, R, t,
                                          options=SceneOptimizerOptions(run_gs=True, gs_iterations=SPLAT_STEPS))
    gs = {k: m.scalar for k, m in metrics["gaussian_splatting_metrics"].items()}
    print(f"slice splat: {gs}", flush=True)
    if launches["matcher"] <= 0:
        raise AssertionError("the slice never launched the matcher kernel")
    if launches["composite"] <= 0:
        raise AssertionError("the slice's splat trainer never launched the compositing kernel")
    if not gs["final_l1"] < gs["initial_l1"]:
        raise AssertionError(f"the slice's splat L1 did not fall: {gs}")
    return launches["matcher"], launches["composite"]


def glue_decisive(z, mask0, mask1, threshold: float):
    """Rows of a log-assignment z (P, K0+1, K1+1) whose match cannot change
    under a perturbation of z below GLUE_GAP/2: the row's top-2 margin, the
    top-2 margin of the column it picks, and the distance of its best score
    from log(threshold) all exceed GLUE_GAP."""
    import torch

    zi = torch.where(mask0[:, :, None] & mask1[:, None, :], z[:, :-1, :-1], -1e9)
    row = torch.topk(zi, 2, dim=2).values
    col = torch.topk(zi, 2, dim=1).values
    pick = torch.argmax(zi, dim=2)
    col_margin = torch.gather(col[:, 0] - col[:, 1], 1, pick)
    return (mask0 & (row[..., 0] - row[..., 1] > GLUE_GAP) & (col_margin > GLUE_GAP)
            & ((row[..., 0] - float(np.log(threshold))).abs() > GLUE_GAP))


def _plain_attention(fa):
    """Swap fused_attention's four entries for their plain versions; returns
    the function that swaps them back."""
    saved = {n: getattr(fa, n) for n in ("fused_attention", "fused_attention_merged",
                                         "fused_cross_attention", "fused_cross_attention_merged")}
    fa.fused_attention, fa.fused_attention_merged = fa.attend, fa.attend_merged
    fa.fused_cross_attention, fa.fused_cross_attention_merged = fa.cross_attend, fa.cross_attend_merged

    def restore():
        for k, v in saved.items():
            setattr(fa, k, v)

    return restore


def phase_lightglue(pairs, R, t):
    """The ring through SceneOptimizer.run with the LightGlue matcher at
    full width on the glue fixture, then the slice's matcher input through
    the kernel and through the plain attention (swapped in here), timed on
    the host clock (plain, kernel, kernel, plain). Returns (attention
    launches during the run, stage seconds, forward seconds)."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa
    from gtsfm_tpu_torch.frontend.matchers.lightglue import LightGlueMatcher, LightGlueOptions

    kp_xy, kp_mask, descs = descriptor_feed(R, t, FOCAL, IMAGE_HW, GLUE_KEYPOINTS, dim=GLUE_DESC_DIM,
                                            desc_sigma=GLUE_SIGMA)
    matcher = LightGlueMatcher(LightGlueOptions(), state_dict=glue_fixture(0))
    launches, sec, _metrics = _ring_slice("lightglue", kp_xy, kp_mask, descs, pairs, R, t, matcher=matcher)
    if launches["attention"] <= 0:
        raise AssertionError("the LightGlue slice never launched the attention kernel")
    if launches["matcher"] != 0:
        raise AssertionError("the LightGlue slice launched the mutual-NN kernel")

    dev = torch.device("cuda")
    i1 = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=dev)
    i2 = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=dev)
    d, xy, m = (torch.as_tensor(a, device=dev) for a in (descs, kp_xy, kp_mask))
    args = (d[i1], d[i2], xy[i1], xy[i2], m[i1], m[i2], (IMAGE_HW[1], IMAGE_HW[0]))
    z, fwd_sec = {}, {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        restore = _plain_attention(fa) if which == "plain" else (lambda: None)
        try:
            torch.cuda.synchronize()
            before = fa.launch_count
            t0 = time.perf_counter()
            z[which] = matcher.log_assignment(*args)
            torch.cuda.synchronize()
            fwd_sec[which].append(time.perf_counter() - t0)
            per_forward = fa.launch_count - before if which == "kernel" else None
        finally:
            restore()
        if which == "kernel":
            fwd_launches = per_forward
    m0, m1 = args[4], args[5]
    idx = {w: matcher._postprocess(z[w], m0, m1)[0] for w in z}
    decisive = glue_decisive(z["plain"], m0, m1, matcher.options.match_threshold)
    bad = int((decisive & (idx["kernel"] != idx["plain"])).sum())
    valid = torch.nn.functional.pad(m0, (0, 1), value=True)[:, :, None] & \
        torch.nn.functional.pad(m1, (0, 1), value=True)[:, None, :]
    zerr = float(torch.where(valid, (z["kernel"] - z["plain"]).abs(), 0.0).max())
    n_match = int((idx["kernel"] >= 0).sum())
    print(f"lightglue check: log-assignment max |kernel - plain| {zerr:.4g}; {int(decisive.sum())} "
          f"decisive rows (gap {GLUE_GAP}), {bad} differ; {n_match} matches through the kernel, "
          f"{int((idx['plain'] >= 0).sum())} through the plain attention | forward s (96 pairs, host "
          f"clock) kernel {fwd_sec['kernel']}, plain {fwd_sec['plain']}; {fwd_launches} attention launches "
          f"per forward", flush=True)
    if bad or int(decisive.sum()) == 0:
        raise AssertionError(f"LightGlue matches through the kernel differ from the plain attention's "
                             f"on {bad} of {int(decisive.sum())} decisive rows")
    return launches["attention"], sec, {w: float(np.median(v)) for w, v in fwd_sec.items()}


def _synthetic_run(name, n, pairs, points, options):
    """SceneOptimizer.run on `cuda` with the synthetic correspondence
    generator (``points`` points, noise 0.4 px) on an n-camera spectral ring
    over ``pairs``,
    every kernel's launch count set to 0 just before the run and read just
    after; ``pairs=None`` leaves them to the default SequentialRetriever
    (the ring is then laid over the same pairs). Returns (optimizer, data,
    metrics by group, launches, GT poses, compare_reconstructions'
    scalars)."""
    import torch

    from gtsfm_tpu_torch.evaluation.compare import compare_reconstructions
    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.frontend.synthetic import SyntheticCorrespondenceGenerator, SyntheticOptions
    from gtsfm_tpu_torch.geometry import Cal3Bundler
    from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader, spectral_ring_poses
    from gtsfm_tpu_torch.retriever.retrievers import RetrieverOptions, sequential_pairs
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer
    from gtsfm_tpu_torch.splat import rendering

    dev = torch.device("cuda")
    ring = pairs if pairs is not None else sequential_pairs(n, RetrieverOptions().max_frame_lookahead)
    gt = spectral_ring_poses(ring, n, device=dev)
    cal = Cal3Bundler.create(
        torch.full((n,), FOCAL), torch.zeros(n), torch.zeros(n),
        torch.full((n,), IMAGE_HW[1] / 2.0), torch.full((n,), IMAGE_HW[0] / 2.0), device=dev,
    )
    so = SceneOptimizer(options, retriever=FixedPairs(pairs) if pairs is not None else None,
                        correspondence=SyntheticCorrespondenceGenerator(
                            SyntheticOptions(num_points=points, noise_px=0.4, seed=0)))
    fused_matcher.launch_count = 0
    fused_attention.launch_count = 0
    rendering.launch_count = 0
    torch.cuda.synchronize()
    data, groups = so.run(SyntheticSceneLoader(gt, cal=cal, image_size=IMAGE_HW))
    torch.cuda.synchronize()
    launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count,
                "composite": rendering.launch_count}
    metrics = {g.name: {m.name: m for m in g.metrics} for g in groups}
    cmp = {m.name: m.scalar for m in compare_reconstructions(data, data.replace(poses=gt)).metrics
           if m.dist is None}
    pts = data.points[data.track_mask]
    if not bool(torch.isfinite(pts).all()) or not bool(torch.isfinite(data.poses.R[data.pose_mask]).all()):
        raise AssertionError(f"{name}: non-finite poses or points")
    if launches["matcher"] != 0:
        raise AssertionError(f"{name}: the direct branch launched the mutual-NN kernel ({launches})")
    return so, data, metrics, launches, gt, cmp


def _stage_sec(metrics) -> dict:
    mvo = metrics["multiview_optimizer_metrics"]
    sec = {"two_view_sec": metrics["frontend_summary"]["two_view_sec"].scalar}
    sec.update({k: mvo[k].scalar for k in ("leaf_mvo_sec", "merge_sec") if k in mvo})
    sec["backend_sec"] = mvo["backend_sec"].scalar
    sec["total_runtime_sec"] = metrics["total_summary"]["total_runtime_sec"].scalar
    return sec


def phase_gate():
    """The twin of tests/scene/test_accuracy_gate_32.py on `cuda`: the
    32-camera ring over pairs (i, i+1..3), the synthetic generator (600
    points, 0.4 px), flat. 32/32 registered and compare_reconstructions'
    pose AUC@5 >= AUC5_BAR required."""
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizerOptions

    n = NUM_CAMERAS
    _so, data, metrics, launches, _gt, cmp = _synthetic_run("gate", n, ring_pairs(n), GATE_POINTS,
                                                         SceneOptimizerOptions())
    auc5 = cmp["pose_auc_@5.0_deg"]
    vs = {k: m.scalar for k, m in metrics["verifier_summary"].items() if m.dist is None}
    print(f"gate: {data.number_images()}/{n} registered, pose AUC@5 {auc5:.4f} (bar {AUC5_BAR}), "
          f"{data.number_tracks()} tracks, verifier {vs}, launches {launches} | "
          + " ".join(f"{k} {v:.3f}" for k, v in _stage_sec(metrics).items()), flush=True)
    if data.number_images() != n:
        raise AssertionError(f"gate: registered {data.number_images()}/{n} cameras")
    if auc5 < AUC5_BAR:
        raise AssertionError(f"gate: pose AUC@5 {auc5:.4f} < {AUC5_BAR}")


def phase_hierarchical(smi: str, n: int = HIER_CAMERAS):
    """bench.py's palace-281 configuration through the port on `cuda`: n
    cameras, pairs from the default SequentialRetriever, the synthetic
    generator (800 points, 0.4 px), SceneOptimizerOptions(hierarchical=True,
    max_cluster_size=40), run once, cold, in this process (the warm run
    was cut for the script's time). The run
    requires the METIS partitioner, >= HIER_MIN_CLUSTERS clusters, no merge
    failure, no matcher launch, registered >= max(0.95 n, the JAX
    reference's - 3), AUC@5 >= the reference's - 0.02, and after a Sim3
    alignment to GT median rotation error < 0.5 deg and median translation
    error < 0.3. Prints the cluster tree and the stage seconds."""
    import torch

    from gtsfm_tpu_torch.geometry.sim3 import align_poses_sim3
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizerOptions
    from gtsfm_tpu_torch.utils.numerics import precise

    opts = SceneOptimizerOptions(hierarchical=True, max_cluster_size=HIER_CLUSTER_SIZE)
    min_registered = max(int(np.ceil(HIER_MIN_REGISTERED * n)), HIER_REF_REGISTERED - HIER_REGISTERED_SLACK
                         if n == HIER_CAMERAS else 0)
    min_auc5 = HIER_REF_AUC5 - HIER_AUC5_SLACK
    so, data, metrics, launches, gt, cmp = _synthetic_run("hierarchical", n, None, HIER_POINTS, opts)
    hm = so.backend_metrics
    paths = [p for p, _ in so.node_results]
    tree = " ".join(f"{'/'.join(map(str, p)) or 'root'}:{d.number_images()}"
                    + ("" if any(q[: len(p)] == p and len(q) > len(p) for q in paths) else "*")
                    for p, d in so.node_results)
    est = data.pose_mask
    with precise():
        sim = align_poses_sim3(data.poses, gt, mask=est)
        aligned = sim.transform_pose(data.poses)
        rot = rotation_error_deg(aligned.R[est].cpu().numpy(), gt.R[est].cpu().numpy())
        trans = torch.linalg.vector_norm(aligned.t - gt.t, dim=-1)[est].cpu().numpy()
    registered = data.number_images()
    auc5 = cmp["pose_auc_@5.0_deg"]
    pairs = int(metrics["frontend_summary"]["num_pairs"].scalar)
    print(f"hierarchical cold: {n} cameras, {pairs} pairs, partitioner {hm.get('partitioner')}, "
          f"{hm['num_clusters']} clusters, {hm['tree_nodes']} nodes, merge failures "
          f"{hm.get('merge_failures', 0)} {hm.get('merge_failure_reasons', [])}; registered {registered} "
          f"(bar {min_registered}), pose AUC@5 {auc5:.4f} (bar {min_auc5:.4f}), median rotation error "
          f"{float(np.median(rot)):.4f} deg, median translation error {float(np.median(trans)):.4f}, "
          f"{data.number_tracks()} tracks, launches {launches}", flush=True)
    print(f"hierarchical cold tree (path:cameras, * = leaf): {tree}", flush=True)
    print(f"hierarchical cold seconds: " + " ".join(f"{k} {v:.3f}" for k, v in _stage_sec(metrics).items())
          + f" | {smi}", flush=True)
    leaf_sec = {}
    for cm in hm["cluster_metrics"]:
        for k, v in cm.items():
            if k.endswith("_sec") and k != "total_sec":
                leaf_sec[k] = leaf_sec.get(k, 0.0) + v
    print(f"hierarchical cold leaf stages, summed over the {len(hm['cluster_metrics'])} leaves: "
          + " ".join(f"{k} {v:.3f}" for k, v in leaf_sec.items()), flush=True)
    if hm.get("partitioner") != "metis":
        raise AssertionError(f"hierarchical: the partitioner was {hm.get('partitioner')!r}, not METIS")
    if hm["num_clusters"] < HIER_MIN_CLUSTERS or hm.get("merge_failures"):
        raise AssertionError(f"hierarchical: {hm['num_clusters']} clusters, merge failures "
                             f"{hm.get('merge_failure_reasons')}")
    if registered < min_registered or auc5 < min_auc5:
        raise AssertionError(f"hierarchical: registered {registered} (bar {min_registered}), "
                             f"AUC@5 {auc5:.4f} (bar {min_auc5:.4f})")
    if not (np.median(rot) < HIER_MEDIAN_ROT_DEG and np.median(trans) < HIER_MEDIAN_TRANS):
        raise AssertionError(f"hierarchical: median errors {np.median(rot):.4f} deg, {np.median(trans):.4f}")


def _runner_runs(name: str, argv: list, n_views: int, min_registered: int, min_auc5: float, smi: str,
                 check_export=None) -> dict:
    """``gtsfm_tpu_torch.runner.main(argv + --output_root)``, in this
    process, cold and then warm, with every launch count and
    ``ba.layout_counts`` set to 0 just before each run and read just after.
    Each run requires DoG-SIFT on `cuda` and nowhere else, a matcher launch
    per chunk of RUNNER_PAIR_BATCH pairs at least, registered >=
    min_registered, AUC@5 >= min_auc5, finite poses, the metrics JSON of
    every group the run reports and a COLMAP export that reads back with
    every registered camera (``check_export(export dir, scene, layouts)``
    checks more). Returns the launches and BA layouts of the warm run."""
    import os
    import tempfile

    import torch

    from gtsfm_tpu_torch import runner
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup
    from gtsfm_tpu_torch.frontend.detectors import dog_sift
    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.io import colmap
    from gtsfm_tpu_torch.splat import rendering

    totals = {}
    with tempfile.TemporaryDirectory() as work:
        for run in ("cold", "warm"):
            out = os.path.join(work, run)
            dog_sift.calls_by_device.clear()
            ba.layout_counts.clear()
            fused_matcher.launch_count = fused_attention.launch_count = rendering.launch_count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = runner.main(argv + ["--output_root", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count,
                        "composite": rendering.launch_count}
            detector = dict(dog_sift.calls_by_device)
            layouts = dict(ba.layout_counts)
            mdir = os.path.join(out, "results", "metrics")
            metrics = {g.name: {m.name: m for m in g.metrics}
                       for g in (MetricsGroup.from_json(os.path.join(mdir, f)) for f in sorted(os.listdir(mdir)))}
            missing = [g for g in RUNNER_METRICS if g not in metrics]
            if rc != 0 or missing:
                raise AssertionError(f"{name} {run}: exit code {rc}, metrics groups missing {missing}")
            fe = {k: m.scalar for k, m in metrics["frontend_summary"].items() if m.dist is None}
            kps = metrics["frontend_summary"]["num_keypoints_per_image"].dist
            pose = metrics["ba_pose_metrics"]
            registered = len(pose["rotation_error_deg"].dist)
            auc5 = pose["pose_auc_@5.0_deg"].scalar
            export = os.path.join(out, "results", "ba_output")
            back = colmap.read_scene(export)
            pairs = int(fe["num_pairs"])
            chunks = -(-pairs // RUNNER_PAIR_BATCH)
            consistent = metrics["track_classification_metrics"]["fraction_tracks_gt_consistent"].scalar
            sec = {k: fe[k] for k in ("detect_describe_sec", "retriever_duration_sec", "two_view_sec")}
            sec["backend_sec"] = metrics["multiview_optimizer_metrics"]["backend_sec"].scalar
            sec["total_runtime_sec"] = metrics["total_summary"]["total_runtime_sec"].scalar
            print(f"{name} {run}: {registered}/{n_views} registered (bar {min_registered}), pose AUC@5 "
                  f"{auc5:.4f} (bar {min_auc5:.4f}), {pairs} pairs ({int(fe['num_valid_pairs'])} valid, >= "
                  f"{chunks} chunks of {RUNNER_PAIR_BATCH}), keypoints per image median "
                  f"{float(np.median(kps)):.0f} min {int(np.min(kps))} max {int(np.max(kps))}, "
                  f"{back.number_tracks()} tracks exported, DoG-SIFT calls by device {detector}, launches {launches}, "
                  f"BA solves by layout {layouts}, tracks consistent with GT {consistent:.4f}", flush=True)
            print(f"{name} {run} seconds: " + " ".join(f"{k} {v:.3f}" for k, v in sec.items())
                  + f" main {wall:.3f} | {smi}", flush=True)
            if set(detector) != {"cuda"}:
                raise AssertionError(f"{name} {run}: DoG-SIFT ran on {detector}, not on cuda alone")
            if launches["matcher"] < chunks:
                raise AssertionError(f"{name} {run}: {launches['matcher']} matcher launches for {pairs} pairs")
            if registered < min_registered or auc5 < min_auc5:
                raise AssertionError(f"{name} {run}: registered {registered} (bar {min_registered}), AUC@5 "
                                     f"{auc5:.4f} (bar {min_auc5:.4f})")
            if back.number_images() != registered or not bool(torch.isfinite(back.poses.R).all()):
                raise AssertionError(f"{name} {run}: the COLMAP export reads back {back.number_images()} cameras, "
                                     f"{registered} registered")
            if check_export is not None:
                check_export(export, back, layouts)
            totals[run] = sec["total_runtime_sec"]
    return {"launches": launches, "layouts": layouts, "totals": totals}


def phase_runner(smi: str, R, t, work: str) -> tuple:
    """The default entry point on `cuda`: the 32 ring views of runner_scene
    at SPLAT_HW, f = SPLAT_FOCAL, rendered by the port on the card and
    written as an Olsson folder under ``work``, then
    ``gtsfm_tpu_torch.runner.main`` with the unified config through
    _runner_runs (cold and warm), registered >= the JAX reference's - 1,
    AUC@5 >= the reference's - 0.02. Returns the launches of the warm run,
    the folder (the runner_options phase reads it too), its view count and
    the cold run's total_runtime_sec."""
    import os

    import torch

    dev = torch.device("cuda")
    order = ring_order(t)
    t0 = time.perf_counter()
    views = ring_views(R, t, dev, runner_scene(np.asarray(t).mean(axis=0)), indices=order)
    data_dir = os.path.join(work, "runner_data")
    write_olsson(data_dir, views, np.asarray(R)[order], np.asarray(t)[order], SPLAT_FOCAL)
    print(f"runner: {len(order)} views of runner_scene at {SPLAT_HW[0]}x{SPLAT_HW[1]} rendered and written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = _runner_runs("runner", ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", data_dir],
                       len(order), RUNNER_REF_REGISTERED - RUNNER_REGISTERED_SLACK,
                       RUNNER_REF_AUC5 - RUNNER_AUC5_SLACK, smi)
    return out["launches"], data_dir, len(order), out["totals"]["cold"]


def write_gt_colmap(data_dir: str, out_dir: str) -> None:
    """The GT poses and calibrations of the Olsson folder ``data_dir`` as
    COLMAP text under the folder's image names, no tracks, written by the
    port's writer: the --compare_to reference of runner_outputs."""
    import torch

    from gtsfm_tpu_torch.common.sfm_data import SceneMeta, SfmData
    from gtsfm_tpu_torch.io import colmap
    from gtsfm_tpu_torch.loader.base import batch_calibrations
    from gtsfm_tpu_torch.loader.olsson import OlssonLoader

    loader = OlssonLoader(data_dir)
    n = len(loader)
    sizes = [(loader.get_image(i).width, loader.get_image(i).height) for i in range(n)]
    data = SfmData.empty(n, meta=SceneMeta(image_names=loader.image_filenames(), image_sizes=sizes))
    colmap.write_scene(data.replace(poses=loader.get_gt_poses(), pose_mask=torch.ones(n, dtype=torch.bool),
                                    cal=batch_calibrations(loader.get_all_intrinsics())), out_dir)


RUNNER_OUTPUT_FILES = ("ba_output/cameras.txt", "ba_output/images.txt", "ba_output/points3D.txt",
                       "metrics/retrieval_metrics.json", "metrics/frontend_summary.json",
                       "metrics/ba_pose_metrics.json", "gtsfm_metrics_report.html", "process_graph.dot",
                       "viewer.html", "plots/scene_3d.png", "comparison/per_camera_errors.csv",
                       "comparison/comparison_metrics.csv", "comparison/camera_centers.png")
OUTPUTS_CHUNK = 8  # --load_chunk_size of run A
OUTPUTS_CHUNK_SHARE = 0.99  # chunked against whole-batch keypoints on the card, per image
OUTPUTS_FRAMES = 24  # --gs_video_frames of run C
OUTPUTS_GS_STEPS = 100  # its trainer steps: the trainer's full-width timing stays in the splat phase
OUTPUTS_CLUSTER_SIZE = 16  # its max_cluster_size, so that the 32 views split into clusters


def _same_scene(a, b) -> bool:
    """Every tensor of two SfmData equal, bit for bit."""
    import torch

    fields = ("pose_mask", "points", "track_mask", "meas_cam", "meas_track", "meas_uv", "meas_mask")
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in fields) and \
        torch.equal(a.poses.R, b.poses.R) and torch.equal(a.poses.t, b.poses.t)


def phase_runner_outputs(smi: str, data_dir: str, runner_cold_total: float) -> dict:
    """What every run writes and the runner's remaining flags, on the
    runner phase's folder (runs A-E, see the module's docstring). Returns
    the launches of the five runs by kernel."""
    import glob
    import os

    import torch

    from gtsfm_tpu_torch.configs import config
    from gtsfm_tpu_torch.evaluation import dashboard
    from gtsfm_tpu_torch.frontend.matchers import lightglue
    from gtsfm_tpu_torch.loader.olsson import OlssonLoader
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer
    from gtsfm_tpu_torch.utils import prewarm

    scenes, prewarmed = [], []
    run, warm = SceneOptimizer.run, prewarm.prewarm_standard_shapes

    def capture_run(self, loader):
        out = run(self, loader)
        scenes.append((self, out[0]))
        return out

    def capture_prewarm(**kw):
        prewarmed.append(warm(**kw))
        return prewarmed[-1]

    forwards = [0]
    log_assignment = lightglue.LightGlueMatcher.log_assignment

    def counted(self, *args, **kwargs):
        forwards[0] += 1
        return log_assignment(self, *args, **kwargs)

    out = {"matcher": 0, "attention": 0, "composite": 0}
    bars = (RUNNER_REF_REGISTERED - RUNNER_REGISTERED_SLACK, RUNNER_REF_AUC5 - RUNNER_AUC5_SLACK)
    with tempfile.TemporaryDirectory() as work:
        gt_dir = os.path.join(work, "gt_colmap")
        write_gt_colmap(data_dir, gt_dir)
        base = ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", data_dir]
        argv_a = base + ["--use_cache", "--cache_root", os.path.join(work, "cache"), "--load_chunk_size",
                         str(OUTPUTS_CHUNK), "--prewarm", "--compare_to", gt_dir]
        SceneOptimizer.run, prewarm.prewarm_standard_shapes = capture_run, capture_prewarm
        lightglue.LightGlueMatcher.log_assignment = counted
        try:
            res = {}
            for tag, argv in (("A", argv_a), ("B", argv_a)):
                res[tag] = _runner_once(f"runner_outputs {tag}", argv, os.path.join(work, tag))
                _print_run(f"runner_outputs {tag}", res[tag], bars, smi)
                print(f"runner_outputs {tag} prewarm seconds: {json.dumps(prewarmed[-1])}", flush=True)
            (so_a, data_a), (_so_b, data_b) = scenes[-2:]
            chunks = -(-res["A"]["pairs"] // RUNNER_PAIR_BATCH)
            identical = _same_scene(data_a, data_b)
            print(f"runner_outputs: B replayed A bit for bit: {identical}; matcher launches A "
                  f"{res['A']['launches']['matcher']} (>= {chunks} chunks of {RUNNER_PAIR_BATCH}), B "
                  f"{res['B']['launches']['matcher']}; total_runtime_sec A {res['A']['sec']['total_runtime_sec']:.3f} "
                  f"(the runner phase's cold run {runner_cold_total:.3f}), B {res['B']['sec']['total_runtime_sec']:.3f}"
                  f" | {smi}", flush=True)
            if not identical or res["B"]["launches"]["matcher"] != 0 or res["A"]["launches"]["matcher"] < chunks:
                raise AssertionError("runner_outputs: the cache replay differs from the cold run or matched")
            results = os.path.join(work, "A", "results")
            missing = [f for f in RUNNER_OUTPUT_FILES if not os.path.isfile(os.path.join(results, f))]
            with open(os.path.join(results, "comparison", "comparison_metrics.csv")) as f:
                comparison = dict(line.strip().split(",", 1) for line in f if "{" not in line)
            print(f"runner_outputs A files: {sorted(os.path.relpath(p, results) for p in glob.glob(results + '/*'))}; "
                  f"against the GT COLMAP: {comparison.get('num_matched_cameras')} cameras matched, pose AUC@5 "
                  f"{comparison.get('pose_auc_@5.0_deg')}", flush=True)
            if missing:
                raise AssertionError(f"runner_outputs A: missing {missing}")

            # the chunked detection on the card against the whole batch's,
            # both detected afresh: neither replays run A's entries nor
            # writes one that run C would replay
            so_a._detect_cache = None
            loader = OlssonLoader(data_dir)
            images, sizes = loader.load_grayscale_batch()
            whole = so_a._detect_batch(torch.as_tensor(images, device="cuda"), sizes)
            chunked = so_a._load_detect_chunked(loader, False)[:3]
            shares = [keypoints_agree(*(a[i] for a in chunked), *(a[i] for a in whole))[0] for i in range(len(images))]
            print(f"runner_outputs: chunks of {OUTPUTS_CHUNK} against the whole batch on the card: keypoint share "
                  f"min {min(shares):.4f} mean {float(np.mean(shares)):.4f} (>= {OUTPUTS_CHUNK_SHARE})", flush=True)
            if min(shares) < OUTPUTS_CHUNK_SHARE:
                raise AssertionError(f"runner_outputs: chunked detection keeps {min(shares):.4f} of the keypoints")

            argv_c = base + ["--hierarchical", "--run_gs", "--gs_video_frames", str(OUTPUTS_FRAMES), "--use_cache",
                             "--cache_root", os.path.join(work, "cache"),
                             f"scene_optimizer.gs_iterations={OUTPUTS_GS_STEPS}",
                             f"scene_optimizer.max_cluster_size={OUTPUTS_CLUSTER_SIZE}"]
            res["C"] = _runner_once("runner_outputs C", argv_c, os.path.join(work, "C"))
            _print_run("runner_outputs C", res["C"], None, smi)
            so_c = scenes[-1][0]
            results = os.path.join(work, "C", "results")
            clusters = [p for p, _ in so_c.node_results if p]
            dirs = sorted(os.path.relpath(d, results) for d, _, _ in os.walk(results)
                          if os.path.basename(d).startswith("C_"))
            frames = sorted(glob.glob(os.path.join(results, "splat_video", "frame_*.png")))
            gif = os.path.isfile(os.path.join(results, "splat_flythrough.gif"))
            comp = res["C"]["launches"]["composite"]
            print(f"runner_outputs C: {len(clusters)} cluster results {clusters}, directories {dirs}; {len(frames)} "
                  f"frames, GIF {gif}, mp4 {os.path.isfile(os.path.join(results, 'splat_flythrough.mp4'))}; "
                  f"{comp} composite launches ({OUTPUTS_GS_STEPS} steps + {OUTPUTS_FRAMES} frames)", flush=True)
            if not clusters or len(dirs) != len(clusters) or len(frames) != OUTPUTS_FRAMES or not gif \
                    or comp != OUTPUTS_GS_STEPS + OUTPUTS_FRAMES:
                raise AssertionError("runner_outputs C: the SceneTree or the fly-through is not what the run made")

            weights = write_deep_weights(work, ("superpoint", "lightglue"))
            argv_d = ["--config_name", "deep_front_end", "--loader", "olsson", "--dataset_dirpath", data_dir] + \
                deep_overrides("deep_front_end", weights) + ["--use_cache", "--cache_root", os.path.join(work, "deep")]
            for tag in ("D", "E"):
                forwards[0] = 0
                res[tag] = _runner_once(f"runner_outputs {tag}", argv_d, os.path.join(work, tag))
                res[tag]["forwards"] = forwards[0]
                _print_run(f"runner_outputs {tag}", res[tag], None, smi)
            identical = _same_scene(scenes[-2][1], scenes[-1][1])
            attn = {t: res[t]["launches"]["attention"] for t in ("D", "E")}
            print(f"runner_outputs: deep_front_end cold {attn['D']} attention launches ({res['D']['forwards']} "
                  f"LightGlue forwards), replay {attn['E']}; E replayed D bit for bit: {identical}", flush=True)
            if not identical or attn["E"] or res["E"]["forwards"] or not res["D"]["forwards"] or \
                    attn["D"] != GLUE_LAUNCHES_PER_FORWARD * res["D"]["forwards"]:
                raise AssertionError("runner_outputs: the deep_front_end replay differs or ran LightGlue")
        finally:
            SceneOptimizer.run, prewarm.prewarm_standard_shapes = run, warm
            lightglue.LightGlueMatcher.log_assignment = log_assignment

        page = dashboard.save_comparison_dashboard({"runner": os.path.join(work, "A")},
                                                   {"runner": os.path.join(work, "B")},
                                                   os.path.join(work, "dashboard.html"))
        with open(page) as f:
            html = f.read()
        print(f"runner_outputs: dashboard over A and B, {len(html)} bytes", flush=True)
        if "<h2>retrieval_metrics</h2>" not in html:
            raise AssertionError("runner_outputs: the dashboard lacks the retrieval_metrics table")
    print("runner_outputs seconds: " + " ".join(
        f"{k} A {res['A']['sec'][k]:.3f} B {res['B']['sec'][k]:.3f}" for k in res["A"]["sec"]) + f" | {smi}",
        flush=True)
    for tag in "ABCDE":
        for k in out:
            out[k] += res[tag]["launches"][k]
    out["runs"] = {tag: res[tag]["launches"] for tag in "ABCDE"}
    return out


def _check_rejections(res, opts) -> dict:
    """Pairs of a TwoViewResult that pass the inlier support but fail the
    homography check or the indeterminacy check."""
    support = (res.num_inliers >= opts.min_num_inliers) & (res.inlier_ratio >= opts.min_inlier_ratio)
    return {"homography": int((support & (res.hf_ratio >= opts.homography_degeneracy_ratio)).sum()),
            "indeterminacy": int((support & ~(res.eig_ratio > opts.indeterminacy_eig_ratio)).sum()),
            "pairs": int(res.valid.numel()), "valid": int(res.valid.sum())}


def phase_runner_options(smi: str, data_dir: str, n_views: int) -> dict:
    """The runner phase's folder through ``gtsfm_tpu_torch.runner.main``
    with RUNNER_OPTIONS (the homography and indeterminacy checks, LMedS
    scoring, top-K-baseline triangulation, one cycle-filter pass, uniform
    rotation weights, measurement-seeded MFAS directions) through
    _runner_runs, cold and warm: registered >= the JAX reference's - 1,
    AUC@5 >= its - 0.02 (scripts/runner_options_reference.py), and both
    checks on in the two-view batch; prints how many pairs each check
    rejected in each run.

    Then the card against the CPU on the two-view batch alone: the first
    OPTIONS_CHECK_PAIRS pairs of the cold run's first chunk (its inputs
    recorded as the run called ``run_two_view_batch``), matched once on the
    card by kernel #1, their essential and homography minimal sets drawn on
    the card (``two_view.draw_samples``), and ``run_two_view_batch`` with
    those matches and draws on `cuda` and on the CPU: ``valid`` must agree
    on every pair whose inlier ratio, H/F ratio and eigenvalue ratio lie
    more than OPTIONS_CHECK_MARGIN (relative) from their thresholds on both
    devices and whose inlier count is not within one of its bar. Returns the
    launches of the warm run."""
    import torch

    from gtsfm_tpu_torch.frontend import two_view
    from gtsfm_tpu_torch.frontend.matchers.fused_matcher import fused_match_descriptors
    from gtsfm_tpu_torch.scene import scene_optimizer

    run_two_view = scene_optimizer.run_two_view_batch
    first_call, rejected = [], {}

    def recording(*args, **kwargs):
        res = run_two_view(*args, **kwargs)
        if not first_call:
            first_call.append((args, kwargs))
        for k, v in _check_rejections(res, kwargs["opts"]).items():
            rejected[k] = rejected.get(k, 0) + v
        return res

    def check_export(export, back, layouts):
        print(f"runner_options: pairs rejected by the homography check {rejected['homography']}, by the "
              f"indeterminacy check {rejected['indeterminacy']} ({rejected['valid']} of {rejected['pairs']} "
              f"valid)", flush=True)
        rejected.clear()  # the counts of one run
        opts = first_call[0][1]["opts"]
        if not (opts.homography_degeneracy_ratio > 0 and opts.indeterminacy_eig_ratio > 0
                and opts.ransac.scoring == "lmeds"):
            raise AssertionError(f"runner_options: the two-view batch ran with {opts}")

    scene_optimizer.run_two_view_batch = recording
    try:
        out = _runner_runs("runner_options", ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath",
                                              data_dir] + RUNNER_OPTIONS,
                           n_views, RUNNER_OPTIONS_REF_REGISTERED - RUNNER_REGISTERED_SLACK,
                           RUNNER_OPTIONS_REF_AUC5 - RUNNER_AUC5_SLACK, smi, check_export)
    finally:
        scene_optimizer.run_two_view_batch = run_two_view

    args, kwargs = first_call[0]
    n = OPTIONS_CHECK_PAIRS
    opts = kwargs["opts"]
    xy1, xy2, d1, d2, m1, m2 = (a[:n] for a in args[:6])
    inputs = (xy1, xy2, d1, d2, m1, m2, args[6].map(lambda a: a[:n]), args[7].map(lambda a: a[:n]), args[8][:n])
    pair_ids = kwargs["pair_ids"][:n]
    midx, mmask, mscore = fused_match_descriptors(d1, d2, m1, m2, ratio=opts.matching_ratio)
    sidx, hidx = two_view.draw_samples(mmask, mscore, inputs[-1], opts, kwargs["seed"], pair_ids)
    draws = dict(seed=kwargs["seed"], opts=opts, pair_ids=pair_ids, sample_idx=sidx, h_sample_idx=hidx,
                 match_idx=midx, match_mask=mmask, match_score=mscore)

    def cpu(x):
        return x.map(lambda a: a.cpu()) if hasattr(x, "map") else x.cpu() if torch.is_tensor(x) else x

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_two_view(*inputs, **draws)
    torch.cuda.synchronize()
    card_sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = run_two_view(*(cpu(a) for a in inputs), **{k: cpu(v) for k, v in draws.items()})
    host_sec = time.perf_counter() - t0
    card = cpu(card)
    far = torch.ones(n, dtype=torch.bool)
    for r in (card, host):
        for name, bar in (("inlier_ratio", opts.min_inlier_ratio), ("hf_ratio", opts.homography_degeneracy_ratio),
                          ("eig_ratio", opts.indeterminacy_eig_ratio)):
            far &= (getattr(r, name) - bar).abs() > OPTIONS_CHECK_MARGIN * bar
        far &= (r.num_inliers - opts.min_num_inliers).abs() > 1
    differ = card.valid != host.valid
    both = card.valid & host.valid
    rot = float((card.i2Ri1 - host.i2Ri1)[both].abs().max()) if bool(both.any()) else 0.0
    print(f"runner_options card vs CPU: {n} pairs of the first chunk, {int(far.sum())} away from every threshold, "
          f"valid {int(card.valid.sum())} on the card and {int(host.valid.sum())} on the CPU, {int(differ.sum())} "
          f"differ ({int((differ & far).sum())} of them away from the thresholds); rejected on the card "
          f"{_check_rejections(card, opts)}, on the CPU {_check_rejections(host, opts)}; max |R| difference of "
          f"pairs valid on both {rot:.3g}; {card_sec:.3f} s on the card, {host_sec:.3f} s on the CPU", flush=True)
    if bool((differ & far).any()):
        raise AssertionError(f"runner_options: valid differs between the card and the CPU on pairs "
                             f"{torch.nonzero(differ & far).flatten().tolist()} away from every threshold")
    return out["launches"]


def colmap_opencv_views(R, t, dev) -> tuple:
    """The runner phase's views (runner_scene from the ring, in ring order)
    resampled through OPENCV_CAMERA: (views (32, H, W, 3), R, t in ring
    order)."""
    order = ring_order(t)
    views = ring_views(R, t, dev, runner_scene(np.asarray(t).mean(axis=0)), indices=order)
    views = np.stack([resample_opencv(v, SPLAT_FOCAL, OPENCV_CAMERA) for v in views])
    return views, np.asarray(R)[order], np.asarray(t)[order]


def phase_colmap_runner(smi: str, R, t) -> dict:
    """The runner with ``--loader colmap`` on `cuda`: colmap_opencv_views
    written as a COLMAP folder (one OPENCV camera, GT poses), then
    _runner_runs with the unified config, cold and warm: DoG-SIFT on the
    distorted images, the matcher kernel, two-view estimation through
    Cal3DS2, MVO, whose dense BA falls back to the entry layout for
    Cal3DS2, and the COLMAP export. Each run requires at least one BA solve
    in the entry layout and none in dense, registered >= the JAX
    reference's - 1, AUC@5 >= its - 0.02, and cameras.txt written as
    OPENCV with the distortion within OPENCV_EXPORT_TOL of the truth.
    Returns the launches of the warm run."""
    import os
    import tempfile

    import torch

    from gtsfm_tpu_torch.geometry import Cal3DS2

    t0 = time.perf_counter()
    views, Ro, to = colmap_opencv_views(R, t, torch.device("cuda"))

    def check_export(export, back, layouts):
        if layouts.get("entry", 0) < 1 or layouts.get("dense", 0):
            raise AssertionError(f"colmap_runner: BA solves by layout {layouts}; entry and no dense expected")
        models = {ln.split()[1] for ln in open(os.path.join(export, "cameras.txt")) if not ln.startswith("#")}
        cal = back.cal
        err = max(float((getattr(cal, k) - OPENCV_CAMERA[k]).abs().max()) for k in ("k1", "k2", "p1", "p2"))
        if models != {"OPENCV"} or not isinstance(cal, Cal3DS2) or err > OPENCV_EXPORT_TOL:
            raise AssertionError(f"colmap_runner: exported models {models}, distortion off by {err}")
        print(f"colmap_runner export: models {sorted(models)}, distortion off by at most {err:.3g} "
              f"(tolerance {OPENCV_EXPORT_TOL})", flush=True)

    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "data")
        write_colmap_opencv(data_dir, views, Ro, to, OPENCV_CAMERA)
        print(f"colmap_runner: {len(views)} views of runner_scene resampled through OPENCV {OPENCV_CAMERA} and "
              f"written in {time.perf_counter() - t0:.3f} s", flush=True)
        out = _runner_runs("colmap_runner",
                           ["--config_name", "unified", "--loader", "colmap", "--dataset_dirpath", data_dir],
                           len(views), COLMAP_REF_REGISTERED - RUNNER_REGISTERED_SLACK,
                           COLMAP_REF_AUC5 - RUNNER_AUC5_SLACK, smi, check_export)
    return out["launches"]


def phase_ba_layouts(smi: str) -> None:
    """The three BA layouts on `cuda` on ba_scene (BA_CAMERAS cameras,
    BA_POINTS points, tracks of BA_TRACK_LEN views, 1 px, plain least
    squares, cameras 0 and 1 fixed), each solved once with the default
    30 LM steps and 40 PCG steps: each must run in its own layout
    (``layout_counts``) and end below BA_COST_RATIO of its initial cost;
    entry and scatter within BA_LAYOUT_GAP of dense. Then the same scene
    plus one track seen by BA_LONG_TRACK cameras with layout="dense": it
    must run in entry, finite and below its initial cost."""
    import torch

    from gtsfm_tpu_torch.bundle import ba

    dev = torch.device("cuda")
    data = ba_sfm_data(ba_scene(), dev)
    fixed = torch.arange(BA_CAMERAS, device=dev) < 2
    n_meas = int(data.meas_mask.sum())
    final = {}
    for layout in ("dense", "entry", "scatter", "dense_long"):
        if layout == "dense_long":
            data = ba_sfm_data(ba_scene(long_track=BA_LONG_TRACK), dev)
        ba.layout_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, m = ba.BundleAdjustment(ba.BAOptions(robust_huber_px=0.0, layout=layout.split("_")[0])).run(
            data, fixed_cam=fixed)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        ran = dict(ba.layout_counts)
        print(f"ba_layouts {layout}: ran {ran}, {BA_CAMERAS} cameras, {data.number_tracks()} tracks, "
              f"{int(data.meas_mask.sum())} measurements, {sec:.3f} s, cost {m['initial_cost']:.6g} -> "
              f"{m['final_cost']:.6g} ({m['final_cost'] / m['initial_cost']:.3g}) | {smi}", flush=True)
        want = "entry" if layout == "dense_long" else layout
        if ran != {want: 1}:
            raise AssertionError(f"ba_layouts {layout}: ran {ran}, not {want}")
        if not (bool(torch.isfinite(out.points).all()) and m["final_cost"] < BA_COST_RATIO * m["initial_cost"]):
            raise AssertionError(f"ba_layouts {layout}: cost {m['initial_cost']} -> {m['final_cost']}")
        final[layout] = m["final_cost"]
    gaps = {k: final[k] / final["dense"] - 1.0 for k in ("entry", "scatter")}
    print(f"ba_layouts: final cost against dense {gaps} ({n_meas} measurements)", flush=True)
    if max(abs(g) for g in gaps.values()) > BA_LAYOUT_GAP:
        raise AssertionError(f"ba_layouts: entry / scatter final costs off dense's by {gaps}")


def splat_trainer_inputs(R, t):
    """The full-width trainer's inputs: the splat scene's views from every
    ring camera (R, t) at SPLAT_HW, rendered by the port, and an SfmData of
    the ring poses, f = SPLAT_FOCAL, and SPLAT_POINTS of the scene's means
    plus seeded noise as points. Returns (SfmData, views (n, H, W, 3))."""
    import torch

    from gtsfm_tpu_torch.common.sfm_data import SfmData
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler

    dev = torch.device("cuda")
    h, w = SPLAT_HW
    n = len(t)
    fields = splat_scene(np.asarray(t).mean(axis=0), n=SPLAT_GAUSSIANS)
    views = ring_views(R, t, dev, fields)
    rng = np.random.default_rng(1)
    pts = fields["means"][:SPLAT_POINTS] + rng.normal(0, 0.05, (SPLAT_POINTS, 3)).astype(np.float32)
    z = torch.zeros(n)
    data = SfmData(
        poses=SE3(R=torch.as_tensor(R, device=dev), t=torch.as_tensor(t, device=dev)),
        cal=Cal3Bundler.create(torch.full((n,), SPLAT_FOCAL), z, z, torch.full((n,), w / 2.0),
                               torch.full((n,), h / 2.0), device=dev),
        pose_mask=torch.ones(n, dtype=torch.bool, device=dev),
        points=torch.as_tensor(pts, device=dev),
        track_mask=torch.ones(SPLAT_POINTS, dtype=torch.bool, device=dev),
        meas_cam=torch.zeros(1, dtype=torch.int64, device=dev),
        meas_track=torch.zeros(1, dtype=torch.int64, device=dev),
        meas_uv=torch.zeros((1, 2), device=dev),
        meas_mask=torch.zeros(1, dtype=torch.bool, device=dev),
    )
    return data, views


def phase_splat(R, t):
    """GaussianSplatting.train at full width: SPLAT_GAUSSIANS slots at
    SPLAT_HW for SPLAT_STEPS steps on splat_trainer_inputs. Returns
    compositing launches during the training."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.splat import rendering
    from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions

    dev = torch.device("cuda")
    h, w = SPLAT_HW
    data, views = splat_trainer_inputs(R, t)
    trainer = GaussianSplatting(GSTrainOptions(iterations=SPLAT_STEPS))
    fused_matcher.launch_count = fused_attention.launch_count = rendering.launch_count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs, metrics = trainer.train(data, views)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = rendering.launch_count
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        counts = rendering.bin_tiles(gs, *splat_camera(R, t, 0, dev), h, w)[2].float()
    print(f"splat: {gs.max_gaussians} slots at {h}x{w}, {SPLAT_STEPS} steps in {sec:.3f} s "
          f"({sec / SPLAT_STEPS:.4f} s/step, host clock), peak device memory {peak / 2**30:.3f} GiB, {launches} "
          f"composite launches | {metrics} | live slots per tile of the trained splats from camera 0: median "
          f"{float(counts.median()):.0f}, mean {float(counts.mean()):.1f}, max {int(counts.max())}", flush=True)
    if launches < SPLAT_STEPS:
        raise AssertionError(f"the trainer launched the compositing kernel {launches} times in {SPLAT_STEPS} steps")
    if not metrics["final_l1"] < SPLAT_L1_RATIO * metrics["initial_l1"]:
        raise AssertionError(f"the trainer's L1 did not fall below {SPLAT_L1_RATIO} of the initial: {metrics}")
    if not bool(torch.isfinite(gs.means).all()):
        raise AssertionError("the trained splats are not finite")
    return launches


def _runner_once(tag: str, argv: list, out: str) -> dict:
    """``gtsfm_tpu_torch.runner.main(argv + --output_root out)`` in this
    process, with every launch count, the DoG-SIFT device count and
    ``ba.layout_counts`` set to 0 just before and read just after, and the
    peak device memory. A run whose back end failed has no pose metrics:
    it counts 0 registered. Returns {"registered", "auc5", "pairs",
    "valid", "sec", "launches", "detector", "peak_gib", "wall", "metrics",
    "pair_list", "matches_per_pair"}: the last two per two-view pair, in
    the order of the metrics."""
    import os

    import torch

    from gtsfm_tpu_torch import runner
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup
    from gtsfm_tpu_torch.frontend.detectors import dog_sift
    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer
    from gtsfm_tpu_torch.splat import rendering

    two_view = SceneOptimizer._run_two_view
    pair_list = []

    def recorded(self, pairs, *args, **kwargs):
        pair_list.extend(np.asarray(pairs).tolist())
        return two_view(self, pairs, *args, **kwargs)

    dog_sift.calls_by_device.clear()
    ba.layout_counts.clear()
    fused_matcher.launch_count = fused_attention.launch_count = rendering.launch_count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SceneOptimizer._run_two_view = recorded
    t0 = time.perf_counter()
    try:
        rc = runner.main(argv + ["--output_root", out])
        torch.cuda.synchronize()
    finally:
        SceneOptimizer._run_two_view = two_view
    wall = time.perf_counter() - t0
    launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count,
                "composite": rendering.launch_count}
    mdir = os.path.join(out, "results", "metrics")
    metrics = {g.name: {m.name: m for m in g.metrics}
               for g in (MetricsGroup.from_json(os.path.join(mdir, f)) for f in sorted(os.listdir(mdir)))}
    if rc != 0 or "frontend_summary" not in metrics or "total_summary" not in metrics:
        raise AssertionError(f"{tag}: exit code {rc}, metrics groups {sorted(metrics)}")
    fe = {k: m.scalar for k, m in metrics["frontend_summary"].items() if m.dist is None}
    pose = metrics.get("ba_pose_metrics", {})
    sec = {k: fe[k] for k in ("detect_describe_sec", "retriever_duration_sec", "two_view_sec")}
    sec["backend_sec"] = metrics["multiview_optimizer_metrics"]["backend_sec"].scalar
    sec["total_runtime_sec"] = metrics["total_summary"]["total_runtime_sec"].scalar
    return {"registered": len(pose["rotation_error_deg"].dist) if pose else 0,
            "auc5": pose["pose_auc_@5.0_deg"].scalar if pose else 0.0,
            "pairs": int(fe["num_pairs"]), "valid": int(fe["num_valid_pairs"]), "sec": sec, "launches": launches,
            "detector": dict(dog_sift.calls_by_device), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "wall": wall, "metrics": metrics,
            "pair_list": pair_list,
            "matches_per_pair": metrics["frontend_summary"]["num_matches_per_pair"].dist.astype(int).tolist()}


def _print_run(tag: str, res: dict, bars, smi: str) -> None:
    """Print a _runner_once result; with ``bars`` (registered, AUC@5) hold
    the run to them."""
    kps = res["metrics"]["frontend_summary"]["num_keypoints_per_image"].dist
    bar = f" (bars {bars[0]}, {bars[1]:.4f})" if bars else ""
    print(f"{tag}: {res['registered']}/{NUM_CAMERAS} registered, pose AUC@5 {res['auc5']:.4f}{bar}, "
          f"{res['pairs']} pairs ({res['valid']} valid), keypoints per image median "
          f"{float(np.median(kps)):.0f} min {int(np.min(kps))} max {int(np.max(kps))}, launches {res['launches']}, "
          f"DoG-SIFT calls by device {res['detector']}, peak device memory {res['peak_gib']:.2f} GiB", flush=True)
    print(f"{tag} seconds: " + " ".join(f"{k} {v:.3f}" for k, v in res["sec"].items())
          + f" main {res['wall']:.3f} | {smi}", flush=True)
    if bars and (res["registered"] < bars[0] or res["auc5"] < bars[1]):
        raise AssertionError(f"{tag}: registered {res['registered']} (bar {bars[0]}), AUC@5 {res['auc5']:.4f} "
                             f"(bar {bars[1]:.4f})")


def deep_reference(config: str) -> dict:
    """The JAX package's runs of ``config`` in DEEP_REFERENCE: the medians
    over its seeds of registered, AUC@5 and valid pairs, the values by
    seed, and the first run's pairs and per-pair match counts (the seed
    moves neither)."""
    import os

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), DEEP_REFERENCE)) as f:
        runs = [r for r in json.load(f)["runs"] if r["config"] == config]
    by_seed = {"registered": [r["registered"] for r in runs], "auc5": [r["pose_auc_@5.0_deg"] for r in runs],
               "valid": [r["num_valid_pairs"] for r in runs]}
    seeds = [int(o.split("=")[1]) for r in runs for o in r["overrides"] if o.startswith("scene_optimizer.seed=")]
    return {"seeds": seeds, "median": {k: float(np.median(v)) for k, v in by_seed.items()}, "by_seed": by_seed,
            "pairs": runs[0]["pairs"], "matches": np.asarray(runs[0]["num_matches_per_pair"])}


def _hold_to_reference(tag: str, runs: list, ref: dict) -> dict:
    """The runs of a deep config, one for each of DEEP_SEEDS, against the
    JAX package's (deep_reference): the first run (seed 0, as the
    reference's first) holds at least DEEP_PAIR_SHARE of the reference's
    pairs, and on the common pairs its match counts within
    DEEP_MATCH_ABS + DEEP_MATCH_TOL each and DEEP_MATCH_TOTAL_TOL in sum
    (relative); the medians of registered, AUC@5 and valid pairs within
    the bars. Returns the medians, the pair share and the match counts'
    differences."""
    mine = dict(zip(map(tuple, runs[0]["pair_list"]), runs[0]["matches_per_pair"]))
    theirs = dict(zip(map(tuple, ref["pairs"]), ref["matches"].tolist()))
    common = [p for p in theirs if p in mine]
    share = len(common) / max(len(theirs), len(mine))
    got, want = np.asarray([mine[p] for p in common]), np.asarray([theirs[p] for p in common])
    off = np.abs(got - want)
    worst = int(np.argmax(off / (DEEP_MATCH_ABS + DEEP_MATCH_TOL * want)))
    share_of_tol = float(off[worst] / (DEEP_MATCH_ABS + DEEP_MATCH_TOL * want[worst]))
    total = abs(int(got.sum()) - int(want.sum())) / max(int(want.sum()), 1)
    med = {k: float(np.median([r[k] for r in runs])) for k in ("registered", "auc5", "valid")}
    bars = {"registered": ref["median"]["registered"] - RUNNER_REGISTERED_SLACK,
            "auc5": ref["median"]["auc5"] - RUNNER_AUC5_SLACK,
            "valid": ref["median"]["valid"] * (1.0 - DEEP_VALID_SLACK)}
    print(f"{tag} against the JAX package: {len(common)} of its {len(theirs)} pairs retrieved ({share:.4f}, bar "
          f"{DEEP_PAIR_SHARE}; only here {sorted(set(mine) - set(theirs))}, only there "
          f"{sorted(set(theirs) - set(mine))}); matches on them {int(got.sum())} (the reference's {int(want.sum())}, "
          f"{total:.5f} apart, tol {DEEP_MATCH_TOTAL_TOL}), {int((got == want).sum())} pairs equal, by pair at "
          f"worst {int(got[worst])} against {int(want[worst])} ({share_of_tol:.3f} of the tolerance "
          f"{DEEP_MATCH_ABS} + {DEEP_MATCH_TOL} of the reference's)", flush=True)
    print(f"{tag} over seeds {DEEP_SEEDS}: registered {[r['registered'] for r in runs]}, AUC@5 "
          f"{[round(r['auc5'], 4) for r in runs]}, valid {[r['valid'] for r in runs]}; medians "
          + ", ".join(f"{k} {v:.4f} (bar {bars[k]:.4f})" for k, v in med.items())
          + f"; the reference's over seeds {ref['seeds']}: registered {ref['by_seed']['registered']}, AUC@5 "
          f"{[round(a, 4) for a in ref['by_seed']['auc5']]}, valid {ref['by_seed']['valid']}", flush=True)
    if share < DEEP_PAIR_SHARE or share_of_tol > 1.0 or total > DEEP_MATCH_TOTAL_TOL:
        raise AssertionError(f"{tag}: pairs {share:.4f} in common, match counts {share_of_tol:.3f} of the "
                             f"tolerance apart at worst and {total:.5f} in sum")
    low = [k for k in med if med[k] < bars[k]]
    if low:
        raise AssertionError(f"{tag}: medians {med} below the bars {bars} ({low})")
    return {"median": med, "bars": bars, "pair_share": share, "match_share_of_tol": share_of_tol,
            "match_rel_total": total}


def _capture(module, names: tuple, store: dict):
    """Wrap ``module``'s functions ``names`` so that each keeps the
    arguments of its first call in ``store``; returns the function that
    restores them. The wrapped calls run (and count) as before."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def f(*args, **kwargs):
            store.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return f

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)

    return restore


def keypoints_agree(xy_a, m_a, d_a, xy_b, m_b, d_b, tol: float = 0.05) -> tuple:
    """Two detections of one image (coordinates (K, 2), masks (K,),
    descriptors (K, D), numpy): the share of the valid keypoints found in
    both (a valid keypoint of the other within ``tol`` px) over the larger
    valid count, and the largest descriptor difference over those pairs."""
    from scipy.spatial import cKDTree

    a, b = xy_a[m_a], xy_b[m_b]
    if len(a) == 0 or len(b) == 0:
        return float(len(a) == len(b)), 0.0
    dist, j = cKDTree(b).query(a, distance_upper_bound=tol)
    hit = np.isfinite(dist)
    share = int(hit.sum()) / max(len(a), len(b))
    err = float(np.abs(d_a[m_a][hit] - d_b[m_b][j[hit]]).max()) if hit.any() else 0.0
    return share, err


@contextlib.contextmanager
def tf32_allowed():
    """Every ``precise()`` of the port turns TF32 on for matmuls and cuDNN
    instead of off: the negative control of the card-against-CPU checks,
    which must fail with it."""
    import torch

    from gtsfm_tpu_torch.utils import numerics

    @contextlib.contextmanager
    def loose():
        flags = torch.backends.cuda.matmul, torch.backends.cudnn
        prev = tuple(f.allow_tf32 for f in flags)
        for f in flags:
            f.allow_tf32 = True
        try:
            yield
        finally:
            for f, v in zip(flags, prev):
                f.allow_tf32 = v

    strict = numerics.precise
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("gtsfm_tpu_torch.") and getattr(m, "precise", None) is strict]
    for m in mods:
        m.precise = loose
    try:
        yield
    finally:
        for m in mods:
            m.precise = strict


def _hold_detector(tag: str, det, images) -> dict:
    """A registry detector on the card and on the CPU on the same images:
    each image's valid keypoints in both >= DEEP_KEYPOINT_SHARE (the top-K
    cut and NMS ties move with float32 order), descriptors of the common
    ones within DEEP_DESC_TOL; the card run with TF32 on must fail that.
    Returns the card call's seconds and the worst share and error, with
    TF32 off and on."""
    import torch

    x = torch.as_tensor(images, device="cuda")
    det.detect_batch(x)  # first call: cuDNN picks its algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = det.detect_batch(x)
    torch.cuda.synchronize()
    card_sec = time.perf_counter() - t0
    cpu = det.detect_batch(torch.as_tensor(images))
    with tf32_allowed():
        loose = det.detect_batch(x)

    def held(got):
        res = [keypoints_agree(*(a[b] for a in got), *(a[b] for a in cpu)) for b in range(len(images))]
        return min(r[0] for r in res), max(r[1] for r in res)

    (share, err), (share32, err32) = held(card), held(loose)
    n_valid = [int(m.sum()) for m in card[1]]
    print(f"{tag} card vs CPU on {len(images)} views at {images.shape[1]}x{images.shape[2]}: valid keypoints "
          f"{n_valid}, worst share in both {share:.4f} (bar {DEEP_KEYPOINT_SHARE}), descriptors max |d| {err:.3g} "
          f"(tol {DEEP_DESC_TOL}); with TF32 on {share32:.4f}, {err32:.3g}; card {card_sec:.4f} s a batch",
          flush=True)
    if share < DEEP_KEYPOINT_SHARE or err > DEEP_DESC_TOL or min(n_valid) == 0:
        raise AssertionError(f"{tag}: the card and the CPU disagree (share {share:.4f}, descriptors {err:.3g})")
    if share32 >= DEEP_KEYPOINT_SHARE and err32 <= DEEP_DESC_TOL:
        raise AssertionError(f"{tag}: the check passes with TF32 on too (share {share32:.4f}, descriptors {err32:.3g})")
    return {"card_sec": card_sec, "share": share, "desc_err": err, "valid": n_valid, "tf32_share": share32,
            "tf32_desc_err": err32}


def _hold_descriptor(tag: str, desc, images) -> dict:
    """A global descriptor on the card and on the CPU: every value within
    DEEP_DESC_TOL (unit rows); with TF32 on, not."""
    import torch

    x = torch.as_tensor(images, device="cuda")
    desc.describe_batch(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = desc.describe_batch(x)
    torch.cuda.synchronize()
    card_sec = time.perf_counter() - t0
    cpu = desc.describe_batch(torch.as_tensor(images))
    with tf32_allowed():
        loose = desc.describe_batch(x)
    err, err32 = float(np.abs(card - cpu).max()), float(np.abs(loose - cpu).max())
    print(f"{tag} card vs CPU on {len(images)} views: {card.shape[1]}-d, max |d| {err:.3g} (tol {DEEP_DESC_TOL}), "
          f"with TF32 on {err32:.3g}; largest |value| {float(np.abs(cpu).max()):.3g}; card {card_sec:.4f} s a batch",
          flush=True)
    if err > DEEP_DESC_TOL or not np.isfinite(card).all():
        raise AssertionError(f"{tag}: the card and the CPU disagree by {err:.3g}")
    if err32 <= DEEP_DESC_TOL:
        raise AssertionError(f"{tag}: the check passes with TF32 on too ({err32:.3g})")
    return {"card_sec": card_sec, "err": err, "tf32_err": err32}


def _attention_flops(q, mask_k, dh_total) -> float:
    """Operations of one attention direction on this data: every query row
    against the valid keys, q.k and p.v, 2 per multiply-add."""
    return 4.0 * dh_total * q.shape[1] * float(mask_k.sum())


def _attention_at_runner_shape(captured: dict, heads: int) -> dict:
    """The merged self and cross entries on the inputs LightGlue gave them
    in the runner (their first calls): kernel against plain
    (attention_agrees), then each timed in turns with its plain version and
    scaled_dot_product_attention (10 samples for the plain version at this
    size). The bound counts this data's valid keys. Returns {entry:
    {"err", "ratio", "kernel", "plain", "library", "bound", "shape"}}."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa

    out = {}
    (q, k, v, h), kw = captured["fused_attention_merged"]
    mask = kw.get("kv_mask")
    (qk0, qk1, v0, v1, h2), kw2 = captured["fused_cross_attention_merged"]
    m0, m1 = kw2.get("mask0"), kw2.get("mask1")
    C = q.shape[-1]
    cases = {
        "fused_attention_merged": (lambda: [fa.fused_attention_merged(q, k, v, h, kv_mask=mask)],
                                   lambda: [fa.attend_merged(q, k, v, h, mask)], [v],
                                   attention_library(*(x.contiguous() for x in (q, k, q, v)), mask, mask,
                                                     h)["fused_attention_merged"],
                                   _attention_flops(q, mask, C),
                                   4 * q.nbytes + mask.nbytes),
        "fused_cross_attention_merged": (
            lambda: list(fa.fused_cross_attention_merged(qk0, qk1, v0, v1, h2, m0, m1)),
            lambda: list(fa.cross_attend_merged(qk0, qk1, v0, v1, h2, m0, m1)), [v1, v0],
            attention_library(*(x.contiguous() for x in (qk0, qk1, v0, v1)), m0, m1,
                              h2)["fused_cross_attention_merged"],
            _attention_flops(qk0, m1, C) + _attention_flops(qk1, m0, C),
            2 * (qk0.nbytes + qk1.nbytes + v0.nbytes + v1.nbytes) + m0.nbytes + m1.nbytes),
    }
    from gtsfm_tpu_torch.utils.numerics import precise

    with precise():
        for entry, (kern, plain, vs, lib, flops, nbytes) in cases.items():
            got, want = kern(), plain()
            res = [attention_agrees(g, w, vv) for g, w, vv in zip(got, want, vs)]
            err, ratio = max(r[0] for r in res), max(r[1] for r in res)
            del got, want
            if ratio > 1.0 or not all(r[2] for r in res):
                raise AssertionError(f"attention kernel disagrees at the runner's shape / {entry}: max abs err "
                                     f"{err:.4g}, {ratio:.3f} of the tolerance")
            bound = max((flops / PEAK_BF16 * 1e3, "operations"), (nbytes / PEAK_BYTES * 1e3, "bytes"))
            calls = {"kernel": kern, "plain": plain, "library": lib}
            runs = [(w, _median_ms(calls[w], reps=10, batch=1) if w == "plain" else _median_ms(calls[w]))
                    for w in ("kernel", "library", "plain", "plain", "library", "kernel")]
            ms = {w: float(np.median([t for kk, t in runs if kk == w])) for w in calls}
            shape = f"P{q.shape[0]}_K{q.shape[1]}_{h}x{C // h}"
            out[entry] = dict(ms, err=err, ratio=ratio, bound=bound, shape=shape, flops=flops)
            print(f"attention at the runner's shape {shape} {entry}: max abs err {err:.4g} ({ratio:.3f} of the "
                  f"tolerance) | kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
                  f"scaled_dot_product_attention {ms['library']:.4f} ms (median of samples, CUDA events, in "
                  f"turns) | {flops / ms['kernel'] / 1e9:.1f} TFLOP/s on the valid keys, bound {bound[0]:.4f} ms "
                  f"({bound[1]}), {bound[0] / ms['kernel']:.3f} of it | runs {runs}", flush=True)
    return out


def phase_deep_front_end(smi: str, data_dir: str) -> dict:
    """The deep front end through the entry point on `cuda`:
    ``gtsfm_tpu_torch.runner.main`` with ``deep_front_end`` (SuperPoint at
    K=2048 on the 480x640 views, LightGlue at full width, NetVLAD, the
    joint retriever, pair_batch_size 256) on the runner phase's Olsson
    folder, with the seeded SuperPoint and LightGlue checkpoints by
    ``weights_path`` (NetVLAD keeps its seeded init), cold and then warm:
    36 attention launches per LightGlue forward, no matcher launch,
    registered and AUC@5 within the JAX package's bars
    (scripts/deep_front_end_reference.py); then the attention kernel on the
    inputs LightGlue gave it in the warm run against its plain version and
    timed; then the card against the CPU: SuperPoint on DEEP_CPU_VIEWS
    views, NetVLAD on all 32, LightGlue on DEEP_CPU_PAIRS pairs (the
    matches on every decisive row). Returns the warm run's results and the
    attention timings."""
    import os

    import torch

    from gtsfm_tpu_torch.frontend import registry
    from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import NetVLADDescriptor
    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa
    from gtsfm_tpu_torch.frontend.matchers import lightglue
    from gtsfm_tpu_torch.loader.olsson import OlssonLoader

    with tempfile.TemporaryDirectory() as work:
        weights = write_deep_weights(work, ("superpoint", "lightglue"))
        netvlad = NetVLADDescriptor()
        sumsq = dict(weights["sumsq"], netvlad=float(sum(v.double().square().sum()
                                                            for v in netvlad.net.state_dict().values())))
        print(f"deep_front_end weights: sums of squares {sumsq}", flush=True)
        argv = ["--config_name", "deep_front_end", "--loader", "olsson", "--dataset_dirpath", data_dir] + \
            deep_overrides("deep_front_end", weights)
        forwards = [0]
        orig = lightglue.LightGlueMatcher.log_assignment

        def counted(self, *args, **kwargs):
            forwards[0] += 1
            return orig(self, *args, **kwargs)

        captured = {}
        results = {}
        lightglue.LightGlueMatcher.log_assignment = counted
        try:
            for run, seed in [("cold", DEEP_SEEDS[0]), ("warm", DEEP_SEEDS[0])] + \
                    [(f"seed {s}", s) for s in DEEP_SEEDS[1:]]:
                forwards[0] = 0
                restore = _capture(fa, ("fused_attention_merged", "fused_cross_attention_merged"),
                                   captured) if run == "warm" else (lambda: None)
                try:
                    res = _runner_once(f"deep_front_end {run}", argv + [f"scene_optimizer.seed={seed}"],
                                       os.path.join(work, run.replace(" ", "")))
                finally:
                    restore()
                res["forwards"] = forwards[0]
                _print_run(f"deep_front_end {run}", res, None, smi)
                print(f"deep_front_end {run}: {forwards[0]} LightGlue forwards, {res['launches']['attention']} "
                      f"attention launches ({GLUE_LAUNCHES_PER_FORWARD} a forward required)", flush=True)
                if forwards[0] < -(-res["pairs"] // 256) or \
                        res["launches"]["attention"] != GLUE_LAUNCHES_PER_FORWARD * forwards[0]:
                    raise AssertionError(f"deep_front_end {run}: {res['launches']['attention']} attention launches "
                                         f"for {forwards[0]} forwards over {res['pairs']} pairs")
                if res["launches"]["matcher"] != 0:
                    raise AssertionError(f"deep_front_end {run}: the mutual-NN kernel ran")
                results[run] = res
        finally:
            lightglue.LightGlueMatcher.log_assignment = orig
        held = _hold_to_reference("deep_front_end", [results["warm"]] + [results[f"seed {s}"] for s in DEEP_SEEDS[1:]],
                                  deep_reference("deep_front_end"))
        attn = _attention_at_runner_shape(captured, LIGHTGLUE_HEADS)
        del captured
        torch.cuda.empty_cache()

        images, _sizes = OlssonLoader(data_dir).load_grayscale_batch()
        det = registry.build_detector({"name": "superpoint", "max_keypoints": 2048,
                                       "weights_path": weights["superpoint"]})
        sp = _hold_detector("deep_front_end SuperPoint", det, images[:DEEP_CPU_VIEWS])
        nv = _hold_descriptor("deep_front_end NetVLAD", netvlad, images)
        xy, mask, desc = det.detect_batch(torch.as_tensor(images[: DEEP_CPU_PAIRS + 1], device="cuda"))
        matcher = registry.build_matcher({"name": "lightglue", "weights_path": weights["lightglue"]})
        i1, i2 = np.arange(DEEP_CPU_PAIRS), np.arange(1, DEEP_CPU_PAIRS + 1)
        hw = images.shape[1:]
        z = {}
        for dev in ("cuda", "cpu"):
            t = [torch.as_tensor(a, device=dev) for a in (desc[i1], desc[i2], xy[i1], xy[i2], mask[i1], mask[i2])]
            z[dev] = matcher.log_assignment(*t, image_size=(hw[1], hw[0])).float().cpu()
        m0, m1 = torch.as_tensor(mask[i1]), torch.as_tensor(mask[i2])
        idx = {d: matcher._postprocess(z[d], m0, m1)[0] for d in z}
        decisive = glue_decisive(z["cpu"], m0, m1, matcher.options.match_threshold)
        bad = int((decisive & (idx["cuda"] != idx["cpu"])).sum())
        valid = torch.nn.functional.pad(m0, (0, 1), value=True)[:, :, None] & \
            torch.nn.functional.pad(m1, (0, 1), value=True)[:, None, :]
        zerr = float(torch.where(valid, (z["cuda"] - z["cpu"]).abs(), 0.0).max())
        print(f"deep_front_end LightGlue card vs CPU on {DEEP_CPU_PAIRS} pairs of SuperPoint keypoints: "
              f"log-assignment max |d| {zerr:.4g}; {int(decisive.sum())} decisive rows (gap {GLUE_GAP}), {bad} "
              f"differ; {int((idx['cuda'] >= 0).sum())} matches on the card, {int((idx['cpu'] >= 0).sum())} on "
              f"the CPU", flush=True)
        if bad or int(decisive.sum()) == 0:
            raise AssertionError(f"LightGlue's matches on the card differ from the CPU's on {bad} of "
                                 f"{int(decisive.sum())} decisive rows")
    return {"warm": results["warm"], "cold": results["cold"], "attention": attn, "superpoint": sp, "netvlad": nv,
            "lightglue_z_err": zerr, "held": held}


def phase_megaloc_sift(smi: str, data_dir: str) -> dict:
    """``gtsfm_tpu_torch.runner.main`` with ``megaloc_sift_frontend`` on
    `cuda` (MegaLoc ViT-B/14 at 322x322 from the seeded megaloc.torch by
    ``global_descriptor.weights_path``, DoG-SIFT at K=5000, the similarity
    retriever at 10, the two-view batch through the matcher kernel) on the
    runner phase's folder, once for each of DEEP_SEEDS: DoG-SIFT on
    `cuda` only, matcher launches, no attention launch in each run; the
    pairs, each pair's match count and the medians held to the JAX
    package's (_hold_to_reference); then the matcher kernel on the inputs
    of the first run's first chunk: held
    against its plain version and timed on its first MATCHER_SUBSET pairs
    (the plain version's (P, K, K) similarity at the whole chunk would take
    25.6 GB), the kernel alone also on the whole chunk; MegaLoc on the card
    against the CPU on DEEP_CPU_VIEWS views."""
    import os

    import torch

    from gtsfm_tpu_torch.frontend import registry, two_view
    from gtsfm_tpu_torch.frontend.matchers import fused_matcher
    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
    from gtsfm_tpu_torch.loader.olsson import OlssonLoader
    from gtsfm_tpu_torch.utils.numerics import precise

    with tempfile.TemporaryDirectory() as work:
        weights = write_deep_weights(work, ("megaloc",))
        print(f"megaloc_sift weights: sums of squares {weights['sumsq']}", flush=True)
        argv = ["--config_name", "megaloc_sift_frontend", "--loader", "olsson", "--dataset_dirpath", data_dir] + \
            deep_overrides("megaloc_sift_frontend", weights)
        captured = {}
        runs = []
        for seed in DEEP_SEEDS:
            restore = _capture(two_view, ("fused_match_descriptors",), captured) if not runs else (lambda: None)
            try:
                res = _runner_once(f"megaloc_sift seed {seed}", argv + [f"scene_optimizer.seed={seed}"],
                                   os.path.join(work, f"out{seed}"))
            finally:
                restore()
            _print_run(f"megaloc_sift seed {seed}", res, None, smi)
            if set(res["detector"]) != {"cuda"} or res["launches"]["matcher"] < 1 or res["launches"]["attention"]:
                raise AssertionError(f"megaloc_sift: DoG-SIFT ran on {res['detector']}, launches {res['launches']}")
            runs.append(res)
        held = _hold_to_reference("megaloc_sift", runs, deep_reference("megaloc_sift_frontend"))
        res = runs[0]

        (a, b, ma, mb), _kw = captured["fused_match_descriptors"]
        del captured
        n = min(MATCHER_SUBSET, a.shape[0])
        sa, sb, sma, smb = (x[:n].contiguous() for x in (a, b, ma, mb))
        with precise():
            got = fused_matcher.fused_match_descriptors(sa, sb, sma, smb)
            want = match_descriptors(sa, sb, sma, smb)
            err, n_dec, bad = kernel_agrees(got, want, sa, sb, sma, smb)
        name = f"P{n}_K{a.shape[1]}_D{a.shape[2]}"
        print(f"kernel check {name} (the megaloc_sift run's first chunk): max|best| err {err:.3g}, {n_dec} decisive "
              f"rows agree, {int(got[1].sum())} matches", flush=True)
        if err > KERNEL_TOL_BEST or bad or n_dec == 0:
            raise AssertionError(f"kernel disagrees on {name}: max|best| err {err:.3g}, {bad}/{n_dec} decisive "
                                 f"rows differ")
        del got, want
        torch.cuda.empty_cache()
        ms, bound = _time_matcher(name, sa, sb, sma, smb)
        with precise():
            full_ms = _graph_ms(lambda: fused_matcher.fused_match_descriptors(a, b, ma, mb))
        P, K1, D = a.shape
        full_bound = max((2.0 * P * K1 * b.shape[1] * D / PEAK_BF16 * 1e3, "operations"),
                         ((a.nbytes + b.nbytes + ma.nbytes + mb.nbytes + P * K1 * 9) / PEAK_BYTES * 1e3, "bytes"))
        print(f"kernel timing P{P}_K{K1}_D{D} (the whole chunk, a CUDA graph of {TIMING_BATCH} calls): "
              f"{full_ms:.4f} ms, bound {full_bound[0]:.4f} ms ({full_bound[1]}), {full_bound[0] / full_ms:.3f} of it",
              flush=True)
        del a, b, ma, mb
        torch.cuda.empty_cache()

        images, _sizes = OlssonLoader(data_dir).load_grayscale_batch()
        ml = registry.build_global_descriptor({"name": "megaloc", "weights_path": weights["megaloc"]})
        megaloc = _hold_descriptor("megaloc_sift MegaLoc", ml, images[:DEEP_CPU_VIEWS])
    return {"run": res, "runs": runs, "err": err, "ms": ms, "bound": bound, "shape": name, "full_ms": full_ms,
            "full_bound": full_bound, "full_shape": f"P{P}_K{K1}_D{D}", "megaloc": megaloc, "held": held}


def phase_deep_components(data_dir: str) -> dict:
    """D2-Net, DISK and hloc's VGG16-NetVLAD at full width (their seeded
    inits, through the registry) on the first DEEP_COMPONENT_VIEWS views of
    the runner phase's folder at 480x640, each on the card against the
    CPU: keypoints and descriptors as for SuperPoint, the NetVLAD rows
    within DEEP_DESC_TOL."""
    from gtsfm_tpu_torch.frontend import registry
    from gtsfm_tpu_torch.loader.olsson import OlssonLoader

    images, _sizes = OlssonLoader(data_dir).load_grayscale_batch(indices=list(range(DEEP_COMPONENT_VIEWS)))
    out = {}
    for name in ("d2net", "disk"):
        out[name] = _hold_detector(f"deep_components {name}", registry.build_detector({"name": name}), images)
    out["hloc_netvlad"] = _hold_descriptor("deep_components hloc_netvlad",
                                           registry.build_global_descriptor({"name": "hloc_netvlad"}), images)
    return out


# ---------------------------------------------------------------------------
# the feed-forward cluster slots
# ---------------------------------------------------------------------------


class _StageTimer:
    """Wraps functions and methods so that each call adds its host-clock
    seconds, between two device synchronizations, to a named stage
    (``name`` a string, or a function of the call's arguments)."""

    def __init__(self):
        self.sec, self.calls, self.each, self._saved = {}, {}, {}, []

    def wrap(self, owner, attr: str, name):
        import torch

        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            key = name(args, kwargs) if callable(name) else name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            self.sec[key] = self.sec.get(key, 0.0) + sec
            self.calls[key] = self.calls.get(key, 0) + 1
            self.each.setdefault(key, []).append(sec)
            return out

        setattr(owner, attr, timed)
        self._saved.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def _ff_slot_argv(slot: str, data_dir: str, gs_steps=None, extra=()) -> list:
    """The runner's arguments for a slot; anysplat with ``gs_steps`` runs
    the trainer (--run_gs) for that many steps."""
    argv = ["--config_name", slot, "--loader", "olsson", "--dataset_dirpath", data_dir]
    if slot == "anysplat" and gs_steps:
        argv += ["--run_gs", f"scene_optimizer.gs_iterations={gs_steps}"]
    return argv + list(extra)


def _ff_load_weights(slot: str) -> None:
    """``feedforward_fixture`` at 480x640 (its FastVGGT blocks for
    fastvggt) into the port's model cache on the card, as the reference
    script places it in the JAX package's."""
    from gtsfm_tpu_torch.frontend.feedforward import FeedforwardOptions
    from gtsfm_tpu_torch.scene import cluster_feedforward as cf
    from gtsfm_tpu_torch.utils import convert

    stride = 4 if slot == "fastvggt" else 1
    cf._MODEL_CACHE.clear()
    cf._resolve_model(cf.ClusterFeedforwardOptions(model=FeedforwardOptions(global_kv_stride=stride)), SPLAT_HW,
                      convert.feedforward_state_dict(feedforward_fixture(FF_SEED, SPLAT_HW, stride)), "cuda")


def _ff_run(tag: str, argv: list, out: str, timer: _StageTimer = None) -> dict:
    """``gtsfm_tpu_torch.runner.main(argv + --output_root out)`` in this
    process for a feed-forward slot, every launch count set to 0 just
    before and read just after, the compact forward's outputs (the last
    ``FeedforwardReconstruction.run``) and the slot's metrics (the last
    ``ClusterFeedforward.run_raw``) kept, the peak device memory. Requires
    exit code 0, every camera registered, finite poses and no matcher or
    attention launch (the slot bypasses the front end)."""
    import os

    import torch

    from gtsfm_tpu_torch import runner
    from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup
    from gtsfm_tpu_torch.frontend import feedforward as ff
    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.io import colmap
    from gtsfm_tpu_torch.scene import cluster_feedforward as cf
    from gtsfm_tpu_torch.splat import rendering

    seen = {}
    run, run_raw = ff.FeedforwardReconstruction.run, cf.ClusterFeedforward.run_raw

    def fwd(self, images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = run(self, images)
        torch.cuda.synchronize()
        seen["forward"], seen["forward_sec"] = (o, self.last_track_feat), time.perf_counter() - t0
        return o

    def raw(self, *args):
        o = run_raw(self, *args)
        seen["metrics"] = o[1]
        return o

    fused_matcher.launch_count = fused_attention.launch_count = rendering.launch_count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ff.FeedforwardReconstruction.run, cf.ClusterFeedforward.run_raw = fwd, raw
    t0 = time.perf_counter()
    try:
        rc = runner.main(argv + ["--output_root", out])
        torch.cuda.synchronize()
    finally:
        ff.FeedforwardReconstruction.run, cf.ClusterFeedforward.run_raw = run, run_raw
        if timer is not None:
            timer.restore()
    wall = time.perf_counter() - t0
    launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count,
                "composite": rendering.launch_count}
    mdir = os.path.join(out, "results", "metrics")
    metrics = {g.name: {m.name: (m.scalar if m.dist is None else m.dist) for m in g.metrics}
               for g in (MetricsGroup.from_json(os.path.join(mdir, f)) for f in sorted(os.listdir(mdir)))}
    n_views = len(os.listdir(os.path.join(argv[argv.index("--dataset_dirpath") + 1], "images")))
    pose = metrics.get("ba_pose_metrics", {})
    res = {"rc": rc, "wall": wall, "launches": launches, "metrics": metrics, "peak_gib":
           torch.cuda.max_memory_allocated() / 2**30, "registered": len(pose.get("rotation_error_deg", [])),
           "auc5": float(pose.get("pose_auc_@5.0_deg", 0.0)), "views": n_views,
           "num_tracks_ff": int(metrics["feedforward_metrics"]["num_tracks_ff"]),
           "post_ba": seen["metrics"].get("post_ba"), "forward": seen.get("forward"),
           "forward_sec": seen.get("forward_sec")}
    back = colmap.read_scene(os.path.join(out, "results", "ba_output"))
    print(f"{tag}: {res['registered']}/{n_views} registered, pose AUC@5 {res['auc5']:.4f}, "
          f"{res['num_tracks_ff']} feed-forward tracks, {back.number_tracks()} exported, post-BA cost "
          + (f"{res['post_ba']['initial_cost']:.6g} -> {res['post_ba']['final_cost']:.6g}" if res["post_ba"] else "-")
          + f", launches {launches}, peak device memory {res['peak_gib']:.3f} GiB; seconds: feedforward_sec "
          f"{metrics['feedforward_metrics']['feedforward_sec']:.3f} (compact forward "
          + (f"{res['forward_sec']:.3f}" if res["forward_sec"] is not None else "-")
          + f") total_runtime_sec {metrics['total_summary']['total_runtime_sec']:.3f} main {wall:.3f}", flush=True)
    if rc != 0 or res["registered"] != n_views or not bool(torch.isfinite(back.poses.t).all()):
        raise AssertionError(f"{tag}: exit code {rc}, {res['registered']}/{n_views} registered, finite poses "
                             f"{bool(torch.isfinite(back.poses.t).all())}")
    if launches["matcher"] or launches["attention"]:
        raise AssertionError(f"{tag}: the feed-forward slot launched the front end's kernels: {launches}")
    return res


def _hold_ff_run(tag: str, res: dict, ref: dict) -> dict:
    """A feedforward run against the JAX package's (FEEDFORWARD_REFERENCE):
    the forward's poses, focal ratios, patch confidences and track features
    within FF_TOL, depth within FF_TOL_DEPTH relative; the feed-forward
    track count within FF_TRACK_SLACK; every camera registered as in the
    reference, AUC@5 within RUNNER_AUC5_SLACK; with the same tracks, the
    post-BA initial cost within FF_COST_TOL relative, and a final cost
    below it; for anysplat, the trainer's initial L1 within FF_L1_TOL
    relative and a falling L1. Returns the largest distances."""
    (poses, depth, conf, focal), feat = res["forward"]
    mine = ff_forward_record(*(a.cpu().numpy() for a in (poses.R, poses.t, focal, depth, conf, feat)))
    dist = {}
    for k, v in mine.items():
        want = np.asarray(ref["forward"][k], np.float32)
        if v.shape != want.shape:
            raise AssertionError(f"{tag}: forward {k} of shape {v.shape}, the reference's {want.shape}")
        d = np.abs(v - want) / (np.abs(want) if k == "depth" else 1.0)
        dist[k] = float(d.max())
    bad = [k for k, d in dist.items() if d > (FF_TOL_DEPTH if k == "depth" else FF_TOL)]
    tracks_off = abs(res["num_tracks_ff"] - ref["num_tracks_ff"])
    cost = None
    if res["post_ba"] is not None and ref["post_ba"] is not None:
        cost = abs(res["post_ba"]["initial_cost"] / ref["post_ba"]["initial_cost"] - 1.0)
    print(f"{tag} against the JAX package: forward max |d| " + ", ".join(f"{k} {d:.3g}" for k, d in dist.items())
          + f" (tol {FF_TOL}, depth {FF_TOL_DEPTH} relative); feed-forward tracks {res['num_tracks_ff']} (the "
          f"reference's {ref['num_tracks_ff']}, slack {FF_TRACK_SLACK}); registered {res['registered']} "
          f"({ref['registered']}); AUC@5 {res['auc5']:.4f} ({ref['pose_auc_@5.0_deg']:.4f}); post-BA initial cost "
          + ("-" if cost is None else f"{cost:.3g} apart (tol {FF_COST_TOL}), final {res['post_ba']['final_cost']:.6g} "
             f"(the reference's {ref['post_ba']['final_cost']:.6g})"), flush=True)
    if bad or tracks_off > FF_TRACK_SLACK or res["registered"] != ref["registered"]:
        raise AssertionError(f"{tag}: forward {bad} out of tolerance, tracks {tracks_off} apart, registered "
                             f"{res['registered']} against {ref['registered']}")
    if abs(res["auc5"] - ref["pose_auc_@5.0_deg"]) > RUNNER_AUC5_SLACK:
        raise AssertionError(f"{tag}: AUC@5 {res['auc5']:.4f} against {ref['pose_auc_@5.0_deg']:.4f}")
    if res["post_ba"] is not None:
        if not res["post_ba"]["final_cost"] < res["post_ba"]["initial_cost"]:
            raise AssertionError(f"{tag}: post-BA cost did not fall: {res['post_ba']}")
        if tracks_off == 0 and cost > FF_COST_TOL:
            raise AssertionError(f"{tag}: post-BA initial cost {cost:.3g} from the reference's")
    if "gs" in ref:
        gs = res["metrics"]["gaussian_splatting_metrics"]
        l1 = abs(gs["initial_l1"] / ref["gs"]["initial_l1"] - 1.0)
        dist["initial_l1"] = l1
        print(f"{tag} trainer: L1 {gs['initial_l1']:.6f} -> {gs['final_l1']:.6f} (the reference's "
              f"{ref['gs']['initial_l1']:.6f} -> {ref['gs']['final_l1']:.6f}, initial {l1:.3g} apart, tol "
              f"{FF_L1_TOL}), {int(gs['num_gaussians'])} gaussians alive ({ref['gs']['num_gaussians']})", flush=True)
        if l1 > FF_L1_TOL or not gs["final_l1"] < gs["initial_l1"]:
            raise AssertionError(f"{tag}: trainer L1 {gs}")
    return dist


def phase_feedforward(smi: str, runner_dir: str, R, t, work: str) -> dict:
    """The runner with the vggt, fastvggt and anysplat --run_gs configs on
    the card with the seeded compact model: first on FF_VIEWS numpy-made
    views held to the JAX package's runs (_hold_ff_run), then on the runner
    phase's 32 rendered views, timed (anysplat's trainer at
    FF_TIMED_GS_STEPS).
    Returns the compositing launches of the anysplat runs and the largest
    distances."""
    import os

    order = ring_order(t)[:FF_VIEWS]
    ff_dir = os.path.join(work, "feedforward_data")
    write_olsson(ff_dir, feedforward_views(R, t, order), np.asarray(R)[order], np.asarray(t)[order], SPLAT_FOCAL)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), FEEDFORWARD_REFERENCE)) as f:
        refs = {r["slot"]: r for r in json.load(f)["runs"]}
    out = {"composite": 0, "dist": {}, "runs": {}}
    for slot in ("vggt", "fastvggt", "anysplat"):
        _ff_load_weights(slot)
        res = _ff_run(f"feedforward {slot} ({FF_VIEWS} views)", _ff_slot_argv(slot, ff_dir, FF_GS_STEPS),
                      os.path.join(work, f"ff_{slot}"))
        out["dist"][slot] = _hold_ff_run(f"feedforward {slot}", res, refs[slot])
        out["composite"] += res["launches"]["composite"]
    for slot in ("vggt", "fastvggt", "anysplat"):
        _ff_load_weights(slot)
        res = _ff_run(f"feedforward {slot} (32 rendered views)", _ff_slot_argv(slot, runner_dir, FF_TIMED_GS_STEPS),
                      os.path.join(work, f"ff32_{slot}"))
        print(f"feedforward {slot} (32 rendered views) | {smi}", flush=True)
        out["runs"][slot] = {k: res[k] for k in ("wall", "peak_gib", "forward_sec", "launches")}
        if slot == "anysplat":
            gs = res["metrics"]["gaussian_splatting_metrics"]
            if res["launches"]["composite"] < FF_TIMED_GS_STEPS or not gs["final_l1"] < gs["initial_l1"]:
                raise AssertionError(f"feedforward anysplat: {res['launches']} launches, trainer {gs}")
            out["composite"] += res["launches"]["composite"]
    from gtsfm_tpu_torch.scene import cluster_feedforward as cf

    cf._MODEL_CACHE.clear()
    return out


def _vggt_stage_timer() -> _StageTimer:
    """A _StageTimer on VGGT's stages: each aggregator pass, the camera
    head, the DPT heads by activation (depth, the gaussian head's raw
    output, the track head's features), the tracker, the gaussians'
    assembly, post-BA, and every attention (the DINO pass's and VGGT's)."""
    from gtsfm_tpu_torch.bundle.ba import BundleAdjustment
    from gtsfm_tpu_torch.frontend import anysplat, vggt, vggt_track
    from gtsfm_tpu_torch.frontend.global_descriptors import megaloc

    timer = _StageTimer()
    timer.wrap(vggt.Aggregator, "forward", "aggregator")
    timer.wrap(vggt.CameraHead, "forward", "camera_head")
    names = {"exp": "depth_head", "raw": "gaussian_head", "features": "track_features"}
    timer.wrap(vggt.DPTHead, "forward", lambda a, k: names[k.get("activation", "exp")])
    timer.wrap(vggt_track.Tracker, "forward", "tracker")
    timer.wrap(anysplat.AnySplatModel, "_assemble_gaussians", "gaussian_assembly")
    timer.wrap(BundleAdjustment, "run", "post_ba")
    timer.wrap(vggt, "attention", "attention")
    timer.wrap(megaloc, "attention", "attention")
    return timer


def _hold_vggt_check(R, t) -> dict:
    """VGGT at the public widths with the depth cut (vggt_check_options) on
    the card: the forward on vggt_check_inputs and the track head after 1
    and 4 iterations of its tracker against the JAX package's
    (FEEDFORWARD_REFERENCE): cameras within VGGT_TOL_CAM relative, depth
    and confidence within VGGT_TOL_DEPTH relative, 1-iteration tracks
    within VGGT_TOL_TRACK_1 px and their visibility and confidence within
    VGGT_TOL_VIS_1, 4-iteration ones within VGGT_TOL_TRACK px and
    VGGT_TOL_VIS. Returns the largest distances."""
    import os

    from gtsfm_tpu_torch.frontend.vggt import VGGTModel

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), FEEDFORWARD_REFERENCE)) as f:
        ref = json.load(f)["vggt_check"]
    vo, to = vggt_check_options()
    sd = vggt_fixture(VGGT_SEED, vo, to)
    sumsq = float(sum(np.square(v, dtype=np.float64).sum() for v in sd.values()))
    model = VGGTModel(vo, state_dict=sd, device="cuda")
    images, qp = vggt_check_inputs(R, t)
    t0 = time.perf_counter()
    run = {k: v.cpu().numpy() for k, v in model.run(images).items()}
    track = {k: v.cpu().numpy() for k, v in model.track(images, qp).items()}
    sec = time.perf_counter() - t0
    mine = vggt_check_record(run, vggt_track_iters(model, images, qp, 1), track)
    tol = {"extrinsic": VGGT_TOL_CAM, "intrinsic": VGGT_TOL_CAM, "depth": VGGT_TOL_DEPTH,
           "depth_conf": VGGT_TOL_DEPTH, "depth_sum": VGGT_TOL_DEPTH, "conf_sum": VGGT_TOL_DEPTH,
           "tracks_1": VGGT_TOL_TRACK_1, "vis_1": VGGT_TOL_VIS_1, "track_conf_1": VGGT_TOL_VIS_1,
           "tracks": VGGT_TOL_TRACK, "vis": VGGT_TOL_VIS, "track_conf": VGGT_TOL_VIS}
    absolute = ("tracks_1", "vis_1", "track_conf_1", "tracks", "vis", "track_conf")
    dist = {}
    for k, v in mine.items():
        want = np.asarray(ref["record"][k])
        d = np.abs(v - want) / (1.0 if k in absolute else np.maximum(np.abs(want), 1e-6))
        dist[k] = float(np.max(d))
    bad = [k for k in dist if dist[k] > tol[k]]
    print(f"vggt_full check (VGGT-1B widths, depth {vo.depth} pairs, DINO {vo.dino_depth}, trunk "
          f"{vo.camera_trunk_depth}, track {to.depth}; {VGGT_CHECK_VIEWS} views at {VGGT_CHECK_HW}, "
          f"{VGGT_CHECK_QUERIES} queries; weights sum of squares {sumsq:.6f}, the reference's "
          f"{ref['weights_sumsq']:.6f}) in {sec:.3f} s against the JAX package: "
          + ", ".join(f"{k} {d:.3g} (tol {tol[k]})" for k, d in dist.items()), flush=True)
    if bad or abs(sumsq / ref["weights_sumsq"] - 1.0) > 1e-9:
        raise AssertionError(f"vggt_full check: {bad} out of tolerance, weights sum of squares {sumsq}")
    return dist


def phase_vggt_full(smi: str, runner_dir: str, R, t, work: str) -> dict:
    """VGGT at the public VGGT-1B widths: the depth-cut check
    (_hold_vggt_check), then the full model's seeded weights
    (write_vggt_weights, the public layout, about 5 GB) and the runner
    with anysplat and scene_optimizer.feedforward_post_ba=true on the
    runner phase's 32 rendered views through
    scene_optimizer.feedforward_backbone=vggt_exact: the vggt slot's path
    (VGGT's forward, the track head, post-BA on its tracks) and the
    AnySplat head in one run (the vggt slot's own VGGT-1B run is cut for
    the script's time; it runs with the compact model in the feedforward
    phase), its stages timed (_vggt_stage_timer: the aggregator passes,
    the heads, the tracker, post-BA, the attention's share of the
    aggregator), peak memory, registered cameras and tracks; the run must
    finish with finite poses, every camera registered, and every one of
    those stages run, post-BA included."""
    import os

    import torch

    from gtsfm_tpu_torch.scene import cluster_feedforward as cf

    out = {"check": _hold_vggt_check(R, t), "runs": {}}
    path = os.path.join(work, "vggt1b.pt")
    t0 = time.perf_counter()
    sumsq = write_vggt_weights(path, VGGT_SEED)
    print(f"vggt_full: seeded VGGT-1B weights (public layout, {os.path.getsize(path) / 2**30:.3f} GiB, sum of "
          f"squares {sumsq:.6f}) written in {time.perf_counter() - t0:.3f} s", flush=True)
    # post-BA on, as the vggt slot runs it: one anysplat run drives both slots' paths
    extra = ["scene_optimizer.feedforward_backbone=vggt_exact", f"scene_optimizer.vggt_weights_path={path}",
             "scene_optimizer.feedforward_post_ba=true"]
    cf._MODEL_CACHE.clear()
    timer = _vggt_stage_timer()
    res = _ff_run("vggt_full anysplat (VGGT-1B, 32 rendered views)", _ff_slot_argv("anysplat", runner_dir, extra=extra),
                  os.path.join(work, "vggt_anysplat"), timer)
    agg = timer.sec.get("aggregator", 0.0)
    share = timer.sec.get("attention", 0.0) / agg if agg else float("nan")
    print("vggt_full anysplat stages (s, calls): " + ", ".join(
        f"{k} {v:.3f} ({timer.calls[k]})" for k, v in sorted(timer.sec.items()))
        + f"; each aggregator pass {[round(x, 3) for x in timer.each.get('aggregator', [])]}; attention share "
        f"of the aggregator passes {share:.4f}; peak device memory {res['peak_gib']:.3f} GiB | {smi}", flush=True)
    missing = [k for k in ("aggregator", "tracker", "track_features", "gaussian_head", "post_ba")
               if not timer.calls.get(k)]
    if missing:
        raise AssertionError(f"vggt_full anysplat: stages {missing} never ran")
    out["runs"]["anysplat"] = {"stages": dict(timer.sec), "calls": dict(timer.calls), "attention_share": share,
                               "aggregator_passes": timer.each.get("aggregator", []), "peak_gib": res["peak_gib"],
                               "wall": res["wall"]}
    cf._MODEL_CACHE.clear()
    os.remove(path)
    torch.cuda.empty_cache()
    return out


def mvs_views(R, t, indices) -> np.ndarray:
    """The mvs phase's gray images, (n, H, W) float32: feedforward_views'."""
    return np.ascontiguousarray(feedforward_views(R, t, indices)[..., 0])


def mvs_sfm_data(R, t, indices, dev, hw: tuple = SPLAT_HW, focal: float = SPLAT_FOCAL):
    """The port's SfmData of the mvs phase on ``dev``: the views' GT poses
    (camera-to-world R, center t), Cal3Bundler(focal, 0, 0, w/2, h/2) and
    mvs_tracks."""
    import torch

    from gtsfm_tpu_torch.common.sfm_data import SfmData
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler

    n, (h, w) = len(indices), hw
    f32 = dict(dtype=torch.float32, device=dev)
    poses = SE3(R=torch.as_tensor(np.asarray(R)[indices], **f32), t=torch.as_tensor(np.asarray(t)[indices], **f32))
    z = torch.zeros(n, **f32)
    cal = Cal3Bundler.create(torch.full((n,), focal, **f32), z, z, torch.full((n,), w / 2.0, **f32),
                             torch.full((n,), h / 2.0, **f32))
    return SfmData.from_cameras_and_tracks(poses, cal, mvs_tracks(R, t, indices, hw=hw, focal=focal), num_cameras=n)


def mvs_record(depths: dict, confs: dict, points: np.ndarray, truth: np.ndarray) -> dict:
    """What the mvs phase holds of a backend's run (numpy): the views with
    a depth map, depth and confidence every MVS_DEPTH_STEP pixels, the
    dense point count and centroid, and the median relative error of the
    depth maps against the analytic depth ``truth`` (n, H, W), on every
    pixel and on those with confidence > MVS_SWEEP_CONF."""
    s = MVS_DEPTH_STEP
    views = sorted(depths)
    d, c = np.stack([depths[i] for i in views]), np.stack([confs[i] for i in views])
    err = np.abs(d - truth[views]) / truth[views]
    confident = c > MVS_SWEEP_CONF
    return {"views": np.asarray(views), "depth": d[:, s // 2 :: s, s // 2 :: s].astype(np.float32),
            "conf": c[:, s // 2 :: s, s // 2 :: s].astype(np.float32), "count": np.asarray(len(points)),
            "centroid": points.mean(axis=0) if len(points) else np.zeros(3, np.float32),
            "truth_median": np.asarray(np.median(err)),
            "truth_median_confident": np.asarray(np.median(err[confident]) if confident.any() else np.nan)}


def phase_mvs(smi: str, R, t, work: str) -> dict:
    """The dense back ends on the card held to the JAX package
    (MVS_REFERENCE, from scripts/mvs_reference.py on the CPU): the
    FF_VIEWS feedforward_views at 480x640 with their GT poses and
    mvs_tracks; the source views equal, the depth ranges within
    MVS_RANGE_TOL; PlaneSweepMVS at MVSOptions() and PatchmatchNetMVS on
    pmnet_fixture (written by write_mvs_weights, read by
    load_torch_weights), each cold and then warm: >= MVS_DEPTH_SHARE of the
    held depths within MVS_DEPTH_TOL, dense point counts within
    MVS_COUNT_TOL; prints the stage seconds, peak memory and each
    backend's median relative error against the analytic depth beside
    the JAX package's."""
    import os

    import torch

    from gtsfm_tpu_torch.densify import mvs
    from gtsfm_tpu_torch.densify import patchmatchnet as pm

    dev = torch.device("cuda")
    ref = dict(np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), MVS_REFERENCE)))
    order = ring_order(t)[:FF_VIEWS]
    views, truth = mvs_views(R, t, order), feedforward_depths(R, t, order)
    data = mvs_sfm_data(R, t, order, dev)
    opts = mvs.MVSOptions()
    src = mvs.select_source_views(data, opts)
    ranges = mvs._depth_range_per_view(data, opts.depth_margin)
    range_err = float(np.max(np.abs(ranges - ref["depth_ranges"]) / np.abs(ref["depth_ranges"])))
    print(f"mvs: {FF_VIEWS} views at {SPLAT_HW[0]}x{SPLAT_HW[1]}, {data.number_tracks()} GT tracks, "
          f"{data.number_measurements()} measurements; source views equal to the JAX package's: "
          f"{np.array_equal(src, ref['source_views'])}; depth ranges {np.round(ranges, 3).tolist()}, largest "
          f"relative distance {range_err:.3g} (bar {MVS_RANGE_TOL})", flush=True)
    if not np.array_equal(src, ref["source_views"]) or not range_err <= MVS_RANGE_TOL:
        raise AssertionError(f"mvs: source views {src.tolist()} against {ref['source_views'].tolist()}, depth range "
                             f"distance {range_err}")
    path = os.path.join(work, "model_000007.ckpt")
    sumsq = write_mvs_weights(path, MVS_SEED)
    backends = {"plane_sweep": lambda: mvs.PlaneSweepMVS(opts, device=dev),
                "patchmatchnet": lambda: pm.PatchmatchNetMVS(opts, state_dict=pm.load_torch_weights(path),
                                                             seed=MVS_SEED, device=dev)}
    out = {}
    for name, make in backends.items():
        backend = make()
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sec = {}
            depths, confs = backend.compute_depths(data, views, sec)
            t0 = time.perf_counter()
            points, _colors, _m = mvs.fuse_depth_maps(depths, confs, data, views, opts)
            sec["fusion_sec"] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"mvs {name} {run}: " + " ".join(f"{k} {v:.3f}" for k, v in sec.items())
                  + f", peak device memory {peak:.3f} GiB | {smi}", flush=True)
        out[name] = _hold_mvs(name, mvs_record(depths, confs, points, truth), ref)
        out[name].update(sec=sec, peak_gib=peak)
        if name == "patchmatchnet":
            print(f"mvs patchmatchnet: seeded weights, sum of squares {sumsq:.6f}", flush=True)
    os.remove(path)
    out["big"] = _mvs_big_view(smi, views, data, src, ranges)
    torch.cuda.empty_cache()
    return out


def _hold_mvs(name: str, rec: dict, ref: dict) -> dict:
    """A backend's mvs_record against the reference's: the same views;
    PatchmatchNet: >= MVS_DEPTH_SHARE of the held depths within
    MVS_DEPTH_TOL and the dense count within MVS_COUNT_TOL; the plane
    sweep: the same on its confident pixels (MVS_SWEEP_*, see there)."""
    held, sweep = ref[f"{name}_depth"], name == "plane_sweep"
    rel = np.abs(rec["depth"] - held) / np.maximum(np.abs(held), 1e-6)
    sel = ref[f"{name}_conf"] > MVS_SWEEP_CONF if sweep else np.ones(held.shape, bool)
    share, share_all = float(np.mean(rel[sel] <= MVS_DEPTH_TOL)), float(np.mean(rel <= MVS_DEPTH_TOL))
    count, count_ref = int(rec["count"]), int(ref[f"{name}_count"])
    bar_share, bar_count = (MVS_SWEEP_SHARE, MVS_SWEEP_COUNT_TOL) if sweep else (MVS_DEPTH_SHARE, MVS_COUNT_TOL)
    truth, truth_ref = float(rec["truth_median_confident"]), float(ref[f"{name}_truth_median_confident"])
    print(f"mvs {name}: views {rec['views'].tolist()}, {share:.5f} of {int(sel.sum())} held depths"
          + (f" (confidence > {MVS_SWEEP_CONF})" if sweep else "") + f" within {MVS_DEPTH_TOL} of the JAX "
          f"package's (bar {bar_share}; {share_all:.5f} of all {rel.size}; median relative distance "
          f"{float(np.median(rel)):.3g}, largest {float(rel.max()):.3g}), {count} dense points (JAX {count_ref}, "
          f"{count / count_ref - 1:+.4f}, bar {bar_count}), centroid {np.round(rec['centroid'], 4).tolist()} (JAX "
          f"{np.round(ref[name + '_centroid'], 4).tolist()}); median relative error against the analytic depth "
          f"{float(rec['truth_median']):.4f} (JAX {float(ref[name + '_truth_median']):.4f}), on the pixels of "
          f"confidence > {MVS_SWEEP_CONF} {truth:.4f} (JAX {truth_ref:.4f})", flush=True)
    if (not np.array_equal(rec["views"], ref["views"]) or share < bar_share
            or abs(count - count_ref) > bar_count * count_ref
            or (sweep and not abs(truth - truth_ref) <= MVS_SWEEP_TRUTH_TOL)):
        raise AssertionError(f"mvs {name}: views {rec['views'].tolist()}, depth share {share}, {count} points "
                             f"against {count_ref}, truth error {truth} against {truth_ref}")
    return {"share": share, "share_all": share_all, "count": count, "count_ref": count_ref,
            "truth_median": float(rec["truth_median"]), "truth_median_confident": truth}


def _mvs_big_view(smi: str, views: np.ndarray, data, src, ranges) -> dict:
    """plane_sweep_depth at MVSOptions() on view 0 and its sources
    upsampled (bilinear) to MVS_BIG_HW, K scaled with them: seconds warm
    (host clock, synchronized) and peak device memory."""
    import torch
    import torch.nn.functional as F

    from gtsfm_tpu_torch.densify import mvs

    dev = torch.device("cuda")
    opts = mvs.MVSOptions()
    srcs = [int(s) for s in src[0] if s != 0][: opts.num_source_views]
    ids = [0] + srcs
    imgs = torch.as_tensor(views[ids], device=dev)[:, None]
    big = F.interpolate(imgs, size=MVS_BIG_HW, mode="bilinear", align_corners=False)[:, 0]
    scale = MVS_BIG_HW[0] / views.shape[1]
    K = data.cal.K()[ids].clone()
    K[:, :2] *= scale
    cTw_R = data.poses.R[ids].transpose(-1, -2)
    cTw_t = -torch.einsum("nij,nj->ni", cTw_R, data.poses.t[ids])
    args = (big[0], big[1:], K[0], K[1:], cTw_R[0], cTw_t[0], cTw_R[1:], cTw_t[1:], float(ranges[0, 0]),
            float(ranges[0, 1]))
    mvs.plane_sweep_depth(*args, num_depths=opts.num_depths, window=opts.window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depth, _conf = mvs.plane_sweep_depth(*args, num_depths=opts.num_depths, window=opts.window)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"mvs plane sweep one view at {MVS_BIG_HW[0]}x{MVS_BIG_HW[1]} (D={opts.num_depths}, S={len(srcs)}, "
          f"window {opts.window}): {sec:.4f} s warm, peak device memory {peak:.3f} GiB, finite "
          f"{bool(torch.isfinite(depth).all())} | {smi}", flush=True)
    if not bool(torch.isfinite(depth).all()):
        raise AssertionError("mvs: the upsampled view's depth is not finite")
    return {"sec": sec, "peak_gib": peak}


def phase_mvs_runner(smi: str, runner_dir: str, work: str) -> dict:
    """``gtsfm_tpu_torch.runner.main`` with --run_mvs on the runner phase's
    32 rendered views, cold and warm (the plane sweep), then once with
    --mvs_backend patchmatchnet on pmnet_fixture, through _runner_once:
    each run holds the runner phase's bars, DoG-SIFT on `cuda`, a matcher
    launch per RUNNER_PAIR_BATCH pairs, an mvs_metrics group with a depth
    map for every registered view but one at most, and for the plane sweep
    a dense_points.ply that reads back with points; prints mvs_sec and its
    three parts and the peak device memory. Returns the matcher launches
    of the three runs."""
    import os

    from gtsfm_tpu_torch.io.ply import read_ply

    path = os.path.join(work, "mvs_runner_model_000007.ckpt")
    write_mvs_weights(path, MVS_SEED)
    base = ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", runner_dir, "--run_mvs"]
    bars = (RUNNER_REF_REGISTERED - RUNNER_REGISTERED_SLACK, RUNNER_REF_AUC5 - RUNNER_AUC5_SLACK)
    out = {"launches": 0, "runs": {}}
    for tag, argv in (("plane_sweep cold", base), ("plane_sweep warm", base),
                      ("patchmatchnet", base + ["--mvs_backend", "patchmatchnet", "--mvs_weights_path", path])):
        dest = os.path.join(work, "mvs_runner_" + tag.replace(" ", "_"))
        res = _runner_once(f"mvs_runner {tag}", argv, dest)
        _print_run(f"mvs_runner {tag}", res, bars, smi)
        m = {k: v.scalar for k, v in res["metrics"]["mvs_metrics"].items()}
        chunks = -(-res["pairs"] // RUNNER_PAIR_BATCH)
        ply = os.path.join(dest, "results", "dense_points.ply")
        n_ply = len(read_ply(ply)[0]) if os.path.exists(ply) else 0
        print(f"mvs_runner {tag}: mvs_sec {m['mvs_sec']:.3f} (source_selection_sec {m['source_selection_sec']:.3f}, "
              f"depth_sec {m['depth_sec']:.3f}, fusion_sec {m['fusion_sec']:.3f}), {int(m['num_views_with_depth'])} "
              f"views with depth of {res['registered']} registered, {int(m['num_dense_points'])} dense points "
              f"({n_ply} in dense_points.ply), peak device memory {res['peak_gib']:.3f} GiB | {smi}", flush=True)
        if set(res["detector"]) != {"cuda"} or res["launches"]["matcher"] < chunks:
            raise AssertionError(f"mvs_runner {tag}: DoG-SIFT on {res['detector']}, {res['launches']} launches for "
                                 f"{res['pairs']} pairs")
        if m["num_views_with_depth"] < res["registered"] - 1:
            raise AssertionError(f"mvs_runner {tag}: {m['num_views_with_depth']} views with depth, "
                                 f"{res['registered']} registered")
        if tag.startswith("plane_sweep") and not n_ply:
            raise AssertionError(f"mvs_runner {tag}: no dense point in {ply}")
        out["launches"] += res["launches"]["matcher"]
        out["runs"][tag] = {"mvs": m, "peak_gib": res["peak_gib"], "sec": res["sec"], "wall": res["wall"]}
    os.remove(path)
    return out


def _corr_recorders():
    """Wrap the aggregator and the direct generators so that each run's
    per-pair correspondence counts, the aggregator's host seconds and the
    generators' seconds are recorded, and the generator and matcher objects
    a run built are kept (the held pairs run on them). Returns (the record,
    the function that restores the originals)."""
    import torch

    from gtsfm_tpu_torch.frontend import correspondence, mast3r
    from gtsfm_tpu_torch.frontend.matchers import superglue

    rec = {"counts": {}, "aggregate_sec": 0.0, "generate_sec": 0.0, "objects": {}}
    saved = [(correspondence.KeypointAggregatorDedup, "aggregate"),
             (correspondence.DenseCorrespondenceGenerator, "generate"),
             (mast3r.Mast3rCorrespondenceGenerator, "generate"), (superglue.SuperGlueMatcher, "match_batch")]
    orig = {(cls, name): getattr(cls, name) for cls, name in saved}

    def aggregate(self, num_images, pair_corrs):
        rec["counts"] = {k: len(v[0]) for k, v in pair_corrs.items()}
        t0 = time.perf_counter()
        try:
            return orig[(correspondence.KeypointAggregatorDedup, "aggregate")](self, num_images, pair_corrs)
        finally:
            rec["aggregate_sec"] += time.perf_counter() - t0

    def timed_generate(cls, key):
        def generate(self, images, pairs):
            rec["objects"][key] = self
            t0 = time.perf_counter()
            try:
                return orig[(cls, "generate")](self, images, pairs)
            finally:
                torch.cuda.synchronize()
                rec["generate_sec"] += time.perf_counter() - t0
        return generate

    def match_batch(self, *args, **kwargs):
        rec["objects"]["superglue"] = self
        return orig[(superglue.SuperGlueMatcher, "match_batch")](self, *args, **kwargs)

    correspondence.KeypointAggregatorDedup.aggregate = aggregate
    correspondence.DenseCorrespondenceGenerator.generate = timed_generate(correspondence.DenseCorrespondenceGenerator,
                                                                          "loftr")
    mast3r.Mast3rCorrespondenceGenerator.generate = timed_generate(mast3r.Mast3rCorrespondenceGenerator, "mast3r")
    superglue.SuperGlueMatcher.match_batch = match_batch

    def restore():
        for (cls, name), fn in orig.items():
            setattr(cls, name, fn)
    return rec, restore


def phase_correspondence(smi: str, runner_dir: str, R, t, work: str) -> dict:
    """The direct image-correspondence front ends, SuperGlue and the OpenCV
    detectors through ``gtsfm_tpu_torch.runner.main`` on `cuda` on the
    runner phase's 32 views (runs A-F, see the module's docstring): A
    colmap_front_end on a COLMAP model of CORR_GT_POINTS GT points
    (write_colmap_tracks of mvs_tracks) against the JAX package's bars
    (CORR_REFERENCE), with E, telemetry_db and GTSFM_TPU_TRACE, on it; B
    skydio_front_end (LoFTR at its published widths), C mast3r (ViT-L
    encoder, base decoders, long edge 512) and D deep_front_end with
    matcher.name=superglue, on the seeded public-layout checkpoints of
    write_correspondence_weights, recorded (seeded nets make no photo
    result); F unified with detector.name=sift, whose matches go through
    kernel #1. B-D must make correspondences and no kernel launch; F must
    launch kernel #1. Then each generator of B-D on the card on
    CORR_HOLD_PAIRS (the runs' first pairs) against the JAX package's
    outputs on the same weights and views (CORR_REFERENCE_NPZ): at least
    CORR_MATCH_SHARE of the matches identical, LoFTR's refined coordinates
    within CORR_FINE_TOL_PX. Returns F's launches and the held shares."""
    import os
    import sqlite3

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, CORR_REFERENCE)) as f:
        ref = json.load(f)
    npz = dict(np.load(os.path.join(root, CORR_REFERENCE_NPZ)))
    order = ring_order(t)
    t0 = time.perf_counter()
    colmap_dir = os.path.join(work, "corr_colmap")
    write_colmap_tracks(colmap_dir, np.asarray(R)[order], np.asarray(t)[order],
                        mvs_tracks(R, t, order, n=CORR_GT_POINTS))
    wdir = os.path.join(work, "corr_weights")
    os.makedirs(wdir, exist_ok=True)
    weights = write_correspondence_weights(wdir)
    weights["superpoint"] = write_deep_weights(wdir, ("superpoint",))["superpoint"]
    print(f"correspondence: COLMAP model and seeded weights written in {time.perf_counter() - t0:.3f} s; sums of "
          f"squares {weights['sumsq']} (the reference's {ref['sumsq']})", flush=True)
    if any(abs(weights["sumsq"][k] - ref["sumsq"][k]) > 1e-6 * ref["sumsq"][k] for k in ref["sumsq"]):
        raise AssertionError("correspondence: the seeded weights differ from the reference's")
    base = ["--loader", "olsson", "--dataset_dirpath", runner_dir]
    # F: the unified config with OpenCV's SIFT in the detector slot (its
    # DoG-SIFT fields, contrast_threshold, are not OpenCV's options)
    import yaml

    from gtsfm_tpu_torch.configs.config import load_config

    import cv2

    print(f"correspondence F: OpenCV {cv2.__version__}", flush=True)
    sift_cfg = dict(load_config("unified"), detector={"name": "sift", "max_keypoints": 2048})
    sift_yaml = os.path.join(work, "unified_sift.yaml")
    with open(sift_yaml, "w") as f:
        yaml.safe_dump(sift_cfg, f)
    runs = {
        "A colmap_front_end": ["--config_name", "colmap_front_end", f"correspondence.colmap_dir={colmap_dir}",
                               f"scene_optimizer.telemetry_db={os.path.join(work, 'telemetry.sqlite')}"],
        "B skydio_front_end": ["--config_name", "skydio_front_end", f"correspondence.weights_path={weights['loftr']}"],
        "C mast3r": ["--config_name", "mast3r", f"correspondence.weights_path={weights['mast3r']}"],
        "D deep_front_end superglue": ["--config_name", "deep_front_end", "matcher.name=superglue",
                                       f"matcher.weights_path={weights['superglue']}",
                                       f"detector.weights_path={weights['superpoint']}"],
        "F unified sift": ["--config_name", sift_yaml],
    }
    trace_dir = os.path.join(work, "corr_trace")
    results, objects = {}, {}
    for tag, argv in runs.items():
        rec, restore = _corr_recorders()
        if tag.startswith("A"):
            os.environ["GTSFM_TPU_TRACE"] = trace_dir
        try:
            res = _runner_once(f"correspondence {tag}", base + argv, os.path.join(work, "corr_" + tag.split()[0]))
        finally:
            restore()
            os.environ.pop("GTSFM_TPU_TRACE", None)
        objects.update(rec["objects"])
        counts = np.asarray(list(rec["counts"].values()) or res["matches_per_pair"])
        res.update(counts=counts, aggregate_sec=rec["aggregate_sec"], generate_sec=rec["generate_sec"])
        bars = None
        if tag.startswith("A"):
            j = ref["colmap_front_end"]
            bars = (j["registered"] - RUNNER_REGISTERED_SLACK, j["pose_auc_@5.0_deg"] - RUNNER_AUC5_SLACK)
        _print_run(f"correspondence {tag}", res, bars, smi)
        print(f"correspondence {tag}: {'correspondences' if rec['counts'] else 'matches'} per pair median "
              f"{float(np.median(counts)):.0f} min {int(counts.min())} max {int(counts.max())} (sum "
              f"{int(counts.sum())}), valid pairs {res['valid']} of {res['pairs']}, the generator "
              f"{rec['generate_sec']:.3f} s, the aggregator {rec['aggregate_sec']:.3f} s on the host | {smi}",
              flush=True)
        if tag.startswith("F"):
            if res["launches"]["matcher"] < 1:
                raise AssertionError(f"correspondence {tag}: kernel #1 never launched")
        else:
            if res["launches"]["matcher"] or res["launches"]["attention"]:
                raise AssertionError(f"correspondence {tag}: a kernel launched in a run that has none on its path "
                                     f"({res['launches']})")
            if int(counts.sum()) == 0:
                raise AssertionError(f"correspondence {tag}: no correspondence")
        if tag[0] in "BCD" and [tuple(p) for p in res["pair_list"][: len(CORR_HOLD_PAIRS)]] != list(CORR_HOLD_PAIRS):
            raise AssertionError(f"correspondence {tag}: the run's first pairs {res['pair_list'][:4]} are not "
                                 f"{CORR_HOLD_PAIRS}")
        results[tag] = res
        torch.cuda.empty_cache()

    # E: the telemetry rows and the trace of run A
    with sqlite3.connect(os.path.join(work, "telemetry.sqlite")) as conn:
        n_rows = conn.execute("SELECT COUNT(*) FROM two_view_results").fetchone()[0]
        stages = sorted(r[0] for r in conn.execute("SELECT stage FROM stage_timings"))
    traces = [os.path.join(d, f) for d, _, fs in os.walk(trace_dir) for f in fs]
    trace_bytes = sum(os.path.getsize(f) for f in traces)
    print(f"correspondence E: telemetry {n_rows} two-view rows for {results['A colmap_front_end']['pairs']} pairs, "
          f"stages {stages}; trace files {[os.path.relpath(f, trace_dir) for f in traces]} ({trace_bytes} bytes)",
          flush=True)
    if n_rows != results["A colmap_front_end"]["pairs"] or not trace_bytes:
        raise AssertionError("correspondence E: the telemetry rows or the trace are missing")

    # the held pairs: each generator on the card against the JAX package's
    hold = np.asarray(CORR_HOLD_PAIRS)
    gray = corr_hold_gray(npz["views_rgb"])  # the reference's views, so that both sides see the same pixels
    held = {}
    for kind in ("loftr", "mast3r"):
        t0 = time.perf_counter()
        got = objects[kind].generate(list(gray), hold)
        sec = time.perf_counter() - t0
        held[kind] = [corr_share(kind, got[tuple(p)], (npz[f"{kind}_uv1_{k}"], npz[f"{kind}_uv2_{k}"]))
                      for k, p in enumerate(hold.tolist())]
        print(f"correspondence held {kind}: {[(h['n_port'], h['n_ref'], h['common']) for h in held[kind]]} "
              f"(port, reference, identical) on {hold.tolist()}, shares {[round(h['share'], 4) for h in held[kind]]}"
              + (f", refined coordinates of the common ones at most {max(h['fine_err'] for h in held[kind]):.3g} "
                 f"px apart" if kind == "loftr" else "") + f"; {sec:.3f} s | {smi}", flush=True)
    (xy, mask, desc), (i1, i2) = corr_glue_feed(np.asarray(R)[order], np.asarray(t)[order])
    dev = torch.device("cuda")
    T = [torch.as_tensor(a, device=dev) for a in (desc[i1], desc[i2], xy[i1], xy[i2], mask[i1], mask[i2])]
    idx, ok, _score = (a.cpu().numpy() for a in objects["superglue"].match_batch(
        *T, image_size=(SPLAT_HW[1], SPLAT_HW[0])))
    held["superglue"] = [corr_share("superglue", (idx[k], ok[k]), (npz["superglue_idx"][k], npz["superglue_mask"][k]))
                         for k in range(len(hold))]
    print(f"correspondence held superglue (descriptor feed, K={GLUE_KEYPOINTS}): "
          f"{[(h['n_port'], h['n_ref'], h['common']) for h in held['superglue']]} (port, reference, identical), "
          f"shares {[round(h['share'], 4) for h in held['superglue']]}", flush=True)
    bad = [(kind, k) for kind, hs in held.items() for k, h in enumerate(hs)
           if h["share"] < CORR_MATCH_SHARE or h["n_ref"] == 0 or h["fine_err"] > CORR_FINE_TOL_PX]
    if bad:
        raise AssertionError(f"correspondence: held pairs below the bars (share {CORR_MATCH_SHARE}, LoFTR "
                             f"{CORR_FINE_TOL_PX} px): {bad}")
    return {"launches": results["F unified sift"]["launches"]["matcher"], "held": held,
            "runs": {k: {"registered": r["registered"], "auc5": r["auc5"], "valid": r["valid"], "pairs": r["pairs"]}
                     for k, r in results.items()}}


def phase_bal(smi: str, work: str) -> dict:
    """The BAL tool mode on the card: bal_problem at Trafalgar-257's counts
    written perturbed (and once at the truth), ``runner.main(["--bal",
    path, ...])`` (BAOptions(), camera 0 fixed); the final cost must stay
    within BAL_COST_SLACK above the cost at the generating parameters on
    the same observations (BA with no iteration on the truth's file), and
    the COLMAP export must read back with every camera. Prints the
    seconds, iterations and costs."""
    import contextlib
    import io
    import os
    import re

    import torch

    from gtsfm_tpu_torch import runner
    from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
    from gtsfm_tpu_torch.io import colmap
    from gtsfm_tpu_torch.io.bal import read_bal

    path, gt_path = os.path.join(work, "trafalgar_257.txt"), os.path.join(work, "trafalgar_257_truth.txt")
    t0 = time.perf_counter()
    counts = bal_problem(path, perturbed=True)
    bal_problem(gt_path, perturbed=False)
    write_sec = time.perf_counter() - t0
    gt = read_bal(gt_path).map(lambda a: a.to("cuda"))
    fixed = np.zeros(gt.max_cameras, bool)
    fixed[0] = True
    cost_gen = BundleAdjustment(BAOptions(max_iterations=0)).run(gt, fixed_cam=fixed)[1]["initial_cost"]
    del gt
    out_dir = os.path.join(work, "bal_out")
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = runner.main(["--bal", path, "--output_root", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print(text.strip(), flush=True)
    m = re.search(r"BA: cost (\S+) -> (\S+) in (\d+) iterations \((\S+)s\)", text)
    back = colmap.read_scene(os.path.join(out_dir, "bal_output"))
    n_obs, n_par = 2 * counts["observations"], 9 * counts["cameras"] + 3 * counts["points"]
    c0, cf, iters = float(m.group(1)), float(m.group(2)), int(m.group(3))
    print(f"bal: {counts}, written in {write_sec:.3f} s; main {wall:.3f} s, {iters} iterations; cost {c0:.6g} -> "
          f"{cf:.6g}, at the generating parameters {cost_gen:.6g}: final / generating {cf / cost_gen:.4f} (bar "
          f"<= {1 + BAL_COST_SLACK}; a least-squares fit of {n_par} parameters to {n_obs} residuals drops it by "
          f"about {n_par / n_obs:.3f}); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"the export reads back {back.number_images()} cameras | {smi}", flush=True)
    if rc != 0 or not cf <= (1 + BAL_COST_SLACK) * cost_gen or back.number_images() != BAL_CAMERAS:
        raise AssertionError(f"bal: exit code {rc}, final cost {cf} against {cost_gen}, {back.number_images()} "
                             f"cameras exported")
    for p in (path, gt_path):
        os.remove(p)
    return {"wall": wall, "iterations": iters, "initial_cost": c0, "final_cost": cf, "cost_gen": cost_gen}


def main() -> int:
    import torch

    t_script = time.perf_counter()
    phase_sec = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_sec[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_sec[name]:.1f} s", flush=True)
        return out

    smi = phase_device()
    timed("build", phase_build)

    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    pairs = ring_pairs(NUM_CAMERAS)
    gt = spectral_ring_poses(pairs, NUM_CAMERAS)
    R, t = gt.R.numpy(), gt.t.numpy()
    kp_xy, kp_mask, descs = descriptor_feed(R, t, FOCAL, IMAGE_HW, NUM_KEYPOINTS)

    err, ms_slice, bound_slice = timed("kernel", phase_kernel, kp_mask, descs, pairs)
    err_runner, ms, bound = timed("kernel_runner", phase_kernel_runner)
    attn_err, attn_ms, attn_bound = timed("attention", phase_attention)
    comp_err, comp_ms, comp_bound = timed("composite", phase_composite, R, t)
    slice_launches, slice_comp_launches = timed("slice", phase_slice, kp_xy, kp_mask, descs, pairs, R, t)
    attn_launches, _sec, fwd = timed("lightglue", phase_lightglue, pairs, R, t)
    # the forward's 36 launches: per layer two self entries and one cross
    # entry (two launches), each at the timed P96_K2048 shape
    from gtsfm_tpu_torch.frontend.matchers.lightglue import LightGlueOptions

    layers = LightGlueOptions().num_layers
    attn_fwd_ms = layers * (2 * attn_ms["fused_attention_merged"]["kernel"]
                            + attn_ms["fused_cross_attention_merged"]["kernel"])
    print(f"lightglue forward: {fwd['kernel'] * 1e3:.3f} ms warm (host clock), of which the attention kernel "
          f"{attn_fwd_ms:.3f} ms ({layers} layers x (2 self + 1 cross entry) at the timed medians), "
          f"{attn_fwd_ms / (fwd['kernel'] * 1e3):.3f} of the forward", flush=True)
    timed("gate", phase_gate)
    timed("hierarchical", phase_hierarchical, smi)
    timed("ba_layouts", phase_ba_layouts, smi)
    with tempfile.TemporaryDirectory() as work:
        runner_launches, runner_dir, runner_views, runner_cold = timed("runner", phase_runner, smi, R, t, work)
        options_launches = timed("runner_options", phase_runner_options, smi, runner_dir, runner_views)
        colmap_launches = timed("colmap_runner", phase_colmap_runner, smi, R, t)
        comp_launches = timed("splat", phase_splat, R, t)
        deep = timed("deep_front_end", phase_deep_front_end, smi, runner_dir)
        megaloc = timed("megaloc_sift", phase_megaloc_sift, smi, runner_dir)
        timed("deep_components", phase_deep_components, runner_dir)
        ff = timed("feedforward", phase_feedforward, smi, runner_dir, R, t, work)
        timed("vggt_full", phase_vggt_full, smi, runner_dir, R, t, work)
        timed("mvs", phase_mvs, smi, R, t, work)
        mvs_launches = timed("mvs_runner", phase_mvs_runner, smi, runner_dir, work)["launches"]
        timed("bal", phase_bal, smi, work)
        corr = timed("correspondence", phase_correspondence, smi, runner_dir, R, t, work)
        outputs = timed("runner_outputs", phase_runner_outputs, smi, runner_dir, runner_cold)
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in phase_sec.items()}), flush=True)
    print(f"script seconds: {time.perf_counter() - t_script:.1f} (limit 1200)", flush=True)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_mutual_nn_matcher",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/fused_matcher.cu",
        "replaces": "gtsfm_tpu/frontend/matchers/pallas_matcher.py:29",
        "shape": "P64_K2048_D128",
        "launches": runner_launches["matcher"] + options_launches["matcher"] + colmap_launches["matcher"]
        + sum(r["launches"]["matcher"] for r in megaloc["runs"]) + mvs_launches + corr["launches"]
        + outputs["matcher"],
        "runner_launches": runner_launches["matcher"],
        "runner_outputs_launches": {tag: r["matcher"] for tag, r in outputs["runs"].items()},
        "runner_options_launches": options_launches["matcher"],
        "colmap_runner_launches": colmap_launches["matcher"],
        "mvs_runner_launches": mvs_launches,
        "correspondence_launches": corr["launches"],
        "max_abs_err": max(err, err_runner, megaloc["err"]),
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "device_ms": ms["device"],
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "slice": {"shape": "P96_K1024_D128", "launches": slice_launches, "ms": ms_slice["kernel"],
                  "plain_ms": ms_slice["plain"], "device_ms": ms_slice["device"], "bound_ms": bound_slice[0],
                  "bound_by": bound_slice[1]},
        "megaloc_sift": {"shape": megaloc["shape"], "launches": sum(r["launches"]["matcher"] for r in megaloc["runs"]),
                         "max_abs_err": megaloc["err"], "ms": megaloc["ms"]["kernel"],
                         "plain_ms": megaloc["ms"]["plain"], "device_ms": megaloc["ms"]["device"],
                         "bound_ms": megaloc["bound"][0], "bound_by": megaloc["bound"][1], "library_ms": None,
                         "chunk": {"shape": megaloc["full_shape"], "device_ms": megaloc["full_ms"],
                                   "bound_ms": megaloc["full_bound"][0], "bound_by": megaloc["full_bound"][1]}},
    }, {
        "name": "fused_attention",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/fused_attention.cu",
        "replaces": "gtsfm_tpu/frontend/matchers/pallas_attention.py:127",
        "also_replaces": ["gtsfm_tpu/frontend/matchers/pallas_attention.py:99",
                          "gtsfm_tpu/frontend/matchers/pallas_attention.py:29"],
        "shape": deep["attention"]["fused_attention_merged"]["shape"],
        "launches": deep["warm"]["launches"]["attention"] + outputs["attention"],
        "deep_front_end_launches": deep["warm"]["launches"]["attention"],
        "runner_outputs_launches": {tag: r["attention"] for tag, r in outputs["runs"].items()},
        "lightglue_forwards": deep["warm"]["forwards"],
        "max_abs_err": max([attn_err] + [e["err"] for e in deep["attention"].values()]),
        "ms": deep["attention"]["fused_attention_merged"]["kernel"],
        "plain_ms": deep["attention"]["fused_attention_merged"]["plain"],
        "bound_ms": deep["attention"]["fused_attention_merged"]["bound"][0],
        "bound_by": deep["attention"]["fused_attention_merged"]["bound"][1],
        "library_ms": deep["attention"]["fused_attention_merged"]["library"],
        "entries": {e: {"replaces": r, "max_abs_err": v["err"], "ms": v["kernel"], "plain_ms": v["plain"],
                        "bound_ms": v["bound"][0], "bound_by": v["bound"][1], "library_ms": v["library"]}
                    for (e, v), r in zip(deep["attention"].items(),
                                         ("gtsfm_tpu/frontend/matchers/pallas_attention.py:127",
                                          "gtsfm_tpu/frontend/matchers/pallas_attention.py:99"))},
        "slice": {"shape": "P96_K2048_4x64", "launches": attn_launches, "max_abs_err": attn_err,
                  "ms": attn_ms["fused_attention_merged"]["kernel"],
                  "plain_ms": attn_ms["fused_attention_merged"]["plain"],
                  "bound_ms": attn_bound[0], "bound_by": attn_bound[1],
                  "library_ms": attn_ms["fused_attention_merged"]["library"],
                  "split_layout_ms": attn_ms["fused_attention"]["kernel"],
                  "split_layout_library_ms": attn_ms["fused_attention"]["library"]},
    }, {
        "name": "splat_composite",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/splat_composite.cu",
        "replaces": "gtsfm_tpu/splat/rendering.py:420",
        "launches": comp_launches + ff["composite"] + outputs["composite"],
        "splat_launches": comp_launches,
        "runner_outputs_launches": {tag: r["composite"] for tag, r in outputs["runs"].items()},
        "feedforward_launches": ff["composite"],
        "slice_launches": slice_comp_launches,
        "max_abs_err": comp_err,
        "ms": comp_ms["kernel"],
        "plain_ms": comp_ms["plain"],
        "device_ms": comp_ms["device"],
        "bound_ms": comp_bound[0],
        "bound_by": comp_bound[1],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
