"""What a run writes under ``output_root``, the port against the JAX
reference on the same seeded numpy inputs, on the CPU.

- ``retrieval_metrics``: scores equal, GT angles within 1e-3 deg, the
  correlation within 1e-5; ``merge_metrics_groups``: equal.
- ``generate_html_report``: the same text once the base64 histograms are
  taken out, and as many histograms (the reference draws them with
  matplotlib, the port with PIL).
- The process graph: the same DOT text.
- ``export_scene_html``: the embedded points, cameras, center and scale
  within 1e-4; ``scan_results_and_build_index``: the same scenes.
- ``SceneTree``: the same files written, the same tree and scenes read.
- The dashboard: ``load_run_metrics`` equal, ``generate_comparison_html``
  equal but for the package's name in the title.
- ``compare_colmap_dirs`` and ``compare_colmap_dirs_by_cluster``: counts,
  lengths and distances within 1e-5, angles within 2e-3 deg and the AUCs
  within 2e-4 (float32 arccos near 1 in both packages), nearest-point
  distances within 1e-4; the same CSV rows at those tolerances; a
  camera-centers PNG.
- The splat fly-through (``_export_splat_video``): as many frames, each
  within 2/255 of the reference's PNG, and a GIF.
- ``prewarm_standard_shapes``: the reference's names, at a tiny shape set.
- The figures of visualization/viz.py: PNGs of the expected sizes.
"""

import base64
import csv
import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
from PIL import Image

from gtsfm_tpu.common.sfm_data import SceneMeta as JSceneMeta, SfmData as JSfmData
from gtsfm_tpu.evaluation import compare as j_compare
from gtsfm_tpu.evaluation import dashboard as j_dashboard
from gtsfm_tpu.evaluation.metrics import Metric as JMetric, MetricsGroup as JMetricsGroup
from gtsfm_tpu.evaluation.report import generate_html_report as j_report
from gtsfm_tpu.evaluation.retrieval_metrics import merge_metrics_groups as j_merge, retrieval_metrics as j_retrieval
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal, so3 as jso3
from gtsfm_tpu.io import colmap as j_colmap
from gtsfm_tpu.products.scene_tree import SceneTree as JSceneTree
from gtsfm_tpu.scene.scene_optimizer import SceneOptimizer as JSceneOptimizer
from gtsfm_tpu.splat.gs_data import GSData as JGSData
from gtsfm_tpu.ui.registry import ProcessGraphGenerator as JGraph
from gtsfm_tpu.utils import prewarm as j_prewarm
from gtsfm_tpu.visualization.viewer import export_scene_html as j_export_html
from gtsfm_tpu.visualization.viewer import scan_results_and_build_index as j_scan
from gtsfm_tpu_torch.common.sfm_data import SceneMeta
from gtsfm_tpu_torch.evaluation import compare, dashboard
from gtsfm_tpu_torch.evaluation.metrics import Metric, MetricsGroup
from gtsfm_tpu_torch.evaluation.report import generate_html_report
from gtsfm_tpu_torch.evaluation.retrieval_metrics import merge_metrics_groups, retrieval_metrics
from gtsfm_tpu_torch.products.scene_tree import SceneTree
from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer
from gtsfm_tpu_torch.ui.registry import ProcessGraphGenerator
from gtsfm_tpu_torch.utils import convert
from gtsfm_tpu_torch.utils.prewarm import prewarm_standard_shapes
from gtsfm_tpu_torch.visualization import viz
from gtsfm_tpu_torch.visualization.viewer import export_scene_html, scan_results_and_build_index
from tests.torch_threads import cap_threads, threads

cap_threads()

TOL = 1e-5


def _ring_scene(n=8, tracks=60, seed=0, noise=0.0, sim=None):
    """(JAX SfmData, port SfmData) of n cameras on a ring looking at
    ``tracks`` points near the origin, measurements the exact projections;
    ``noise`` perturbs the cameras, ``sim`` (s, R, t) moves the scene."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    c = np.stack([4 * np.cos(ang), 0.2 * np.sin(2 * ang), 4 * np.sin(ang)], axis=1)
    z = -c / np.linalg.norm(c, axis=1, keepdims=True)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=2)
    pts = rng.uniform(-1, 1, (tracks, 3))
    if noise:
        R = np.stack([np.asarray(jso3.expmap(jnp.asarray(rng.normal(0, noise, 3), jnp.float32))) @ r for r in R])
        c = c + rng.normal(0, noise, c.shape)
        pts = pts + rng.normal(0, noise, pts.shape)
    if sim is not None:
        s, Rs, ts = sim
        R, c, pts = Rs @ R, s * c @ Rs.T + ts, s * pts @ Rs.T + ts
    meas = [(i, j) for j in range(tracks) for i in rng.choice(n, 3, replace=False)]
    mc = np.array([m[0] for m in meas], np.int32)
    mt = np.array([m[1] for m in meas], np.int32)
    f, u0, v0 = 300.0, 160.0, 120.0
    Rcw = np.transpose(R[mc], (0, 2, 1))
    pc = np.einsum("mij,mj->mi", Rcw, pts[mt] - c[mc])
    uv = np.stack([f * pc[:, 0] / pc[:, 2] + u0, f * pc[:, 1] / pc[:, 2] + v0], axis=1)
    names = [f"view_{i:02d}.png" for i in range(n)]
    jdata = JSfmData(poses=JSE3(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(c, jnp.float32)),
                     cal=JCal.create(np.full(n, f, np.float32), np.zeros(n, np.float32), np.zeros(n, np.float32),
                                     np.full(n, u0, np.float32), np.full(n, v0, np.float32)),
                     pose_mask=jnp.ones(n, bool), points=jnp.asarray(pts, jnp.float32),
                     track_mask=jnp.ones(tracks, bool), meas_cam=jnp.asarray(mc), meas_track=jnp.asarray(mt),
                     meas_uv=jnp.asarray(uv, jnp.float32), meas_mask=jnp.ones(len(mc), bool),
                     meta=JSceneMeta(image_names=names, image_sizes=[(320, 240)] * n))
    tdata = convert.sfm_data(jdata).replace(meta=SceneMeta(image_names=names, image_sizes=[(320, 240)] * n))
    return jdata, tdata


def _groups(rng):
    """Three metrics groups of scalars and distributions, in both packages."""
    spec = {
        "frontend_summary": {"num_pairs": 28.0, "two_view_sec": 1.25,
                             "num_inliers_per_pair": rng.integers(10, 200, 28).astype(np.float64)},
        "ba_pose_metrics": {"rotation_error_deg": rng.gamma(2.0, 0.3, 8), "pose_auc_@5.0_deg": 0.8125,
                            "translation_error": np.append(rng.gamma(2.0, 0.1, 7), np.nan)},
        "total_summary": {"total_runtime_sec": 12.5},
    }
    port = [MetricsGroup(g, [Metric(k, v) for k, v in ms.items()]) for g, ms in spec.items()]
    ref = [JMetricsGroup(g, [JMetric(k, v) for k, v in ms.items()]) for g, ms in spec.items()]
    return port, ref


def test_retrieval_metrics_match_reference():
    rng = np.random.default_rng(1)
    n = 12
    R = np.asarray(jso3.expmap(jnp.asarray(rng.normal(0, 0.8, (n, 3)), jnp.float32)))
    gt_j = JSE3(R=jnp.asarray(R), t=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))
    gt_t = convert.se3(gt_j)
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, min(i + 4, n))], np.int64)
    sim = rng.uniform(0, 1, (n, n)).astype(np.float32)
    gj, gt = j_retrieval(pairs, sim, gt_j), retrieval_metrics(pairs, sim, gt_t)
    mj, mt = {m.name: m for m in gj.metrics}, {m.name: m for m in gt.metrics}
    assert gt.name == gj.name == "retrieval_metrics" and list(mt) == list(mj)
    assert mt["num_retrieved_pairs"].scalar == mj["num_retrieved_pairs"].scalar == len(pairs)
    np.testing.assert_array_equal(mt["similarity_scores"].dist, mj["similarity_scores"].dist)
    np.testing.assert_allclose(mt["gt_relative_rotation_deg"].dist, mj["gt_relative_rotation_deg"].dist, atol=1e-3)
    assert abs(mt["score_vs_proximity_correlation"].scalar - mj["score_vs_proximity_correlation"].scalar) <= 1e-5

    port, ref = _groups(np.random.default_rng(2))
    port2, ref2 = _groups(np.random.default_rng(3))
    merged_t = merge_metrics_groups(port + port2, "merged").to_dict()
    merged_j = j_merge(ref + ref2, "merged").to_dict()
    assert json.dumps(merged_t, sort_keys=True) == json.dumps(merged_j, sort_keys=True)


def _strip_images(text: str) -> tuple:
    images = re.findall(r'src="data:image/png;base64,([A-Za-z0-9+/=]+)"', text)
    return re.sub(r'src="data:image/png;base64,[A-Za-z0-9+/=]+"', 'src=""', text), images


def test_html_report_and_process_graph_match_reference(tmp_path):
    port, ref = _groups(np.random.default_rng(4))
    cmp_port, cmp_ref = _groups(np.random.default_rng(5))
    for compare_t, compare_j, tag in ((None, None, "plain"), (cmp_port, cmp_ref, "compared")):
        generate_html_report(port, str(tmp_path / f"port_{tag}.html"), compare_groups=compare_t)
        j_report(ref, str(tmp_path / f"jax_{tag}.html"), compare_groups=compare_j)
        text_t, img_t = _strip_images((tmp_path / f"port_{tag}.html").read_text())
        text_j, img_j = _strip_images((tmp_path / f"jax_{tag}.html").read_text())
        assert text_t == text_j
        assert len(img_t) == len(img_j) == 3
        for b in img_t:
            png = Image.open(io.BytesIO(base64.b64decode(b)))
            assert png.size == (288, 192)
    assert ProcessGraphGenerator().to_dot() == JGraph().to_dot()
    ProcessGraphGenerator().save_graph(str(tmp_path / "g.dot"))
    assert (tmp_path / "g.dot").read_text() == JGraph().to_dot()


def _viewer_fields(path) -> dict:
    text = open(path).read()
    return {k: json.loads(re.search(rf"const {k} = (.*?);\n", text).group(1))
            for k in ("points", "cameras", "center", "scale")}


def test_viewer_and_scan_match_reference(tmp_path):
    jdata, tdata = _ring_scene()
    export_scene_html(tdata, str(tmp_path / "port.html"))
    j_export_html(jdata, str(tmp_path / "jax.html"))
    ft, fj = _viewer_fields(tmp_path / "port.html"), _viewer_fields(tmp_path / "jax.html")
    for k in ("points", "cameras", "center", "scale"):
        np.testing.assert_allclose(np.asarray(ft[k]), np.asarray(fj[k]), atol=1e-4)
    assert len(ft["points"]) == 60 and len(ft["cameras"]) == 8

    root = tmp_path / "results"
    j_colmap.write_scene(jdata, str(root / "ba_output"))
    j_colmap.write_scene(_ring_scene(seed=1)[0], str(root / "C_1"))
    (root / "splats.ply").write_text("ply\n")
    os.makedirs(tmp_path / "port_index")
    os.makedirs(tmp_path / "jax_index")
    found_t = scan_results_and_build_index(str(root), str(tmp_path / "port_index" / "index.html"))
    found_j = j_scan(str(root), str(tmp_path / "jax_index" / "index.html"))
    assert found_t == found_j and len(found_t) == 2
    assert (tmp_path / "port_index" / "index.html").read_text() == (tmp_path / "jax_index" / "index.html").read_text()
    assert sorted(os.listdir(tmp_path / "port_index")) == sorted(os.listdir(tmp_path / "jax_index"))


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_scene_tree_writes_and_reads_as_reference(tmp_path):
    scenes = [_ring_scene(n=6, seed=s) for s in range(3)]

    def tree(make, data, root):
        leaf = make(directory=os.path.join(root, "C_1", "C_1_2"), scene=data[2])
        mid = make(directory=os.path.join(root, "C_1"), scene=data[1], children=[leaf])
        return make(directory=os.path.join(root, "C_2"), scene=data[0]), mid

    for make, k, tag in ((SceneTree, 1, "port"), (JSceneTree, 0, "jax")):
        for node in tree(make, [s[k] for s in scenes], str(tmp_path / tag)):
            node.write()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") and len(_files(tmp_path / "port")) == 9
    for name in _files(tmp_path / "port"):
        if name.endswith(("cameras.txt", "images.txt")):
            assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    read_t, read_j = SceneTree.read(str(tmp_path / "port")), JSceneTree.read(str(tmp_path / "jax"))
    assert read_t.num_nodes() == read_j.num_nodes() == 3
    shape = lambda node, kids: (os.path.basename(node.directory), kids)  # noqa: E731
    assert read_t.map_postorder(shape)[1] == read_j.map_postorder(shape)[1]  # the roots' names differ
    for st, sj in zip(read_t.all_scenes(), read_j.all_scenes()):
        assert st.number_images() == sj.number_images() and st.number_tracks() == sj.number_tracks()
        np.testing.assert_allclose(st.poses.t.numpy(), np.asarray(sj.poses.t), atol=1e-5)


def test_dashboard_matches_reference(tmp_path):
    runs = {}
    for tag, seed in (("master", 6), ("branch", 7)):
        port, _ref = _groups(np.random.default_rng(seed))
        for g in port:
            g.save_json(str(tmp_path / tag / "door" / "results" / "metrics"))
        runs[tag] = {"door": str(tmp_path / tag / "door")}
    assert dashboard.load_run_metrics(runs["master"]["door"]) == j_dashboard.load_run_metrics(runs["master"]["door"])
    html_t = dashboard.generate_comparison_html(runs["master"], runs["branch"])
    html_j = j_dashboard.generate_comparison_html(runs["master"], runs["branch"])
    assert html_t.replace("gtsfm_tpu_torch", "GTSFM-TPU") == html_j
    out = tmp_path / "dash.html"
    dashboard.main(["--master", f"door={runs['master']['door']}", "--branch", f"door={runs['branch']['door']}",
                    "--output", str(out)])
    assert out.read_text() == html_t


def _compare_tol(name: str) -> float:
    """The tolerance of one comparison metric. Both packages take the
    angles of rotations and directions about half a degree apart through a
    float32 arccos near 1, where one ulp of the cosine is about 4e-4 deg:
    the angles are held to 2e-3 deg and the AUCs built on them to 2e-4.
    The nearest-point distances expand |a - b|^2 in float32 at coordinates
    near 10: 1e-4. Counts, lengths and translation distances: 1e-5."""
    if name.endswith("_deg"):
        return 2e-3
    if name.startswith("pose_auc"):
        return 2e-4
    if name.startswith("point_nn"):
        return 1e-4
    return TOL


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            tol = _compare_tol(ra[0]) if len(ra) == 2 else 2e-3  # per-camera rows: angles
            try:
                assert abs(float(x) - float(y)) <= tol, (ra, rb)
            except ValueError:
                if x.startswith("{"):
                    da, db = json.loads(x), json.loads(y)
                    np.testing.assert_allclose(np.asarray(da.pop("quartiles")), np.asarray(db.pop("quartiles")),
                                               atol=tol)
                    for key in da:
                        assert abs(da[key] - db[key]) <= tol, (key, ra, rb)
                else:
                    assert x == y


@threads(4)
def test_compare_colmap_dirs_match_reference(tmp_path):
    Rs = np.asarray(jso3.expmap(jnp.asarray([0.2, -0.1, 0.3], jnp.float32)), np.float64)
    ref_j, _ = _ring_scene()
    est_j, _ = _ring_scene(noise=0.01, sim=(1.7, Rs, np.array([0.5, -1.0, 2.0])))
    j_colmap.write_scene(ref_j, str(tmp_path / "ref"))
    j_colmap.write_scene(est_j, str(tmp_path / "est"))
    gt = compare.compare_colmap_dirs(str(tmp_path / "est"), str(tmp_path / "ref"), output_dir=str(tmp_path / "ct"))
    gj = j_compare.compare_colmap_dirs(str(tmp_path / "est"), str(tmp_path / "ref"), output_dir=str(tmp_path / "cj"))

    def same(gt, gj):
        mt, mj = {m.name: m for m in gt.metrics}, {m.name: m for m in gj.metrics}
        assert list(mt) == list(mj) and len(mt) > 10
        for k in mt:
            tol = _compare_tol(k)
            if mj[k].dist is None:
                assert abs(mt[k].scalar - mj[k].scalar) <= tol, k
            else:
                np.testing.assert_allclose(mt[k].dist, mj[k].dist, atol=tol, err_msg=k)

    same(gt, gj)
    for name in ("per_camera_errors.csv", "comparison_metrics.csv"):
        _same_rows(_csv_rows(tmp_path / "ct" / name), _csv_rows(tmp_path / "cj" / name))
    assert Image.open(tmp_path / "ct" / "camera_centers.png").size == (1050, 1050)

    root = tmp_path / "clusters"
    j_colmap.write_scene(est_j, str(root))
    j_colmap.write_scene(_ring_scene(n=6, noise=0.02, seed=1)[0], str(root / "C_1" / "ba_output"))
    j_colmap.write_scene(_ring_scene(n=6, noise=0.02, seed=2)[0], str(root / "C_2"))
    by_t = compare.compare_colmap_dirs_by_cluster(str(root), str(tmp_path / "ref"))
    by_j = j_compare.compare_colmap_dirs_by_cluster(str(root), str(tmp_path / "ref"))
    assert [g.name for g in by_t] == [g.name for g in by_j] == [
        "reconstruction_comparison__root", "reconstruction_comparison__C_1", "reconstruction_comparison__C_2"]
    for a, b in zip(by_t, by_j):
        same(a, b)


@threads(4)
def test_splat_video_matches_reference(tmp_path):
    rng = np.random.default_rng(8)
    G, n, frames = 200, 4, 5
    means = rng.uniform(-1.5, 1.5, (G, 3)).astype(np.float32)
    means[:, 2] += 6
    fields = dict(means=means, log_scales=np.log(rng.uniform(0.05, 0.2, (G, 3))).astype(np.float32),
                  quats=rng.normal(size=(G, 4)).astype(np.float32), colors=rng.normal(0, 1, (G, 3)).astype(np.float32),
                  opacity_logit=rng.normal(1, 1, G).astype(np.float32), alive=np.ones(G, np.float32))
    gs_j = JGSData(**{k: jnp.asarray(v) for k, v in fields.items()})
    gs_t = convert.gs_data(fields)
    R = np.stack([np.asarray(jso3.expmap(jnp.asarray([0.0, 0.08 * (k - 1.5), 0.0], jnp.float32)))
                  for k in range(n)])
    t = np.stack([[0.4 * (k - 1.5), 0.0, 0.0] for k in range(n)]).astype(np.float32)
    jdata = JSfmData(poses=JSE3(R=jnp.asarray(R), t=jnp.asarray(t)),
                     cal=JCal.create(np.full(n, 60.0, np.float32), np.zeros(n, np.float32), np.zeros(n, np.float32),
                                     np.full(n, 40.0, np.float32), np.full(n, 30.0, np.float32)),
                     pose_mask=jnp.ones(n, bool), points=jnp.zeros((1, 3)), track_mask=jnp.ones(1, bool),
                     meas_cam=jnp.zeros(1, jnp.int32), meas_track=jnp.zeros(1, jnp.int32), meas_uv=jnp.zeros((1, 2)),
                     meas_mask=jnp.zeros(1, bool))
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    SceneOptimizer._export_splat_video(None, gs_t, convert.sfm_data(jdata), str(tmp_path / "port"), frames)
    JSceneOptimizer._export_splat_video(None, gs_j, jdata, str(tmp_path / "jax"), frames)
    names = sorted(os.listdir(tmp_path / "port" / "splat_video"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "splat_video")) == [f"frame_{f:04d}.png" for f in range(frames)]
    for name in names:
        a = np.asarray(Image.open(tmp_path / "port" / "splat_video" / name), np.int32)
        b = np.asarray(Image.open(tmp_path / "jax" / "splat_video" / name), np.int32)
        assert a.shape == b.shape == (60, 80, 3)
        assert np.abs(a - b).max() <= 2, name
        assert a.std() > 1  # the splats are in view
    gif = Image.open(tmp_path / "port" / "splat_flythrough.gif")
    assert gif.n_frames == frames and gif.size == (80, 60)


def test_prewarm_returns_the_reference_names(monkeypatch):
    class _Lowered:
        def compile(self):
            return None

    for name in ("_lower_two_view", "_lower_ba", "_lower_detector"):
        monkeypatch.setattr(j_prewarm, name, lambda *a, **k: _Lowered())
    monkeypatch.setattr(j_prewarm, "enable_persistent_cache", lambda *a, **k: None)
    shapes = dict(pair_batches=(4,), max_keypoints=64, desc_dim=32, hypotheses=32, ba_shapes=((8, 64, 256),),
                  detector_hw=(48, 64), image_batch=2)
    with threads(4):
        got = prewarm_standard_shapes(device="cpu", **shapes)
    want = j_prewarm.prewarm_standard_shapes(**shapes)
    assert list(got) == list(want) == ["two_view_P4_K64", "ba_8c_64t_256m", "detector_B2_48x64"]
    assert all(v >= 0 for v in got.values())


def test_figures_are_drawn(tmp_path):
    _jdata, tdata = _ring_scene()
    viz.plot_scene_3d(tdata, str(tmp_path / "scene.png"))
    img = np.asarray(Image.open(tmp_path / "scene.png"))
    assert img.shape == (880, 880, 3) and (img != 255).any()
    # every camera's red x axis is drawn
    assert ((img[..., 0] == 255) & (img[..., 1] == 0) & (img[..., 2] == 0)).sum() > 8
    rng = np.random.default_rng(9)
    a, b = rng.uniform(0, 1, (60, 80)), rng.uniform(0, 1, (50, 70))
    kp = rng.uniform(5, 45, (200, 2))
    viz.plot_matches(a, b, kp, kp, str(tmp_path / "matches.png"))
    assert Image.open(tmp_path / "matches.png").size == (150, 60)
    images = rng.uniform(0, 1, (8, 240, 320)).astype(np.float32)
    viz.plot_track_reprojections(tdata, images, [0, 1], str(tmp_path / "tracks.png"))
    assert Image.open(tmp_path / "tracks.png").size == (3 * 128, 2 * (128 + 14))
