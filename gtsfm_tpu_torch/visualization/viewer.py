"""Standalone HTML scene browser.

Port of gtsfm_tpu/visualization/viewer.py: one self-contained HTML file
per scene, the point cloud and the camera frusta embedded with a small
inline canvas orbit renderer (no server, no CDN); a scan of a results tree
that writes a viewer per COLMAP scene and an index page linking the splat
files, fly-throughs and reports beside them; a stdlib HTTP server over the
tree; and the CLI:

    python -m gtsfm_tpu_torch.visualization.viewer <colmap_dir> [out.html]
    python -m gtsfm_tpu_torch.visualization.viewer --scan <results_root> [index.html]
    python -m gtsfm_tpu_torch.visualization.viewer --serve <results_root> [--port 8080]
"""

from __future__ import annotations

import json
import os

import numpy as np

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.io import colmap as colmap_io

_JS = """
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = 0.6, pitch = 0.4, dist = 3.0, cx = 0, cy = 0;
let dragging = false, lastX = 0, lastY = 0;
canvas.onmousedown = e => { dragging = true; lastX = e.clientX; lastY = e.clientY; };
window.onmouseup = () => dragging = false;
window.onmousemove = e => {
  if (!dragging) return;
  yaw += (e.clientX - lastX) * 0.008;
  pitch += (e.clientY - lastY) * 0.008;
  lastX = e.clientX; lastY = e.clientY; draw();
};
canvas.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); draw(); };
function proj(p) {
  const cyw = Math.cos(yaw), syw = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  let x = p[0] - center[0], y = p[1] - center[1], z = p[2] - center[2];
  let x1 = cyw * x + syw * z, z1 = -syw * x + cyw * z;
  let y2 = cp * y - sp * z1, z2 = sp * y + cp * z1;
  z2 += dist * scale;
  if (z2 <= 0.01) return null;
  const f = 0.9 * canvas.height;
  return [canvas.width / 2 + f * x1 / z2, canvas.height / 2 + f * y2 / z2, z2];
}
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  for (const p of points) {
    const q = proj(p);
    if (!q) continue;
    const s = Math.max(0.5, 2.5 * scale / q[2]);
    ctx.fillStyle = '#ccc'; ctx.fillRect(q[0], q[1], s, s);
  }
  ctx.strokeStyle = '#e33';
  for (const cam of cameras) {
    const q0 = proj(cam[0]); if (!q0) continue;
    ctx.beginPath();
    for (let i = 1; i < cam.length; i++) {
      const q = proj(cam[i]); if (!q) continue;
      ctx.moveTo(q0[0], q0[1]); ctx.lineTo(q[0], q[1]);
    }
    ctx.stroke();
  }
}
draw();
"""


def export_scene_html(data: SfmData, output_path: str, max_points: int = 30000) -> None:
    """The scene's points (at most ``max_points``, drawn at random with
    seed 0) and registered cameras as a standalone orbit viewer."""
    pts = data.points.cpu().numpy()[data.track_mask.cpu().numpy()]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).permutation(len(pts))[:max_points]]
    pm = data.pose_mask.cpu().numpy()
    centers = data.poses.t.cpu().numpy()[pm]
    Rs = data.poses.R.cpu().numpy()[pm]
    all_pts = pts if len(pts) else centers
    center = all_pts.mean(axis=0) if len(all_pts) else np.zeros(3)
    scale = float(np.ptp(all_pts, axis=0).max() + 1e-6) if len(all_pts) else 1.0

    cams = []
    fr = 0.06 * scale
    for c, R in zip(centers, Rs):
        corners = [c]
        for sx, sy in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            corners.append(c + R @ np.array([sx * fr, sy * fr, 2 * fr]))
        cams.append([list(map(float, p)) for p in corners])

    html_doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>gtsfm_tpu scene</title></head>
<body style="margin:0;background:#111;color:#eee;font-family:sans-serif">
<div style="position:absolute;padding:8px">{len(pts)} points, {len(cams)} cameras
 &mdash; drag to orbit, wheel to zoom</div>
<canvas id="c" width="1280" height="900" style="width:100vw;height:100vh"></canvas>
<script>
const points = {json.dumps(np.round(pts, 4).tolist())};
const cameras = {json.dumps(cams)};
const center = {json.dumps(list(map(float, center)))};
const scale = {scale};
{_JS}
</script></body></html>"""
    with open(output_path, "w") as f:
        f.write(html_doc)


def scan_results_and_build_index(results_root: str, output_path: str) -> list:
    """Write a viewer for every COLMAP scene under ``results_root`` and an
    index page at ``output_path`` linking them and the splat files,
    fly-throughs and metric reports beside them. Returns the scene
    directories found."""
    scenes = []
    for dirpath, _dirs, files in os.walk(results_root):
        if {"cameras.txt", "images.txt", "points3D.txt"} <= set(files):
            scenes.append(dirpath)
    out_dir = os.path.dirname(output_path) or "."
    links = []
    for s in scenes:
        data = colmap_io.read_scene(s)
        rel = os.path.relpath(s, results_root).replace(os.sep, "_")
        out = os.path.join(out_dir, f"scene_{rel}.html")
        export_scene_html(data, out)
        extras = []
        parent = os.path.dirname(s)
        for name, label in [
            ("splat_flythrough.gif", "fly-through"),
            ("splat_flythrough.mp4", "fly-through video"),
            ("splats.ply", "splats"),
            ("gaussian_points.ply", "gaussian cloud"),
            ("metrics_report.html", "metrics"),
        ]:
            for base in (s, parent):
                p = os.path.join(base, name)
                if os.path.isfile(p):
                    extras.append((label, os.path.relpath(p, out_dir)))
                    break
        links.append((rel, os.path.basename(out), data.number_tracks(), extras))
    with open(output_path, "w") as f:
        f.write("<html><body style='font-family:sans-serif'><h1>gtsfm_tpu scenes</h1><ul>")
        for rel, href, ntracks, extras in links:
            extra_html = " ".join(f'&middot; <a href="{p}">{label}</a>' for label, p in extras)
            f.write(f'<li><a href="{href}">{rel}</a> ({ntracks} tracks) {extra_html}</li>')
        f.write("</ul></body></html>")
    return scenes


def serve_results(results_root: str, port: int = 8080) -> None:
    """Scan ``results_root`` and serve it over HTTP on localhost (stdlib
    http.server). Blocks until interrupted."""
    import functools
    import http.server

    scenes = scan_results_and_build_index(results_root, os.path.join(results_root, "index.html"))
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=results_root)
    with http.server.ThreadingHTTPServer(("", port), handler) as httpd:
        print(f"serving {len(scenes)} scenes from {results_root} at http://localhost:{port}/index.html")
        httpd.serve_forever()


def main(argv=None):
    """View a COLMAP reconstruction, or scan or serve a results tree."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="COLMAP dir (or results root with --scan / --serve)")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("--scan", action="store_true", help="scan a results tree and build an index page")
    ap.add_argument("--serve", action="store_true", help="scan and serve the results browser over HTTP")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)
    if args.serve:
        serve_results(args.path, port=args.port)
    elif args.scan:
        out = args.output or os.path.join(args.path, "index.html")
        entries = scan_results_and_build_index(args.path, out)
        print(f"indexed {len(entries)} scenes -> {out}")
    else:
        out = args.output or os.path.join(args.path, "viewer.html")
        export_scene_html(colmap_io.read_scene(args.path), out)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    main()
