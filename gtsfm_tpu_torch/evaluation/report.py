"""Self-contained HTML metrics report.

Port of gtsfm_tpu/evaluation/report.py: one table per metrics group
(count, min, median, mean and max of each distribution, the value of each
scalar, optionally beside a second run's value, green where it is not
worse), and a histogram of each distribution embedded as a base64 PNG.
The reference draws the histograms with matplotlib, which the card's
machine does not have; the port draws them with PIL and numpy, with the
reference's bins: ``min(40, max(8, int(sqrt(n))))`` over the n finite
values, at the reference's 288x192 pixels.
"""

from __future__ import annotations

import base64
import html
import io
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup

_CSS = """
body { font-family: -apple-system, Segoe UI, sans-serif; margin: 2em; }
h2 { border-bottom: 2px solid #444; padding-bottom: 4px; }
table { border-collapse: collapse; margin: 0.6em 0 1.4em; }
td, th { border: 1px solid #bbb; padding: 4px 10px; text-align: right; }
th { background: #f0f0f0; }
.metric-name { text-align: left; font-weight: 600; }
img.hist { border: 1px solid #ddd; margin: 4px; }
.better { background: #d8f5d8; } .worse { background: #f5d8d8; }
"""

_HIST_WH = (288, 192)  # 3.6 x 2.4 inches at 80 dpi


def histogram_png(data: np.ndarray, title: str) -> bytes:
    """PNG bytes of a histogram of the finite values of ``data``, with the
    title above and the range below."""
    w, h = _HIST_WH
    left, right, top, bottom = 8, 8, 18, 18
    img = Image.new("RGB", (w, h), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    draw.text((left, 3), title[:46], fill=(0, 0, 0))
    d = data[np.isfinite(data)]
    draw.rectangle([left, top, w - right, h - bottom], outline=(0, 0, 0))
    if d.size:
        counts, edges = np.histogram(d, bins=min(40, max(8, int(np.sqrt(d.size)))))
        pw, ph = w - left - right - 2, h - top - bottom - 2
        bw = pw / len(counts)
        for k, c in enumerate(counts):
            if c:
                x0 = left + 1 + k * bw
                draw.rectangle([x0, h - bottom - 1 - ph * c / counts.max(), x0 + bw - 1, h - bottom - 1],
                               fill=(72, 120, 176))
        draw.text((left, h - bottom + 3), f"{edges[0]:.4g}", fill=(0, 0, 0))
        hi = f"{edges[-1]:.4g}"
        draw.text((w - right - 6 * len(hi), h - bottom + 3), hi, fill=(0, 0, 0))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def generate_html_report(groups: Sequence[MetricsGroup], output_path: str,
                         compare_groups: Optional[Sequence[MetricsGroup]] = None,
                         compare_label: str = "baseline") -> None:
    """Write a single-file HTML report of ``groups``; with
    ``compare_groups``, each scalar beside the other run's value."""
    cmp_lookup = {}
    if compare_groups:
        for g in compare_groups:
            cmp_lookup[g.name] = g.to_dict()[g.name]

    parts = [f"<html><head><style>{_CSS}</style></head><body>", "<h1>gtsfm_tpu metrics report</h1>"]
    for g in groups:
        parts.append(f"<h2>{html.escape(g.name)}</h2>")
        rows, hists = [], []
        for name, v in g.to_dict()[g.name].items():
            if isinstance(v, dict) and "full_data" in v:
                s = v["summary"]
                if isinstance(s, dict) and "median" in s:
                    rows.append(
                        f"<tr><td class=metric-name>{html.escape(name)}</td>"
                        f"<td>{s['count']}</td><td>{s['min']:.4g}</td>"
                        f"<td>{s['median']:.4g}</td><td>{s['mean']:.4g}</td>"
                        f"<td>{s['max']:.4g}</td></tr>"
                    )
                    png = histogram_png(np.asarray(v["full_data"], np.float64), name)
                    hists.append(f'<img class=hist src="data:image/png;base64,{base64.b64encode(png).decode()}">')
            else:
                cmp_html = ""
                if g.name in cmp_lookup and name in cmp_lookup[g.name]:
                    other = cmp_lookup[g.name][name]
                    if isinstance(other, (int, float)) and isinstance(v, (int, float)):
                        cls = "better" if v >= other else "worse"
                        cmp_html = f"<td class={cls}>{other:.4g} ({compare_label})</td>"
                val = f"{v:.5g}" if isinstance(v, (int, float)) else html.escape(str(v))
                rows.append(f"<tr><td class=metric-name>{html.escape(name)}</td><td colspan=4>{val}</td>{cmp_html}</tr>")
        if rows:
            parts.append("<table><tr><th>metric</th><th>count</th><th>min</th>"
                         "<th>median</th><th>mean</th><th>max</th></tr>" + "".join(rows) + "</table>")
        parts.extend(hists)
    parts.append("</body></html>")
    with open(output_path, "w") as f:
        f.write("".join(parts))
