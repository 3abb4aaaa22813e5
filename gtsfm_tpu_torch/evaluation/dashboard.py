"""Benchmark comparison dashboard: master against branch, red to green.

Port of gtsfm_tpu/evaluation/dashboard.py (plain Python and HTML, the
reference's output): one self-contained HTML file with a table per metrics
group, one column per benchmark, each cell the percentage change from
master to branch, colored by whether the change is better (for error,
runtime and outlier metrics a decrease is better), clipped to +/-20%.

Inputs are run directories as written by SceneOptimizer
(<run>/results/metrics/*.json, the MetricsGroup JSON schema). CLI:

    python -m gtsfm_tpu_torch.evaluation.dashboard \
        --master door=runs/master/door [skydio=...] \
        --branch door=runs/branch/door [...] --output dashboard.html
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

# metrics where smaller is better (substring match, lower-cased)
_LOWER_IS_BETTER = (
    "error", "_sec", "duration", "outlier", "runtime", "reproj", "failure",
)

_CLIP_PCT = 20.0


def _lower_is_better(metric_name: str) -> bool:
    n = metric_name.lower()
    return any(s in n for s in _LOWER_IS_BETTER)


def load_run_metrics(run_dir: str) -> Dict[str, Dict[str, float]]:
    """Flatten <run>/results/metrics/*.json (or <run>/*.json) into
    {group: {metric[.stat]: scalar}} — distributions contribute their
    summary stats, matching the reference's table rows (median/mean/...)."""
    pattern = os.path.join(run_dir, "results", "metrics", "*.json")
    files = sorted(glob.glob(pattern)) or sorted(
        glob.glob(os.path.join(run_dir, "*.json"))
    )
    out: Dict[str, Dict[str, float]] = {}
    for path in files:
        with open(path) as f:
            doc = json.load(f)
        for group, metrics in doc.items():
            flat = out.setdefault(group, {})
            for name, v in metrics.items():
                if isinstance(v, dict):
                    summary = v.get("summary", v)
                    if isinstance(summary, dict):
                        for stat in ("median", "mean", "min", "max", "count"):
                            if isinstance(summary.get(stat), (int, float)):
                                flat[f"{name}.{stat}"] = float(summary[stat])
                elif isinstance(v, (int, float)):
                    flat[name] = float(v)
    return out


def _pct_change(master: float, branch: float) -> Optional[float]:
    if master == 0:
        return None if branch == 0 else float("inf")
    return 100.0 * (branch - master) / abs(master)


def _cell_color(pct: Optional[float], lower_better: bool) -> str:
    """red -> pale yellow -> green over [-20%, +20%] of *goodness* change."""
    if pct is None or pct != pct or pct in (float("inf"), float("-inf")):
        return "#eeeeee"
    good = -pct if lower_better else pct
    x = max(-_CLIP_PCT, min(_CLIP_PCT, good)) / _CLIP_PCT  # [-1, 1]
    # -1 = red (223,1,1), 0 = pale yellow (245,246,206), +1 = green (49,180,4)
    if x < 0:
        t = 1 + x
        r, g, b = 223 + t * (245 - 223), 1 + t * (246 - 1), 1 + t * (206 - 1)
    else:
        t = x
        r, g, b = 245 + t * (49 - 245), 246 + t * (180 - 246), 206 + t * (4 - 206)
    return f"rgb({int(r)},{int(g)},{int(b)})"


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "—"
    if v == int(v) and abs(v) < 1e6:
        return str(int(v))
    return f"{v:.4g}"


def generate_comparison_html(
    master_runs: Dict[str, str], branch_runs: Dict[str, str]
) -> str:
    """master_runs/branch_runs: {benchmark_name: run_dir}. Returns HTML."""
    benchmarks = [b for b in master_runs if b in branch_runs]
    master = {b: load_run_metrics(master_runs[b]) for b in benchmarks}
    branch = {b: load_run_metrics(branch_runs[b]) for b in benchmarks}

    groups: Dict[str, list] = {}
    for b in benchmarks:
        for g in set(master[b]) | set(branch[b]):
            rows = groups.setdefault(g, [])
            for m in sorted(set(master[b].get(g, {})) | set(branch[b].get(g, {}))):
                if m not in rows:
                    rows.append(m)

    parts = [
        "<html><head><meta charset='utf-8'><title>gtsfm_tpu_torch benchmark comparison"
        "</title><style>",
        "body{font-family:sans-serif;margin:24px} table{border-collapse:collapse;"
        "margin-bottom:32px} th,td{border:1px solid #bbb;padding:4px 10px;"
        "font-size:13px;text-align:right} th{background:#f2f2f2} "
        "td.name{text-align:left} h2{margin-bottom:6px}",
        "</style></head><body><h1>Benchmark comparison (branch vs master)</h1>",
        "<p>Cell = % change; green = improvement (direction-aware: for error/"
        "runtime metrics a decrease is green). Color clipped to ±20%. Hover a "
        "cell for master/branch values.</p>",
    ]
    for g, rows in sorted(groups.items()):
        parts.append(f"<h2>{g}</h2><table><tr><th>metric</th>")
        parts += [f"<th>{b}</th>" for b in benchmarks]
        parts.append("</tr>")
        for m in sorted(rows):
            parts.append(f"<tr><td class='name'>{m}</td>")
            for b in benchmarks:
                mv = master[b].get(g, {}).get(m)
                bv = branch[b].get(g, {}).get(m)
                pct = None if (mv is None or bv is None) else _pct_change(mv, bv)
                color = _cell_color(pct, _lower_is_better(m))
                label = "—" if pct is None else f"{pct:+.1f}%"
                title = f"master: {_fmt(mv)} | branch: {_fmt(bv)}"
                parts.append(
                    f"<td style='background:{color}' title='{title}'>{label}</td>"
                )
            parts.append("</tr>")
        parts.append("</table>")
    parts.append("</body></html>")
    return "".join(parts)


def save_comparison_dashboard(
    master_runs: Dict[str, str], branch_runs: Dict[str, str], output_path: str
) -> str:
    html = generate_comparison_html(master_runs, branch_runs)
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w") as f:
        f.write(html)
    return output_path


def _parse_named(items) -> Dict[str, str]:
    out = {}
    for it in items:
        name, _, path = it.partition("=")
        if not path:
            raise SystemExit(f"expected name=path, got {it!r}")
        out[name] = path
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--master", nargs="+", required=True, metavar="NAME=DIR")
    ap.add_argument("--branch", nargs="+", required=True, metavar="NAME=DIR")
    ap.add_argument("--output", default="visual_comparison_dashboard.html")
    args = ap.parse_args(argv)
    path = save_comparison_dashboard(
        _parse_named(args.master), _parse_named(args.branch), args.output
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
