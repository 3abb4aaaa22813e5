"""PLY point-cloud IO.

Port of gtsfm_tpu/io/ply.py: binary little-endian float32 points with
optional uchar colors.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """points (N, 3); colors (N,) gray in [0, 1] or (N, 3) RGB in [0, 1]
    (values clipped to [0, 1] and scaled by 255, whatever their dtype)."""
    n = len(points)
    header = ("ply\nformat binary_little_endian 1.0\n" f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n")
    if colors is not None:
        header += "property uchar red\nproperty uchar green\nproperty uchar blue\n"
    header += "end_header\n"
    pts = np.asarray(points, "<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        if colors is None:
            f.write(pts.tobytes())
            return
        c = np.asarray(colors)
        if c.ndim == 1:
            c = np.stack([c] * 3, -1)
        rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = pts
        rec["rgb"] = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        f.write(rec.tobytes())


def read_ply(path: str) -> tuple:
    """-> (points (N, 3), colors (N, 3) float in [0, 1] or None)."""
    with open(path, "rb") as f:
        n = 0
        props = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property"):
                props.append(line.split()[2].decode())
            elif line == b"end_header":
                break
        if "red" in props:
            rec = np.frombuffer(f.read(n * 15), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            return rec["xyz"].copy(), rec["rgb"].astype(np.float32) / 255.0
        return np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3).copy(), None
