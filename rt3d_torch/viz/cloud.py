"""Point-cloud scene export (external-viewer analog of the reference's
in-process Open3D windows, `1cam/rt-tracking.py:157-285`): the numpy-only
`save_ply` and `load_ply` of `rt3d/viz/cloud.py`, copied, so the files are
the JAX package's byte for byte."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None,
             binary: bool = False) -> str:
    """Write a PLY any viewer (Open3D, MeshLab, CloudCompare) opens.

    ``binary=True`` writes binary_little_endian via one structured-array
    ``tofile`` — used by the live spool, where the ASCII per-point loop
    would block the pipeline's dispatch thread for tens of ms."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    has_c = colors is not None
    fmt = "binary_little_endian" if binary else "ascii"
    header = [f"ply\nformat {fmt} 1.0\n", f"element vertex {n}\n",
              "property float x\nproperty float y\nproperty float z\n"]
    if has_c:
        header.append(
            "property uchar red\nproperty uchar green\nproperty uchar blue\n")
    header.append("end_header\n")
    if binary:
        dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if has_c:
            dt += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        rec = np.empty(n, np.dtype(dt))
        rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        if has_c:
            c = np.asarray(colors, np.uint8)
            rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
        with open(path, "wb") as f:
            f.write("".join(header).encode())
            rec.tofile(f)
    else:
        with open(path, "w") as f:
            f.write("".join(header))
            for i in range(n):
                row = f"{pts[i,0]} {pts[i,1]} {pts[i,2]}"
                if has_c:
                    c = colors[i]
                    row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
                f.write(row + "\n")
    return path


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Parse a PLY written by `save_ply` (ascii or binary) back into
    (points (N,3) f32, colors (N,3) u8 or None)."""
    with open(path, "rb") as f:
        n = 0
        has_color = False
        binary = False
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("format binary"):
                binary = True
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line == "property uchar red":
                has_color = True
            elif line == "end_header":
                break
            elif not line:
                return np.zeros((0, 3), np.float32), None
        if binary:
            dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if has_color:
                dt += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.fromfile(f, np.dtype(dt), count=n)
            pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1)
            cols = (np.stack([rec["red"], rec["green"], rec["blue"]], -1)
                    if has_color else None)
            return pts, cols
        rows = np.loadtxt(f, max_rows=n, ndmin=2) if n else np.zeros((0, 6))
    pts = rows[:, :3].astype(np.float32)
    cols = rows[:, 3:6].astype(np.uint8) if has_color and rows.shape[1] >= 6 \
        else None
    return pts, cols
