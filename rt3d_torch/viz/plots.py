"""Offline analysis plots over the CSV logs (port of `rt3d/viz/plots.py`).

Functional equivalents of the reference's `2cam/visualizer_fps.py`
(smoothed FPS curve, 30 s window, Savitzky-Golay window 15 / order 2, avg
line + max annotation) and `2cam/visualizer_performance.py` (per-stage mean
ms bar chart with value labels). Reads the CSV schemas the reference, the
JAX package and the port all write (`rt3d_torch.runtime.timing`). Without
matplotlib the plots write nothing and return None.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np

from rt3d_torch.viz.render import pyplot


def _read_fps_log(path: str):
    ts, fps = [], []
    with open(path) as f:
        r = csv.reader(f)
        next(r, None)  # header
        for row in r:
            if len(row) >= 2:
                ts.append(float(row[0]))
                fps.append(float(row[1]))
    return np.asarray(ts), np.asarray(fps)


def read_timings(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        r = csv.reader(f)
        next(r, None)
        for row in r:
            if len(row) >= 2 and row[1]:
                out[row[0]] = np.asarray([float(v) for v in row[1].split(",")])
    return out


def _smooth(fps: np.ndarray, window: int, order: int) -> np.ndarray:
    """Savitzky-Golay smoothing where scipy is installed, else a 5-frame
    moving average, as in the JAX package; short logs stay as they are."""
    if len(fps) <= window:
        return fps
    try:
        from scipy.signal import savgol_filter
    except ImportError:
        return np.convolve(fps, np.ones(5) / 5, mode="same")
    return savgol_filter(fps, window, order)


def plot_fps(
    fps_log_path: str, out_path: str, window_s: float = 30.0,
    smooth_window: int = 15, smooth_order: int = 2,
) -> Optional[str]:
    plt = pyplot()
    if plt is None:
        return None
    ts, fps = _read_fps_log(fps_log_path)
    if len(fps) == 0:
        return None
    t = ts - ts[0]
    sel = t <= window_s
    t, fps = t[sel], fps[sel]
    smoothed = _smooth(fps, smooth_window, smooth_order)
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(t, smoothed, label="FPS (smoothed)", lw=2)
    avg = float(np.mean(fps))
    ax.axhline(avg, ls="--", c="tab:orange", label=f"avg {avg:.2f}")
    imax = int(np.argmax(smoothed))
    ax.annotate(f"max {smoothed[imax]:.2f}", (t[imax], smoothed[imax]),
                textcoords="offset points", xytext=(5, 5))
    ax.set_xlabel("time (s)")
    ax.set_ylabel("FPS")
    ax.set_title("End-to-end FPS over time")
    ax.legend()
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_stage_timings(timings_path: str, out_path: str) -> Optional[str]:
    plt = pyplot()
    if plt is None:
        return None
    data = read_timings(timings_path)
    if not data:
        return None
    names, means = [], []
    for k, v in data.items():
        names.append(k)
        means.append(1000.0 * float(np.mean(v[1:] if len(v) > 1 else v)))
    fig, ax = plt.subplots(figsize=(11, 5))
    bars = ax.bar(range(len(names)), means, color="tab:blue")
    for b, m in zip(bars, means):
        ax.text(b.get_x() + b.get_width() / 2, m, f"{m:.1f}", ha="center",
                va="bottom", fontsize=8)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=20, ha="right", fontsize=8)
    ax.set_ylabel("mean ms / frame")
    ax.set_title("Average timing per pipeline stage")
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path
