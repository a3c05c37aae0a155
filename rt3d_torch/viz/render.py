"""Headless 3D scene rendering (matplotlib; port of `rt3d/viz/render.py`),
the no-GUI analog of the reference's interactive Open3D window
(`1cam/rt-tracking.py:157-285`).

Renders point buffers as a 3D scatter with robot-frame axes; pairs with the
PLY export (`rt3d_torch.viz.cloud`) for external viewers. Without
matplotlib (the card's machine has none) it renders nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def render_scene(
    clouds: Sequence[Tuple[np.ndarray, str, str]],
    out_path: str,
    title: str = "rt3d scene (robot frame)",
    elev: float = 28.0,
    azim: float = -50.0,
    point_size: float = 0.6,
) -> Optional[str]:
    """clouds: list of (points (N,3), color, label). Returns the path or
    None if matplotlib is unavailable."""
    plt = pyplot()
    if plt is None:
        return None
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    for pts, color, label in clouds:
        if len(pts) == 0:
            continue
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size, c=color,
                   label=f"{label} ({len(pts)} pts)", depthshade=False)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(title)
    ax.legend(loc="upper left", markerscale=8)
    ax.set_box_aspect((1, 1, 0.5))
    fig.savefig(out_path, dpi=160, bbox_inches="tight")
    plt.close(fig)
    return out_path


def pyplot():
    """`matplotlib.pyplot` on the Agg backend, or None where matplotlib is
    not installed (imported at first use)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt
