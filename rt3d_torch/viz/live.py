"""Live visualization spool (port of `rt3d/viz/live.py`): the decoupled
analog of the reference's in-loop `cv2.imshow` + Open3D windows
(`1cam/rt-tracking.py:157-301`, `vision_pipeline_utils.py:357-373`).

The reference renders INSIDE its hot loop (every `imshow`/`waitKey` and
Open3D `poll_events` steals frame time). Here the pipeline process only
*publishes* its latest outputs — an annotated frame, the fused cloud, a
status line — into a spool directory with atomic replaces, and a separate
viewer process (`rt3d_torch.apps.viewer`) tails that directory at its own
rate. The hot loop never blocks on display.

Spool contents (all atomically replaced):
  status.json       {"frame": i, "fps": f, "timestamp": t, "objects": n, ...}
  frame.png / .npy  annotated side-by-side camera frames (png if cv2)
  cloud.ply         fused objects + subtracted workspace, colored

The frame outputs may live on the card: `publish` reads them to the host
only on the frames it writes (1 in `every`), so skipped frames never
synchronize the device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from rt3d_torch.viz.cloud import load_ply, save_ply
from rt3d_torch.viz.draw import annotate_frame, optional_cv2, side_by_side


def _atomic_replace(path: str, write_fn) -> None:
    tmp = path + ".tmp"
    write_fn(tmp)
    os.replace(tmp, path)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class LiveSpool:
    """Publisher handed to `PipelineDriver.run(on_frame=spool.publish)`.

    ``every`` mirrors the reference's every-30th-frame scene refresh
    (`1cam/rt-tracking.py:189,267`); ``subsample`` its 5% cloud subsample
    (`:272`), drawn from ``np.random.default_rng(seed)`` as the JAX
    package draws it, so the same outputs give the same cloud bytes."""

    def __init__(self, directory: str, every: int = 5,
                 subsample: float = 1.0, seed: int = 0):
        self.dir = directory
        self.every = max(1, every)
        self.subsample = subsample
        self._rng = np.random.default_rng(seed)
        self._t_last: Optional[float] = None
        self._fps = 0.0
        os.makedirs(directory, exist_ok=True)

    def _tick_fps(self) -> None:
        now = time.perf_counter()
        if self._t_last is not None:
            dt = max(now - self._t_last, 1e-6)
            inst = 1.0 / dt
            self._fps = 0.9 * self._fps + 0.1 * inst if self._fps else inst
        self._t_last = now

    def _write_status(self, i: int, **extra) -> None:
        def write(p):
            with open(p, "w") as f:
                json.dump({"frame": int(i), "fps": round(float(self._fps), 2),
                           "timestamp": time.time(), **extra}, f)

        _atomic_replace(os.path.join(self.dir, "status.json"), write)

    def publish(self, i: int, out, rgb: Optional[np.ndarray] = None,
                rgb_fn=None) -> None:
        """Publish frame i. `out` is a `FrameOutputs` (on any device);
        `rgb` the (C, H, W, 3) source frames if the caller still has them.

        Skipped frames (``i % every != 0``) cost only the FPS bookkeeping —
        in particular they never touch `out` (no device->host read) and
        never call `rgb_fn`. Callers on the hot path should pass ``rgb_fn``
        (lazily fetches the frames) rather than ``rgb`` so the fetch is
        paid 1-in-`every` times.
        """
        self._tick_fps()
        if i % self.every:
            return
        if rgb is None and rgb_fn is not None:
            rgb = rgb_fn()

        if rgb is not None:
            d = out.detections
            boxes, scores, classes, valid = (_host(t) for t in (d.boxes, d.scores, d.classes,
                                                                 d.valid))
            ids = _host(out.track_ids)
            frames = [annotate_frame(rgb[c], boxes[c], scores[c], classes[c], valid[c],
                                     ids[c], fps=self._fps)
                      for c in range(rgb.shape[0])]
            if len(frames) == 2:
                panel = side_by_side(frames[0], frames[1])
            elif len(frames) == 1:
                panel = frames[0]
            else:
                panel = np.concatenate(frames, axis=1)
            self._write_image(panel)

        ws = _host(out.workspace.points)[_host(out.workspace.valid)]
        ob = _host(out.objects_flat.points)[_host(out.objects_flat.valid)]
        if self.subsample < 1.0 and len(ws):
            keep = self._rng.uniform(size=len(ws)) < self.subsample
            ws = ws[keep]
        pts = np.concatenate([ws, ob], axis=0) if len(ob) else ws
        colors = np.zeros((len(pts), 3), np.uint8)
        colors[: len(ws)] = (160, 160, 160)   # workspace: gray
        colors[len(ws):] = (255, 64, 32)      # objects: red
        if len(pts):
            # binary: the ASCII writer's per-point loop costs tens of ms on
            # the driver thread; the structured tofile is ~free
            _atomic_replace(os.path.join(self.dir, "cloud.ply"),
                            lambda p: save_ply(p, pts, colors, binary=True))
        else:
            # empty frame: drop the previous cloud so the viewer doesn't
            # render a stale one labeled with this frame number
            try:
                os.unlink(os.path.join(self.dir, "cloud.ply"))
            except FileNotFoundError:
                pass

        self._write_status(i, objects=int(_host(out.objects.present).sum()),
                           workspace_points=int(len(ws)))

    def publish_frame(self, i: int, panel: Optional[np.ndarray] = None,
                      panel_fn=None, **extra) -> None:
        """Frame-only publish for producers without cloud outputs
        (`rt3d_torch.apps.track_only`). Call EVERY frame (skipped frames pay
        only the FPS bookkeeping); pass ``panel_fn`` so the annotated frame
        is only built 1-in-`every` times."""
        self._tick_fps()
        if i % self.every:
            return
        if panel is None and panel_fn is not None:
            panel = panel_fn()
        if panel is not None:
            self._write_image(panel)
        self._write_status(i, **extra)

    def _write_image(self, panel: np.ndarray) -> None:
        """`frame.png` through cv2; where cv2 is missing or cannot write,
        `frame.npy` (`np.save`) instead."""
        cv2 = optional_cv2()
        # cv2 keys the format off the extension: the temporary name ends in .png
        tmp = os.path.join(self.dir, "frame.tmp.png")
        if cv2 is not None and cv2.imwrite(tmp, panel, [cv2.IMWRITE_PNG_COMPRESSION, 1]):
            os.replace(tmp, os.path.join(self.dir, "frame.png"))
            return
        # don't leave a partially written tmp behind in the spool
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass

        def w_npy(p):
            with open(p, "wb") as f:  # np.save would append .npy
                np.save(f, panel)

        _atomic_replace(os.path.join(self.dir, "frame.npy"), w_npy)


# ---------------------------------------------------------------------------
# Viewer side
# ---------------------------------------------------------------------------


def read_status(directory: str) -> Optional[dict]:
    """The spool's status, or None while it is missing or half written."""
    try:
        with open(os.path.join(directory, "status.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_cloud(directory: str):
    """Parse the spooled PLY back into (points (N,3) f32, colors (N,3) u8)."""
    path = os.path.join(directory, "cloud.ply")
    if not os.path.exists(path):
        return None, None
    return load_ply(path)


class ViewerState:
    """One poll step of the viewer, separated from the CLI loop so the
    headless path is testable."""

    def __init__(self, directory: str, out_dir: Optional[str] = None):
        self.dir = directory
        self.out_dir = out_dir or directory
        os.makedirs(self.out_dir, exist_ok=True)
        self.last_frame = -1
        self.azim = -50.0

    def tick(self) -> Optional[dict]:
        """Returns the new status dict when a fresh frame was rendered,
        None when nothing changed."""
        status = read_status(self.dir)
        if not status or status.get("frame", -1) == self.last_frame:
            return None
        self.last_frame = status["frame"]
        pts, cols = load_cloud(self.dir)
        if pts is not None and len(pts):
            from rt3d_torch.viz.render import render_scene

            gray = pts if cols is None else pts[cols[:, 0] < 200]
            red = np.zeros((0, 3)) if cols is None else pts[cols[:, 0] >= 200]
            self.azim = (self.azim + 6.0) % 360.0  # rotating view
            render_scene(
                [(gray, "0.55", "workspace"), (red, "tab:red", "objects")],
                os.path.join(self.out_dir, "viewer_scene.png"),
                title=f"frame {status['frame']} @ {status.get('fps', 0)} FPS",
                azim=self.azim,
            )
        return status
