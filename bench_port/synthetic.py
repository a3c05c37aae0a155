"""The benchmark's traffic: a frozen numpy copy of the easy domain of the
port's synthetic scene source (`SyntheticSource(domain="easy")`), so that
the frames a cell sees cannot change with the program.

Cameras look straight down at a z=0 table from 1 m, each 8 cm from the
next; `num_objects` flat-shaded boxes glide on orbits whose phases and
speeds come from the seed. Even slots are Bottles (39), odd slots Cups
(41, wider and flatter). Frames are HD720-shaped: (C, H, W, 3) uint8 BGR
and (C, H, W) float32 depth in metres, NaN where a ray misses the table.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

BOTTLE, CUP = 39, 41


class EasyScene:
    def __init__(self, num_cameras: int, num_objects: int, seed: int,
                 hw: Tuple[int, int] = (720, 1280), cam_height_m: float = 1.0,
                 object_size_m: Tuple[float, float, float] = (0.06, 0.08, 0.12)):
        self.num_cameras = num_cameras
        self.num_objects = num_objects
        self.hw = hw
        self.obj_size = object_size_m
        h, w = hw
        f = 0.55 * w
        self.intrinsics = dict(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
        rng = np.random.default_rng(seed)
        self._phases = rng.uniform(0, 2 * math.pi, num_objects)
        self._speeds = rng.uniform(0.5, 1.0, num_objects)
        self.object_classes = np.array([(BOTTLE, CUP)[k % 2] for k in range(num_objects)],
                                       np.int64)
        self._rotation = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))
        self._translations = [(0.25 + (i - (num_cameras - 1) / 2) * 0.08, 0.6, cam_height_m)
                              for i in range(num_cameras)]

    def cameras(self) -> List[Dict]:
        """Each camera's calibration as plain values: name, serial,
        intrinsics (fx, fy, cx, cy, width, height), camera-to-robot
        rotation (row-major 3x3) and translation."""
        return [dict(name=f"cam{i + 1}", serial=1000 + i, intrinsics=dict(self.intrinsics),
                     rotation=self._rotation, translation=t)
                for i, t in enumerate(self._translations)]

    def _size(self, k: int) -> Tuple[float, float, float]:
        return self.obj_size if k % 2 == 0 else (0.09, 0.09, 0.055)

    def object_centers(self, index: int) -> np.ndarray:
        """(N, 3) object centres in the robot frame at frame `index`
        (30 frames a second)."""
        t = index / 30.0
        out = np.zeros((self.num_objects, 3), np.float32)
        for k in range(self.num_objects):
            ph = self._phases[k] + self._speeds[k] * t
            out[k] = [0.25 + 0.15 * math.cos(ph),
                      0.6 + 0.2 * math.sin(ph) + 0.25 * k / max(self.num_objects, 1),
                      self._size(k)[2] / 2]
        return out

    def _render_camera(self, ci: int, centers: np.ndarray):
        h, w = self.hw
        intr = self.intrinsics
        R = np.asarray(self._rotation, np.float32)
        t = np.asarray(self._translations[ci], np.float32)
        us = (np.arange(w, dtype=np.float32) - intr["cx"]) / intr["fx"]
        vs = (np.arange(h, dtype=np.float32) - intr["cy"]) / intr["fy"]
        du, dv = np.meshgrid(us, vs)
        d_cam = np.stack([du, dv, np.ones_like(du)], axis=-1)
        d_rob = d_cam @ R.T
        dz = d_rob[..., 2]
        s_table = np.where(dz < -1e-6, -t[2] / np.minimum(dz, -1e-6), np.inf)
        depth = s_table.astype(np.float32)
        rgb = np.full((h, w, 3), 90, np.uint8)
        for k, c in enumerate(centers):
            sx, sy, sz = self._size(k)
            s_top = np.where(dz < -1e-6, (sz - t[2]) / np.minimum(dz, -1e-6), np.inf)
            px = t[0] + s_top * d_rob[..., 0]
            py = t[1] + s_top * d_rob[..., 1]
            hit = (np.abs(px - c[0]) <= sx / 2) & (np.abs(py - c[1]) <= sy / 2) & (s_top < depth)
            depth = np.where(hit, s_top.astype(np.float32), depth)
            rgb[hit] = np.array([40 + 50 * k % 200, 160, 220], np.uint8)
        depth = np.where(np.isfinite(depth), depth, np.nan).astype(np.float32)
        return rgb, depth

    def render(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Frame `index` of every camera: (rgb (C, H, W, 3) uint8, depth
        (C, H, W) float32)."""
        centers = self.object_centers(index)
        parts = [self._render_camera(ci, centers) for ci in range(self.num_cameras)]
        return np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])

    def render_all(self, count: int, workers: int = 1):
        """Frames 0 .. count - 1, rendered by `workers` threads."""
        if workers <= 1:
            return [self.render(i) for i in range(count)]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(self.render, range(count)))


def cycle(count: int) -> int:
    """Frames in one ping-pong cycle over `count` rendered frames."""
    return max(2 * count - 2, 1)


def ping_pong(frame: int, count: int) -> int:
    """The rendered frame that global frame `frame` replays: 0, 1, ..,
    count - 1, count - 2, .., 1, 0, 1, .. so that motion stays continuous."""
    if count == 1:
        return 0
    p = frame % cycle(count)
    return p if p < count else 2 * count - 2 - p
