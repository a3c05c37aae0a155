"""Synthetic analytic scene source: a tabletop with moving objects.

Numpy-only copy of `rt3d/io/synthetic.py` for the PyTorch port (same
scenes, bit for bit, from the same seed).

Serves two roles the reference fills with live hardware:
  * benchmark input with the exact tensor shapes/dtypes of ZED HD720
    capture (RGB u8 + f32 depth) when no recorded sequence is available;
  * golden-test input, since ground-truth instance masks and object
    geometry are known analytically (`gt_masks`).

Two scene families (the `domain` knob):

* ``"easy"`` — the original family: two cameras look straight down at a
  z=0 table; `num_objects` flat-shaded boxes glide across it. Odd object
  slots ('Cup') render as wider/flatter boxes (`_easy_size`), so the
  class<->shape correlation matches the hard family instead of
  contradicting it.

* ``"hard"`` — the domain-randomized family that approximates the
  reference's real operating conditions (real bottles/cups on a real
  table, clutter, occlusion).  Per-scene
  (seed-driven) randomization of:
    - camera pose: oblique tilt (not top-down), so objects OCCLUDE each
      other when their paths cross in view;
    - class-correlated SHAPE semantics: Bottle(39) = tall cylinder,
      Cup(41) = short wide cylinder — color is random per object, so
      shape/scale is the discriminative cue (the easy family's
      color-coded boxes let a detector shortcut on hue);
    - per-object scale/aspect jitter within the class ranges;
    - distractor objects of NON-target classes (book 73 = flat box,
      mouse 64 = small rounded box) that the model must learn to label
      correctly and the pipeline's `class_filter` must drop;
    - world-space table texture (value-noise lattice + colored decal
      patches, consistent across cameras) and directional Lambertian
      lighting with a per-scene light direction and gain;
    - per-frame Gaussian RGB sensor noise.
  Rendering is a vectorized ray-caster with a z-buffer; `gt_masks`
  returns VISIBLE (occlusion-aware) instance masks, which is also what
  a segmentation model is supervised on.  Depth is analytic-exact by
  default; the opt-in ``depth_noise`` knob (`DepthNoise`) corrupts the
  SERVED depth maps with a ZED-NEURAL-like artifact model — range-
  dependent Gaussian sigma, isolated speckle outliers, random dropout,
  and edge 'flying pixels' at discontinuities — while every ground-truth
  accessor stays exact, so goldens can measure what the SOR stages
  actually buy (`2cam/2cams.py:72-76` NEURAL depth;
  `vision_pipeline_utils.py:48-58` the SOR that cleans it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from rt3d_torch.config import CameraConfig, Extrinsics, Intrinsics
from rt3d_torch.io.source import FramePacket

# non-target classes rendered as clutter in the hard domain; neither is in
# any preset `class_filter` (2cam 39/41; cpu 39/41/42/43/45; 1cam
# 39/41/42/43/44/45/46 — config.py), so the pipeline must drop them.
DISTRACTOR_CLASSES = (73, 64)  # book, mouse


@dataclass
class DepthNoise:
    """ZED-NEURAL-like depth corruption (opt-in; served frames only —
    ground-truth accessors stay analytic-exact).

    The artifact classes mirror what stereo NEURAL depth actually emits
    and what the reference's SOR stages exist to remove
    (`vision_pipeline_utils.py:48-58`):

    - ``sigma_coeff``: Gaussian sigma = coeff * z^2 meters — stereo
      disparity error grows quadratically with range (~0.4% of z at 1 m
      with the default).
    - ``speckle_frac`` / ``speckle_m``: isolated pixels offset by up to
      +-speckle_m along the ray — the floating speckle SOR removes.
    - ``dropout_frac``: random invalid (0) pixels, rejected by the
      pipeline's ``depth_min_m`` gate like the SDK's NaN holes.
    - ``edge_flare`` / ``edge_jump_m``: at depth discontinuities larger
      than ``edge_jump_m``, pixels become 'flying pixels' interpolated
      between foreground and background — the classic stereo edge
      artifact that puts points in free space behind object rims.
    """

    sigma_coeff: float = 0.004
    speckle_frac: float = 0.002
    speckle_m: float = 0.25
    dropout_frac: float = 0.01
    edge_flare: float = 0.5
    edge_jump_m: float = 0.1


@dataclass
class SceneObject:
    """One rigid body: a vertical box or cylinder standing on the table."""

    kind: str                # 'box' | 'cyl'
    cls: int                 # COCO class id
    size: Tuple[float, float, float]  # box: (sx, sy, sz); cyl: (r, r, h)
    color: np.ndarray        # (3,) uint8 base color (BGR, as captured)
    x0: float                # orbit centre
    y0: float
    rx: float                # orbit radii (0 => static)
    ry: float
    phase: float
    speed: float
    is_target: bool

    def center(self, t: float) -> np.ndarray:
        ph = self.phase + self.speed * t
        return np.array(
            [self.x0 + self.rx * math.cos(ph),
             self.y0 + self.ry * math.sin(ph),
             self.size[2] / 2], np.float32)


def _look_at_extrinsics(pos: np.ndarray, target: np.ndarray) -> Extrinsics:
    """Camera->robot rotation whose +z looks at `target`, +y is image-down.

    Columns of R are the camera axes in the robot frame; at zero tilt this
    reproduces the easy domain's ((1,0,0),(0,-1,0),(0,0,-1))."""
    f = target - pos
    f = f / np.linalg.norm(f)
    x = np.cross(f, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(x) < 1e-6:  # straight down: keep the easy convention
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(f, x)
    r = np.stack([x, y, f], axis=1)
    return Extrinsics(rotation=tuple(map(tuple, r.astype(float))),
                      translation=tuple(map(float, pos)))


def _bilinear_lattice(values: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Sample a (G, G) random lattice at fractional coords u, v (tiled)."""
    g = values.shape[0]
    u = np.mod(u, g)
    v = np.mod(v, g)
    u0 = np.floor(u).astype(np.int64) % g
    v0 = np.floor(v).astype(np.int64) % g
    fu, fv = u - np.floor(u), v - np.floor(v)
    u1, v1 = (u0 + 1) % g, (v0 + 1) % g
    a = values[v0, u0] * (1 - fu) + values[v0, u1] * fu
    b = values[v1, u0] * (1 - fu) + values[v1, u1] * fu
    return a * (1 - fv) + b * fv


class SyntheticSource:
    def __init__(
        self,
        num_cameras: int = 2,
        num_frames: Optional[int] = 300,
        hw: Tuple[int, int] = (720, 1280),
        num_objects: int = 1,
        cam_height_m: float = 1.0,
        object_size_m: Tuple[float, float, float] = (0.06, 0.08, 0.12),
        seed: int = 0,
        domain: str = "easy",
        num_distractors: Optional[int] = None,
        rgb_noise: Optional[float] = None,
        tilt_deg: Optional[float] = None,
        depth_noise: "Optional[DepthNoise | bool]" = None,
    ):
        self._n_cams = num_cameras
        self._n_frames = num_frames
        self._hw = hw
        self.num_objects = num_objects
        self.cam_height = cam_height_m
        self.obj_size = object_size_m
        self.domain = domain
        self.seed = seed
        h, w = hw
        f = 0.55 * w  # ~ZED HD720 focal in pixels at this width
        self._intr = Intrinsics(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
        rng = np.random.default_rng(seed)
        self._phases = rng.uniform(0, 2 * math.pi, num_objects)
        self._speeds = rng.uniform(0.5, 1.0, num_objects)
        self._memo: Tuple[int, tuple] | None = None
        self.depth_noise = (DepthNoise() if depth_noise is True
                            else (depth_noise or None))

        if domain == "easy":
            self.rgb_noise = float(rgb_noise or 0.0)
            self.object_classes = np.array(
                [(39, 41)[k % 2] for k in range(num_objects)], np.int64)
            self.distractor_classes = np.zeros((0,), np.int64)
            # camera i sits above the table, slightly offset, looking
            # straight down (cam axes -> robot: x->x, y->-y, z->-z)
            self._cams = []
            for i in range(num_cameras):
                off = (i - (num_cameras - 1) / 2) * 0.08
                ext = Extrinsics(
                    rotation=((1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
                              (0.0, 0.0, -1.0)),
                    translation=(0.25 + off, 0.6, cam_height_m),
                )
                self._cams.append(
                    CameraConfig(name=f"cam{i+1}", intrinsics=self._intr,
                                 extrinsics=ext, serial=1000 + i))
            return
        if domain != "hard":
            raise ValueError(f"unknown domain {domain!r}")

        # ---- hard domain: per-scene randomization -----------------------
        self.rgb_noise = (float(rgb_noise) if rgb_noise is not None
                          else float(rng.uniform(0.005, 0.02)))

        def object_color() -> np.ndarray:
            # random but FAIR: real bottles/cups are rarely the exact
            # shade of the table they stand on. Resample until the color
            # is either clearly saturated (channel spread) or clearly
            # off the table's ~95-gray luminance — a camouflage-gray
            # object under dim light is an unfair ask at any model size
            # (a 95-gray cup on the textured table).
            while True:
                c = rng.integers(30, 226, 3).astype(np.float32)
                if (c.max() - c.min()) >= 45 or abs(c.mean() - 95.0) >= 55:
                    return c.astype(np.uint8)
        look = np.array([0.25, 0.6, 0.0])
        tilt = (float(tilt_deg) if tilt_deg is not None
                else float(rng.uniform(22.0, 40.0)))
        height = cam_height_m * float(rng.uniform(0.85, 1.15))
        self._cams = []
        for i in range(num_cameras):
            off = (i - (num_cameras - 1) / 2) * float(rng.uniform(0.10, 0.22))
            cam_tilt = math.radians(tilt + float(rng.uniform(-3.0, 3.0)))
            dist = height / math.cos(cam_tilt)
            pos = look + np.array(
                [off, -dist * math.sin(cam_tilt), height])
            self._cams.append(
                CameraConfig(name=f"cam{i+1}", intrinsics=self._intr,
                             extrinsics=_look_at_extrinsics(pos, look),
                             serial=1000 + i))

        # targets: Bottle(39)=tall cylinder, Cup(41)=short wide cylinder
        cls_order = np.array([(39, 41)[k % 2] for k in range(num_objects)])
        rng.shuffle(cls_order)
        self.object_classes = cls_order.astype(np.int64)
        self._objects: List[SceneObject] = []
        for k in range(num_objects):
            cls = int(cls_order[k])
            if cls == 39:
                r = float(rng.uniform(0.028, 0.042))
                hgt = float(rng.uniform(0.17, 0.28))
            else:
                r = float(rng.uniform(0.038, 0.058))
                hgt = float(rng.uniform(0.07, 0.12))
            self._objects.append(SceneObject(
                kind="cyl", cls=cls, size=(r, r, hgt),
                color=object_color(),
                # orbit centres spread across the tabletop (±5 cm packed
                # every target into one permanently-overlapping pile under
                # tilt — unfairly beyond the reference's operating scene)
                x0=0.25 + float(rng.uniform(-0.15, 0.15)),
                y0=0.6 + float(rng.uniform(-0.14, 0.14)),
                rx=float(rng.uniform(0.05, 0.16)),
                ry=float(rng.uniform(0.05, 0.17)),
                phase=float(self._phases[k]), speed=float(self._speeds[k]),
                is_target=True))
        nd = (int(num_distractors) if num_distractors is not None
              else int(rng.integers(1, 4)))
        self.distractor_classes = np.array(
            [DISTRACTOR_CLASSES[j % 2] for j in range(nd)], np.int64)
        for j in range(nd):
            cls = int(self.distractor_classes[j])
            if cls == 73:   # book: flat wide box
                size = (float(rng.uniform(0.12, 0.22)),
                        float(rng.uniform(0.09, 0.16)),
                        float(rng.uniform(0.015, 0.04)))
            else:           # mouse: small low box
                size = (float(rng.uniform(0.05, 0.08)),
                        float(rng.uniform(0.03, 0.05)),
                        float(rng.uniform(0.025, 0.04)))
            moving = bool(rng.uniform() < 0.4)
            self._objects.append(SceneObject(
                kind="box", cls=cls, size=size,
                color=object_color(),
                x0=0.25 + float(rng.uniform(-0.16, 0.16)),
                y0=0.6 + float(rng.uniform(-0.18, 0.18)),
                rx=float(rng.uniform(0.04, 0.10)) if moving else 0.0,
                ry=float(rng.uniform(0.04, 0.10)) if moving else 0.0,
                phase=float(rng.uniform(0, 2 * math.pi)),
                speed=float(rng.uniform(0.3, 0.8)) if moving else 0.0,
                is_target=False))

        # lighting + table appearance (world-space => camera-consistent)
        az = float(rng.uniform(0, 2 * math.pi))
        el = math.radians(float(rng.uniform(35.0, 70.0)))
        self._light = np.array(
            [math.cos(az) * math.cos(el), math.sin(az) * math.cos(el),
             math.sin(el)], np.float32)
        self._ambient = float(rng.uniform(0.35, 0.55))
        self._gain = float(rng.uniform(0.85, 1.15))
        self._tex_coarse = rng.uniform(-1.0, 1.0, (8, 8)).astype(np.float32)
        self._tex_fine = rng.uniform(-1.0, 1.0, (32, 32)).astype(np.float32)
        self._tex_tint = rng.uniform(-1.0, 1.0, (8, 8, 3)).astype(np.float32)
        self._tex_amp = float(rng.uniform(10.0, 35.0))
        decals = []
        for _ in range(int(rng.integers(2, 6))):
            cx = 0.25 + float(rng.uniform(-0.35, 0.35))
            cy = 0.6 + float(rng.uniform(-0.35, 0.35))
            decals.append((
                cx, cy, float(rng.uniform(0.04, 0.18)),
                float(rng.uniform(0.04, 0.18)),
                rng.integers(30, 226, 3).astype(np.float32)))
        self._decals = decals
        self._ray_cache: dict = {}

    # -- FrameSource ------------------------------------------------------

    @property
    def num_cameras(self) -> int:
        return self._n_cams

    @property
    def num_frames(self) -> Optional[int]:
        return self._n_frames

    @property
    def frame_hw(self) -> Tuple[int, int]:
        return self._hw

    def cameras(self) -> List[CameraConfig]:
        return list(self._cams)

    def close(self) -> None:
        pass

    # -- scene model ------------------------------------------------------

    def set_objects(self, objects: List["SceneObject"]) -> None:
        """Replace the scene's objects with an explicit script (hard domain
        only). The tracking/occlusion goldens use this to stage exact
        events — e.g. a target orbiting behind a static occluder for a
        known number of frames — while keeping the analytic ground truth
        (`gt_masks`, `visible_fraction`) exact."""
        if self.domain != "hard":
            raise ValueError("set_objects requires domain='hard'")
        flags = [o.is_target for o in objects]
        if flags != sorted(flags, reverse=True):
            raise ValueError("targets must precede distractors "
                             "(gt_masks slices the leading rows)")
        self._objects = list(objects)
        self.num_objects = sum(1 for o in objects if o.is_target)
        self.object_classes = np.array(
            [o.cls for o in objects if o.is_target], np.int64)
        self.distractor_classes = np.array(
            [o.cls for o in objects if not o.is_target], np.int64)
        self._memo = None

    @property
    def all_classes(self) -> np.ndarray:
        """(N_targets + N_distractors,) classes, targets first."""
        return np.concatenate([self.object_classes, self.distractor_classes])

    def _easy_size(self, k: int) -> Tuple[float, float, float]:
        """Easy-domain per-object box size. Even slots ('Bottle') keep the
        original `object_size_m`; odd slots ('Cup') are a wider, flatter
        box, so the class<->shape correlation is CONSISTENT with the hard
        family (a detector trained on both domains learns one class
        rule)."""
        if k % 2 == 0:
            return self.obj_size
        return (0.09, 0.09, 0.055)

    def object_centers(self, index: int) -> np.ndarray:
        """(N, 3) TARGET object centres in the robot frame at a frame."""
        t = index / 30.0
        if self.domain == "easy":
            out = np.zeros((self.num_objects, 3), np.float32)
            for k in range(self.num_objects):
                ph = self._phases[k] + self._speeds[k] * t
                out[k] = [
                    0.25 + 0.15 * math.cos(ph),
                    0.6 + 0.2 * math.sin(ph) + 0.25 * k / max(self.num_objects, 1),
                    self._easy_size(k)[2] / 2,
                ]
            return out
        return np.stack([o.center(t) for o in self._objects if o.is_target])

    # ---- easy renderer --------------------------------------------------

    def _render_camera(self, cam: CameraConfig, centers: np.ndarray):
        h, w = self._hw
        intr = cam.intrinsics
        R, t = cam.extrinsics.R, cam.extrinsics.t
        # camera looks along +z(cam) = -z(robot); table plane z_robot=0 is at
        # depth = cam height. Ray through pixel (u, v): direction d_cam =
        # ((u-cx)/fx, (v-cy)/fy, 1); in robot frame dz = (R @ d_cam)[2].
        us = (np.arange(w, dtype=np.float32) - intr.cx) / intr.fx
        vs = (np.arange(h, dtype=np.float32) - intr.cy) / intr.fy
        du, dv = np.meshgrid(us, vs)
        d_cam = np.stack([du, dv, np.ones_like(du)], axis=-1)  # (H, W, 3)
        d_rob = d_cam @ R.T
        # table: t_z + s * dz = 0 -> s = -t_z / dz ; depth(z_cam) = s (unit
        # z-component in cam frame) since d_cam z == 1.
        dz = d_rob[..., 2]
        s_table = np.where(dz < -1e-6, -t[2] / np.minimum(dz, -1e-6), np.inf)
        depth = s_table.astype(np.float32)
        rgb = np.full((h, w, 3), 90, np.uint8)  # grey table

        masks = np.zeros((len(centers), h, w), bool)
        for k, c in enumerate(centers):
            sx, sy, sz = self._easy_size(k)
            # top face of the box at z = sz: s = (sz - t_z)/dz
            s_top = np.where(dz < -1e-6, (sz - t[2]) / np.minimum(dz, -1e-6), np.inf)
            px = t[0] + s_top * d_rob[..., 0]
            py = t[1] + s_top * d_rob[..., 1]
            hit = (
                (np.abs(px - c[0]) <= sx / 2)
                & (np.abs(py - c[1]) <= sy / 2)
                & (s_top < depth)
            )
            depth = np.where(hit, s_top.astype(np.float32), depth)
            masks[k] = hit
            color = np.array([40 + 50 * k % 200, 160, 220], np.uint8)
            rgb[hit] = color
        depth = np.where(np.isfinite(depth), depth, np.nan).astype(np.float32)
        return rgb, depth, masks

    # ---- hard renderer: ray-cast with a z-buffer ------------------------

    def _rays(self, ci: int):
        """Cached (d_rob (H,W,3), origin (3,)) for camera `ci`."""
        if ci not in self._ray_cache:
            h, w = self._hw
            cam = self._cams[ci]
            intr = cam.intrinsics
            us = (np.arange(w, dtype=np.float32) - intr.cx) / intr.fx
            vs = (np.arange(h, dtype=np.float32) - intr.cy) / intr.fy
            du, dv = np.meshgrid(us, vs)
            d_cam = np.stack([du, dv, np.ones_like(du)], axis=-1)
            self._ray_cache[ci] = (
                (d_cam @ np.asarray(cam.extrinsics.R).T).astype(np.float32),
                np.asarray(cam.extrinsics.t, np.float32))
        return self._ray_cache[ci]

    @staticmethod
    def _intersect_box(o, d, c, size):
        """AABB x [c +- (sx,sy)/2] x z in [0, sz]: entry dist + normal."""
        sx, sy, sz = size
        lo = np.array([c[0] - sx / 2, c[1] - sy / 2, 0.0], np.float32)
        hi = np.array([c[0] + sx / 2, c[1] + sy / 2, sz], np.float32)
        safe = np.where(np.abs(d) < 1e-9, 1e-9, d)
        t1 = (lo - o) / safe
        t2 = (hi - o) / safe
        tlo, thi = np.minimum(t1, t2), np.maximum(t1, t2)
        axis = np.argmax(tlo, axis=-1)
        tmin = np.max(tlo, axis=-1)
        tmax = np.min(thi, axis=-1)
        hit = (tmax >= tmin) & (tmin > 0.05)
        s = np.where(hit, tmin, np.inf).astype(np.float32)
        # entry-face normal: -sign(d) on the entry axis
        n = np.zeros(d.shape, np.float32)
        sgn = -np.sign(np.take_along_axis(d, axis[..., None], -1))[..., 0]
        np.put_along_axis(n, axis[..., None], sgn[..., None], -1)
        return s, n

    @staticmethod
    def _intersect_cyl(o, d, c, size):
        """Vertical cylinder: centre (cx, cy), radius r, z in [0, h]."""
        r, _, hgt = size
        ox, oy, oz = o[0] - c[0], o[1] - c[1], o[2]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        a = dx * dx + dy * dy
        b = 2.0 * (ox * dx + oy * dy)
        cc = ox * ox + oy * oy - r * r
        disc = b * b - 4 * a * cc
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        s_side = np.where(ok, (-b - sq) / np.maximum(2 * a, 1e-12), np.inf)
        z_side = oz + s_side * dz
        side_ok = ok & (s_side > 0.05) & (z_side >= 0.0) & (z_side <= hgt)
        s_side = np.where(side_ok, s_side, np.inf)
        # top cap disk at z = hgt
        dz_safe = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        s_cap = (hgt - oz) / dz_safe
        px = ox + s_cap * dx
        py = oy + s_cap * dy
        cap_ok = (s_cap > 0.05) & (px * px + py * py <= r * r)
        s_cap = np.where(cap_ok, s_cap, np.inf)
        s = np.minimum(s_side, s_cap).astype(np.float32)
        use_cap = s_cap <= s_side
        sf = np.where(np.isfinite(s), s, 0.0)  # normals only used at hits
        nx = np.where(use_cap, 0.0, (ox + sf * dx) / r)
        ny = np.where(use_cap, 0.0, (oy + sf * dy) / r)
        nz = np.where(use_cap, 1.0, 0.0)
        return s, np.stack([nx, ny, nz], axis=-1).astype(np.float32)

    def _table_rgb(self, px, py):
        """World-space procedural table color (H, W, 3) float."""
        lum = (self._tex_amp
               * (_bilinear_lattice(self._tex_coarse, px / 0.12, py / 0.12)
                  + 0.5 * _bilinear_lattice(self._tex_fine, px / 0.035,
                                            py / 0.035)))
        base = np.full(px.shape + (3,), 95.0, np.float32)
        for ch in range(3):
            base[..., ch] += lum + 12.0 * _bilinear_lattice(
                self._tex_tint[..., ch], px / 0.3, py / 0.3)
        for (cx, cy, hx, hy, col) in self._decals:
            # soft elliptical blend: reads as a stain/texture patch, NOT an
            # object — solid rectangles were visually identical to the
            # flat 'book' distractors and taught the detector that crisp
            # color patches on the table are things (ghost detections,
            # mostly on decals)
            r2 = ((px - cx) / hx) ** 2 + ((py - cy) / hy) ** 2
            alpha = 0.45 * np.clip(1.3 - r2, 0.0, 1.0)[..., None]
            base = base * (1.0 - alpha) + col[None, None, :] * alpha
        return base

    def _shade(self, normal):
        lam = np.maximum((normal * self._light).sum(-1), 0.0)
        return self._ambient + (1.0 - self._ambient) * lam

    def _render_camera_hard(self, ci: int, t_sec: float):
        h, w = self._hw
        d_rob, origin = self._rays(ci)
        dz = d_rob[..., 2]
        s_table = np.where(dz < -1e-6, -origin[2] / np.minimum(dz, -1e-6),
                           np.inf).astype(np.float32)
        depth = s_table.copy()
        owner = np.full((h, w), -1, np.int32)
        shade = np.full((h, w), self._shade(np.array([0.0, 0.0, 1.0])),
                        np.float32)
        amodal = np.zeros((len(self._objects), h, w), bool)
        for k, obj in enumerate(self._objects):
            c = obj.center(t_sec)
            if obj.kind == "box":
                s, n = self._intersect_box(origin, d_rob, c, obj.size)
            else:
                s, n = self._intersect_cyl(origin, d_rob, c, obj.size)
            amodal[k] = s < s_table  # visible were the others absent
            closer = s < depth
            depth = np.where(closer, s, depth)
            owner = np.where(closer, k, owner)
            shade = np.where(closer, self._shade(n).astype(np.float32), shade)
        px = origin[0] + s_table * d_rob[..., 0]
        py = origin[1] + s_table * d_rob[..., 1]
        rgb = self._table_rgb(np.where(np.isfinite(s_table), px, 0.0),
                              np.where(np.isfinite(s_table), py, 0.0))
        colors = np.stack([o.color for o in self._objects]).astype(np.float32)
        obj_rgb = colors[np.clip(owner, 0, None)]
        rgb = np.where((owner >= 0)[..., None], obj_rgb, rgb)
        rgb = np.clip(rgb * (shade * self._gain)[..., None], 0, 255)
        masks = np.stack([owner == k for k in range(len(self._objects))]) \
            if self._objects else np.zeros((0, h, w), bool)
        depth = np.where(np.isfinite(depth), depth, np.nan).astype(np.float32)
        return rgb.astype(np.uint8), depth, masks, amodal

    def _render_all(self, index: int):
        if self._memo is not None and self._memo[0] == index:
            return self._memo[1]
        t_sec = index / 30.0
        rgbs, depths, masks, amodals = [], [], [], []
        if self.domain == "easy":
            centers = self.object_centers(index)
            for cam in self._cams:
                r, d, m = self._render_camera(cam, centers)
                rgbs.append(r), depths.append(d), masks.append(m)
                amodals.append(m)  # top-down boxes never occlude
        else:
            for ci in range(self._n_cams):
                r, d, m, am = self._render_camera_hard(ci, t_sec)
                rgbs.append(r), depths.append(d), masks.append(m)
                amodals.append(am)
        out = (np.stack(rgbs), np.stack(depths), np.stack(masks),
               np.stack(amodals))
        self._memo = (index, out)
        return out

    def _apply_depth_noise(self, depth: np.ndarray, index: int) -> np.ndarray:
        """Corrupt a (C, H, W) exact depth stack per `DepthNoise`.

        Deterministic per (seed, index) so recorded sequences and goldens
        replay bit-exactly; never mutates the memoized exact render."""
        nz = self.depth_noise
        rng = np.random.default_rng(
            (self.seed * 2_000_003 + 7 * index + 13) & 0x7FFFFFFF)
        z = depth.astype(np.float32, copy=True)
        valid = z > 0
        if nz.sigma_coeff > 0:
            z = np.where(
                valid,
                z + rng.standard_normal(z.shape).astype(np.float32)
                * (nz.sigma_coeff * z * z),
                z)
        if nz.edge_flare > 0:
            for axis in (-1, -2):
                nb = np.roll(z, 1, axis=axis)
                nb_ok = np.roll(valid, 1, axis=axis)
                jump = np.abs(z - nb) > nz.edge_jump_m
                pick = (jump & valid & nb_ok
                        & (rng.uniform(size=z.shape) < nz.edge_flare))
                alpha = rng.uniform(0.2, 0.8, z.shape).astype(np.float32)
                z = np.where(pick, alpha * z + (1.0 - alpha) * nb, z)
        if nz.speckle_frac > 0:
            spk = valid & (rng.uniform(size=z.shape) < nz.speckle_frac)
            z = np.where(
                spk,
                z + rng.uniform(-nz.speckle_m, nz.speckle_m,
                                z.shape).astype(np.float32),
                z)
        if nz.dropout_frac > 0:
            z = np.where(rng.uniform(size=z.shape) < nz.dropout_frac, 0.0, z)
        return np.maximum(z, 0.0)

    def get(self, index: int) -> FramePacket:
        rgb, depth, _, _ = self._render_all(index)
        if self.depth_noise is not None:
            depth = self._apply_depth_noise(depth, index)
        if self.rgb_noise:
            nrng = np.random.default_rng(
                (self.seed * 1_000_003 + index) & 0x7FFFFFFF)
            rgb = np.clip(
                rgb.astype(np.float32)
                + nrng.normal(0.0, self.rgb_noise * 255.0, rgb.shape),
                0, 255).astype(np.uint8)
        return FramePacket(
            rgb=rgb, depth=depth,
            status=np.zeros(self._n_cams, np.uint32), index=index,
        )

    def gt_masks(self, index: int) -> np.ndarray:
        """(C, N_targets, H, W) VISIBLE ground-truth instance masks."""
        _, _, masks, _ = self._render_all(index)
        return masks[:, :self.num_objects]

    def gt_masks_all(self, index: int) -> np.ndarray:
        """(C, N_targets + N_distractors, H, W) visible masks (hard domain;
        in the easy domain identical to `gt_masks`). Row k's class is
        `all_classes[k]`."""
        _, _, masks, _ = self._render_all(index)
        return masks

    def visible_fraction(self, index: int) -> np.ndarray:
        """(C, N_targets) visible-px / amodal-px per target — 1.0 when
        unoccluded, 0.0 when fully hidden (or out of frame). The goldens
        use this to locate genuine occlusion events analytically."""
        _, _, masks, amodal = self._render_all(index)
        vis = masks[:, :self.num_objects].sum((-1, -2)).astype(np.float64)
        amo = amodal[:, :self.num_objects].sum((-1, -2)).astype(np.float64)
        return (vis / np.maximum(amo, 1.0)).astype(np.float32)
