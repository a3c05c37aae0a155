"""Typed configuration for the rt3d pipeline (PyTorch port).

A numpy-only copy of `rt3d/config.py`: the same dataclasses and fields, so
``Config.from_dict(rt3d.config.Config().to_dict())`` rebuilds the same
configuration here. The port adds the mask-model fields of `ModelConfig`
(`MASK_FIELDS`); `to_dict` writes them only where they differ from the
default, so the dict of a configuration with the proto masks is the JAX
package's, and `from_dict` fills them in where they are missing.

The reference scatters every parameter as hardcoded literals across its entry
scripts (camera serials `2cam/2cams_mask_gpu.py:66-67`, calibration matrices
`:109-123`, workspace bounds `:232-234`, voxel sizes `:251`, class filters /
conf `:274`, fusion & subtraction thresholds `:379,397`) plus tracker YAMLs
(`trackers/bytetrack.yaml`).  Here all of that lives in one typed, serializable
config tree.  Defaults reproduce the reference's benchmarked configuration
(`2cams_mask_gpu.py`, the numbers behind BASELINE.md).

Static shape parameters (padded buffer capacities) are first-class config: on
the accelerator every per-frame tensor has a fixed shape, so capacities like
``max_detections`` and ``max_points_per_object`` are compile-time constants.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Camera model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics (reference: ZED factory calibration, `2cams.py:90-96`)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 1280
    height: int = 720

    def scaled(self, sx: float, sy: float) -> "Intrinsics":
        """Intrinsics for a resized image (e.g. the 640x360 workspace grid)."""
        return Intrinsics(
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=self.cx * sx,
            cy=self.cy * sy,
            width=int(round(self.width * sx)),
            height=int(round(self.height * sy)),
        )


@dataclass(frozen=True)
class Extrinsics:
    """Rigid transform camera->robot base frame.

    The reference hand-composes T_robot_cam = T_robot_chess @ T_chess_cam
    (`2cam/2cams.py:100-124`) and then uses R, t as torch tensors.  We store
    the 3x3 rotation and translation directly (row-major tuples so the config
    stays hashable / serializable).
    """

    rotation: Tuple[Tuple[float, float, float], ...] = (
        (1.0, 0.0, 0.0),
        (0.0, 1.0, 0.0),
        (0.0, 0.0, 1.0),
    )
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def R(self) -> np.ndarray:
        return np.asarray(self.rotation, dtype=np.float32)

    @property
    def t(self) -> np.ndarray:
        return np.asarray(self.translation, dtype=np.float32)

    @staticmethod
    def from_matrix(T: np.ndarray) -> "Extrinsics":
        T = np.asarray(T, dtype=np.float64)
        return Extrinsics(
            rotation=tuple(tuple(float(v) for v in row) for row in T[:3, :3]),
            translation=tuple(float(v) for v in T[:3, 3]),
        )


@dataclass(frozen=True)
class CameraConfig:
    """One camera of the rig (reference: serials at `2cams_mask_gpu.py:66-67`)."""

    name: str
    intrinsics: Intrinsics
    extrinsics: Extrinsics = field(default_factory=Extrinsics)
    serial: Optional[int] = None
    fps: int = 30
    depth_min_m: float = 0.4  # DEPTH_MODE min distance, `2cams_mask_gpu.py:75`


# Reference rig: two ZED cams, HD720.  Intrinsics below are representative ZED
# HD720 factory values; real deployments load them from recorded sequences.
_DEFAULT_INTR = Intrinsics(fx=527.2, fy=527.2, cx=636.7, cy=361.3)


def _default_cameras() -> Tuple[CameraConfig, ...]:
    # Extrinsics reproduce the shape of the reference's chessboard-composed
    # transforms (`2cams.py:100-124`): cameras looking down at a tabletop from
    # two sides.  Values are placeholders overridden by sequence metadata.
    c, s = float(np.cos(np.pi / 4)), float(np.sin(np.pi / 4))
    ext1 = Extrinsics(
        rotation=((1.0, 0.0, 0.0), (0.0, -s, c), (0.0, -c, -s)),
        translation=(0.25, -0.3, 0.8),
    )
    ext2 = Extrinsics(
        rotation=((-1.0, 0.0, 0.0), (0.0, s, c), (0.0, c, -s)),
        translation=(0.25, 1.5, 0.8),
    )
    return (
        CameraConfig(name="cam1", intrinsics=_DEFAULT_INTR, extrinsics=ext1,
                     serial=33137761),
        CameraConfig(name="cam2", intrinsics=_DEFAULT_INTR, extrinsics=ext2,
                     serial=36829049),
    )


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrackerConfig:
    """ByteTrack parameters (reference: `trackers/bytetrack.yaml:11-15`)."""

    tracker_type: str = "bytetrack"
    track_high_thresh: float = 0.6
    track_low_thresh: float = 0.05
    new_track_thresh: float = 0.5
    track_buffer: int = 1500
    match_thresh: float = 0.7
    fuse_score: bool = True
    max_tracks: int = 64  # fixed track-slot capacity (static shape)
    # LAP solver: 'greedy' (the default), 'refined' (greedy + swap/move
    # rounds) or 'exact' (Hungarian), all three in rt3d_torch.tracking.assignment;
    # the JAX package documents the quality gap (tests/test_assignment_modes.py)
    assignment: str = "greedy"
    # BoT-SORT appearance extension (reference `trackers/botsort.yaml:14-19`)
    with_reid: bool = False
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.25
    emb_dim: int = 64          # pooled-neck appearance feature width
    gmc: bool = False          # camera-motion compensation on/off
    # 'affine' = grid phase correlation + robust LSQ fit (the TPU-native
    # equivalent of botsort.yaml's sparseOptFlow+RANSAC); 'translation' =
    # single full-frame phase correlation
    gmc_method: str = "affine"
    # DeepSORT (tracker_type="deepsort", rt3d/tracking/deepsort.py —
    # BASELINE configs[3]): appearance-primary association with chi-square
    # Mahalanobis gating. with_reid is implied (enforced by the pipeline).
    max_cosine_distance: float = 0.2   # DeepSORT release default
    motion_lambda: float = 0.0         # paper's λ motion-blend (release: 0)
    gate_only_position: bool = False   # gate on (x,y) only (2-dof chi2)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """YOLO11-seg model selection + static inference shapes.

    Reference: `yolo11x-seg.pt` at `2cams_mask_gpu.py:51`, `yolo11l-seg.pt`
    at `1cam/rt-tracking.py:78`, `imgsz=640` (`2cams_mask_gpu.py:284`).
    Input 1280x720 letterboxes to 640x384 (stride-32 rectangular letterbox,
    matching ultralytics `auto=True` behavior).
    """

    variant: str = "x"  # n / s / m / l / x
    num_classes: int = 80
    num_mask_coeffs: int = 32
    input_hw: Tuple[int, int] = (384, 640)
    conf_thresh: float = 0.1        # `2cams_mask_gpu.py:274`
    iou_thresh: float = 0.7         # ultralytics NMS default
    max_detections: int = 20        # precedent: max_det=20, `1cam/rt-tracking.py:212`
    nms_pre_topk: int = 128         # candidates entering NMS (static)
    # post-NMS same-class centre-distance suppression radius in ORIGINAL
    # image pixels (0 = off, the reference-parity default). In-env
    # trained detectors emit near-duplicate boxes below the NMS IoU gate
    # that multiply downstream object slots (and the fused-SOR work);
    # 24 px at HD720 ~= 2.5 cm at
    # 1 m — below any real object separation in the operating scenes.
    dedupe_center_px: float = 0.0
    class_filter: Tuple[int, ...] = (39, 41)  # Bottle + Cup, `2cams_mask_gpu.py:274`
    weights: Optional[str] = None   # path to converted params (.npz) or .pt
    compute_dtype: str = "bfloat16"
    # dtype of the letterbox resize (HD720 u8 -> model-input RGB). u8
    # values are exact in bf16, so only the resize interpolation precision
    # changes; "float32" runs the resize in full precision.
    preprocess_dtype: str = "bfloat16"
    # dtype of the retina-mask bilinear upsample (proto-res -> full-res
    # over max_detections slots). In bf16 only probabilities within bf16
    # resolution (~0.004) of the 0.5 threshold can flip: a <=1 px band at
    # mask boundaries.
    mask_resize_dtype: str = "bfloat16"
    # the mask model: "proto" (the detector's 32 proto coefficients) or
    # Segment Anything ViT-H prompted by the detections' boxes, "sam_vit_h"
    # (`rt3d_torch/models/sam.py`), in `compute_dtype`, with its resizes in
    # `mask_resize_dtype`
    mask_model: str = "proto"
    # SAM's weights: the public checkpoint (e.g. sam_vit_h_4b8939.pth), else
    # random from `sam_seed` by the rule of `sam.init_random`
    sam_weights: Optional[str] = None
    sam_seed: int = 0


# the fields of `ModelConfig` that the JAX package lacks
MASK_FIELDS = ("mask_model", "sam_weights", "sam_seed")


# ---------------------------------------------------------------------------
# Pipeline geometry / capacities
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelineConfig:
    """Per-frame geometry parameters + padded buffer capacities.

    Reference values: voxel 0.005 (`2cams_mask_gpu.py:251`), workspace bounds
    (`vision_pipeline_utils.py:241-243`), fusion threshold 0.3
    (`2cams_mask_gpu.py:379`), subtraction threshold 0.06 (`:397`), SOR
    nb_neighbors=20 / std_ratio=1.5 (`vision_pipeline_utils.py:48`).
    """

    voxel_size: float = 0.005
    workspace_x_bounds: Tuple[float, float] = (-0.25, 0.75)
    workspace_y_bounds: Tuple[float, float] = (-0.5, 1.75)
    workspace_z_bounds: Tuple[float, float] = (-0.05, 2.0)
    fusion_distance_threshold: float = 0.3
    subtraction_threshold: float = 0.06
    sor_nb_neighbors: int = 20
    sor_std_ratio: float = 1.5
    # half-range of the packed voxel-dedupe grid around the robot origin;
    # points beyond it are dropped (see rt3d/geometry/ops.py packed path)
    dedupe_bound_m: float = 2.56
    # Workspace cloud is retrieved at reduced resolution in the reference
    # (640x360 XYZ measure, `2cams.py:143-150`); we stride the full-res depth.
    workspace_stride: int = 2
    # Square-kernel mask erosion applied to every instance mask before
    # backprojection; 0 disables. The CPU reference variant erodes 12x12
    # (`2cams_mask_cpu.py:55,583-586`), the 1cam app 10x10
    # (`1cam/rt-tracking.py:30`); the benchmarked GPU variant leaves it off.
    erode_kernel: int = 0
    # SOR the fused workspace cloud (CPU variant only,
    # `2cams_mask_cpu.py:530`); the GPU/benchmark variant skips it.
    workspace_sor: bool = False
    # Persistent TSDF-style workspace accumulation (stretch config;
    # BASELINE.json configs[4]). The reference rebuilds its workspace
    # cloud from scratch every frame (`vision_pipeline_utils.py:229-254`);
    # with this on, the post-subtraction workspace voxels fold into a
    # persistent weighted voxel set (`rt3d/geometry/voxel_sets.py`):
    # weights decay by `accum_decay` per frame, observed voxels gain
    # `accum_obs_weight`, and the published workspace cloud is the set of
    # voxels with weight >= `accum_min_weight` — so geometry survives
    # transient occlusion and sensor dropouts, and noise voxels fade out.
    workspace_accumulate: bool = False
    accum_capacity: int = 65536
    accum_decay: float = 0.97
    accum_obs_weight: float = 1.0
    accum_min_weight: float = 0.5
    # Skip the per-camera workspace voxel dedupe when accumulation is on
    # (ignored otherwise). The published workspace is then
    # `extract_accumulated`, whose merge dedupes globally anyway — the
    # per-camera sorts only pre-shrink its input. At 1 mm voxels nearly
    # every ray is a distinct voxel (pixel footprint > voxel), so those
    # sorts (4x ~230 K rows at the stretch config) buy ~nothing and cost
    # the most expensive ops in the frame. Rays are still SNAPPED to voxel
    # centers elementwise (no sort), so subtraction and the accumulator
    # merge see exactly the coordinates the dedupe path publishes.
    # Semantic delta: a voxel seen by k rays in one frame gains
    # k*accum_obs_weight instead of 1x — weight becomes per-RAY support,
    # the same multi-counting the per-camera dedupe already allows ACROSS
    # cameras. The extracted voxel SET is unchanged wherever weights clear
    # `accum_min_weight` either way (tested with live detections,
    # tests/test_pipeline.py). Ignored when `workspace_sor` is on: kNN
    # statistics are not duplicate-invariant, so raw mode would change
    # which voxels SOR keeps.
    accum_skip_prededupe: bool = False
    # --- static capacities (padded buffer sizes; compile-time constants) ---
    # raw mask-union pixels entering the object-path sort (pre-dedupe)
    mask_presort_capacity: int = 131072
    # unique voxels across ALL detections per camera (bounds the batched
    # per-detection compaction sort; 8192 covers ~8 full-capacity objects)
    max_union_voxels: int = 8192
    max_points_per_object: int = 1024     # voxels per object after downsample
    max_points_fused_object: int = 2048   # after 2-camera vstack
    # per-camera workspace voxels. An HD720 camera 1 m above a tabletop
    # sees ~41 K unique 5 mm voxels inside the default bounds (measured on
    # the synthetic rig; 32768 silently dropped ~20% of the workspace
    # every frame — surfaced by the per-frame overflow counter).
    max_points_workspace: int = 65536
    max_points_workspace_fused: int = 131072
    max_objects_fused: int = 40           # 2 x max_detections slots
    # capacity of the flattened all-objects buffer handed to subtraction
    # (the reference vstacks everything, `vision_pipeline_utils.py:314-318`);
    # sized for ~10 simultaneous full-capacity fused objects — the worst
    # realistic scene, not the theoretical 40x2048 maximum. Overflow beyond
    # this is counted and reported per frame (`step.py` fuse()).
    max_points_fused_flat: int = 20480


@dataclass(frozen=True)
class RigConfig:
    cameras: Tuple[CameraConfig, ...] = field(default_factory=_default_cameras)

    @property
    def num_cameras(self) -> int:
        return len(self.cameras)


@dataclass(frozen=True)
class Config:
    """Top-level config for one pipeline run."""

    rig: RigConfig = field(default_factory=RigConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    # ------------------------------------------------------------------
    # Serialization (JSON round-trip; YAML via pyyaml if available)
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        default = ModelConfig()
        for k in MASK_FIELDS:
            if d["model"][k] == getattr(default, k):
                del d["model"][k]
        return d

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        def _tupled(x):
            if isinstance(x, list):
                return tuple(_tupled(v) for v in x)
            return x

        rig = RigConfig(cameras=tuple(
            CameraConfig(
                name=c["name"],
                intrinsics=Intrinsics(**c["intrinsics"]),
                extrinsics=Extrinsics(
                    rotation=_tupled(c["extrinsics"]["rotation"]),
                    translation=_tupled(c["extrinsics"]["translation"]),
                ),
                serial=c.get("serial"),
                fps=c.get("fps", 30),
                depth_min_m=c.get("depth_min_m", 0.4),
            )
            for c in d.get("rig", {}).get("cameras", [])
        ) or _default_cameras())
        model = ModelConfig(**{**d.get("model", {}),
                               "input_hw": tuple(d.get("model", {}).get("input_hw", (384, 640))),
                               "class_filter": tuple(d.get("model", {}).get("class_filter", (39, 41)))})
        tracker = TrackerConfig(**d.get("tracker", {}))
        p = dict(d.get("pipeline", {}))
        for k in ("workspace_x_bounds", "workspace_y_bounds", "workspace_z_bounds"):
            if k in p:
                p[k] = tuple(p[k])
        pipeline = PipelineConfig(**p)
        return Config(rig=rig, model=model, tracker=tracker, pipeline=pipeline)

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path) as f:
            return Config.from_dict(json.load(f))


def with_cameras(cfg: Config, cameras) -> Config:
    """Config with the rig replaced by a FrameSource's calibration — the
    analog of the reference reading intrinsics/extrinsics from the camera
    SDK at startup (`2cams.py:90-124`) instead of trusting defaults."""
    return dataclasses.replace(cfg, rig=RigConfig(cameras=tuple(cameras)))


def reference_2cam_config() -> Config:
    """The configuration behind the reference's published benchmark numbers
    (`2cams_mask_gpu.py`: voxel 5 mm, conf 0.1, classes Bottle+Cup,
    fusion 0.3, subtraction 0.06)."""
    return Config()


def reference_2cam_cpu_config() -> Config:
    """`2cams_mask_cpu.py` analog: voxel 1 cm, conf 0.25, five COCO classes
    (`2cams_mask_cpu.py:523,543`), mask erosion 12x12 (`:55,583-586`), and
    workspace SOR (`:530`) via the bucketed-kNN kernel (exact O(N^2) SOR
    can't hold 64 K workspace points)."""
    base = Config()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(
            base.model, conf_thresh=0.25,
            class_filter=(39, 41, 42, 43, 45)),
        pipeline=dataclasses.replace(
            base.pipeline, voxel_size=0.01, erode_kernel=12,
            workspace_sor=True),
    )


def reference_1cam_config() -> Config:
    """`1cam/rt-tracking.py` analog: single camera @60fps, yolo11l-seg,
    conf 0.3, 7-class filter (`1cam/rt-tracking.py:209-221`)."""
    base = Config()
    cam = base.rig.cameras[0]
    return dataclasses.replace(
        base,
        rig=RigConfig(cameras=(dataclasses.replace(cam, fps=60, depth_min_m=0.3),)),
        model=dataclasses.replace(
            base.model, variant="l", conf_thresh=0.3,
            class_filter=(39, 41, 42, 43, 44, 45, 46)),
    )
