"""The fused per-frame pipeline step (port of `rt3d/pipeline/step.py`).

Stages, in order: letterbox preprocess, YOLO11-seg forward, DFL decode and
fixed-shape NMS (then, when `dedupe_center_px > 0`, centre-distance
suppression), ByteTrack (one tracker per camera), retina masks (eroded when
`erode_kernel > 0`), per-object clouds (packed mask-voxel dedupe, kernel
K2), workspace clouds (grid voxel dedupe, K1) with, when `workspace_sor`
is on, the Morton-window SOR of their fused cloud, centroid fusion with
slot-batched SOR (K3), and min-distance subtraction (K4).

Inputs and outputs keep the JAX package's layouts: rgb (C, H, W, 3) uint8
BGR and depth (C, H, W) f32 on the pipeline's device, per-camera results
with a leading camera axis. Branches the JAX package has but this port does
not yet (BoT-SORT and DeepSORT with their ReID and GMC, accumulation)
raise `NotImplementedError` naming their ROADMAP item; ByteTrack ignores
the `with_reid` and `gmc` flags, as the JAX package does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields
from typing import Callable, ContextManager, Optional, Sequence, Tuple

import numpy as np
import torch

from rt3d_torch.config import Config
from rt3d_torch.geometry.fusion import ObjectSet, flatten_objects, fuse_centroid
from rt3d_torch.geometry.image import erode_mask
from rt3d_torch.geometry.ops import (
    PointBuffer, aabb_mask, backproject_depth_grid, rigid_transform, scalar_like,
    strided_grid_downsample, voxel_downsample_grid, voxel_downsample_masks,
)
from rt3d_torch.geometry.sor import sor_inlier_mask_windowed
from rt3d_torch.geometry.subtract import subtract_min_dist
from rt3d_torch.models.postprocess import (
    Detections, assemble_masks_retina, boxes_to_original, decode_predictions,
    letterbox_params, nms_fixed, preprocess_frame, suppress_center_duplicates,
)
from rt3d_torch.models.yolo import (
    YoloSeg, cast_for_inference, init_random, load_weights,
)
from rt3d_torch.tracking.bytetrack import TrackerState, bytetrack_init, bytetrack_step

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass
class CameraCalib:
    """Calibration batched over the camera axis, on the pipeline device."""

    fx: torch.Tensor           # (C,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    rotation: torch.Tensor     # (C, 3, 3) camera -> robot
    translation: torch.Tensor  # (C, 3)

    @staticmethod
    def from_config(cfg: Config, device="cuda") -> "CameraCalib":
        cams = cfg.rig.cameras

        def t(vals):
            return torch.as_tensor(np.asarray(vals, np.float32), device=device)

        return CameraCalib(
            fx=t([c.intrinsics.fx for c in cams]), fy=t([c.intrinsics.fy for c in cams]),
            cx=t([c.intrinsics.cx for c in cams]), cy=t([c.intrinsics.cy for c in cams]),
            rotation=t(np.stack([c.extrinsics.R for c in cams])),
            translation=t(np.stack([c.extrinsics.t for c in cams])))


@dataclass
class PipelineState:
    """All cross-frame state: one ByteTrack state per camera."""

    trackers: Tuple[TrackerState, ...]


@dataclass
class FrameOutputs:
    detections: Detections        # leading camera axis
    track_ids: torch.Tensor       # (C, D) int32
    objects: ObjectSet            # fused, robot frame
    objects_flat: PointBuffer     # all fused object points, compacted
    workspace: PointBuffer        # subtracted workspace cloud
    per_camera_objects: ObjectSet  # leading camera axis (pre-fusion)
    overflow: torch.Tensor        # () int32 total dropped-point count


def _map_tree(fn: Callable, *trees):
    """`fn` over the tensors of equal-shaped trees of `FrameOutputs`,
    `Detections`, `ObjectSet` and `PointBuffer` (dataclasses of tensors)."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return type(trees[0])(**{f.name: _map_tree(fn, *(getattr(t, f.name) for t in trees))
                             for f in fields(trees[0])})


def _stack_outputs(outs: Sequence[FrameOutputs]) -> FrameOutputs:
    """Frame outputs stacked on a new leading frame axis."""
    return _map_tree(lambda *xs: torch.stack(xs), *outs)


def index_outputs(out: FrameOutputs, j: int) -> FrameOutputs:
    """Frame `j` of outputs with a leading frame axis (`Pipeline.step_scan`)."""
    return _map_tree(lambda x: x[j], out)


def _no_stage(name: str) -> ContextManager:
    return contextlib.nullcontext()


def _stack_objects(sets) -> ObjectSet:
    return ObjectSet(*(torch.stack([getattr(s, f) for s in sets])
                       for f in ("points", "valid", "class_id", "present", "track_id")))


def _camera_objects(objs: ObjectSet, c: int) -> ObjectSet:
    return ObjectSet(objs.points[c], objs.valid[c], objs.class_id[c],
                     objs.present[c], objs.track_id[c])


@dataclass
class Pipeline:
    """Config, model and device. ``plain_kernels=True`` runs every kernel's
    plain PyTorch version instead of the kernel (for comparisons only)."""

    cfg: Config
    model: YoloSeg
    device: torch.device
    plain_kernels: bool = False

    def init_state(self) -> PipelineState:
        return PipelineState(trackers=tuple(
            bytetrack_init(self.cfg.tracker.max_tracks, self.device)
            for _ in range(self.cfg.rig.num_cameras)))

    def calib(self) -> CameraCalib:
        return CameraCalib.from_config(self.cfg, self.device)

    def _meta(self):
        cam = self.cfg.rig.cameras[0]
        return letterbox_params((cam.intrinsics.height, cam.intrinsics.width),
                                self.model.input_hw)

    # -- stages ---------------------------------------------------------

    def preprocess(self, rgb: torch.Tensor) -> torch.Tensor:
        """(C, H, W, 3) u8 -> (C, h, w, 3) letterboxed model input."""
        meta = self._meta()
        dt = _DTYPES[self.cfg.model.preprocess_dtype]
        return torch.stack([preprocess_frame(f, meta, dt) for f in rgb])

    def detect(self, images: torch.Tensor) -> Tuple[Detections, torch.Tensor]:
        """Forward + decode + NMS. Returns (detections with boxes in original
        pixels, camera axis leading; protos (C, hp, wp, nm))."""
        p = self.cfg.model
        meta = self._meta()
        with torch.no_grad():
            box_l, cls_l, coeff_l, protos = self.model(images)
        boxes, scores = decode_predictions(self.model.input_hw, box_l, cls_l)
        class_mask = torch.full((p.num_classes,), not p.class_filter, device=boxes.device)
        for c in p.class_filter:  # one fill each, no host-to-device copy
            class_mask[c] = True
        dets = []
        for b, s, c in zip(boxes, scores, coeff_l):
            det = nms_fixed(b, s, c, conf_thresh=p.conf_thresh, iou_thresh=p.iou_thresh,
                            max_det=p.max_detections, pre_topk=p.nms_pre_topk,
                            class_mask=class_mask)
            det = det.replace(boxes=boxes_to_original(det.boxes, meta))
            if p.dedupe_center_px > 0:
                det = suppress_center_duplicates(det, p.dedupe_center_px)
            dets.append(det)
        return Detections.stack(dets), protos

    def track(self, state: PipelineState, det: Detections
              ) -> Tuple[PipelineState, torch.Tensor]:
        t = self.cfg.tracker
        # ByteTrack uses neither ReID nor GMC: the JAX package ignores both
        # flags for it (its `_use_reid` and `_use_gmc` rules)
        if t.tracker_type != "bytetrack":
            raise NotImplementedError(
                "BoT-SORT and DeepSORT, with their ReID and GMC, are ROADMAP item 13")
        fps = self.cfg.rig.cameras[0].fps
        new, ids = [], []
        for c, ts in enumerate(state.trackers):
            ts, i = bytetrack_step(ts, det.camera(c), t, frame_rate=fps)
            new.append(ts)
            ids.append(i)
        return PipelineState(trackers=tuple(new)), torch.stack(ids)

    def masks(self, protos: torch.Tensor, det: Detections) -> torch.Tensor:
        """(C, D, H, W) bool full-resolution instance masks, eroded by a
        k x k element when `erode_kernel` k > 0."""
        meta = self._meta()
        rdt = _DTYPES[self.cfg.model.mask_resize_dtype]
        out = torch.stack([
            assemble_masks_retina(protos[c], det.coeffs[c], det.boxes[c], meta, rdt)
            for c in range(protos.shape[0])])
        k = self.cfg.pipeline.erode_kernel
        return erode_mask(out, k) if k > 0 else out

    def dense_robot_points(self, depth: torch.Tensor, calib: CameraCalib, c: int):
        """Camera c's full-resolution points in the robot frame (H, W, 3)
        and validity (H, W)."""
        xyz, valid = backproject_depth_grid(depth[c], calib.fx[c], calib.fy[c],
                                            calib.cx[c], calib.cy[c])
        return rigid_transform(xyz, calib.rotation[c], calib.translation[c]), valid

    def object_clouds(self, depth, masks, det: Detections, track_ids,
                      calib: CameraCalib) -> Tuple[ObjectSet, torch.Tensor]:
        """Per-detection voxelized clouds of every camera (K2 inside)."""
        p = self.cfg.pipeline
        sets, ovfs = [], []
        for c in range(depth.shape[0]):
            pts, valid = self.dense_robot_points(depth, calib, c)
            h, w = valid.shape
            buf, ovf = voxel_downsample_masks(
                pts.reshape(-1, 3), valid.reshape(-1), masks[c].reshape(masks.shape[1], -1),
                p.voxel_size, p.max_points_per_object, bound_m=p.dedupe_bound_m,
                stage1_capacity=p.mask_presort_capacity,
                union_capacity=p.max_union_voxels, grid_hw=(h, w),
                plain=self.plain_kernels)
            dc = det.camera(c)
            sets.append(ObjectSet(points=buf.points,
                                  valid=buf.valid & dc.valid[:, None],
                                  class_id=dc.classes,
                                  present=dc.valid & (buf.count > 0),
                                  track_id=track_ids[c]))
            ovfs.append(ovf.sum(dtype=torch.int32))
        return _stack_objects(sets), torch.stack(ovfs)

    def workspace_clouds(self, depth, calib: CameraCalib
                         ) -> Tuple[PointBuffer, torch.Tensor]:
        """Strided cloud -> robot frame -> AABB crop -> voxel dedupe (K1),
        per camera."""
        p = self.cfg.pipeline
        if p.workspace_accumulate:
            raise NotImplementedError(
                "workspace accumulation is ROADMAP item 12")
        s = p.workspace_stride
        depth_s = strided_grid_downsample(depth, s)
        pts_out, valid_out, ovfs = [], [], []
        for i in range(depth.shape[0]):
            sd = scalar_like(float(s), depth_s)
            xyz, valid = backproject_depth_grid(
                depth_s[i], calib.fx[i] / sd, calib.fy[i] / sd,
                calib.cx[i] / sd, calib.cy[i] / sd)
            pts = rigid_transform(xyz, calib.rotation[i], calib.translation[i])
            valid = valid & aabb_mask(pts, p.workspace_x_bounds,
                                      p.workspace_y_bounds, p.workspace_z_bounds)
            buf, ovf = voxel_downsample_grid(pts, valid, p.voxel_size,
                                             p.max_points_workspace,
                                             bound_m=p.dedupe_bound_m,
                                             plain=self.plain_kernels)
            pts_out.append(buf.points)
            valid_out.append(buf.valid)
            ovfs.append(ovf)
        return (PointBuffer(points=torch.stack(pts_out), valid=torch.stack(valid_out)),
                torch.stack(ovfs))

    def fuse(self, per_cam: ObjectSet) -> Tuple[ObjectSet, PointBuffer, torch.Tensor]:
        """Fold the cameras' object sets pairwise, then flatten (K3 inside)."""
        p = self.cfg.pipeline
        fused = _camera_objects(per_cam, 0)
        for c in range(1, self.cfg.rig.num_cameras):
            fused = fuse_centroid(fused, _camera_objects(per_cam, c),
                                  p.fusion_distance_threshold, p.sor_nb_neighbors,
                                  p.sor_std_ratio, plain=self.plain_kernels)
        flat, ovf = flatten_objects(fused, capacity=p.max_points_fused_flat)
        return fused, flat, ovf

    def workspace_sor(self, ws_all: PointBuffer) -> PointBuffer:
        """The fused (C * cap, 3) workspace cloud, SOR-filtered by the
        Morton-window form when `workspace_sor` is on (the exact form
        cannot hold workspace-scale clouds), else as it came."""
        p = self.cfg.pipeline
        if not p.workspace_sor:
            return ws_all
        keep = sor_inlier_mask_windowed(ws_all.points, ws_all.valid,
                                        p.sor_nb_neighbors, p.sor_std_ratio)
        return PointBuffer(points=ws_all.points, valid=keep)

    def subtract(self, workspace: PointBuffer, objects_flat: PointBuffer) -> PointBuffer:
        return subtract_min_dist(workspace, objects_flat,
                                 self.cfg.pipeline.subtraction_threshold,
                                 plain=self.plain_kernels)

    # -- the fused step -------------------------------------------------

    def step(self, state: PipelineState, rgb: torch.Tensor, depth: torch.Tensor,
             calib: CameraCalib, stage: Optional[Callable[[str], ContextManager]] = None
             ) -> Tuple[PipelineState, FrameOutputs]:
        """One frame of every camera: rgb (C, H, W, 3) uint8 BGR, depth
        (C, H, W) f32 meters, both on the pipeline's device.

        `stage(name)`, when given, returns a context entered around each of
        the reference's stage groups, under its `timings.csv` name (the
        driver's profile mode times them); it does not change the outputs."""
        stage = stage or _no_stage
        with torch.no_grad():
            with stage("YOLO11 Inference"):
                images = self.preprocess(rgb)
                det, protos = self.detect(images)
                state, ids = self.track(state, det)
            with stage("Mask Processing"):
                masks = self.masks(protos, det)
                per_cam, obj_ovf = self.object_clouds(depth, masks, det, ids, calib)
            with stage("Point Cloud Processing"):
                ws, ws_ovf = self.workspace_clouds(depth, calib)
                ws_all = self.workspace_sor(PointBuffer(points=ws.points.reshape(-1, 3),
                                                        valid=ws.valid.reshape(-1)))
            with stage("Point Cloud Fusion"):
                fused, flat, flat_ovf = self.fuse(per_cam)
            with stage("Subtraction"):
                ws_out = self.subtract(ws_all, flat)
            overflow = obj_ovf.sum(dtype=torch.int32) + ws_ovf.sum(dtype=torch.int32) \
                + flat_ovf.to(torch.int32)
        return state, FrameOutputs(
            detections=det, track_ids=ids, objects=fused, objects_flat=flat,
            workspace=ws_out, per_camera_objects=per_cam, overflow=overflow)

    def step_scan(self, state: PipelineState, rgb: torch.Tensor, depth: torch.Tensor,
                  calib: CameraCalib, good: Sequence[bool]
                  ) -> Tuple[PipelineState, FrameOutputs]:
        """K frames in order (the JAX package's `lax.scan` over `step`): rgb
        (K, C, H, W, 3), depth (K, C, H, W), `good` a host (K,) bool mask.
        A frame with ``good[k]`` False computes its outputs from the state
        before it and leaves that state unchanged. Outputs carry a leading K
        axis (`index_outputs` takes frame k). Keeping the old state is
        sound because `step` builds new state tensors and never writes into
        the ones it is given."""
        outs = []
        for k in range(rgb.shape[0]):
            new, out = self.step(state, rgb[k], depth[k], calib)
            if good[k]:
                state = new
            outs.append(out)
        return state, _stack_outputs(outs)


def build_pipeline(cfg: Optional[Config] = None, weights: Optional[str] = None,
                   device="cuda", seed: int = 0,
                   plain_kernels: bool = False) -> Pipeline:
    """The pipeline for `cfg` on `device`: YOLO weights from a JAX-package
    ``.npz`` or an ultralytics ``.pt`` (`weights`, else
    `cfg.model.weights`), else random from `seed`; parameters cast to
    `cfg.model.compute_dtype`.
    ``plain_kernels=True`` swaps every kernel for its plain PyTorch version;
    it exists for comparisons and is never the default."""
    cfg = cfg or Config()
    device = torch.device(device)
    m = cfg.model
    model = YoloSeg(variant=m.variant, num_classes=m.num_classes,
                    num_mask_coeffs=m.num_mask_coeffs, input_hw=m.input_hw)
    path = weights or m.weights
    if path:
        load_weights(model, path)
    else:
        init_random(model, seed)
    model = cast_for_inference(model, _DTYPES[m.compute_dtype], device)
    return Pipeline(cfg=cfg, model=model, device=device, plain_kernels=plain_kernels)
