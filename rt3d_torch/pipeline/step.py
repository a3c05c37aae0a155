"""The fused per-frame pipeline step (port of `rt3d/pipeline/step.py`).

Stages, in order: letterbox preprocess, YOLO11-seg forward, DFL decode and
fixed-shape NMS (then, when `dedupe_center_px > 0`, centre-distance
suppression), tracking (one tracker per camera: ByteTrack, BoT-SORT with
the detector's pooled stride-8 features as ReID and grey-frame GMC, or
DeepSORT), retina masks (eroded when `erode_kernel > 0`), per-object clouds
(mask-voxel dedupe: the packed key with kernel K2, the two-word key at
1 mm), workspace clouds (grid voxel dedupe, K1; with accumulation and
`accum_skip_prededupe`, the raw rays snapped to voxel centres) with, when
`workspace_sor` is on, the Morton-window SOR of their fused cloud, centroid
fusion with slot-batched SOR (K3), min-distance subtraction (K4), and,
with `workspace_accumulate`, the fold of the subtracted workspace into the
persistent voxel accumulator, whose voxels above `accum_min_weight` are
published as the workspace.

The masks come from the pipeline's mask model: YOLO-seg's protos
(`ProtoMasks`), or, with `mask_model` set to a SAM model, Segment Anything
prompted by the detections' boxes (`rt3d_torch.models.sam.SamMasks`). Its
context (the protos, or SAM's image embeddings of every camera's frame as
one batch) is made right after `detect`, inside `YOLO11 Inference`.

On the card, with autograd off, forward, decode and NMS replay one CUDA
graph (`Pipeline.detect`), and so does every camera's tracker step when it
reads nothing back (`Pipeline.track`: greedy assignment, no embeddings, no
GMC), each bit for bit the eager path's kernels (`rt3d_torch.runtime.graphs`);
the CPU runs them eagerly.

Inputs and outputs keep the JAX package's layouts: rgb (C, H, W, 3) uint8
BGR and depth (C, H, W) f32 on the pipeline's device, per-camera results
with a leading camera axis. ByteTrack ignores the `with_reid` and `gmc`
flags, as the JAX package does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, ContextManager, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rt3d_torch import tree
from rt3d_torch.config import Config
from rt3d_torch.geometry.fusion import ObjectSet, flatten_objects, fuse_centroid
from rt3d_torch.geometry.image import erode_mask
from rt3d_torch.geometry.ops import (
    PointBuffer, _pad_to, aabb_mask, backproject_depth_grid, packed2_fits,
    rigid_transform, scalar_like, strided_grid_downsample, voxel_downsample_grid,
    voxel_downsample_masks,
)
from rt3d_torch.geometry.sor import sor_inlier_mask_windowed
from rt3d_torch.geometry.subtract import subtract_min_dist
from rt3d_torch.geometry.voxel_sets import (
    VoxelAccumulator, accumulate_voxels, extract_accumulated,
)
from rt3d_torch.models.postprocess import (
    Detections, ProtoMasks, boxes_to_original, decode_predictions, letterbox_params, nms_fixed,
    preprocess_frame, suppress_center_duplicates,
)
from rt3d_torch.models.sam import Sam, SamMasks, build_sam
from rt3d_torch.models.yolo import (
    YoloSeg, cast_for_inference, init_random, load_weights,
)
from rt3d_torch.runtime import graphs, trace
from rt3d_torch.tracking.assignment import greedy_fits
from rt3d_torch.tracking.botsort import (
    estimate_affine_gmc, estimate_translation_gmc, rescale_warp, translation_warp,
)
from rt3d_torch.tracking.bytetrack import TrackerState, bytetrack_init, bytetrack_step
from rt3d_torch.tracking.deepsort import deepsort_step

TRACKERS = {"bytetrack": bytetrack_step, "botsort": bytetrack_step,
            "deepsort": deepsort_step}

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
    """All cross-frame state: one tracker state per camera, the previous
    frame's grey images for GMC ((C, 1, 1) zeros when GMC is off) and the
    workspace voxel accumulator (capacity 1 when accumulation is off)."""

    trackers: Tuple[TrackerState, ...]
    prev_gray: torch.Tensor
    accum: VoxelAccumulator


@dataclass
class FrameOutputs:
    detections: Detections        # leading camera axis
    track_ids: torch.Tensor       # (C, D) int32
    objects: ObjectSet            # fused, robot frame
    objects_flat: PointBuffer     # all fused object points, compacted
    workspace: PointBuffer        # subtracted workspace cloud
    per_camera_objects: ObjectSet  # leading camera axis (pre-fusion)
    overflow: torch.Tensor        # () int32 total dropped-point count
    # SAM's low-resolution logits of each slot's mask, (C, D, 256, 256) in
    # the compute dtype (its predictor's `low_res_logits`); None on the
    # proto path
    low_res_logits: Optional[torch.Tensor] = None


def index_outputs(out: FrameOutputs, j: int) -> FrameOutputs:
    """Frame `j` of outputs with a leading frame axis (`Pipeline.step_scan`)."""
    return tree.index(out, j)


def _no_stage(name: str) -> ContextManager:
    return contextlib.nullcontext()


def _snapped_rays(pts: torch.Tensor, valid: torch.Tensor, voxel_size: float,
                  capacity: int) -> PointBuffer:
    """A grid's rays, each snapped to its voxel centre ``round(p / v) * v``
    (the coordinates the dedupe path publishes), padded to `capacity`."""
    fp = pts.reshape(-1, 3).float()
    fp = torch.round(fp / scalar_like(voxel_size, fp)) * voxel_size
    fv = _pad_to(valid.reshape(-1), capacity, False)
    fp = _pad_to(fp, capacity, 0.0)
    return PointBuffer(points=torch.where(fv[:, None], fp, 0.0), valid=fv)


def class_mask(num_classes: int, class_filter: Sequence[int], device) -> torch.Tensor:
    """(num_classes,) bool: the classes `class_filter` keeps, all of them
    when it is empty. Built on the device from comparisons, so no Python
    scalar is copied to it."""
    ids = torch.arange(num_classes, device=device)
    mask = torch.full((num_classes,), not class_filter, dtype=torch.bool, device=device)
    for c in class_filter:
        mask |= ids == c
    return mask


@dataclass
class Pipeline:
    """Config, model and device. ``plain_kernels=True`` runs every kernel's
    plain PyTorch version instead of the kernel (for comparisons only).
    `sam` is SAM when `cfg.model.mask_model` names it; `mask_model`, the
    mask model, is made from it."""

    cfg: Config
    model: YoloSeg
    device: torch.device
    plain_kernels: bool = False
    sam: Optional[Sam] = None
    _detect_graph: Optional[graphs.CapturedGraph] = field(default=None, init=False, repr=False,
                                                          compare=False)
    _track_graph: Optional[graphs.CapturedGraph] = field(default=None, init=False, repr=False,
                                                         compare=False)

    def __post_init__(self):
        m = self.cfg.model
        self.class_mask = class_mask(m.num_classes, m.class_filter, self.device)
        cam = self.cfg.rig.cameras[0].intrinsics
        src_hw, rdt = (cam.height, cam.width), _DTYPES[m.mask_resize_dtype]
        self.mask_model = (ProtoMasks(letterbox_params(src_hw, m.input_hw), rdt)
                           if self.sam is None else SamMasks(self.sam, src_hw, rdt))

    @property
    def _use_reid(self) -> bool:
        """DeepSORT always uses appearance, BoT-SORT with `with_reid`."""
        t = self.cfg.tracker
        return (t.tracker_type == "botsort" and t.with_reid) or t.tracker_type == "deepsort"

    @property
    def _use_gmc(self) -> bool:
        t = self.cfg.tracker
        return t.tracker_type in ("botsort", "deepsort") and t.gmc

    def _gray_hw(self) -> Tuple[int, int]:
        h, w = self.model.input_hw
        return h // 4, w // 4

    def init_state(self) -> PipelineState:
        c, t, p = self.cfg.rig.num_cameras, self.cfg.tracker, self.cfg.pipeline
        gh, gw = self._gray_hw() if self._use_gmc else (1, 1)
        return PipelineState(
            trackers=tuple(bytetrack_init(t.max_tracks, t.emb_dim, self.device)
                           for _ in range(c)),
            prev_gray=torch.zeros((c, gh, gw), dtype=torch.float32, device=self.device),
            accum=VoxelAccumulator.empty(
                p.accum_capacity if p.workspace_accumulate else 1, self.device))

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

    def detect(self, images: torch.Tensor
               ) -> Tuple[Detections, torch.Tensor, Optional[torch.Tensor]]:
        """Forward + decode + NMS. Returns (detections with boxes in original
        pixels, camera axis leading; the protos (C, hp, wp, nm);
        embeddings (C, D, emb_dim) when the tracker uses ReID, else None).

        On the card with autograd off, forward, decode and NMS
        (`_detect_core`) replay one CUDA graph, captured on the first such
        call and again whenever the images' shape, strides, dtype or device
        or the model's generation change. The detections are then stacked
        out of the graph's memory, so they stay as they are when the next
        call replays it; the protos stay in it, valid until the next call.
        The embeddings are computed after the replay, eagerly. A replay
        runs no Python: the model's forward hooks fire only on the eager
        path, so a caller that reads activations through hooks calls the
        model itself (as `quant.collect_act_scales` does) or `detect` with
        autograd on."""
        if graphs.replayable(images.device):
            with trace.span("detect.graph"):
                key = (images.shape, images.stride(), images.dtype, images.device,
                       self.model, self.model.generation)
                dets, protos, feats = graphs.replayed(self, "detect", key, self._detect_core,
                                                      images)
                det = tree.stack(dets)
        else:
            with torch.no_grad():
                dets, protos, feats = self._detect_core(images)
            det = tree.stack(dets)
        emb = None
        if self._use_reid:
            meta = self._meta()
            with trace.span("detect.embed"):
                p3 = feats[0].float().permute(0, 2, 3, 1)  # stride 8, channels last
                emb = torch.stack([self._pooled_embeddings(p3[c], tree.index(det, c), meta)
                                   for c in range(p3.shape[0])])
        return det, protos, emb

    def _detect_core(self, images: torch.Tensor
                     ) -> Tuple[List[Detections], torch.Tensor, Tuple[torch.Tensor, ...]]:
        """The YOLO forward, decode and per-camera NMS: (a camera's
        detections each, protos, the neck features). Static shapes, no host
        read: what `detect` captures."""
        p = self.cfg.model
        meta = self._meta()
        with trace.span("detect.forward"):
            (box_l, cls_l, coeff_l, protos), feats = self.model.forward_with_feats(images)
        with trace.span("detect.decode_nms"):
            boxes, scores = decode_predictions(self.model.input_hw, box_l, cls_l)
            dets = []
            for b, s, c in zip(boxes, scores, coeff_l):
                det = nms_fixed(b, s, c, conf_thresh=p.conf_thresh, iou_thresh=p.iou_thresh,
                                max_det=p.max_detections, pre_topk=p.nms_pre_topk,
                                class_mask=self.class_mask)
                det = det.replace(boxes=boxes_to_original(det.boxes, meta))
                if p.dedupe_center_px > 0:
                    det = suppress_center_duplicates(det, p.dedupe_center_px)
                dets.append(det)
        return dets, protos, feats

    def _pooled_embeddings(self, p3: torch.Tensor, det: Detections, meta) -> torch.Tensor:
        """Appearance features in place of a ReID network: the stride-8 neck
        feature (hf, wf, c) at each box centre, averaged over groups of
        c / emb_dim channels, L2-normalized: (D, emb_dim)."""
        e = self.cfg.tracker.emb_dim
        hf, wf, c = p3.shape
        assert c % e == 0, (c, e)
        ratio = scalar_like(meta.ratio, det.boxes)
        cx = (det.boxes[:, 0] + det.boxes[:, 2]) / 2
        cy = (det.boxes[:, 1] + det.boxes[:, 3]) / 2
        fx = torch.clamp(((cx * ratio + meta.pad_left) / 8).to(torch.int32), 0, wf - 1)
        fy = torch.clamp(((cy * ratio + meta.pad_top) / 8).to(torch.int32), 0, hf - 1)
        v = p3[fy.long(), fx.long()].reshape(-1, e, c // e)
        v = v.sum(-1) / scalar_like(float(c // e), v)
        norm = torch.sqrt((v * v).sum(-1, keepdim=True))
        return v / torch.clamp_min(norm, 1e-6)

    def _gray(self, images: torch.Tensor) -> torch.Tensor:
        """(C, h/4, w/4) grey images for GMC: the channel mean of the model
        input, downscaled by antialiased bilinear interpolation (what
        `jax.image.resize(..., "linear")` does when shrinking)."""
        im = images.float()
        g = (im[..., 0] + im[..., 1]) + im[..., 2]
        g = g / scalar_like(3.0, g)
        return F.interpolate(g[:, None], size=self._gray_hw(), mode="bilinear",
                             align_corners=False, antialias=True)[:, 0]

    def _gmc_warps(self, prev_gray: torch.Tensor, gray: torch.Tensor):
        """Per camera, the (2, 3) camera motion from the previous grey
        image to this one, in original pixels."""
        t, meta = self.cfg.tracker, self._meta()
        warps = []
        for c in range(gray.shape[0]):
            if t.gmc_method == "affine":
                w = estimate_affine_gmc(prev_gray[c], gray[c])
            else:
                w = translation_warp(estimate_translation_gmc(prev_gray[c], gray[c]))
            # the warp is at 1/4 of the letterbox: p = ratio / 4 * p_orig + pad / 4
            warps.append(rescale_warp(w, meta.ratio / 4.0,
                                      (meta.pad_left / 4.0, meta.pad_top / 4.0)))
        return warps

    def track(self, state: PipelineState, det: Detections,
              det_emb: Optional[torch.Tensor] = None, images: Optional[torch.Tensor] = None
              ) -> Tuple[PipelineState, torch.Tensor]:
        """Step each camera's tracker. BoT-SORT and DeepSORT take the
        detections' embeddings when they use ReID, and with GMC the camera
        motion from the previous frame's grey image (`images` are the model
        inputs, `preprocess`'s output); ByteTrack uses neither, whatever the
        flags say.

        On the card with autograd off, when the step reads nothing back
        (greedy assignment on its kernel, no embeddings, no GMC warp: see
        `_track_replays`), every camera's step replays one CUDA graph of
        `_track_core`, captured on the first such call and again whenever
        the shapes, dtypes or devices of its inputs, the tracker
        configuration or the frame rate change; the new states and ids are
        copied out of the graph's memory. Anything else runs eagerly."""
        prev_gray = state.prev_gray
        warps = [None] * len(state.trackers)
        if self._use_gmc and images is not None:
            with trace.span("track.gmc"):
                gray = self._gray(images)
                warps = self._gmc_warps(prev_gray, gray)
                prev_gray = gray
        emb = det_emb if self._use_reid else None
        if self._track_replays(det.boxes.device, emb, warps):
            with trace.span("track.graph"):
                args = (state.trackers, det.replace(coeffs=None))  # trackers read no coeffs
                key = (tuple((x.shape, x.dtype, x.device) for x in tree.leaves(args)),
                       self.cfg.tracker, self.cfg.rig.cameras[0].fps)
                new, ids = graphs.copied(graphs.replayed(self, "track", key, self._track_core,
                                                         *args))
        else:
            new, ids = self._track_core(state.trackers, det, emb, warps)
        return PipelineState(trackers=new, prev_gray=prev_gray, accum=state.accum), ids

    def _track_replays(self, device: torch.device, emb: Optional[torch.Tensor],
                       warps: Sequence) -> bool:
        """Whether `track` replays its CUDA graph: where `graphs.replayable`,
        with the greedy solves on their kernel (greedy assignment, no
        `plain_kernels`), no embeddings and no GMC warp. `refined` and
        `exact` assignment, ReID, GMC and DeepSORT read back, and run eagerly."""
        return (graphs.replayable(device) and not self.plain_kernels
                and self.cfg.tracker.assignment == "greedy" and emb is None
                and all(w is None for w in warps))

    def _track_core(self, trackers: Sequence[TrackerState], det: Detections,
                    emb: Optional[torch.Tensor] = None, warps: Optional[Sequence] = None
                    ) -> Tuple[Tuple[TrackerState, ...], torch.Tensor]:
        """Every camera's tracker step, in order: (new states, (C, D) ids).
        What `track` captures when `emb` and `warps` are None."""
        t = self.cfg.tracker
        fps = self.cfg.rig.cameras[0].fps
        step = TRACKERS[t.tracker_type]
        new, ids = [], []
        for c, ts in enumerate(trackers):
            with trace.span("track.camera"):
                ts, i = step(ts, tree.index(det, c), t, frame_rate=fps,
                             det_emb=None if emb is None else emb[c],
                             gmc_warp=None if warps is None else warps[c],
                             plain=self.plain_kernels)
            new.append(ts)
            ids.append(i)
        return tuple(new), torch.stack(ids)

    def masks(self, ctx: torch.Tensor, det: Detections
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(C, D, H, W) bool full-resolution instance masks, eroded by a
        k x k element when `erode_kernel` k > 0, from the mask model's
        context (`mask_model.context`: the protos, or SAM's embeddings); and
        SAM's low-resolution logits (C, D, 256, 256), None on the proto
        path."""
        out, low = self.mask_model.masks(ctx, det)
        k = self.cfg.pipeline.erode_kernel
        return (erode_mask(out, k) if k > 0 else out), low

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
            dc = tree.index(det, c)
            sets.append(ObjectSet(points=buf.points,
                                  valid=buf.valid & dc.valid[:, None],
                                  class_id=dc.classes,
                                  present=dc.valid & (buf.count > 0),
                                  track_id=track_ids[c]))
            ovfs.append(ovf.sum(dtype=torch.int32))
        return tree.stack(sets), torch.stack(ovfs)

    def workspace_clouds(self, depth, calib: CameraCalib
                         ) -> Tuple[PointBuffer, torch.Tensor]:
        """Strided cloud -> robot frame -> AABB crop -> voxel dedupe (K1),
        per camera. With accumulation and `accum_skip_prededupe` (and no
        workspace SOR, whose statistics count duplicates), a grid that fits
        the buffer skips the dedupe: its rays are snapped to voxel centres
        in place and the accumulator's merge dedupes them."""
        p = self.cfg.pipeline
        raw = p.workspace_accumulate and p.accum_skip_prededupe and not p.workspace_sor
        s = p.workspace_stride
        depth_s = strided_grid_downsample(depth, s)
        bufs, ovfs = [], []
        for i in range(depth.shape[0]):
            sd = scalar_like(float(s), depth_s)
            xyz, valid = backproject_depth_grid(
                depth_s[i], calib.fx[i] / sd, calib.fy[i] / sd,
                calib.cx[i] / sd, calib.cy[i] / sd)
            pts = rigid_transform(xyz, calib.rotation[i], calib.translation[i])
            valid = valid & aabb_mask(pts, p.workspace_x_bounds,
                                      p.workspace_y_bounds, p.workspace_z_bounds)
            if raw and valid.numel() <= p.max_points_workspace:
                buf = _snapped_rays(pts, valid, p.voxel_size, p.max_points_workspace)
                ovf = torch.zeros((), dtype=torch.int32, device=valid.device)
            else:
                buf, ovf = voxel_downsample_grid(pts, valid, p.voxel_size,
                                                 p.max_points_workspace,
                                                 bound_m=p.dedupe_bound_m,
                                                 plain=self.plain_kernels)
            bufs.append(buf)
            ovfs.append(ovf)
        return tree.stack(bufs), torch.stack(ovfs)

    def fuse(self, per_cam: ObjectSet) -> Tuple[ObjectSet, PointBuffer, torch.Tensor]:
        """Fold the cameras' object sets pairwise, then flatten (K3 inside)."""
        p = self.cfg.pipeline
        with trace.span("fuse"):
            fused = tree.index(per_cam, 0)
            for c in range(1, self.cfg.rig.num_cameras):
                fused = fuse_centroid(fused, tree.index(per_cam, c),
                                      p.fusion_distance_threshold, p.sor_nb_neighbors,
                                      p.sor_std_ratio, plain=self.plain_kernels)
        with trace.span("fuse.flatten"):
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

    def accumulate(self, state: PipelineState, ws_out: PointBuffer
                   ) -> Tuple[PipelineState, PointBuffer, torch.Tensor]:
        """With `workspace_accumulate`, fold the subtracted workspace into
        the accumulator and publish its voxels at or above
        `accum_min_weight`; else pass the workspace through."""
        p = self.cfg.pipeline
        if not p.workspace_accumulate:
            return state, ws_out, torch.zeros((), dtype=torch.int32, device=ws_out.valid.device)
        acc, ovf = accumulate_voxels(state.accum, ws_out.points, ws_out.valid, p.voxel_size,
                                     p.dedupe_bound_m, decay=p.accum_decay,
                                     obs_weight=p.accum_obs_weight)
        state = PipelineState(trackers=state.trackers, prev_gray=state.prev_gray, accum=acc)
        return (state, extract_accumulated(acc, p.voxel_size, p.dedupe_bound_m,
                                           min_weight=p.accum_min_weight), ovf)

    # -- the fused step -------------------------------------------------

    def step(self, state: PipelineState, rgb: torch.Tensor, depth: torch.Tensor,
             calib: CameraCalib, stage: Optional[Callable[[str], ContextManager]] = None
             ) -> Tuple[PipelineState, FrameOutputs]:
        """One frame of every camera: rgb (C, H, W, 3) uint8 BGR, depth
        (C, H, W) f32 meters, both on the pipeline's device.

        `stage(name)`, when given, returns a context entered around each of
        the reference's stage groups, under its `timings.csv` name (the
        driver's profile mode times them); it does not change the outputs.
        A step handed `stage` is traced (`rt3d_torch.runtime.trace`): the
        groups are spans under the root `step`, the stages spans under
        them."""
        span = trace.span
        with torch.no_grad(), trace.step(stage is not None):
            stage = stage or _no_stage
            with stage("YOLO11 Inference"), span("YOLO11 Inference"):
                with span("preprocess"):
                    images = self.preprocess(rgb)
                det, protos, emb = self.detect(images)
                ctx = self.mask_model.context(rgb, protos)
                state, ids = self.track(state, det, det_emb=emb, images=images)
            with stage("Mask Processing"), span("Mask Processing"):
                with span("masks"):
                    masks, low_res = self.masks(ctx, det)
                with span("object_clouds"):
                    per_cam, obj_ovf = self.object_clouds(depth, masks, det, ids, calib)
            with stage("Point Cloud Processing"), span("Point Cloud Processing"):
                with span("workspace_clouds"):
                    ws, ws_ovf = self.workspace_clouds(depth, calib)
                with span("workspace_sor"):
                    ws_all = self.workspace_sor(tree.map(lambda x: x.flatten(0, 1), ws))
            with stage("Point Cloud Fusion"), span("Point Cloud Fusion"):
                fused, flat, flat_ovf = self.fuse(per_cam)
            with stage("Subtraction"), span("Subtraction"):
                with span("subtract"):
                    ws_out = self.subtract(ws_all, flat)
                with span("accumulate"):
                    state, ws_out, acc_ovf = self.accumulate(state, ws_out)
            overflow = obj_ovf.sum(dtype=torch.int32) + ws_ovf.sum(dtype=torch.int32) \
                + flat_ovf.to(torch.int32) + acc_ovf
        return state, FrameOutputs(
            detections=det, track_ids=ids, objects=fused, objects_flat=flat,
            workspace=ws_out, per_camera_objects=per_cam, overflow=overflow,
            low_res_logits=low_res)

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
        return state, tree.stack(outs)


def build_pipeline(cfg: Optional[Config] = None, weights: Optional[str] = None,
                   device="cuda", seed: int = 0,
                   plain_kernels: bool = False) -> Pipeline:
    """The pipeline for `cfg` on `device`: YOLO weights from a JAX-package
    ``.npz`` or an ultralytics ``.pt`` (`weights`, else
    `cfg.model.weights`), else random from `seed`; parameters cast to
    `cfg.model.compute_dtype`. With a SAM `mask_model`, SAM from
    `cfg.model.sam_weights`, else random from `cfg.model.sam_seed`.
    ``plain_kernels=True`` swaps every kernel for its plain PyTorch version;
    it exists for comparisons and is never the default."""
    cfg = cfg or Config()
    if cfg.tracker.tracker_type not in TRACKERS:
        raise ValueError(f"unknown tracker_type {cfg.tracker.tracker_type!r}; "
                         "expected 'bytetrack', 'botsort', or 'deepsort'")
    p = cfg.pipeline
    if p.workspace_accumulate and not packed2_fits(p.voxel_size, p.dedupe_bound_m):
        raise ValueError(
            "workspace_accumulate needs the two-word packed voxel grid: "
            f"voxel_size={p.voxel_size} with dedupe_bound_m={p.dedupe_bound_m} "
            "overflows int32 key words; use a coarser accumulation voxel or a "
            "tighter bound")
    device = torch.device(device)
    t = cfg.tracker
    if (device.type == "cuda" and not plain_kernels and t.assignment != "exact"
            and not greedy_fits(t.max_tracks, cfg.model.max_detections)):
        raise ValueError(
            f"max_tracks={t.max_tracks} x max_detections={cfg.model.max_detections} is over "
            "the greedy matching kernel's limit; use fewer track or detection slots")
    m = cfg.model
    sam = None if m.mask_model == "proto" else build_sam(
        m.mask_model, _DTYPES[m.compute_dtype], device, seed=m.sam_seed, weights=m.sam_weights)
    model = YoloSeg(variant=m.variant, num_classes=m.num_classes,
                    num_mask_coeffs=m.num_mask_coeffs, input_hw=m.input_hw)
    path = weights or m.weights
    if path:
        load_weights(model, path)
    else:
        init_random(model, seed)
    model = cast_for_inference(model, _DTYPES[m.compute_dtype], device)
    return Pipeline(cfg=cfg, model=model, device=device, plain_kernels=plain_kernels, sam=sam)
