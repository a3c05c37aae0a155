"""What decides `correct`: the program's outputs on frames that the timed
path produced, judged stage by stage by the plain reference
(`bench_port.reference`: float32, TF32 off, every kernel's plain version)
on the same frames.

* detect: the reference's own detections from the frame, against the
  program's, paired per camera greedily by the reference's score with a
  same-class program detection of IoU 0.5 or more.
* masks and object clouds: the reference's own prototypes (float32) with
  the program's detections give per-camera object voxels, against the
  program's.
* track: the reference's trackers, fed the program's detections, from the
  state before the frame, give track IDs and a tracker state, each equal to
  the program's.
* fuse (K3), workspace (K1), subtract (K4) and accumulate: the reference
  fuses the program's per-camera objects and builds, subtracts and
  accumulates the workspace from the depth and the program's fused
  objects; each output equal to the program's.

Stages after detect read the program's outputs of the stage before only to
judge them, as a served model's tokens are read. The reference follows the
program step by step: each compared frame starts from the program's state
before it (trackers, accumulator), so that a frame deep in the window needs
no replay of it all. The start is checked on its own (frame 0 starts from
the reference's own initial state), and so is every state the step hands
on (the tracker and accumulator state after each compared frame).

Voxels are compared as sets of integer lattice keys (round(p / voxel)).

The reference pipeline is the configuration's architecture's
(`arch/<name>.py`, `reference_pipeline`); `ReferencePipeline` below is
what the stages call on it. An architecture may add numbers of its own
(`ExtraNumbers`), which join those that a cell's limits may name.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Protocol, Tuple

import torch

IOU_PAIR = 0.5
# relative L2 distance from the reference's mask coefficients beyond which a
# paired detection's coefficients count as off: about twice the bf16 median
COEFF_OFF = 0.01


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda x: (x[:, 2:] - x[:, :2]).clamp_min(0).prod(-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp_min(1e-9)


def _keys(points: torch.Tensor, valid: torch.Tensor, voxel: float) -> torch.Tensor:
    """Sorted unique int64 lattice keys of the valid points."""
    p = points.reshape(-1, 3)[valid.reshape(-1)].double()
    ijk = torch.round(p / voxel).long() + (1 << 20)
    return torch.unique((ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2])


def _symdiff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((~torch.isin(a, b)).sum()) + int((~torch.isin(b, a)).sum())


def _differ(a, b) -> int:
    """Elements that differ between two equal-shaped trees of tensors
    (dataclasses, tuples); NaN equals NaN."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return max(a.numel(), b.numel(), 1)
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        return int((~same).sum())
    if isinstance(a, (tuple, list)):
        return sum(_differ(x, y) for x, y in zip(a, b))
    return sum(_differ(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))


def pair_detections(p, r, c: int) -> List[Tuple[int, int]]:
    """(program slot, reference slot) pairs of camera c."""
    pv = torch.nonzero(p.valid[c]).flatten().tolist()
    rv = torch.nonzero(r.valid[c]).flatten().tolist()
    if not pv or not rv:
        return []
    iou = _iou(r.boxes[c][rv].double(), p.boxes[c][pv].double()).cpu()
    rcls, pcls = r.classes[c][rv].cpu(), p.classes[c][pv].cpu()
    order = torch.argsort(r.scores[c][rv].cpu(), descending=True, stable=True).tolist()
    used, pairs = set(), []
    for i in order:
        best, bj = IOU_PAIR, None
        for j in range(len(pv)):
            if j not in used and pcls[j] == rcls[i] and iou[i, j] >= best:
                best, bj = float(iou[i, j]), j
        if bj is not None:
            used.add(bj)
            pairs.append((pv[bj], rv[i]))
    return pairs


def to_reference(obj, classes: Dict[str, type]):
    """The program's dataclasses as the reference's (by class name),
    tensors cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple):
        return tuple(to_reference(o, classes) for o in obj)
    cls = classes[type(obj).__name__]
    return cls(**{f.name: to_reference(getattr(obj, f.name), classes)
                  for f in dataclasses.fields(obj)})


class Tally:
    """The compared numbers, accumulated frame by frame."""

    def __init__(self):
        self.det_unpaired = 0
        self.box, self.score, self.coeff = [], [], []
        self.obj_diff = self.obj_ref = 0
        self.exact = dict(track_ids=0, tracker_state=0, fused=0, workspace=0, accum=0)
        self.frames = 0

    def detect(self, p, r) -> None:
        for c in range(p.valid.shape[0]):
            pairs = pair_detections(p, r, c)
            self.det_unpaired += int(p.valid[c].sum()) + int(r.valid[c].sum()) - 2 * len(pairs)
            for i, j in pairs:
                self.box.append(float((p.boxes[c, i] - r.boxes[c, j]).abs().max()))
                self.score.append(abs(float(p.scores[c, i] - r.scores[c, j])))
                dc = (p.coeffs[c, i].float() - r.coeffs[c, j]).norm()
                self.coeff.append(float(dc / r.coeffs[c, j].norm().clamp_min(1e-6)))

    def objects(self, p_objs, r_objs, valid, voxel: float) -> None:
        for c in range(valid.shape[0]):
            for i in torch.nonzero(valid[c]).flatten().tolist():
                a = _keys(p_objs.points[c, i], p_objs.valid[c, i], voxel)
                b = _keys(r_objs.points[c, i], r_objs.valid[c, i], voxel)
                self.obj_diff += _symdiff(a, b)
                self.obj_ref += int(b.numel())

    def numbers(self) -> Dict[str, float]:
        med = lambda v: statistics.median(v) if v else 0.0  # noqa: E731
        out = dict(det_unpaired=self.det_unpaired,
                   box_px_med=med(self.box), score_med=med(self.score),
                   score_max=max(self.score, default=0.0), coeff_rel_med=med(self.coeff),
                   coeff_off_share=sum(v > COEFF_OFF for v in self.coeff) / max(len(self.coeff), 1),
                   obj_voxels=self.obj_diff / max(self.obj_ref, 1))
        out.update({f"{k}_diff": v for k, v in self.exact.items()})
        return out


class ReferencePipeline(Protocol):
    """What `judge_frame` calls on an architecture's plain reference. The
    state and outputs it takes and gives are dataclasses of tensors whose
    classes carry the names of the program's (`compare` maps one to the
    other by name)."""

    cfg: Any       # the stated config; `cfg.pipeline.voxel_size` is read
    device: Any

    def calib(self): ...
    def init_state(self): ...
    def preprocess(self, rgb: torch.Tensor) -> torch.Tensor: ...

    def detect(self, images: torch.Tensor) -> Tuple[Any, Any, Any]:
        """(detections, mask context, ReID embeddings or None). The mask
        context is opaque to the check and handed back to `masks`: YOLO's
        prototypes, or what a mask model needs of the image."""

    def track(self, state, det, det_emb=None, images=None) -> Tuple[Any, torch.Tensor]: ...
    def masks(self, ctx, det) -> torch.Tensor: ...
    def object_clouds(self, depth, masks, det, track_ids, calib) -> Tuple[Any, Any]: ...
    def fuse(self, per_cam) -> Tuple[Any, Any, Any]: ...
    def workspace_clouds(self, depth, calib) -> Tuple[Any, Any]: ...
    def workspace_sor(self, ws_all): ...
    def subtract(self, workspace, objects_flat): ...
    def accumulate(self, state, ws_out) -> Tuple[Any, Any, Any]: ...


class ExtraNumbers(Protocol):
    """An architecture's own compared numbers (`arch/<name>.py` may define
    a class `ExtraNumbers` of this shape): `add` once a compared frame,
    after the mask stage, with the reference, its mask context, its masks
    of the program's detections and the program's outputs of the frame."""

    def add(self, ref: ReferencePipeline, ctx, masks, outputs) -> None: ...
    def numbers(self) -> Dict[str, float]: ...


def reference_pipeline(arch, config: Dict, cameras, device, weights: str) -> ReferencePipeline:
    """Architecture `arch`'s reference pipeline for configuration `config`:
    float32, TF32 off, the weights read from the same file as the
    program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return arch.reference_pipeline(config, cameras, device, weights)


def judge_frame(ref: ReferencePipeline, tally: Tally, kept, rgb, depth, classes,
                extra: ExtraNumbers = None) -> None:
    """One compared frame, stage by stage."""
    from bench_port.reference.geometry.ops import PointBuffer

    p, calib = kept.outputs, ref.calib()
    voxel = ref.cfg.pipeline.voxel_size
    rgb = torch.as_tensor(rgb, device=ref.device)
    depth = torch.as_tensor(depth, device=ref.device)
    state = ref.init_state() if kept.before is None else to_reference(kept.before, classes)
    p_det = to_reference(p.detections, classes)
    with torch.no_grad():
        images = ref.preprocess(rgb)
        r_det, ctx, emb = ref.detect(images)
        tally.detect(p.detections, r_det)

        r_state, r_ids = ref.track(state, p_det, det_emb=None, images=images)
        tally.exact["track_ids"] += _differ(p.track_ids, r_ids)
        tally.exact["tracker_state"] += _differ(to_reference(kept.after.trackers, classes),
                                                r_state.trackers)

        masks = ref.masks(ctx, p_det)
        if extra is not None:
            extra.add(ref, ctx, masks, p)
        r_objs, _ = ref.object_clouds(depth, masks, p_det, p.track_ids, calib)
        tally.objects(p.per_camera_objects, r_objs, p.detections.valid, voxel)

        r_fused, r_flat, _ = ref.fuse(to_reference(p.per_camera_objects, classes))
        tally.exact["fused"] += _differ(to_reference(p.objects, classes), r_fused)
        tally.exact["fused"] += _differ(to_reference(p.objects_flat, classes), r_flat)

        ws, _ = ref.workspace_clouds(depth, calib)
        ws_all = ref.workspace_sor(PointBuffer(points=ws.points.reshape(-1, 3),
                                               valid=ws.valid.reshape(-1)))
        r_sub = ref.subtract(ws_all, to_reference(p.objects_flat, classes))
        r_state, r_pub, _ = ref.accumulate(r_state, r_sub)
        tally.exact["workspace"] += _differ(to_reference(p.workspace, classes), r_pub)
        tally.exact["accum"] += _differ(to_reference(kept.after.accum, classes), r_state.accum)
    tally.frames += 1


def compare(kept, frames_of, ref: ReferencePipeline, extra: ExtraNumbers = None
            ) -> Dict[str, float]:
    """Judge each kept frame (`frames_of(g)` gives its rgb and depth); the
    numbers of `extra` join the check's own."""
    from bench_port.reference.geometry.fusion import ObjectSet
    from bench_port.reference.geometry.ops import PointBuffer
    from bench_port.reference.geometry.voxel_sets import VoxelAccumulator
    from bench_port.reference.models.postprocess import Detections
    from bench_port.reference.pipeline.step import PipelineState
    from bench_port.reference.tracking.bytetrack import TrackerState

    classes = {c.__name__: c for c in (PipelineState, TrackerState, VoxelAccumulator,
                                       Detections, ObjectSet, PointBuffer)}
    tally = Tally()
    for k in kept:
        judge_frame(ref, tally, k, *frames_of(k.frame), classes, extra)
    numbers = tally.numbers()
    if extra is not None:
        own = extra.numbers()
        if set(own) & set(numbers):
            raise ValueError(f"extra numbers reuse the check's names: {sorted(set(own) & set(numbers))}")
        numbers.update(own)
    return numbers
