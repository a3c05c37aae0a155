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
* a mask model with state (the reference's `PipelineState.mask_state` not
  None): its reference, fed the program's detections, track IDs, tracker
  state after the frame and mask state before it, gives masks and a mask
  state, held to the program's by `mask_state_int_diff` (integer and bool
  elements that differ) and `mask_state_rel` (the largest relative L2
  distance of a float leaf).
* fuse (K3), workspace (K1), subtract (K4) and accumulate: the reference
  fuses the program's per-camera objects and builds, subtracts and
  accumulates the workspace from the depth and the program's fused
  objects; each output equal to the program's.

Stages after detect read the program's outputs of the stage before only to
judge them, as a served model's tokens are read. The reference follows the
program step by step: each compared frame starts from the program's state
before it (trackers, accumulator, mask state), so that a frame deep in the
window needs no replay of it all. The start is checked on its own (frame 0
starts from the reference's own initial state), and so is every state the
step hands on (the tracker, accumulator and mask state after each compared
frame).

Voxels are compared as sets of integer lattice keys (round(p / voxel)).

The reference pipeline is the configuration's architecture's
(`arch/<name>.py`, `reference_pipeline`); `ReferencePipeline` below is
what the stages call on it. An architecture may add numbers of its own
(`ExtraNumbers`), which join those that a cell's limits may name. The
dataclasses of the reference's initial mask state are mapped from the
program's classes of the same name.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Dict, List, Protocol, Tuple

import torch

IOU_PAIR = 0.5
# relative L2 distance from the reference's mask coefficients beyond which a
# paired detection's coefficients count as off: about twice the bf16 median
COEFF_OFF = 0.01
# `mask_state_rel` of a float leaf that cannot be compared (a gap that is not
# finite, or another shape): the largest float32
STATE_REL_UNCOMPARABLE = 3.4028234663852886e38


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
    tensors cloned in their own dtype, None kept. A field that the
    reference's class has and the program's object lacks takes the
    reference's default; a field that the program has and the reference's
    class lacks is an error."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple):
        return tuple(to_reference(o, classes) for o in obj)
    name = type(obj).__name__
    if name not in classes or not dataclasses.is_dataclass(obj):
        raise ValueError(f"the reference has no class for the program's {name}")
    cls = classes[name]
    own = {f.name for f in dataclasses.fields(cls)}
    extra = [f.name for f in dataclasses.fields(obj) if f.name not in own]
    if extra:
        raise ValueError(f"the program's {name} has fields that the reference's lacks: "
                         f"{', '.join(extra)}")
    return cls(**{f.name: to_reference(getattr(obj, f.name), classes)
                  for f in dataclasses.fields(obj)})


def _dataclass_types(tree) -> List[type]:
    """The dataclass types in a tree of dataclasses and tuples."""
    if isinstance(tree, tuple):
        return [t for o in tree for t in _dataclass_types(o)]
    if not dataclasses.is_dataclass(tree):
        return []
    return [type(tree)] + [t for f in dataclasses.fields(tree)
                           for t in _dataclass_types(getattr(tree, f.name))]


def reference_classes(mask_state=None) -> Dict[str, type]:
    """The reference's state and output classes by name, to which
    `to_reference` maps the program's: the check's own and the dataclasses
    of the reference's initial mask state. Two classes of one name are an
    error."""
    from bench_port.reference.geometry.fusion import ObjectSet
    from bench_port.reference.geometry.ops import PointBuffer
    from bench_port.reference.geometry.voxel_sets import VoxelAccumulator
    from bench_port.reference.models.postprocess import Detections
    from bench_port.reference.pipeline.step import PipelineState
    from bench_port.reference.tracking.bytetrack import TrackerState

    every = list(dict.fromkeys((PipelineState, TrackerState, VoxelAccumulator, Detections,
                                ObjectSet, PointBuffer, *_dataclass_types(mask_state))))
    names = [c.__name__ for c in every]
    twice = sorted({n for n in names if names.count(n) > 1})
    if twice:
        raise ValueError(f"state classes named twice: {twice}")
    return dict(zip(names, every))


def _state_gaps(a, b) -> Tuple[int, float]:
    """(integer and bool elements that differ, the largest relative L2
    distance of a float leaf) between the program's mask state `a` and the
    reference's `b`, trees of tensors (dataclasses, tuples) of one shape;
    float leaves are compared in float32, whatever their dtype."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.is_floating_point() != b.is_floating_point():
            return max(a.numel(), b.numel(), 1), 0.0
        if not a.is_floating_point():
            return _differ(a, b), 0.0
        if a.shape != b.shape:
            return 0, STATE_REL_UNCOMPARABLE
        a, b = a.float(), b.float()
        rel = float((a - b).norm() / b.norm().clamp_min(1e-12))
        return 0, rel if math.isfinite(rel) else STATE_REL_UNCOMPARABLE
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        parts = [_state_gaps(x, y) for x, y in zip(a, b)]
    elif dataclasses.is_dataclass(a) and type(a).__name__ == type(b).__name__:
        parts = [_state_gaps(getattr(a, f.name), getattr(b, f.name))
                 for f in dataclasses.fields(b)]
    else:
        raise ValueError(f"the program's mask state ({type(a).__name__}) is not shaped as "
                         f"the reference's ({type(b).__name__})")
    return sum(p[0] for p in parts), max((p[1] for p in parts), default=0.0)


class Tally:
    """The compared numbers, accumulated frame by frame."""

    def __init__(self):
        self.det_unpaired = 0
        self.box, self.score, self.coeff = [], [], []
        self.obj_diff = self.obj_ref = 0
        self.exact = dict(track_ids=0, tracker_state=0, fused=0, workspace=0, accum=0)
        self.state_int, self.state_rel = None, 0.0
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

    def mask_state(self, p_state, r_state) -> None:
        gaps = _state_gaps(p_state, r_state)
        self.state_int = (self.state_int or 0) + gaps[0]
        self.state_rel = max(self.state_rel, gaps[1])

    def numbers(self) -> Dict[str, float]:
        med = lambda v: statistics.median(v) if v else 0.0  # noqa: E731
        out = dict(det_unpaired=self.det_unpaired,
                   box_px_med=med(self.box), score_med=med(self.score),
                   score_max=max(self.score, default=0.0), coeff_rel_med=med(self.coeff),
                   coeff_off_share=sum(v > COEFF_OFF for v in self.coeff) / max(len(self.coeff), 1),
                   obj_voxels=self.obj_diff / max(self.obj_ref, 1))
        out.update({f"{k}_diff": v for k, v in self.exact.items()})
        if self.state_int is not None:
            out.update(mask_state_int_diff=self.state_int, mask_state_rel=self.state_rel)
        return out


class ReferencePipeline(Protocol):
    """What `judge_frame` calls on an architecture's plain reference. The
    state and outputs it takes and gives are dataclasses of tensors whose
    classes carry the names of the program's (`compare` maps one to the
    other by name).

    A mask model with state across frames: the reference's `init_state`
    gives its initial state in `PipelineState.mask_state` (None: no state,
    and `masks` is called as for a model without), and the reference has
    `masks_with_state`. Whether the mask model has state is the reference's
    to say: the program's `PipelineState.mask_state` before and after every
    compared frame must then be set. It is a dataclass of tensors, or a
    tuple of them, that every step builds anew and never writes in place
    (`drive.Recorder` keeps references to the states before and after each
    sampled frame and copies nothing inside the window). Its float leaves
    may be in the compute dtype: they reach the reference as they are, and
    the reference reads them in float32."""

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

    def masks_with_state(self, ctx, det, track_ids, trackers, mask_state
                         ) -> Tuple[torch.Tensor, Any]:
        """Optional; only a mask model with state has it: (masks, the mask
        state after the frame), from the program's detections, its track
        IDs, its tracker states after the frame (the reference's classes)
        and its mask state before the frame (frame 0: `init_state`'s)."""

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
    of the program's detections and the program's outputs of the frame.
    For a mask model with state, and only then, `add` also gets the mask
    state before the frame (`mask_state`, as `masks_with_state` got it) as a
    keyword argument; the program's track IDs are in `outputs`."""

    def add(self, ref: ReferencePipeline, ctx, masks, outputs, **state) -> None: ...
    def numbers(self) -> Dict[str, float]: ...


def reference_pipeline(arch, config: Dict, cameras, device, weights: str) -> ReferencePipeline:
    """Architecture `arch`'s reference pipeline for configuration `config`:
    float32, TF32 off, the weights read from the same file as the
    program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return arch.reference_pipeline(config, cameras, device, weights)


def judge_frame(ref: ReferencePipeline, tally: Tally, kept, rgb, depth, classes,
                extra: ExtraNumbers = None, stateful: bool = False) -> None:
    """One compared frame, stage by stage; `stateful`: the reference's mask
    model has state."""
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
        p_trackers = to_reference(kept.after.trackers, classes)
        tally.exact["tracker_state"] += _differ(p_trackers, r_state.trackers)

        if not stateful:
            masks = ref.masks(ctx, p_det)
            if extra is not None:
                extra.add(ref, ctx, masks, p)
        else:
            p_mask = to_reference(getattr(kept.after, "mask_state", None), classes)
            if state.mask_state is None or p_mask is None:
                raise ValueError(f"frame {kept.frame}: the program hands on no mask state "
                                 f"{'into' if state.mask_state is None else 'out of'} it, "
                                 "where the reference's mask model has state")
            masks, r_mask = ref.masks_with_state(ctx, p_det, p.track_ids, p_trackers,
                                                 state.mask_state)
            tally.mask_state(p_mask, r_mask)
            if extra is not None:
                extra.add(ref, ctx, masks, p, mask_state=state.mask_state)
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
    mask_state = ref.init_state().mask_state
    classes = reference_classes(mask_state)
    tally = Tally()
    for k in kept:
        judge_frame(ref, tally, k, *frames_of(k.frame), classes, extra, mask_state is not None)
    numbers = tally.numbers()
    if extra is not None:
        own = extra.numbers()
        if set(own) & set(numbers):
            raise ValueError(f"extra numbers reuse the check's names: {sorted(set(own) & set(numbers))}")
        numbers.update(own)
    return numbers
