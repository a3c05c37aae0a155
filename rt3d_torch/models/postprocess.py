"""Static-shape YOLO post-processing: letterbox, DFL decode, NMS, masks.

PyTorch port of `rt3d/models/yolo/postprocess.py`. Layouts are the JAX
package's (channels-last images, xyxy boxes). Two details keep it on the
reference's results:

* the HD720 -> 640x360 downscale uses ``antialias=True``, which is what
  `jax.image.resize` does when shrinking; the mask upsample needs none;
* `lax.top_k` orders ties by the lower index. `torch.topk` on CUDA promises
  no order for ties, so candidates are ranked by a stable descending sort.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch
import torch.nn.functional as F

from rt3d_torch.geometry.ops import scalar_like
from rt3d_torch.models.yolo import REG_MAX, STRIDES


@dataclass
class Detections:
    """Fixed-capacity detection set, score-sorted slots; boxes xyxy in
    ORIGINAL camera pixels. A leading camera axis when batched."""

    boxes: torch.Tensor    # (D, 4) f32
    scores: torch.Tensor   # (D,) f32
    classes: torch.Tensor  # (D,) int32
    coeffs: torch.Tensor   # (D, nm) f32
    valid: torch.Tensor    # (D,) bool

    def replace(self, **kw) -> "Detections":
        return replace(self, **kw)


@dataclass(frozen=True)
class LetterboxMeta:
    """Static letterbox geometry for one (src_hw -> dst_hw) pair
    (ultralytics LetterBox(auto=True))."""

    src_hw: Tuple[int, int]
    dst_hw: Tuple[int, int]
    ratio: float
    pad_top: int
    pad_left: int
    new_hw: Tuple[int, int]


def letterbox_params(src_hw, dst_hw) -> LetterboxMeta:
    sh, sw = src_hw
    dh, dw = dst_hw
    r = min(dh / sh, dw / sw)
    nh, nw = round(sh * r), round(sw * r)
    pad_h, pad_w = dh - nh, dw - nw
    return LetterboxMeta(src_hw=tuple(src_hw), dst_hw=tuple(dst_hw), ratio=r,
                         pad_top=pad_h // 2, pad_left=pad_w // 2, new_hw=(nh, nw))


def preprocess_frame(frame_bgr: torch.Tensor, meta: LetterboxMeta,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 3) BGR uint8 -> (dst_h, dst_w, 3) RGB in [0, 1] of `dtype`,
    letterboxed with the 114-gray fill. The antialiased resize runs in f32
    and its result is rounded to `dtype`."""
    img = frame_bgr.flip(-1).float()
    img = img / scalar_like(255.0, img)
    nh, nw = meta.new_hw
    img = F.interpolate(img.permute(2, 0, 1)[None], size=(nh, nw),
                        mode="bilinear", align_corners=False, antialias=True)
    dh, dw = meta.dst_hw
    pad_bottom = dh - nh - meta.pad_top
    pad_right = dw - nw - meta.pad_left
    img = F.pad(img[0].to(dtype), (meta.pad_left, pad_right, meta.pad_top, pad_bottom),
                value=114.0 / 255.0)
    return img.permute(1, 2, 0)


def anchor_grid(input_hw, device=None):
    """Anchor centres (A, 2) in input pixels and strides (A,)."""
    pts, strs = [], []
    h, w = input_hw
    for s in STRIDES:
        gh, gw = h // s, w // s
        ys = torch.arange(gh, dtype=torch.float32, device=device) + 0.5
        xs = torch.arange(gw, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        strs.append(torch.full((gh * gw,), float(s), device=device))
    return torch.cat(pts), torch.cat(strs)


def decode_predictions(input_hw, box_logits: torch.Tensor,
                       cls_logits: torch.Tensor):
    """DFL decode: (B, A, 64) logits -> xyxy boxes in letterboxed-input
    pixels; class logits -> sigmoid scores."""
    b, a, _ = box_logits.shape
    anchors, strides = anchor_grid(input_hw, box_logits.device)
    dist = torch.softmax(box_logits.reshape(b, a, 4, REG_MAX), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=box_logits.device)
    ltrb = (dist * bins).sum(-1)
    lt, rb = ltrb[..., :2], ltrb[..., 2:]
    x1y1 = (anchors[None] - lt) * strides[None, :, None]
    x2y2 = (anchors[None] + rb) * strides[None, :, None]
    return torch.cat([x1y1, x2y2], dim=-1), torch.sigmoid(cls_logits)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (Na, 4) x (Nb, 4) -> (Na, Nb)."""
    area_a = torch.clamp_min(a[:, 2] - a[:, 0], 0) * torch.clamp_min(a[:, 3] - a[:, 1], 0)
    area_b = torch.clamp_min(b[:, 2] - b[:, 0], 0) * torch.clamp_min(b[:, 3] - b[:, 1], 0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def _top_k(x: torch.Tensor, k: int):
    """`lax.top_k` on a 1-D tensor: descending, ties to the lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, coeffs: torch.Tensor,
              conf_thresh: float, iou_thresh: float, max_det: int,
              pre_topk: int = 128, class_mask: torch.Tensor | None = None
              ) -> Detections:
    """Exact greedy class-aware NMS with static shapes: each anchor's best
    allowed class, the top `pre_topk` by confidence, `max_det` greedy
    selection rounds."""
    if class_mask is not None:
        scores = torch.where(class_mask[None, :], scores, 0.0)
    pre_topk = min(pre_topk, boxes.shape[0])
    best_conf = scores.amax(-1)
    best_cls = torch.argmax(scores, dim=-1).to(torch.int32)
    cand = torch.where(best_conf >= conf_thresh, best_conf, 0.0)
    top_scores, top_idx = _top_k(cand, pre_topk)
    top_boxes = boxes[top_idx]
    top_cls = best_cls[top_idx]
    top_valid = top_scores > 0.0

    iou = box_iou_matrix(top_boxes, top_boxes)
    conflict = (iou > iou_thresh) & (top_cls[:, None] == top_cls[None, :])

    order = torch.arange(pre_topk, device=boxes.device)
    sup = torch.zeros(pre_topk, dtype=torch.bool, device=boxes.device)
    keep = torch.zeros_like(sup)
    for _ in range(min(max_det, pre_topk)):
        # the first available candidate is the best one left; only kept
        # candidates suppress, so this equals the classic keep recurrence
        # (indices stay 1-element tensors: indexing with a 0-dim tensor
        # would read it back to the host, a synchronization per round)
        avail = top_valid & ~sup & ~keep
        i = torch.argmax(avail.to(torch.uint8)).view(1)
        has = avail.gather(0, i)
        keep = keep | ((order == i) & has)
        sup = sup | (has & conflict.index_select(0, i)[0] & (order > i))

    final = torch.where(keep, top_scores, 0.0)
    k = min(max_det, pre_topk)
    sel_scores, sel = _top_k(final, k)
    pad = max_det - k

    def padded(t):
        if not pad:
            return t
        return torch.cat([t, torch.zeros((pad,) + t.shape[1:], dtype=t.dtype,
                                         device=t.device)])

    return Detections(
        boxes=padded(top_boxes[sel]), scores=padded(sel_scores),
        classes=padded(top_cls[sel]), coeffs=padded(coeffs[top_idx][sel]),
        valid=padded(sel_scores > 0.0))


def suppress_center_duplicates(det: Detections, dist_px: float) -> Detections:
    """Post-NMS same-class centre-distance suppression: slots in order, a
    live slot kills every later live slot of its class whose box centre lies
    within `dist_px`; only survivors suppress. The loop over the D slots
    stays on the device (no value is read back)."""
    d = det.valid.shape[0]
    cx = (det.boxes[:, 0] + det.boxes[:, 2]) * 0.5
    cy = (det.boxes[:, 1] + det.boxes[:, 3]) * 0.5
    d2 = (cx[:, None] - cx[None, :]) ** 2 + (cy[:, None] - cy[None, :]) ** 2
    same = det.classes[:, None] == det.classes[None, :]
    order = torch.arange(d, device=det.valid.device)
    later = order[None, :] > order[:, None]
    conflict = (d2 <= scalar_like(dist_px, d2) ** 2) & same & later
    alive = det.valid
    for i in range(d):
        alive = alive & ~(alive[i] & conflict[i])
    return det.replace(valid=alive, scores=torch.where(alive, det.scores, 0.0))


def boxes_to_original(boxes: torch.Tensor, meta: LetterboxMeta) -> torch.Tensor:
    """Letterboxed-input xyxy -> original-image xyxy, clipped."""
    sh, sw = meta.src_hw
    r = scalar_like(meta.ratio, boxes)
    x = (boxes[:, 0::2] - meta.pad_left) / r
    y = (boxes[:, 1::2] - meta.pad_top) / r
    return torch.stack([x[:, 0].clamp(0.0, sw), y[:, 0].clamp(0.0, sh),
                        x[:, 1].clamp(0.0, sw), y[:, 1].clamp(0.0, sh)], dim=-1)


def assemble_masks_retina(protos: torch.Tensor, coeffs: torch.Tensor,
                          boxes_orig: torch.Tensor, meta: LetterboxMeta,
                          resize_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full-resolution instance masks (ultralytics `retina_masks=True`):
    sigmoid(coeff . proto) in `resize_dtype`, letterbox padding cropped,
    bilinear upsample to the camera image, crop to the box, > 0.5.
    protos (Hp, Wp, nm), coeffs (D, nm), boxes (D, 4) -> (D, H, W) bool."""
    hp, wp, nm = protos.shape
    logits = torch.einsum("dn,hwn->dhw", coeffs.float(), protos.float())
    m = torch.sigmoid(logits).to(resize_dtype)
    stride = meta.dst_hw[0] // hp
    top, left = meta.pad_top // stride, meta.pad_left // stride
    nh, nw = meta.new_hw[0] // stride, meta.new_hw[1] // stride
    m = m[:, top:top + nh, left:left + nw]
    sh, sw = meta.src_hw
    m = F.interpolate(m[None], size=(sh, sw), mode="bilinear",
                      align_corners=False)[0]
    return (m > 0.5) & in_boxes(boxes_orig, (sh, sw))


def in_boxes(boxes: torch.Tensor, hw) -> torch.Tensor:
    """(..., H, W) bool: the pixels of an (H, W) image inside each (..., 4)
    box (x1 <= x < x2, y1 <= y < y2), the retina masks' crop."""
    ys = torch.arange(hw[0], dtype=torch.float32, device=boxes.device)[:, None]
    xs = torch.arange(hw[1], dtype=torch.float32, device=boxes.device)[None, :]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    return (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)


class ProtoMasks:
    """YOLO-seg's own mask model, the retina masks. A mask model (or
    `rt3d_torch.models.sam.SamMasks`) makes its `context` from the frames and
    the protos right after detect; `masks` gives from it every slot's (C, D,
    H, W) bool mask, cut to its box, and SAM's logits (None here)."""

    def __init__(self, meta: LetterboxMeta, resize_dtype: torch.dtype):
        self.meta, self.resize_dtype = meta, resize_dtype

    def context(self, rgb: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
        return protos

    def masks(self, protos: torch.Tensor, det: Detections) -> Tuple[torch.Tensor, None]:
        return torch.stack([
            assemble_masks_retina(protos[c], det.coeffs[c], det.boxes[c], self.meta,
                                  self.resize_dtype)
            for c in range(protos.shape[0])]), None
