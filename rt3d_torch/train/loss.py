"""Detection + segmentation training objective for YOLO11-seg (port of
`rt3d/train/loss.py`).

A dense objective over the static anchor grid: per-anchor class BCE
normalized by the positive count, DFL cross-entropy of the box bins on
assigned anchors, and one of two mask terms: the legacy BCE of prototype
channel 0 against a foreground map, or the instance scheme's per-anchor
assembled-mask BCE cropped to the instance box, with a differentiable IoU
term and quality-aligned class targets.

Gradients follow the JAX package's at ties and zeros: `jnp.maximum` and
`jnp.minimum` split the gradient half and half between equal inputs, as
`torch.maximum`/`torch.minimum` do (`clamp` and `relu` do not), so every
``max(x, 0)`` is ``torch.maximum(x, 0)`` here; and `jnp.abs` has slope +1
at 0 where `torch.abs` has 0, so the BCE's ``|x|`` is `_abs`. At a zero
logit the two make the BCE's slope ``0.5 - t - 0.5``, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from rt3d_torch.models.yolo import REG_MAX

PROTO_STRIDE = 4


def _same(count: torch.Tensor) -> torch.Tensor:
    return count


def _maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.maximum(x, torch.full_like(x, v))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with `jnp.abs`'s slope at 0: +1."""
    return torch.where(x >= 0, x, -x)


def _bce(logit: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (_maximum(logit, 0.0) - logit * target
            + torch.log1p(torch.exp(-_abs(logit))))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take_along_axis(x, idx, axis=1)` for (B, N, ...) `x` and (B, K)
    indices: (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def seg_detection_loss(
    model,
    images: torch.Tensor,        # (B, H, W, 3)
    targets: Dict[str, torch.Tensor],
    num_mask_anchors: int = 32,
    total: Callable[[torch.Tensor], torch.Tensor] = _same,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of `model` on `images` and its parts.

    Every part is a sum over the batch divided by a count over the batch
    (positives, assignment weights, pixels). `total`, when given, maps a
    count of this batch to the count over the global batch that this one
    is a slice of (a sum over the data-parallel ranks): then each part is
    this slice's share of the global batch's, and the shares of all the
    slices sum to the loss of the global batch, gradients included. The
    counts carry no gradient. `targets`:

    box:    (B, A, 4)   ltrb distances in stride units, clipped to REG_MAX-1
    box_w:  (B, A)      anchor assignment weights (0 = background)
    and then ONE of the two mask-supervision schemes:
    cls:    (B, A, nc)  per-anchor class labels, with
    mask:   (B, hp, wp) a foreground map (prototype channel 0), OR
    inst_id:   (B, A)           instance index per positive anchor (-1 bg)
    inst_cls:  (B, M)           class of each instance
    inst_mask: (B, M, hp, wp)   per-instance masks at proto resolution
    inst_box:  (B, M, 4)        xyxy boxes in letterboxed-input pixels.
    A ``cls`` beside the instance targets takes the place of the rebuilt
    one-hot (and of its quality weighting).
    """
    box_logits, cls_logits, coeffs, protos = model(images)
    b, a, nc = cls_logits.shape

    if "cls" in targets:
        cls_t = targets["cls"]
    else:
        # the dense one-hot, rebuilt from the per-anchor instance assignment
        cid = _take(targets["inst_cls"], targets["inst_id"].clamp_min(0))       # (B, A)
        classes = torch.arange(nc, device=cid.device)
        cls_t = ((cid[..., None] == classes).float()
                 * (targets["box_w"] > 0)[..., None].float())
        # quality-aligned score targets: each positive's class target scaled
        # by its current box IoU, renormalized per instance
        if "inst_mask" in targets:
            pred_iou = _pred_box_iou(box_logits, targets)
            cls_t = cls_t * _alignment_quality(pred_iou.detach(), targets)[..., None]
    num_pos = _maximum(total(cls_t.sum()), 1.0)
    bce = _bce(cls_logits, cls_t).sum() / num_pos

    # box: cross-entropy of the DFL distribution against the two bins
    # around each target distance
    box_t = torch.clamp(targets["box"], 0, REG_MAX - 1 - 1e-3)
    logp = F.log_softmax(box_logits.reshape(b, a, 4, REG_MAX), dim=-1)
    lo = torch.floor(box_t).long()
    w_hi = box_t - lo
    ce = -(torch.gather(logp, -1, lo[..., None])[..., 0] * (1 - w_hi)
           + torch.gather(logp, -1, (lo + 1)[..., None])[..., 0] * w_hi)
    w = targets["box_w"]
    w_sum = _maximum(total(w.sum()), 1.0)
    box_loss = (ce.mean(dim=-1) * w).sum() / w_sum

    if "inst_mask" in targets:
        proto_loss = _instance_mask_loss(coeffs, protos, targets, num_mask_anchors, total)
        pred_iou = _pred_box_iou(box_logits, targets)
        iou_loss = ((1.0 - pred_iou) * w).sum() / w_sum
        loss = bce + box_loss + 2.5 * iou_loss + 0.5 * proto_loss
        return loss, {"cls": bce, "box": box_loss, "iou": iou_loss, "proto": proto_loss}
    # legacy: BCE of the first prototype channel against a foreground map
    px = _bce(protos[..., 0], targets["mask"])
    proto_loss = px.sum() / total(px.new_tensor(px.numel()))
    loss = bce + box_loss + 0.5 * proto_loss
    return loss, {"cls": bce, "box": box_loss, "proto": proto_loss}


def _pred_box_iou(box_logits: torch.Tensor, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, A) differentiable IoU between the decoded (DFL-expectation) box
    and the target box at each anchor; 0 off-assignment. Both boxes span
    [-l, r] x [-t, b] around the anchor in stride units."""
    b, a, _ = box_logits.shape
    dist = torch.softmax(box_logits.reshape(b, a, 4, REG_MAX), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=box_logits.device)
    pred = torch.einsum("bafr,r->baf", dist, bins)     # (B, A, 4) ltrb
    tgt = targets["box"]
    iw = torch.minimum(pred[..., 0], tgt[..., 0]) + torch.minimum(pred[..., 2], tgt[..., 2])
    ih = torch.minimum(pred[..., 1], tgt[..., 1]) + torch.minimum(pred[..., 3], tgt[..., 3])
    inter = _maximum(iw, 0.0) * _maximum(ih, 0.0)
    area_p = (pred[..., 0] + pred[..., 2]) * (pred[..., 1] + pred[..., 3])
    area_t = (tgt[..., 0] + tgt[..., 2]) * (tgt[..., 1] + tgt[..., 3])
    return inter / _maximum(area_p + area_t - inter, 1e-9) * targets["box_w"]


def _alignment_quality(iou: torch.Tensor, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, A) quality in [0, 1] of each positive anchor, without gradient:
    its box IoU over its instance's largest, so that every instance keeps
    one anchor at full target weight. Background 0.

    The per-instance max is `jax.ops.segment_max`: -inf on an instance with
    no anchor, which a scatter with ``include_self=False`` would leave at
    its initial value; starting from -inf and including it gives -inf
    there too. Background anchors (``inst_id`` -1) fold into instance 0
    with IoU 0, as in the JAX package; only anchors with ``box_w > 0`` read
    the result."""
    iou = iou.detach()
    w = targets["box_w"]
    m = targets["inst_mask"].shape[1]
    sid = targets["inst_id"].clamp_min(0).long()
    inst_max = torch.full((iou.shape[0], m), float("-inf"), dtype=iou.dtype, device=iou.device)
    inst_max = inst_max.scatter_reduce(1, sid, iou, "amax", include_self=True)
    denom = torch.gather(inst_max, 1, sid)
    return torch.where(w > 0, iou / _maximum(denom, 1e-6), torch.zeros_like(iou))


def _top_k(w: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: descending, ties to the lower index
    (a stable sort; `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(w, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _instance_mask_loss(
    coeffs: torch.Tensor,   # (B, A, nm)
    protos: torch.Tensor,   # (B, hp, wp, nm)
    targets: Dict[str, torch.Tensor],
    k: int,
    total: Callable[[torch.Tensor], torch.Tensor] = _same,
) -> torch.Tensor:
    """Per-anchor assembled-mask BCE, box-cropped and area-normalized, over
    a static top-k of the positive anchors of each image (anchors beyond
    the positive count carry zero weight)."""
    b, a, nm = coeffs.shape
    _, hp, wp, _ = protos.shape
    k = min(k, a)
    wk, idx = _top_k(targets["box_w"], k)                       # (B, k)
    sel_c = _take(coeffs, idx)                                  # (B, k, nm)
    sel_i = _take(targets["inst_id"], idx).clamp_min(0)         # (B, k)
    # an f32 product and sum, as the JAX einsum's preferred_element_type
    logits = torch.einsum("bkn,bhwn->bkhw", sel_c.float(), protos.float())
    gt = _take(targets["inst_mask"], sel_i)                     # (B, k, hp, wp)
    boxes = _take(targets["inst_box"], sel_i) / PROTO_STRIDE    # (B, k, 4)
    dev = protos.device
    ys = torch.arange(hp, dtype=torch.float32, device=dev)[:, None].expand(hp, wp) + 0.5
    xs = torch.arange(wp, dtype=torch.float32, device=dev)[None, :].expand(hp, wp) + 0.5
    x1, y1, x2, y2 = (boxes[..., i][..., None, None] for i in range(4))
    inbox = ((xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)).float()
    px = _bce(logits, gt) * inbox                                # (B, k, hp, wp)
    area = _maximum((x2 - x1) * (y2 - y1), 1.0)[..., 0, 0]       # (B, k)
    per_anchor = px.sum(dim=(-1, -2)) / area
    return (per_anchor * wk).sum() / _maximum(total(wk.sum()), 1.0)
