"""Synthetic training data: analytic scenes -> dense YOLO11-seg targets
(numpy port of `rt3d/train/data.py`).

`SyntheticSource` gives pixel-perfect instance masks for free
(`gt_masks_all`); this module turns them into the dense per-anchor targets
`rt3d_torch.train.loss` consumes. Given the same seed it gives the same
arrays as the JAX package's module, bit for bit: the same numpy draws in
the same order, on the port's own copy of the synthetic source.

Assignment: an anchor is positive for the smallest ground-truth box whose
interior holds the anchor centre and whose visible mask covers it (the box
interior when no centre lands on the mask, the nearest stride-8 anchor
when none lands in the box); positives carry one-hot class, clipped ltrb
DFL bin targets and the index of their instance, so the loss can
supervise sigmoid(coeff . proto) against that instance's mask.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from rt3d_torch.io.synthetic import SyntheticSource
from rt3d_torch.models.postprocess import LetterboxMeta, letterbox_params
from rt3d_torch.models.yolo import REG_MAX, STRIDES

PROTO_STRIDE = 4


def _anchor_grid_np(input_hw: Tuple[int, int]):
    pts, strs = [], []
    h, w = input_hw
    for s in STRIDES:
        gh, gw = h // s, w // s
        ys = np.arange(gh, dtype=np.float32) + 0.5
        xs = np.arange(gw, dtype=np.float32) + 0.5
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1) * s)
        strs.append(np.full((gh * gw,), float(s), np.float32))
    return np.concatenate(pts), np.concatenate(strs)


def _mask_to_box(mask: np.ndarray) -> Optional[np.ndarray]:
    """xyxy box (original-image pixels) of a boolean mask, None if it has
    fewer than 4 pixels."""
    ys, xs = np.nonzero(mask)
    if len(ys) < 4:
        return None
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)


def _proto_sample_idx(meta: LetterboxMeta):
    """Original-image pixel indices sampled by each proto-grid cell
    (nearest), and whether the cell lies inside the image."""
    dh, dw = meta.dst_hw
    hp, wp = dh // PROTO_STRIDE, dw // PROTO_STRIDE
    px = (np.arange(wp, dtype=np.float32) + 0.5) * PROTO_STRIDE
    py = (np.arange(hp, dtype=np.float32) + 0.5) * PROTO_STRIDE
    ox = np.round((px - meta.pad_left) / meta.ratio - 0.5).astype(np.int64)
    oy = np.round((py - meta.pad_top) / meta.ratio - 0.5).astype(np.int64)
    sh, sw = meta.src_hw
    ox_c = np.clip(ox, 0, sw - 1)
    oy_c = np.clip(oy, 0, sh - 1)
    inside = ((ox >= 0) & (ox < sw))[None, :] & ((oy >= 0) & (oy < sh))[:, None]
    return oy_c, ox_c, inside


def targets_for_masks(
    masks: np.ndarray,        # (N, H, W) bool, original-image instance masks
    classes: np.ndarray,      # (N,) int
    meta: LetterboxMeta,
    input_hw: Tuple[int, int],
    num_classes: int,
    max_instances: int,
) -> Dict[str, np.ndarray]:
    """Dense targets for ONE image: ``cls`` (A, nc), ``box`` (A, 4) ltrb in
    stride units, ``box_w`` (A,), ``inst_id`` (A,) (-1 background),
    ``inst_cls`` (M,), ``inst_mask`` (M, hp, wp) and ``inst_box`` (M, 4)
    xyxy in letterboxed-input pixels."""
    a_pts, a_str = _anchor_grid_np(input_hw)
    a = len(a_pts)
    hp, wp = input_hw[0] // PROTO_STRIDE, input_hw[1] // PROTO_STRIDE

    cls_t = np.zeros((a, num_classes), np.float32)
    box_t = np.zeros((a, 4), np.float32)
    box_w = np.zeros((a,), np.float32)
    inst_id = np.full((a,), -1, np.int32)
    inst_cls = np.zeros((max_instances,), np.int32)
    inst_masks = np.zeros((max_instances, hp, wp), np.float32)
    inst_boxes = np.zeros((max_instances, 4), np.float32)

    oy, ox, inside = _proto_sample_idx(meta)
    # anchor centres in original-image pixels, for the on-mask constraint
    sh, sw = meta.src_hw
    ax_o = np.round((a_pts[:, 0] - meta.pad_left) / meta.ratio).astype(np.int64)
    ay_o = np.round((a_pts[:, 1] - meta.pad_top) / meta.ratio).astype(np.int64)
    a_in_img = (ax_o >= 0) & (ax_o < sw) & (ay_o >= 0) & (ay_o < sh)
    ax_c = np.clip(ax_o, 0, sw - 1)
    ay_c = np.clip(ay_o, 0, sh - 1)
    assigned_area = np.full((a,), np.inf, np.float32)
    m_used = 0
    for k in range(len(masks)):
        if m_used >= max_instances:
            break
        box_o = _mask_to_box(masks[k])
        if box_o is None:
            continue
        b = box_o * meta.ratio
        b[0::2] += meta.pad_left
        b[1::2] += meta.pad_top
        area = (b[2] - b[0]) * (b[3] - b[1])
        if area < 4.0:
            continue
        mi = m_used
        m_used += 1
        inst_cls[mi] = int(classes[k])
        inst_boxes[mi] = b
        inst_masks[mi] = (masks[k][oy[:, None], ox[None, :]] & inside)
        hit = (
            (a_pts[:, 0] >= b[0]) & (a_pts[:, 0] < b[2])
            & (a_pts[:, 1] >= b[1]) & (a_pts[:, 1] < b[3])
            & (area < assigned_area)
        )
        # keep only positives whose centre lies on the instance's visible
        # pixels, else the box interior
        on_mask = hit & a_in_img & masks[k][ay_c, ax_c]
        if on_mask.any():
            hit = on_mask
        if not hit.any():
            # tiny or distant object: the nearest anchor of the finest level
            c = np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2])
            fine = a_str == STRIDES[0]
            d2 = ((a_pts - c) ** 2).sum(axis=1)
            d2[~fine] = np.inf
            hit = np.zeros((a,), bool)
            hit[int(np.argmin(d2))] = True
        assigned_area[hit] = area
        cls_t[hit] = 0.0
        cls_t[hit, int(classes[k])] = 1.0
        ltrb = np.stack(
            [a_pts[:, 0] - b[0], a_pts[:, 1] - b[1],
             b[2] - a_pts[:, 0], b[3] - a_pts[:, 1]], axis=-1
        ) / a_str[:, None]
        box_t[hit] = np.clip(ltrb[hit], 0.0, REG_MAX - 1 - 1e-3)
        box_w[hit] = 1.0
        inst_id[hit] = mi

    return {
        "cls": cls_t, "box": box_t, "box_w": box_w, "inst_id": inst_id,
        "inst_cls": inst_cls, "inst_mask": inst_masks,
        "inst_box": inst_boxes,
    }


def build_synth_dataset(
    model,
    num_scenes: int = 16,
    frames_per_scene: int = 4,
    hw: Tuple[int, int] = (720, 1280),
    num_cameras: int = 2,
    max_instances: int = 4,
    seed: int = 0,
    noise: float = 0.02,
    domain: str = "easy",
) -> Dict[str, np.ndarray]:
    """Renders scenes and returns stacked host arrays: ``images`` (N, H, W,
    3) raw BGR uint8 frames (the trainer letterboxes them with the
    inference path's `preprocess_frame`) and the targets of
    `targets_for_masks` but ``cls``, which the loss rebuilds from
    ``inst_id``, ``inst_cls`` and ``box_w``. `model` gives ``input_hw`` and
    ``num_classes``.

    `domain`: "easy" (flat-shaded top-down scenes), "hard" (occlusion,
    texture, lighting, distractor classes) or "mix" (3/4 hard, 1/4 easy:
    scene s is easy when s % 4 == 0). Hard scenes supervise distractors
    with their own classes.
    """
    rng = np.random.default_rng(seed)
    meta = letterbox_params(hw, model.input_hw)
    # hard scenes add up to 3 distractor instances on top of the targets
    inst_cap = max_instances + (0 if domain == "easy" else 3)
    images, targets = [], []
    for s in range(num_scenes):
        hard = domain == "hard" or (domain == "mix" and s % 4 != 0)
        n_obj = int(rng.integers(1, max_instances + 1))
        src = SyntheticSource(
            num_cameras=num_cameras, num_frames=None, hw=hw,
            num_objects=n_obj, seed=seed * 1000 + s,
            domain="hard" if hard else "easy",
        )
        classes = src.all_classes.astype(np.int64)
        for _ in range(frames_per_scene):
            idx = int(rng.integers(0, 3000))
            pkt = src.get(idx)
            gt = src.gt_masks_all(idx)  # (C, M, H, W) visible masks
            for c in range(num_cameras):
                img = pkt.rgb[c]
                if noise:
                    jitter = rng.normal(0.0, noise * 255.0, img.shape)
                    img = np.clip(img.astype(np.float32) + jitter, 0, 255).astype(np.uint8)
                images.append(img)
                targets.append(targets_for_masks(
                    gt[c], classes, meta, model.input_hw, model.num_classes, inst_cap))
    out = {"images": np.stack(images)}
    for k in targets[0]:
        if k != "cls":  # the (A, nc) one-hot would dominate the dataset
            out[k] = np.stack([t[k] for t in targets])
    return out
