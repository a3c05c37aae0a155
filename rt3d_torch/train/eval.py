"""Detection-loop evaluation: the pipeline's own detections against the
analytic scene's truth (port of `tools/eval_synth.py`).

It runs `Pipeline.detect` and `Pipeline.masks`, the inference path of
`Pipeline.step`, and scores the predicted instance masks against
`SyntheticSource.gt_masks_all`:

* ``recall`` / ``mean_iou``: over target instances with at least
  `min_visible_px` visible pixels, the share matched by a same-class
  prediction with mask IoU >= 0.5, and the mean best IoU;
* ``precision`` = TP / (TP + FP) over all predictions, matched one to one
  in score order against all ground-truth instances (targets and
  distractors), the false positives split into ``fp_dup`` (same class,
  IoU >= 0.5 with an instance already claimed), ``fp_misclass`` (IoU >=
  0.5 with an instance of another class) and ``fp_ghost`` (no overlap);
* ``fp_per_frame``: all false positives over the frames.

Keeping the NMS survivors with score >= t is exactly the detection set of
NMS at conf_thresh = t, so one pass gives the rows of every threshold of
the sweep (``by_conf``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import numpy as np
import torch

from rt3d_torch.config import reference_2cam_config, with_cameras
from rt3d_torch.io.synthetic import SyntheticSource
from rt3d_torch.models.yolo import state_dict_from_npz
from rt3d_torch.pipeline.step import build_pipeline


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(max(union, 1))


def match_frame(
    gt_masks: np.ndarray,     # (M, H, W) bool: all instances, one camera
    gt_classes: np.ndarray,   # (M,) int
    pred_masks: np.ndarray,   # (D, H, W) bool, score-ordered
    pred_valid: np.ndarray,   # (D,) bool
    pred_classes: np.ndarray,  # (D,) int
    iou_thresh: float = 0.5,
) -> Dict[str, int]:
    """One-to-one greedy matching in score order. Returns TP/FP counts."""
    claimed = np.zeros(len(gt_masks), bool)
    tp = dup = misclass = ghost = 0
    for d in range(len(pred_masks)):
        if not pred_valid[d]:
            continue
        ious = (np.array([mask_iou(g, pred_masks[d]) for g in gt_masks])
                if len(gt_masks) else np.zeros((0,)))
        same = ious * (gt_classes == pred_classes[d])
        if len(same) and same.max() >= iou_thresh:
            k = int(np.argmax(same))
            if claimed[k]:
                dup += 1
            else:
                claimed[k] = True
                tp += 1
        elif len(ious) and ious.max() >= iou_thresh:
            misclass += 1
        else:
            ghost += 1
    return {"tp": tp, "fp_dup": dup, "fp_misclass": misclass, "fp_ghost": ghost}


def evaluate_weights(
    weights: Union[str, Mapping[str, np.ndarray]],
    variant: str = "n",
    hw=(720, 1280),
    input_hw=(384, 640),
    num_frames: int = 6,
    seed: int = 777,
    conf_thresh: float = 0.25,
    pipe=None,
    domain: str = "easy",
    min_visible_px: int = 64,
    max_objects: int = 3,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Recall, mean IoU, precision and the false-positive split (module
    docstring) of `weights` on `num_frames` fresh seeded scenes (held out
    from training by seed), each with 1 to `max_objects` targets; hard
    scenes add their own distractors. `weights` is a ``.npz`` path or a
    flat dict in the JAX package's layout; they run in `pipe`, or in the
    reference 2cam config with `variant`, `input_hw` and `conf_thresh` (in
    its bf16) on `device`."""
    if isinstance(weights, str):
        with np.load(weights) as z:
            weights = {k: z[k] for k in z.files}
    rng = np.random.default_rng(seed)
    sweep = [t for t in (0.25, 0.4, 0.6, 0.8) if t >= conf_thresh]
    ious = []
    matched = {t: 0 for t in sweep}
    total_gt = gt_small = 0
    counts = {t: {"tp": 0, "fp_dup": 0, "fp_misclass": 0, "fp_ghost": 0} for t in sweep}
    ndets = []
    for f in range(num_frames):
        n_obj = int(rng.integers(1, max_objects + 1))
        src = SyntheticSource(num_cameras=2, num_frames=None, hw=hw, num_objects=n_obj,
                              seed=int(seed) + f, domain=domain)
        if pipe is None:
            cfg = reference_2cam_config()
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, variant=variant, input_hw=tuple(input_hw), conf_thresh=conf_thresh))
            pipe = build_pipeline(with_cameras(cfg, src.cameras()), device=device)
        if f == 0:
            pipe.model.load_state_dict(state_dict_from_npz(weights), strict=True)
        idx = int(rng.integers(0, 3000))
        pkt = src.get(idx)
        gt_all = src.gt_masks_all(idx)     # (C, M, H, W)
        cls_all = src.all_classes          # (M,)
        with torch.no_grad():
            images = pipe.preprocess(torch.from_numpy(pkt.rgb).to(pipe.device))
            det, protos, _ = pipe.detect(images)
            pred_masks = pipe.masks(protos, det)[0].cpu().numpy()   # (C, D, H, W)
        det_valid = det.valid.cpu().numpy()
        det_cls = det.classes.cpu().numpy()
        det_scores = det.scores.cpu().numpy()
        ndets.append(int(det_valid.sum()))
        for c in range(2):
            for t in sweep:
                fm = match_frame(gt_all[c], cls_all, pred_masks[c],
                                 det_valid[c] & (det_scores[c] >= t), det_cls[c])
                for k in counts[t]:
                    counts[t][k] += fm[k]
            for k in range(n_obj):   # recall over targets only
                g = gt_all[c, k]
                npx = g.sum()
                if npx < min_visible_px:
                    gt_small += int(npx >= 16)
                    continue
                total_gt += 1
                best = {t: 0.0 for t in sweep}
                for d in range(pred_masks.shape[1]):
                    if not det_valid[c, d] or det_cls[c, d] != cls_all[k]:
                        continue
                    iou = mask_iou(g, pred_masks[c, d])
                    for t in sweep:
                        if det_scores[c, d] >= t:
                            best[t] = max(best[t], iou)
                ious.append(best[sweep[0]])
                for t in sweep:
                    if best[t] >= 0.5:
                        matched[t] += 1

    def row(t):
        cc = counts[t]
        n_fp = cc["fp_dup"] + cc["fp_misclass"] + cc["fp_ghost"]
        n_pred = cc["tp"] + n_fp
        return {
            "recall": matched[t] / max(total_gt, 1),
            "precision": cc["tp"] / max(n_pred, 1),
            "fp_per_frame": n_fp / max(num_frames, 1),
            "dup_rate": cc["fp_dup"] / max(n_pred, 1),
            **cc,
        }

    return {
        **row(sweep[0]),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "mean_dets": float(np.mean(ndets)) if ndets else 0.0,
        "gt_instances": total_gt,
        "gt_below_min_visible": gt_small,
        "min_visible_px": min_visible_px,
        "conf_thresh": conf_thresh,
        "domain": domain,
        "frames": num_frames,
        "by_conf": {f"{t:g}": row(t) for t in sweep[1:]},
    }
