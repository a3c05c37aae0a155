"""Frame annotation: boxes, track ids, mask tint, FPS overlay (port of
`rt3d/viz/draw.py`; numpy, and cv2 where it is installed).

The host-side analog of `Results.plot()` + the reference's overlay code
(`vision_pipeline_utils.py:357-373`). It consumes the padded Detections
arrays after their download to the host. Without cv2 (the card's machine
has none) the mask tint is drawn and the boxes, labels and FPS are not,
and `side_by_side` does not downscale, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# COCO class names the reference filters on (Bottle=39, Cup=41)
COCO_NAMES = {39: "bottle", 41: "cup", 42: "fork", 43: "knife", 44: "spoon",
              45: "bowl", 46: "banana"}

_PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0),
]


def optional_cv2():
    """cv2, or None where it is not installed (imported at first use)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _color(i: int):
    return _PALETTE[int(i) % len(_PALETTE)]


def annotate_frame(
    frame_bgr: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    track_ids: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,
    fps: Optional[float] = None,
) -> np.ndarray:
    """Returns an annotated copy of the frame."""
    img = np.ascontiguousarray(frame_bgr.copy())
    if masks is not None:
        for i in range(len(boxes)):
            if not valid[i]:
                continue
            m = masks[i].astype(bool)
            tint = np.asarray(_color(track_ids[i] if track_ids is not None else i))
            img[m] = (0.6 * img[m] + 0.4 * tint).astype(np.uint8)
    cv2 = optional_cv2()
    if cv2 is not None:
        for i in range(len(boxes)):
            if not valid[i]:
                continue
            x1, y1, x2, y2 = boxes[i].astype(int)
            c = _color(track_ids[i] if track_ids is not None else i)
            cv2.rectangle(img, (x1, y1), (x2, y2), c, 2)
            name = COCO_NAMES.get(int(classes[i]), str(int(classes[i])))
            tid = (f" id:{int(track_ids[i])}"
                   if track_ids is not None and track_ids[i] >= 0 else "")
            cv2.putText(img, f"{name} {scores[i]:.2f}{tid}", (x1, max(y1 - 6, 12)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, c, 1)
        if fps is not None:
            cv2.putText(img, f"FPS: {fps:.2f}", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
    return img


def side_by_side(frame1: np.ndarray, frame2: np.ndarray, scale: float = 0.5):
    """hconcat + downscale (the reference's combined view,
    `vision_pipeline_utils.py:370-373`)."""
    comb = np.concatenate([frame1, frame2], axis=1)
    cv2 = optional_cv2()
    if cv2 is not None and scale != 1.0:
        comb = cv2.resize(comb, (int(comb.shape[1] * scale), int(comb.shape[0] * scale)))
    return comb
