"""The port's step held against recorded outputs of the JAX package's step.

`tools/make_torch_golden.py` runs the JAX package's `Pipeline.step` in
float32, op by op, on the CPU, over the first frames of each preset of
`rt3d_torch.pipeline.presets`, and writes `tests/golden_torch/<preset>.npz`
with `record`. Here the port's outputs go through the same `record`, and
`measure` puts every difference between the two in one dict of numbers.
`compare_to_golden` raises when a difference lies beyond these bands:

* detections: the valid slots, their classes and every track ID exact;
  boxes within `BOX_ATOL` px and scores within `SCORE_ATOL` (f32
  convolutions summed in another order, on the CPU and on the card);
* fused objects: the present slots, their classes and track IDs exact. Within
  a slot, a voxel of one run missing from the other comes from a mask pixel
  on the other side of the 0.5 threshold (the masks are not recorded, so
  the cause is not checked); their count, both ways, is bounded per slot
  by `VOXEL_FRACTION` of the golden slot's voxels, rounded down;
* workspace: the kept points exact, except where the decision is a tie
  with the 6 cm threshold: a point that only one run keeps must lie within
  `TIE_M2` of the threshold's square (float64 squared distance) from the
  other run's object points, and beyond the threshold, up to the same tie,
  from its own run's object points (`ws_ties`). `measure` also classes the
  rest: a point within the threshold of the other run's objects only, which
  differing object points explain (`ws_by_objects`), and any other
  (`ws_unexplained`, among them a point its own run should have
  subtracted). Both are faults here; the by-objects count serves the
  printed bf16 differences, whose object voxels move;
* overflow counters exact.

The object points used to explain the workspace are the union of the
present slots' points, which is the flattened object buffer the
subtraction reads unless that buffer overflowed (then `overflow` differs
or is non-zero in both).
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden_torch")

# Measured in float32 with TF32 off on an NVIDIA H100 80GB HBM3 (700 W),
# `chip_smoke.py` phase 9, every preset over both frames: boxes at most
# 6.1e-5 px and scores 1.2e-7 from the golden, no object voxel differing,
# workspace differences all ties; on the CPU the same for 1cam frame 0.
BOX_ATOL = 1e-3       # px
SCORE_ATOL = 1e-5
VOXEL_FRACTION = 0.01
TIE_M2 = 1e-8         # m^2, float64 squared distance against threshold^2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def record(outs, subtraction_threshold: float) -> dict:
    """The golden's arrays for a list of per-frame step outputs (the port's
    or the JAX package's `FrameOutputs`): per frame, the detections and
    track IDs of every camera, each fused slot's presence, class, track ID
    and valid points (concatenated in slot order, with per-slot counts),
    the kept workspace points and the overflow count."""
    rec = {"frames": np.int32(len(outs)),
           "subtraction_threshold": np.float64(subtraction_threshold)}
    for i, o in enumerate(outs):
        d, objs = o.detections, o.objects
        present = _np(objs.present).astype(bool)
        valid = _np(objs.valid).astype(bool) & present[:, None]
        ws_valid = _np(o.workspace.valid).astype(bool)
        rec.update({
            f"f{i}_det_valid": _np(d.valid).astype(bool),
            f"f{i}_classes": _np(d.classes).astype(np.int32),
            f"f{i}_boxes": _np(d.boxes).astype(np.float32),
            f"f{i}_scores": _np(d.scores).astype(np.float32),
            f"f{i}_track_ids": _np(o.track_ids).astype(np.int32),
            f"f{i}_obj_present": present,
            f"f{i}_obj_class": _np(objs.class_id).astype(np.int32),
            f"f{i}_obj_track": _np(objs.track_id).astype(np.int32),
            f"f{i}_obj_counts": valid.sum(1).astype(np.int32),
            f"f{i}_obj_points": _np(objs.points).astype(np.float32)[valid],
            f"f{i}_ws_points": _np(o.workspace.points).astype(np.float32)[ws_valid],
            f"f{i}_overflow": np.int64(_np(o.overflow)),
        })
    return rec


def golden_path(preset: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{preset}.npz")


def load_golden(preset: str) -> dict:
    """The recorded arrays of `preset` (a name of `PRESETS`)."""
    with np.load(golden_path(preset)) as z:
        return {k: z[k] for k in z.files}


def _only(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows of (N, 3) float32 `a` beyond their count in `b`, compared by
    their bits (multisets: a fused slot holds a voxel once for each camera
    that sees it)."""
    def rows(x):
        x = np.ascontiguousarray(x, dtype=np.float32)
        return Counter(x.view(np.dtype((np.void, 12))).ravel().tolist())

    extra = rows(a) - rows(b)
    return np.frombuffer(b"".join(r * n for r, n in extra.items()),
                         np.float32).reshape(-1, 3)


def _min_d2(points: np.ndarray, refs: np.ndarray, chunk: int = 256) -> np.ndarray:
    """float64 squared distance of each point to its nearest ref (inf
    without refs)."""
    out = np.full(len(points), np.inf)
    if not len(refs) or not len(points):
        return out
    r = refs.astype(np.float64)
    for c0 in range(0, len(points), chunk):
        p = points[c0:c0 + chunk].astype(np.float64)
        out[c0:c0 + chunk] = ((p[:, None, :] - r[None]) ** 2).sum(-1).min(1)
    return out


def _slot_points(rec: dict, i: int) -> list:
    counts = rec[f"f{i}_obj_counts"]
    return np.split(rec[f"f{i}_obj_points"], np.cumsum(counts)[:-1])


def measure(got: dict, ref: dict) -> dict:
    """Every difference of record `got` from record `ref` over their
    common frames, as plain numbers (see the module docstring)."""
    thr2 = float(ref["subtraction_threshold"]) ** 2
    m = dict(frames=0, det_valid=0, det_class=0, track_id=0, box_max_px=0.0,
             score_max=0.0, slots=0, voxels_differing=0, voxel_slots_over=0,
             voxel_fraction_max=0.0, ws_kept=0, ws_only_port=0, ws_only_golden=0,
             ws_ties=0, ws_by_objects=0, ws_unexplained=0, overflow=0)
    for i in range(min(int(got["frames"]), int(ref["frames"]))):
        m["frames"] += 1
        g = {k[len(f"f{i}_"):]: v for k, v in got.items() if k.startswith(f"f{i}_")}
        r = {k[len(f"f{i}_"):]: v for k, v in ref.items() if k.startswith(f"f{i}_")}
        # detections and track IDs
        both = g["det_valid"] & r["det_valid"]
        m["det_valid"] += int((g["det_valid"] != r["det_valid"]).sum())
        m["det_class"] += int((g["classes"] != r["classes"])[both].sum())
        m["track_id"] += int((g["track_ids"] != r["track_ids"]).sum())
        if both.any():
            m["box_max_px"] = max(m["box_max_px"], float(
                np.abs(g["boxes"] - r["boxes"])[both].max()))
            m["score_max"] = max(m["score_max"], float(
                np.abs(g["scores"] - r["scores"])[both].max()))
        # fused slots
        same = (g["obj_present"] == r["obj_present"]) & (~r["obj_present"] | (
            (g["obj_class"] == r["obj_class"]) & (g["obj_track"] == r["obj_track"])))
        m["slots"] += int((~same).sum())
        for s, (gp, rp) in enumerate(zip(_slot_points(got, i), _slot_points(ref, i))):
            if not (same[s] and r["obj_present"][s]):
                continue
            n_d = len(_only(gp, rp)) + len(_only(rp, gp))
            m["voxels_differing"] += n_d
            m["voxel_fraction_max"] = max(m["voxel_fraction_max"], n_d / max(len(rp), 1))
            m["voxel_slots_over"] += int(n_d > int(VOXEL_FRACTION * len(rp)))
        # workspace: a point kept by one run only is a tie with the
        # threshold, or differing objects explain it, or neither
        m["ws_kept"] += len(r["ws_points"])
        for mine, theirs, own, other, key in (
                (g["ws_points"], r["ws_points"], g["obj_points"], r["obj_points"],
                 "ws_only_port"),
                (r["ws_points"], g["ws_points"], r["obj_points"], g["obj_points"],
                 "ws_only_golden")):
            only = _only(mine, theirs)
            m[key] += len(only)
            d2 = _min_d2(only, other)
            kept_by_own = _min_d2(only, own) > thr2 - TIE_M2
            tie = kept_by_own & (np.abs(d2 - thr2) < TIE_M2)
            by_objects = kept_by_own & ~tie & (d2 <= thr2)
            m["ws_ties"] += int(tie.sum())
            m["ws_by_objects"] += int(by_objects.sum())
            m["ws_unexplained"] += int((~tie & ~by_objects).sum())
        m["overflow"] += int(g["overflow"] != r["overflow"])
    return m


def check_bands(m: dict) -> None:
    """Raise unless the measured differences `m` lie within the bands."""
    faults = [f"{k} = {m[k]}" for k in ("det_valid", "det_class", "track_id", "slots",
                                        "voxel_slots_over", "ws_by_objects",
                                        "ws_unexplained", "overflow")
              if m[k]]
    if m["box_max_px"] > BOX_ATOL:
        faults.append(f"box_max_px = {m['box_max_px']} > {BOX_ATOL}")
    if m["score_max"] > SCORE_ATOL:
        faults.append(f"score_max = {m['score_max']} > {SCORE_ATOL}")
    if not m["frames"]:
        faults.append("no common frame")
    if faults:
        raise AssertionError("outputs differ from the golden beyond its bands: "
                             + "; ".join(faults) + f" (measured {m})")


def compare_to_golden(outs, golden: dict) -> dict:
    """Hold the port's per-frame outputs `outs` against `golden` (from
    `load_golden`), frame by frame from frame 0; returns the measured
    differences and raises beyond the bands."""
    m = measure(record(outs, float(golden["subtraction_threshold"])), golden)
    check_bands(m)
    return m
