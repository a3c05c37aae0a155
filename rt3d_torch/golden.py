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
  from its own run's object points (`ws_ties`). With accumulation
  (`accumulate` in the record) the published workspace holds voxels kept
  in earlier frames, so the tie may lie in any frame so far. `measure` also classes the
  rest: a point within the threshold of the other run's objects only, which
  differing object points explain (`ws_by_objects`), and any other
  (`ws_unexplained`, among them a point its own run should have
  subtracted). Both are faults here; the by-objects count serves the
  printed bf16 differences, whose object voxels move;
* overflow counters exact;
* with a tracker that uses them (the tracker presets' goldens record these
  extras), the detections' pooled embeddings within `EMB_ATOL` on the
  slots valid in both runs, the GMC warps (original pixels, after
  `rescale_warp`) within `WARP_ATOL` in their linear part and
  `WARP_SHIFT_ATOL` px in their translation, and the track IDs that ByteTrack
  alone gives on the run's own detections exact (`Probe`): the preset's
  IDs, which must differ from those on the golden's scene, show that it
  ran its own tracker.

A quantized preset's golden also stores the activation scales the JAX
package calibrated (`golden_act_scales`), so both runs quantize against
the same scales. It has bands of its own (`BANDS`): a 1-ulp difference of
an f32 activation moves its int8 rounding by one step where it lies on a
rounding tie.

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
# the step's appearance features (tests/test_torch_trackers.py)
EMB_ATOL = 1e-4
# GMC's warps in original pixels: the linear part within the CPU tests'
# 1e-3 on textured patches; the translation, which `rescale_warp` divides
# by ratio / 4 (0.125 at HD720), within 5e-3 of a 1/4-letterbox pixel
# (the CPU tests' bound on weakly textured patches, as the synthetic
# table's are) times 8: 0.04 px. Measured on the CPU against the
# 2cam_botsort golden: 8.2e-6 and 2.8e-3 px.
WARP_ATOL = 1e-3
WARP_SHIFT_ATOL = 0.04  # px
# the card's float32 calibration against a quantized golden's scales,
# relative (1.8e-6 measured on the CPU, 2.1e-6 on an NVIDIA H100 80GB
# HBM3 at 700 W)
CALIB_RTOL = 1e-4

# per-preset bands where a preset needs its own (the module docstring).
# 2cam_int8: an activation on a rounding tie moves one int8 step between
# the runs; in float32 its boxes moved 0.0148 px and its scores 1.67e-5
# over the golden's two frames on the CPU, 0.0177 px and 1.86e-5 on an
# NVIDIA H100 80GB HBM3 at 700 W, with every voxel and workspace point
# equal
BANDS: dict = {"2cam_int8": dict(box_max_px=0.1, score_max=1e-4)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def record(outs, subtraction_threshold: float, accumulate: bool = False,
           extras=None) -> dict:
    """The golden's arrays for a list of per-frame step outputs (the port's
    or the JAX package's `FrameOutputs`): per frame, the detections and
    track IDs of every camera, each fused slot's presence, class, track ID
    and valid points (concatenated in slot order, with per-slot counts),
    the kept workspace points (with `accumulate`, the accumulator's
    published voxels) and the overflow count; with `extras` (a dict per
    frame, `Probe.frames`), its ``det_emb``, ``gmc_warp`` and
    ``bytetrack_ids``."""
    rec = {"frames": np.int32(len(outs)),
           "subtraction_threshold": np.float64(subtraction_threshold),
           "accumulate": np.bool_(accumulate)}
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
        for key, v in (extras[i] if extras else {}).items():
            rec[f"f{i}_{key}"] = _np(v).astype(np.int32 if key == "bytetrack_ids"
                                              else np.float32)
    return rec


class Probe:
    """Records, per step of a port `Pipeline`, what a tracker preset's
    golden holds beside the outputs (`record`'s `extras`): the detections'
    embeddings (when the tracker uses ReID), the GMC warps per camera (when
    it uses GMC) and the track IDs that ByteTrack alone, with the preset's
    thresholds, gives on the same detections. It wraps the pipeline's
    `detect` and `_gmc_warps`; the step's outputs do not change."""

    def __init__(self, pipe):
        from rt3d_torch import tree
        from rt3d_torch.tracking.bytetrack import bytetrack_init, bytetrack_step

        t, fps = pipe.cfg.tracker, pipe.cfg.rig.cameras[0].fps
        self.frames: list = []
        trackers = [bytetrack_init(t.max_tracks, t.emb_dim, pipe.device)
                    for _ in range(pipe.cfg.rig.num_cameras)]
        detect, gmc_warps = pipe.detect, pipe._gmc_warps

        def probe_detect(images):
            det, protos, emb = detect(images)
            ids = []
            for c in range(len(trackers)):
                trackers[c], i = bytetrack_step(trackers[c], tree.index(det, c), t, frame_rate=fps)
                ids.append(i)
            frame = {"bytetrack_ids": torch.stack(ids)}
            if emb is not None:
                frame["det_emb"] = emb
            self.frames.append(frame)
            return det, protos, emb

        def probe_gmc_warps(prev_gray, gray):
            warps = gmc_warps(prev_gray, gray)
            self.frames[-1]["gmc_warp"] = torch.stack(warps)
            return warps

        pipe.detect = probe_detect
        pipe._gmc_warps = probe_gmc_warps


def golden_act_scales(g: dict) -> dict:
    """The activation scales a quantized preset's golden was made with."""
    return {str(p): float(v) for p, v in zip(g["act_paths"], g["act_scales"])}


def golden_path(preset: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{preset}.npz")


def encode_lattice(rec: dict, voxel_size: float) -> dict:
    """`rec` with each frame's object and workspace points, when every row is
    a voxel centre ``f32(q) * f32(voxel_size)`` of integer indices q, stored
    as those indices' row differences (``*_lattice``, int32; the workspace
    rows sorted first, as it is compared as a set), which compress to a
    small fraction of the floats. `load_golden` restores the floats bit for
    bit."""
    v = np.float32(voxel_size)
    out = dict(rec, voxel_size=np.float64(voxel_size))
    for key in [k for k in rec if k.endswith(("_obj_points", "_ws_points"))]:
        pts = rec[key]
        q = np.rint(pts.astype(np.float64) / float(v)).astype(np.int32)
        if not np.array_equal(q.astype(np.float32) * v, pts):
            continue
        if key.endswith("_ws_points"):
            q = q[np.lexsort(q.T[::-1])]
        out[key[:-len("points")] + "lattice"] = np.diff(q, axis=0, prepend=np.zeros((1, 3), np.int32))
        del out[key]
    return out


def load_golden(preset: str) -> dict:
    """The recorded arrays of `preset` (a name of `PRESETS`), lattice-coded
    points (`encode_lattice`) restored to floats."""
    with np.load(golden_path(preset)) as z:
        g = {k: z[k] for k in z.files}
    for key in [k for k in g if k.endswith("_lattice")]:
        q = np.cumsum(g.pop(key), axis=0, dtype=np.int32)
        g[key[:-len("lattice")] + "points"] = q.astype(np.float32) * np.float32(g["voxel_size"])
    return g


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
    accumulate = bool(ref.get("accumulate", False))
    objs = {"ws_only_port": ([], []), "ws_only_golden": ([], [])}  # (own, other) per frame
    m = dict(frames=0, det_valid=0, det_class=0, track_id=0, box_max_px=0.0,
             score_max=0.0, slots=0, voxels_differing=0, voxel_slots_over=0,
             voxel_fraction_max=0.0, ws_kept=0, ws_only_port=0, ws_only_golden=0,
             ws_ties=0, ws_by_objects=0, ws_unexplained=0, overflow=0,
             extras_missing=0, emb_max=0.0, warp_max=0.0, warp_shift_max=0.0,
             bytetrack_id=0)
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
            # with accumulation a published voxel may come from the
            # decision of any frame so far: a tie or differing objects
            # in one of them explains it
            own_hist, other_hist = objs[key]
            own_hist.append(own)
            other_hist.append(other)
            frames = range(len(own_hist)) if accumulate else [len(own_hist) - 1]
            tie = np.zeros(len(only), bool)
            by_objects = np.zeros(len(only), bool)
            for j in frames:
                d2 = _min_d2(only, other_hist[j])
                kept_by_own = _min_d2(only, own_hist[j]) > thr2 - TIE_M2
                tie |= kept_by_own & (np.abs(d2 - thr2) < TIE_M2)
                by_objects |= kept_by_own & (d2 <= thr2)
            by_objects &= ~tie
            m["ws_ties"] += int(tie.sum())
            m["ws_by_objects"] += int(by_objects.sum())
            m["ws_unexplained"] += int((~tie & ~by_objects).sum())
        m["overflow"] += int(g["overflow"] != r["overflow"])
        # a tracker preset's extras
        for key in ("det_emb", "gmc_warp", "bytetrack_ids"):
            if key in r and key not in g:
                m["extras_missing"] += 1
        if "det_emb" in r and "det_emb" in g and both.any():
            m["emb_max"] = max(m["emb_max"], float(
                np.abs(g["det_emb"] - r["det_emb"])[both].max()))
        if "gmc_warp" in r and "gmc_warp" in g:
            d = np.abs(g["gmc_warp"] - r["gmc_warp"])
            m["warp_max"] = max(m["warp_max"], float(d[..., :2].max()))
            m["warp_shift_max"] = max(m["warp_shift_max"], float(d[..., 2].max()))
        if "bytetrack_ids" in r and "bytetrack_ids" in g:
            m["bytetrack_id"] += int((g["bytetrack_ids"] != r["bytetrack_ids"]).sum())
    return m


def check_bands(m: dict, preset: str = "") -> None:
    """Raise unless the measured differences `m` lie within the bands (of
    `preset` where `BANDS` has its own)."""
    band = {"box_max_px": BOX_ATOL, "score_max": SCORE_ATOL, "emb_max": EMB_ATOL,
            "warp_max": WARP_ATOL, "warp_shift_max": WARP_SHIFT_ATOL, **BANDS.get(preset, {})}
    faults = [f"{k} = {m[k]}" for k in ("det_valid", "det_class", "track_id", "slots",
                                        "voxel_slots_over", "ws_by_objects",
                                        "ws_unexplained", "overflow", "extras_missing",
                                        "bytetrack_id")
              if m.get(k, 0) > band.get(k, 0)]
    for key in ("box_max_px", "score_max", "emb_max", "warp_max", "warp_shift_max"):
        if m.get(key, 0.0) > band[key]:
            faults.append(f"{key} = {m[key]} > {band[key]}")
    if not m["frames"]:
        faults.append("no common frame")
    if faults:
        raise AssertionError("outputs differ from the golden beyond its bands: "
                             + "; ".join(faults) + f" (measured {m})")


def compare_to_golden(outs, golden: dict, extras=None, preset: str = "") -> dict:
    """Hold the port's per-frame outputs `outs` (and a `Probe`'s `extras`)
    against `golden` (from `load_golden`), frame by frame from frame 0;
    returns the measured differences and raises beyond the bands."""
    m = measure(record(outs, float(golden["subtraction_threshold"]),
                       bool(golden.get("accumulate", False)), extras), golden)
    check_bands(m, preset)
    return m


# ---------------------------------------------------------------------------
# The training step's golden (`train_x`)
# ---------------------------------------------------------------------------
#
# One training step of yolo11x-seg from the committed weights, the JAX
# package's in float32 on the CPU (`tools/make_torch_golden.py --preset
# train_x`): the loss and its parts, the global gradient norm, each
# parameter leaf's gradient and parameter L2 norms, the whole gradient of
# the head's last biases, and each leaf's L2 change after one update of
# the trainer's optimizer (`synth_optimizer` at warm-up 0: the first
# update has the full learning rate). The batch is both cameras of scene 1 (hard) of
# `build_synth_dataset(**TRAIN_DATA)`, letterboxed in float32 and not
# augmented; the golden holds its SHA-256 hashes, not the batch.

TRAIN_GOLDEN = "train_x"
TRAIN_WEIGHTS = os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz")
TRAIN_DATA = dict(num_scenes=2, frames_per_scene=1, hw=(720, 1280), seed=0, domain="mix")
TRAIN_SAMPLES = (2, 3)
TRAIN_OPT = dict(lr=1e-3, warmup=0, steps=800)
TRAIN_GRAD_LEAVES = tuple(f"23/{b}/{i}/2/bias" for b in ("cv2", "cv3", "cv4") for i in range(3))
TRAIN_TARGETS = ("box", "box_w", "inst_id", "inst_cls", "inst_mask", "inst_box")
# bands of the card's float32 step (TF32 off) against the golden: the loss
# and parts relative; the global and each leaf's gradient norm, and each
# leaf's update norm, relative; the head biases' gradients within
# TRAIN_GRAD_ATOL of the leaf's largest |g|. A leaf with no gradient moves
# by its weight decay alone, lr * wd = 1e-7 of each element, under half an
# f32 ulp: p + u rounds to p or to a neighbour, differently in optax's
# order and in torch's (which decays by an f32 1 - lr * wd first). So an
# update norm may also differ by TRAIN_UPDATE_ULPS f32 ulps (2^-23) of the
# leaf's parameter norm.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3
TRAIN_GRAD_ATOL = 1e-3
TRAIN_UPDATE_ULPS = 2


def train_batch(ds: dict) -> dict:
    """The golden's samples of a `build_synth_dataset(**TRAIN_DATA)`
    result: the raw images and the targets."""
    idx = list(TRAIN_SAMPLES)
    return {k: np.ascontiguousarray(ds[k][idx]) for k in ("images",) + TRAIN_TARGETS}


def batch_hashes(batch: dict) -> dict:
    """SHA-256 of each array of `batch` (its dtype, shape and bytes)."""
    import hashlib

    out = {}
    for k, v in batch.items():
        h = hashlib.sha256(f"{v.dtype.str}{v.shape}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
        out[k] = h.hexdigest()
    return out


def train_record(loss: float, parts: dict, grads: dict, updates: dict, params: dict,
                 hashes: dict) -> dict:
    """The arrays of a `train_x` golden. `grads`, `updates` and `params`
    (before the update) map the JAX package's flat parameter names to
    numpy arrays; norms are taken in float64."""
    names = sorted(grads)
    norm = lambda a: float(np.sqrt(np.sum(np.square(np.asarray(a, np.float64)))))  # noqa: E731
    rec = {"loss": np.float64(loss), "names": np.array(names),
           "grad_norms": np.array([norm(grads[k]) for k in names]),
           "update_norms": np.array([norm(updates[k]) for k in names]),
           "param_norms": np.array([norm(params[k]) for k in names])}
    rec["grad_global_norm"] = np.float64(np.sqrt(np.sum(rec["grad_norms"] ** 2)))
    for k, v in parts.items():
        rec[f"part_{k}"] = np.float64(v)
    for k in TRAIN_GRAD_LEAVES:
        rec[f"grad/{k}"] = np.asarray(grads[k], np.float32)
    for k, v in hashes.items():
        rec[f"hash_{k}"] = np.array(v)
    return rec


def measure_train(got: dict, ref: dict) -> dict:
    """The largest differences of train record `got` from `ref`: relative
    for the loss, parts and norms, relative to each leaf's largest |g| for
    the head biases' gradients; the count of batch hashes that differ, and
    of leaves whose update norm lies beyond its band (``update_norm_over``,
    the band in the comment on TRAIN_UPDATE_ULPS). ``update_norm_rel`` is
    taken over the leaves with a gradient. Where the golden's gradient is
    0 (the mask-coefficient branches of levels 2 and 3 when every selected
    positive anchor is on level 1), any gradient is a difference beyond
    every band."""
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))  # noqa: E731
    if list(got["names"]) != list(ref["names"]):
        raise AssertionError("train record: the parameter names differ from the golden's")
    parts = [k for k in ref if k.startswith("part_")]
    moving = ref["grad_norms"] > 0
    return {
        "hashes_differing": sum(str(got.get(k, "")) != str(ref[k])
                                for k in ref if k.startswith("hash_")),
        "loss_rel": max(rel(got[k], ref[k]) for k in ["loss"] + parts),
        "grad_global_rel": rel(got["grad_global_norm"], ref["grad_global_norm"]),
        "grad_norm_rel": rel(got["grad_norms"], ref["grad_norms"]),
        "update_norm_rel": rel(got["update_norms"][moving], ref["update_norms"][moving]),
        "update_norm_over": int(np.sum(
            np.abs(got["update_norms"] - ref["update_norms"])
            > TRAIN_NORM_RTOL * ref["update_norms"]
            + TRAIN_UPDATE_ULPS * 2.0 ** -23 * ref["param_norms"])),
        "grad_leaf_max": max(float(np.max(np.abs(got[f"grad/{k}"] - ref[f"grad/{k}"]))
                                   / max(np.max(np.abs(ref[f"grad/{k}"])), 1e-30))
                             for k in TRAIN_GRAD_LEAVES),
    }


def check_train_bands(m: dict) -> None:
    band = {"loss_rel": TRAIN_LOSS_RTOL, "grad_global_rel": TRAIN_NORM_RTOL,
            "grad_norm_rel": TRAIN_NORM_RTOL, "update_norm_over": 0,
            "grad_leaf_max": TRAIN_GRAD_ATOL, "hashes_differing": 0}
    faults = [f"{k} = {m[k]} > {v}" for k, v in band.items() if not m[k] <= v]
    if faults:
        raise AssertionError("the training step differs from the train_x golden: "
                             + "; ".join(faults) + f" (measured {m})")
