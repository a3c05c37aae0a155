"""ByteTrack over a fixed-slot tracker state (port of the ByteTrack branch of
`rt3d/tracking/bytetrack.py`).

Life cycle, as in ultralytics' BYTETracker: round 1 matches activated
tracked and lost tracks to high-score detections (fused IoU cost, gate
`match_thresh`); round 2 the remaining tracked ones to low-score detections
(IoU, gate 0.5); round 3 unconfirmed tracks to the leftover high detections
(gate 0.7). Unmatched tracked tracks become lost, unmatched unconfirmed ones
are removed, leftover high detections above `new_track_thresh` start tracks,
and lost tracks older than the buffer expire.

BoT-SORT runs through the same step: with detection embeddings (and
`with_reid`) the first round fuses the appearance cost and the tracks'
features are smoothed on match and spawn; with a GMC warp the predicted
tracks are motion-compensated before matching (`rt3d_torch.tracking.botsort`).
Without them the step is ByteTrack's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from rt3d_torch.config import TrackerConfig
from rt3d_torch.models.postprocess import Detections, box_iou_matrix
from rt3d_torch.tracking.assignment import solve_matching
from rt3d_torch.tracking.botsort import (
    apply_gmc_to_tracks, botsort_fuse_costs, embedding_distance, update_smooth_features,
)
from rt3d_torch.tracking.kalman import (
    kalman_initiate, kalman_predict, kalman_update, xyah_to_xyxy, xyxy_to_xyah,
)

EMPTY = 0
TRACKED = 1
LOST = 2


@dataclass
class TrackerState:
    mean: torch.Tensor         # (S, 8) Kalman mean
    cov: torch.Tensor          # (S, 8, 8) Kalman covariance
    score: torch.Tensor        # (S,) last matched detection score
    cls: torch.Tensor          # (S,) int32 class id
    track_id: torch.Tensor     # (S,) int32 persistent id
    state: torch.Tensor        # (S,) int32 {EMPTY, TRACKED, LOST}
    activated: torch.Tensor    # (S,) bool
    last_update: torch.Tensor  # (S,) int32 frame of last measurement
    emb: torch.Tensor          # (S, E) smoothed appearance features (BoT-SORT, DeepSORT)
    frame_id: torch.Tensor     # () int32
    next_id: torch.Tensor      # () int32

    def replace(self, **kw) -> "TrackerState":
        return replace(self, **kw)


def bytetrack_init(max_tracks: int, emb_dim: int = 64, device="cuda") -> TrackerState:
    s = max_tracks

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return TrackerState(
        mean=full((s, 8), 0.0, torch.float32), cov=full((s, 8, 8), 0.0, torch.float32),
        score=full((s,), 0.0, torch.float32), cls=full((s,), -1, torch.int32),
        track_id=full((s,), -1, torch.int32), state=full((s,), EMPTY, torch.int32),
        activated=full((s,), False, torch.bool), last_update=full((s,), 0, torch.int32),
        emb=full((s, emb_dim), 0.0, torch.float32), frame_id=full((), 0, torch.int32), next_id=full((), 1, torch.int32))


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")`` for idx in [0, len(dst)]: rows
    sent to index len(dst) are dropped."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    view = (-1,) + (1,) * (dst.dim() - 1)
    idx = idx.long().view(view).expand((idx.shape[0],) + dst.shape[1:])
    return ext.scatter(0, idx, src.to(dst.dtype).expand_as(idx).contiguous())[:n]


def _assoc_round(ts, det_boxes, det_scores, row_mask, col_mask, thresh,
                 fuse_score, method, det_emb=None, cfg=None, plain=False):
    """One association round: (col_of_row (S,), row_of_col (D,)). With
    `det_emb` and `cfg`, the IoU cost is fused with the appearance cost."""
    iou = box_iou_matrix(xyah_to_xyxy(ts.mean[:, :4]), det_boxes)
    cost = 1.0 - iou
    if fuse_score:
        cost = 1.0 - (1.0 - cost) * det_scores[None, :]
    if det_emb is not None and cfg is not None:
        cost = botsort_fuse_costs(cost, embedding_distance(ts.emb, det_emb),
                                  cfg.proximity_thresh, cfg.appearance_thresh)
    cost = torch.where(row_mask[:, None] & col_mask[None, :], cost, 1e6)
    return solve_matching(cost, thresh, method=method, plain=plain)


def _matched_slots(row_of_col: torch.Tensor, s: int) -> torch.Tensor:
    tgt = torch.where(row_of_col >= 0, row_of_col, s)
    return torch.zeros(s + 1, dtype=torch.bool, device=row_of_col.device).scatter(
        0, tgt.long(), row_of_col >= 0)[:s]


def _apply_matches(ts, row_of_col, det_xyah, det_scores, det_cls):
    """Kalman-update every matched slot with its detection; mark tracked."""
    s = ts.mean.shape[0]
    cols = torch.arange(row_of_col.shape[0], dtype=torch.int32, device=row_of_col.device)
    slot_det = _scatter_drop(torch.full((s,), -1, dtype=torch.int32, device=cols.device),
                             torch.where(row_of_col >= 0, row_of_col, s), cols)
    matched = slot_det >= 0
    di = torch.clamp(slot_det, 0, det_xyah.shape[0] - 1).long()
    new_mean, new_cov = kalman_update(ts.mean, ts.cov, det_xyah[di])
    return ts.replace(
        mean=torch.where(matched[:, None], new_mean, ts.mean),
        cov=torch.where(matched[:, None, None], new_cov, ts.cov),
        score=torch.where(matched, det_scores[di], ts.score),
        cls=torch.where(matched, det_cls[di], ts.cls),
        state=torch.where(matched, TRACKED, ts.state).to(torch.int32),
        activated=ts.activated | matched,
        last_update=torch.where(matched, ts.frame_id, ts.last_update))


def _predict_tracks(ts: TrackerState, gmc_warp: Optional[torch.Tensor] = None
                    ) -> TrackerState:
    """Kalman-predict every live slot (lost tracks get vh zeroed), then warp
    by the camera-motion estimate when one is given."""
    live = ts.state > EMPTY
    mean_in = ts.mean.clone()
    mean_in[:, 7] = torch.where(ts.state == TRACKED, ts.mean[:, 7], 0.0)
    pmean, pcov = kalman_predict(mean_in, ts.cov)
    if gmc_warp is not None:
        pmean, pcov = apply_gmc_to_tracks(pmean, gmc_warp, pcov)
    return ts.replace(mean=torch.where(live[:, None], pmean, ts.mean),
                      cov=torch.where(live[:, None, None], pcov, ts.cov))


def _spawn_new_tracks(ts, is_new, det_xyah, det_scores, det_cls, frame_id):
    """k-th new detection -> k-th empty slot. Returns (state, placeable,
    slot of each detection (S where none), ids_for_new)."""
    s = ts.mean.shape[0]
    empty_slots = ts.state == EMPTY
    slot_order = torch.sort(torch.where(empty_slots, 0, 1), stable=True).indices
    det_rank = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    n_empty = empty_slots.sum(dtype=torch.int32)
    placeable = is_new & (det_rank < n_empty)
    target_slot = slot_order[torch.clamp(det_rank, 0, s - 1).long()]
    new_mean, new_cov = kalman_initiate(det_xyah)
    slot = torch.where(placeable, target_slot, s)
    ids_for_new = ts.next_id + det_rank
    ts = ts.replace(
        mean=_scatter_drop(ts.mean, slot, new_mean),
        cov=_scatter_drop(ts.cov, slot, new_cov),
        score=_scatter_drop(ts.score, slot, det_scores),
        cls=_scatter_drop(ts.cls, slot, det_cls),
        track_id=_scatter_drop(ts.track_id, slot, ids_for_new),
        state=_scatter_drop(ts.state, slot, torch.full_like(det_cls, TRACKED)),
        activated=_scatter_drop(ts.activated, slot,
                                (frame_id == 1).expand(det_cls.shape)),
        last_update=_scatter_drop(ts.last_update, slot, frame_id.expand(det_cls.shape)),
        next_id=ts.next_id + placeable.sum(dtype=torch.int32))
    return ts, placeable, slot, ids_for_new


def _expire_lost(ts: TrackerState, frame_id: torch.Tensor, cfg: TrackerConfig,
                 frame_rate: int) -> TrackerState:
    """Free lost slots older than the buffer (frame_rate / 30 * track_buffer)."""
    max_lost = int(frame_rate / 30.0 * cfg.track_buffer)
    expired = (ts.state == LOST) & (frame_id - ts.last_update > max_lost)
    return ts.replace(state=torch.where(expired, EMPTY, ts.state).to(torch.int32),
                      track_id=torch.where(expired, -1, ts.track_id).to(torch.int32),
                      activated=ts.activated & ~expired)


def _smooth_features(ts: TrackerState, det_emb: torch.Tensor, rounds, slot) -> TrackerState:
    """The features' EMA over the slots matched in `rounds` (row_of_col of
    each round) and the new tracks' `slot`s."""
    s = ts.mean.shape[0]
    cols = torch.arange(det_emb.shape[0], dtype=torch.int32, device=det_emb.device)
    slot_det = torch.full((s,), -1, dtype=torch.int32, device=cols.device)
    for roc in rounds:
        slot_det = _scatter_drop(slot_det, torch.where(roc >= 0, roc, s), cols)
    fresh = _scatter_drop(torch.zeros(s, dtype=torch.bool, device=cols.device), slot,
                          torch.ones_like(cols, dtype=torch.bool))
    slot_det = _scatter_drop(slot_det, slot, cols)
    return ts.replace(emb=update_smooth_features(ts.emb, det_emb, slot_det, fresh))


def _det_ids(ts: TrackerState, rounds, placeable, ids_for_new, frame_id) -> torch.Tensor:
    """(D,) int32: each detection's track id when its slot is activated (a
    new track's only on frame 1), else -1."""
    s = ts.mean.shape[0]
    det_ids = None
    for roc in rounds:
        slot = torch.clamp(roc, 0, s - 1).long()
        ids = torch.where((roc >= 0) & ts.activated[slot], ts.track_id[slot], -1)
        det_ids = ids if det_ids is None else torch.maximum(det_ids, ids)
    new_ids = torch.where(placeable & (frame_id == 1), ids_for_new, -1)
    return torch.maximum(det_ids, new_ids).to(torch.int32)


def bytetrack_step(ts: TrackerState, det: Detections, cfg: TrackerConfig,
                   frame_rate: int = 30, det_emb: Optional[torch.Tensor] = None,
                   gmc_warp: Optional[torch.Tensor] = None, plain: bool = False
                   ) -> Tuple[TrackerState, torch.Tensor]:
    """Advance one camera's tracker one frame. Returns (new state, (D,)
    int32 id per detection slot, -1 when unmatched or not activated).
    `det_emb` (D, E), with `cfg.with_reid`, fuses appearance into the first
    round and smooths the features; `gmc_warp` (2, 3) warps the predicted
    tracks; ``plain=True`` keeps the greedy solves off their kernel. With
    greedy assignment and neither `det_emb` nor `gmc_warp` the step reads
    nothing back to the host, so a CUDA graph can hold it."""
    s = ts.mean.shape[0]
    use_reid = det_emb is not None and cfg.with_reid
    frame_id = ts.frame_id + 1
    ts = ts.replace(frame_id=frame_id)
    high = det.valid & (det.scores >= cfg.track_high_thresh)
    low = det.valid & (det.scores > cfg.track_low_thresh) & (
        det.scores < cfg.track_high_thresh)
    det_xyah = xyxy_to_xyah(det.boxes)

    ts = _predict_tracks(ts, gmc_warp)
    was_tracked = ts.state == TRACKED
    pool = (was_tracked & ts.activated) | (ts.state == LOST)
    unconfirmed = was_tracked & ~ts.activated
    method = cfg.assignment

    _, r1 = _assoc_round(ts, det.boxes, det.scores, pool, high,
                         cfg.match_thresh, cfg.fuse_score, method,
                         det_emb if use_reid else None, cfg if use_reid else None, plain)
    r1_slot = _matched_slots(r1, s)
    ts = _apply_matches(ts, r1, det_xyah, det.scores, det.classes)

    r2_rows = pool & was_tracked & ~r1_slot
    _, r2 = _assoc_round(ts, det.boxes, det.scores, r2_rows, low, 0.5, False, method,
                         plain=plain)
    r2_slot = _matched_slots(r2, s)
    ts = _apply_matches(ts, r2, det_xyah, det.scores, det.classes)
    ts = ts.replace(state=torch.where(r2_rows & ~r2_slot, LOST, ts.state).to(torch.int32))

    det_taken = (r1 >= 0) | (r2 >= 0)
    rem_high = high & ~det_taken
    _, r3 = _assoc_round(ts, det.boxes, det.scores, unconfirmed, rem_high, 0.7,
                         cfg.fuse_score, method, plain=plain)
    r3_slot = _matched_slots(r3, s)
    ts = _apply_matches(ts, r3, det_xyah, det.scores, det.classes)
    ts = ts.replace(state=torch.where(unconfirmed & ~r3_slot, EMPTY,
                                      ts.state).to(torch.int32))

    is_new = rem_high & (r3 < 0) & (det.scores > cfg.new_track_thresh)
    ts, placeable, slot, ids_for_new = _spawn_new_tracks(
        ts, is_new, det_xyah, det.scores, det.classes, frame_id)
    if use_reid:
        ts = _smooth_features(ts, det_emb, (r1, r2, r3), slot)
    ts = _expire_lost(ts, frame_id, cfg, frame_rate)
    return ts, _det_ids(ts, (r1, r2, r3), placeable, ids_for_new, frame_id)
