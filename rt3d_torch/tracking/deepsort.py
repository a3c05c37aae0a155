"""DeepSORT over the fixed-slot tracker state (port of
`rt3d/tracking/deepsort.py`).

The first round matches confirmed (and lost) tracks to confident detections
by appearance: the cosine distance of the smoothed track embedding to the
detection's, gated by the chi-square 0.95 quantile of the squared
Mahalanobis distance to the track's predicted measurement, optionally
blended with it (`motion_lambda`), plus 1e-3 a frame since the track's
last update (the matching cascade's preference for recent tracks, as one
global assignment). The second round matches unconfirmed tracks and tracks
missed for one frame by IoU. The life cycle (predict, spawn, expiry) is
ByteTrack's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rt3d_torch.config import TrackerConfig
from rt3d_torch.models.postprocess import Detections, box_iou_matrix
from rt3d_torch.tracking.assignment import solve_matching
from rt3d_torch.tracking.botsort import embedding_distance
from rt3d_torch.tracking.bytetrack import (
    EMPTY, LOST, TRACKED, TrackerState, _apply_matches, _det_ids, _expire_lost,
    _matched_slots, _predict_tracks, _smooth_features, _spawn_new_tracks,
)
from rt3d_torch.tracking.kalman import gating_distance, xyah_to_xyxy, xyxy_to_xyah

GATE_2DOF = 5.9915  # chi-square 0.95 quantiles: (x, y) gating
GATE_4DOF = 9.4877  # full xyah gating
_INF_COST = 1e6


def deepsort_cost(ts: TrackerState, det_xyah: torch.Tensor, det_emb: torch.Tensor,
                  cfg: TrackerConfig) -> torch.Tensor:
    """(S, D) cost: (1 - lambda) appearance + lambda Mahalanobis / gate,
    infinite beyond the gate or `max_cosine_distance`, plus 1e-3 per frame
    since the track's last update."""
    app = embedding_distance(ts.emb, det_emb)
    maha = gating_distance(ts.mean, ts.cov, det_xyah, only_position=cfg.gate_only_position)
    gate = GATE_2DOF if cfg.gate_only_position else GATE_4DOF
    lam = cfg.motion_lambda
    cost = (1.0 - lam) * app + lam * (maha / gate)
    cost = torch.where(maha > gate, _INF_COST, cost)
    cost = torch.where(app > cfg.max_cosine_distance, _INF_COST, cost)
    age = (ts.frame_id - ts.last_update).float()
    return cost + 1e-3 * age[:, None]


def deepsort_step(ts: TrackerState, det: Detections, cfg: TrackerConfig,
                  frame_rate: int = 30, det_emb: Optional[torch.Tensor] = None,
                  gmc_warp: Optional[torch.Tensor] = None, plain: bool = False
                  ) -> Tuple[TrackerState, torch.Tensor]:
    """Advance one camera's DeepSORT tracker one frame; `bytetrack_step`'s
    contract. `det_emb` (D, E) is required."""
    if det_emb is None:
        raise ValueError("deepsort needs detection embeddings")
    s = ts.mean.shape[0]
    frame_id = ts.frame_id + 1
    ts = ts.replace(frame_id=frame_id)
    conf = det.valid & (det.scores >= cfg.track_high_thresh)
    det_xyah = xyxy_to_xyah(det.boxes)

    ts = _predict_tracks(ts, gmc_warp)
    was_tracked = ts.state == TRACKED
    confirmed = (was_tracked & ts.activated) | (ts.state == LOST)
    unconfirmed = was_tracked & ~ts.activated
    method = cfg.assignment

    cost1 = deepsort_cost(ts, det_xyah, det_emb, cfg)
    cost1 = torch.where(confirmed[:, None] & conf[None, :], cost1, _INF_COST)
    # the gate is the threshold: any finite cost may match
    _, r1 = solve_matching(cost1, _INF_COST * 0.5, method=method, plain=plain)
    r1_slot = _matched_slots(r1, s)
    ts = _apply_matches(ts, r1, det_xyah, det.scores, det.classes)

    recent_miss = confirmed & ~r1_slot & (frame_id - ts.last_update == 1)
    r2_rows = unconfirmed | recent_miss
    rem = conf & ~(r1 >= 0)
    iou_cost = 1.0 - box_iou_matrix(xyah_to_xyxy(ts.mean[:, :4]), det.boxes)
    iou_cost = torch.where(r2_rows[:, None] & rem[None, :], iou_cost, _INF_COST)
    _, r2 = solve_matching(iou_cost, cfg.match_thresh, method=method, plain=plain)
    r2_slot = _matched_slots(r2, s)
    ts = _apply_matches(ts, r2, det_xyah, det.scores, det.classes)

    miss = confirmed & ~r1_slot & ~r2_slot
    state = torch.where(miss & was_tracked, LOST, ts.state)
    state = torch.where(unconfirmed & ~r2_slot, EMPTY, state)
    ts = ts.replace(state=state.to(torch.int32))

    is_new = rem & ~(r2 >= 0) & (det.scores > cfg.new_track_thresh)
    ts, placeable, slot, ids_for_new = _spawn_new_tracks(
        ts, is_new, det_xyah, det.scores, det.classes, frame_id)
    ts = _smooth_features(ts, det_emb, (r1, r2), slot)
    ts = _expire_lost(ts, frame_id, cfg, frame_rate)
    return ts, _det_ids(ts, (r1, r2), placeable, ids_for_new, frame_id)
