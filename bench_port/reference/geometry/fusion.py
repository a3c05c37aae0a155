"""Two-camera object fusion by centroid matching.

PyTorch port of `rt3d/geometry/fusion.py`: objects group by class; a class
seen exactly once by each camera fuses unconditionally, otherwise cam1 slots
claim, in slot order, the nearest unclaimed same-class cam2 slot within the
distance threshold. Matched pairs and unmatched cam1 objects go through SOR
(one K3 launch over all cam1-side slots); unmatched cam2 objects pass raw.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from bench_port.reference.geometry.ops import PointBuffer, compact_points, masked_centroid
from bench_port.reference.geometry.sor import sor_inlier_mask_slots

_INF = 3.4e38


@dataclass
class ObjectSet:
    """Padded object clouds: S slots of K points.

    points (S, K, 3) f32, valid (S, K) bool, class_id (S,) int32,
    present (S,) bool, track_id (S,) int32 (-1 if none)."""

    points: torch.Tensor
    valid: torch.Tensor
    class_id: torch.Tensor
    present: torch.Tensor
    track_id: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.points.shape[0]

    @property
    def point_capacity(self) -> int:
        return self.points.shape[1]


def _class_counts(class_id, present, query):
    """For each query class value, how many present slots share it."""
    eq = (class_id[None, :] == query[:, None]) & present[None, :]
    return eq.sum(1, dtype=torch.int32)


def _match_gates(set1: ObjectSet, set2: ObjectSet, distance_threshold: float):
    """Centroid distances (S1, S2) and per-pair feasibility: same class,
    cam2 slot present, within the threshold or the one-vs-one fast path."""
    c1 = masked_centroid(set1.points, set1.valid)
    c2 = masked_centroid(set2.points, set2.valid)
    n1 = _class_counts(set1.class_id, set1.present, set1.class_id)
    n2 = _class_counts(set2.class_id, set2.present, set1.class_id)
    one_v_one = (n1 == 1) & (n2 == 1)
    dist0 = torch.linalg.vector_norm(c1[:, None, :] - c2[None, :, :], dim=-1)
    gated0 = (set2.present[None, :]
              & (set2.class_id[None, :] == set1.class_id[:, None])
              & (one_v_one[:, None] | (dist0 < distance_threshold)))
    return dist0, gated0


def greedy_centroid_match(set1: ObjectSet, set2: ObjectSet,
                          distance_threshold: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slot-order spec: cam1 slots in order each claim the nearest
    feasible unclaimed cam2 slot (lowest index on ties). Returns
    (match_idx (S1,) int32, -1 unmatched; matched2 (S2,) bool)."""
    dist0, gated0 = _match_gates(set1, set2, distance_threshold)
    s1, s2 = dist0.shape
    dev = dist0.device
    cols = torch.arange(s2, device=dev)
    matched2 = torch.zeros(s2, dtype=torch.bool, device=dev)
    match = []
    inf = torch.full_like(dist0[0], _INF)
    for i in range(s1):
        dist = torch.where(gated0[i] & ~matched2, dist0[i], inf)
        j = torch.argmin(dist).view(1)  # 1-element: no read-back to the host
        found = set1.present[i] & (dist.gather(0, j) < _INF)
        match.append(torch.where(found, j, -1))
        matched2 = matched2 | (found & (cols == j))
    match_idx = (torch.cat(match) if match
                 else torch.zeros(0, dtype=torch.int64, device=dev))
    return match_idx.to(torch.int32), matched2


def fuse_centroid(set1: ObjectSet, set2: ObjectSet, distance_threshold: float,
                  sor_nb_neighbors: int = 20, sor_std_ratio: float = 1.5,
                  apply_sor: bool = True, plain: bool = False) -> ObjectSet:
    """Fuse two cameras' object sets into S1 + S2 slots of K1 + K2 points:
    slots [0, S1) hold cam1 objects with their matched cam2 points, slots
    [S1, S1 + S2) the unmatched cam2 objects."""
    s1, k1 = set1.num_slots, set1.point_capacity
    s2 = set2.num_slots
    match_idx, matched2 = greedy_centroid_match(set1, set2, distance_threshold)

    safe_idx = torch.clamp_min(match_idx, 0).long()
    partner_pts = set2.points[safe_idx]
    partner_valid = set2.valid[safe_idx] & (match_idx >= 0)[:, None]
    fused1_pts = torch.cat([set1.points, partner_pts], dim=1)
    fused1_valid = torch.cat([set1.valid, partner_valid], dim=1)

    left2_present = set2.present & ~matched2
    pad2 = torch.zeros((s2, k1, 3), dtype=torch.float32, device=set2.points.device)
    left2_pts = torch.cat([set2.points, pad2], dim=1)
    left2_valid = torch.cat(
        [set2.valid & left2_present[:, None],
         torch.zeros((s2, k1), dtype=torch.bool, device=set2.valid.device)], dim=1)

    points = torch.cat([fused1_pts, left2_pts], dim=0)
    valid = torch.cat([fused1_valid & set1.present[:, None], left2_valid], dim=0)
    class_id = torch.cat([set1.class_id, set2.class_id])
    present = torch.cat([set1.present, left2_present])
    track_id = torch.cat([set1.track_id, set2.track_id])

    if apply_sor:
        # only the cam1-side slots (fused pairs, lone cam1 objects) are
        # filtered; unmatched cam2 objects pass through raw
        sor_mask = sor_inlier_mask_slots(
            points[:s1].contiguous(), valid[:s1].contiguous(),
            sor_nb_neighbors, sor_std_ratio, plain=plain)
        valid1 = torch.where(set1.present[:, None], sor_mask, valid[:s1])
        valid = torch.cat([valid1, valid[s1:]], dim=0)

    return ObjectSet(points=points, valid=valid, class_id=class_id,
                     present=present, track_id=track_id)


def flatten_objects(objs: ObjectSet, capacity: int
                    ) -> Tuple[PointBuffer, torch.Tensor]:
    """All live object points in one compacted buffer of `capacity` rows.
    Returns (buffer, overflow)."""
    flat_pts = objs.points.reshape(-1, 3)
    flat_valid = (objs.valid & objs.present[:, None]).reshape(-1)
    return compact_points(flat_pts, flat_valid, capacity)
