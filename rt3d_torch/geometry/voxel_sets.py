"""Voxel-set operations: set-difference subtraction and persistent workspace
accumulation (port of `rt3d/geometry/voxel_sets.py`).

Voxel identity is the two-word packed key of `ops._quantize_packed2`,
sorted here as one int64 `ops.pair_key`.

* `subtract_voxel_sets` keeps workspace points whose voxel holds no object
  point: one stable sort of the object keys followed by the workspace keys
  (objects lead each run), a segmented OR of the object tag, and a scatter
  back to input order.
* `VoxelAccumulator` is a fixed-capacity key-sorted voxel set with weights.
  `accumulate_voxels` decays the weights, adds one observation weight per
  point of the frame, and merges by one stable sort with a segmented sum;
  `extract_accumulated` publishes the voxels at or above a weight.

The weights are f32 sums. The port sorts stably (the accumulator's row of a
voxel first, then the frame's points in input order) where the JAX package
sorts unstably, so a voxel's sum may differ from the JAX package's by the
rounding of another order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from rt3d_torch.geometry.ops import (
    DEFAULT_DEDUPE_BOUND_M, INT_SENTINEL, PAIR_SENTINEL, PointBuffer, _decode_packed2,
    _quantize_packed2, _run_starts, packed2_fits, packed_cells, pair_key,
    segmented_or_scan, segmented_sum_scan,
)
from rt3d_torch.runtime import trace


def _check_fits(voxel_size: float, bound_m: float, what: str) -> None:
    if not packed2_fits(voxel_size, bound_m):
        raise ValueError(
            f"{what}: voxel_size={voxel_size} with bound_m={bound_m} overflows even "
            "the two-word packed voxel grid (needs cells_per_axis^2 < 2^31); "
            "tighten the bound or coarsen the voxel")


def subtract_voxel_sets(workspace: PointBuffer, objects: PointBuffer,
                        voxel_size: float,
                        bound_m: float = DEFAULT_DEDUPE_BOUND_M) -> PointBuffer:
    """Keep workspace points whose voxel cell contains no object point."""
    _check_fits(voxel_size, bound_m, "subtract_voxel_sets")
    wh, wl, _, _ = _quantize_packed2(workspace.points, workspace.valid, voxel_size, bound_m)
    oh, ol, _, _ = _quantize_packed2(objects.points, objects.valid, voxel_size, bound_m)
    m = oh.shape[0]
    skey, src = torch.sort(pair_key(torch.cat([oh, wh]), torch.cat([ol, wl])), stable=True)
    poisoned = segmented_or_scan((src < m).to(torch.int32), _run_starts(skey)) > 0
    in_order = torch.empty_like(poisoned).scatter_(0, src, poisoned)
    return PointBuffer(points=workspace.points, valid=~in_order[m:] & workspace.valid)


@dataclass
class VoxelAccumulator:
    """Fixed-capacity persistent voxel set: two-word keys sorted ascending,
    the sentinel in both words marking an empty slot, and a weight each."""

    keys_hi: torch.Tensor  # (CAP,) int32
    keys_lo: torch.Tensor  # (CAP,) int32
    weight: torch.Tensor   # (CAP,) f32

    @property
    def capacity(self) -> int:
        return self.keys_hi.shape[0]

    @staticmethod
    def empty(capacity: int, device="cuda") -> "VoxelAccumulator":
        def full(v, dtype):
            return torch.full((capacity,), v, dtype=dtype, device=device)

        return VoxelAccumulator(keys_hi=full(INT_SENTINEL, torch.int32),
                                keys_lo=full(INT_SENTINEL, torch.int32),
                                weight=full(0.0, torch.float32))


def accumulate_voxels(acc: VoxelAccumulator, points: torch.Tensor, valid: torch.Tensor,
                      voxel_size: float, bound_m: float = DEFAULT_DEDUPE_BOUND_M,
                      decay: float = 0.98, obs_weight: float = 1.0
                      ) -> Tuple[VoxelAccumulator, torch.Tensor]:
    """Fold one frame's cloud into the accumulator: weights decay by
    `decay`, each valid point adds `obs_weight` to its voxel. When the
    merged set exceeds the capacity, the highest weights stay (ties to the
    smaller key) and the overflow counts the voxels evicted."""
    _check_fits(voxel_size, bound_m, "accumulate_voxels")
    cap = acc.capacity
    nh, nl, _, _ = _quantize_packed2(points, valid, voxel_size, bound_m)
    key = pair_key(torch.cat([acc.keys_hi, nh]), torch.cat([acc.keys_lo, nl]))
    obs = torch.where(nh != INT_SENTINEL, obs_weight, 0.0).to(torch.float32)
    w = torch.cat([acc.weight * decay, obs])
    skey, order = torch.sort(key, stable=True)
    total = segmented_sum_scan(w[order], _run_starts(skey))
    # run totals sit at run ends
    emit = torch.ones_like(skey, dtype=torch.bool)
    emit[:-1] = skey[1:] != skey[:-1]
    emit &= skey != PAIR_SENTINEL
    total_unique = emit.sum(dtype=torch.int32)
    # The branch is a host read of the count, once a frame: the JAX
    # package's `lax.cond` on the device.
    with trace.sync("voxel_sets.accum_count"):
        fits = int(total_unique) <= cap
    if fits:
        # emitted keys are unique and ascending: a stable compaction keeps
        # their order, and the sentinel rows (weight 0) follow
        sel = torch.sort((~emit).to(torch.uint8), stable=True).indices[:cap]
        kk = torch.where(emit[sel], skey[sel], PAIR_SENTINEL)
        ww = torch.where(emit[sel], total[sel], 0.0)
    else:
        # the cap highest weights; the stable sort of the key-ordered rows
        # breaks ties by ascending key; the rest (weight key 1) sort last
        wk = torch.where(emit, -total, 1.0)
        sel = torch.sort(wk, stable=True).indices[:cap]
        kk, by_key = torch.sort(skey[sel])
        ww = total[sel][by_key]
    hi = (kk >> 32).to(torch.int32)
    lo = (kk & 0xFFFFFFFF).to(torch.int32)
    return (VoxelAccumulator(keys_hi=hi, keys_lo=lo, weight=ww),
            torch.clamp_min(total_unique - cap, 0))


def extract_accumulated(acc: VoxelAccumulator, voxel_size: float,
                        bound_m: float = DEFAULT_DEDUPE_BOUND_M,
                        min_weight: float = 1.0) -> PointBuffer:
    """Voxels with weight >= `min_weight` as a point buffer (robot frame)."""
    n = packed_cells(voxel_size, bound_m)
    half = (n - 1) // 2
    ok = (acc.keys_hi != INT_SENTINEL) & (acc.weight >= min_weight)
    pts = torch.where(ok[:, None],
                      _decode_packed2(acc.keys_hi, acc.keys_lo, n, half, voxel_size), 0.0)
    return PointBuffer(points=pts, valid=ok)
