"""Padded-buffer point-cloud ops: backprojection, crop, voxel dedupe.

PyTorch port of the parts of `rt3d/geometry/ops.py` on the main path. The
voxel semantics are the JAX package's: ``round(p / voxel)`` with round-half-
to-even, one int32 packed key per voxel, ascending key order in the output,
the lexicographically smallest keys kept under capacity pressure, and every
dropped voxel counted as overflow.

Two kernels carry the windowed pre-dedupe of image-grid clouds:
`window_dedupe` (K1, workspace path) and `window_prev_or` (K2, object-mask
path). Each has its plain PyTorch version beside it; a CPU tensor, or
``plain=True``, takes the plain version, and a CUDA tensor launches the
kernel of `rt3d_torch/csrc/window.cu`.

Sorting note: where the JAX package sorts keys with a payload unstably, the
port sorts stably. Within a run of equal keys the payload order then follows
the input order; the outputs only differ from the JAX package's when such a
run straddles a capacity cut (a case its unstable sort leaves unspecified).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from rt3d_torch import kernels

INT_SENTINEL = 2**31 - 1
DEFAULT_DEDUPE_BOUND_M = 2.56


def scalar_like(x: float, ref: torch.Tensor) -> torch.Tensor:
    """0-dim tensor of `ref`'s dtype and device, filled on the device (no
    copy from the host, so no synchronization). Dividing by it is a true
    IEEE division; dividing by a Python float may be turned into a
    multiplication by the reciprocal, which rounds differently."""
    return torch.full((), x, dtype=ref.dtype, device=ref.device)


@dataclass
class PointBuffer:
    """A padded point cloud: fixed capacity, `valid` marks live rows.
    ``valid`` is the source of truth: live rows need not be contiguous."""

    points: torch.Tensor  # (..., N, 3) float32
    valid: torch.Tensor   # (..., N) bool

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Back-projection, rigid transforms, crop
# ---------------------------------------------------------------------------


def backproject_depth_grid(depth: torch.Tensor, fx, fy, cx, cy
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense pinhole back-projection of a (H, W) depth map: ``(xyz (H, W, 3),
    valid (H, W))``, valid where depth is > 0 and finite."""
    h, w = depth.shape
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    z = depth.float()
    valid = (z > 0) & torch.isfinite(z)
    zs = torch.where(valid, z, torch.zeros((), dtype=z.dtype, device=z.device))
    x = (u - cx) * zs / fx
    y = (v - cy) * zs / fy
    return torch.stack([x, y, zs], dim=-1), valid


def strided_grid_downsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """``x[:, ::s, ::s]`` of a (C, H, W) grid with non-finite values set to 0
    when s divides H and W (the JAX package's selection-matmul form gives
    exactly that); a plain slice otherwise."""
    if s == 1:
        return x
    c, h, w = x.shape
    rows = x[:, ::s, ::s]
    if h % s or w % s:
        return rows
    return torch.where(torch.isfinite(rows), rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def rigid_transform(points: torch.Tensor, rotation: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """p -> R @ p + t over the last axis, in full f32 as an explicit
    elementwise sum ((x R0 + y R1) + z R2) + t, so the result is the same
    on every device."""
    r = rotation.to(points.dtype)
    out = (points[..., 0:1] * r[:, 0] + points[..., 1:2] * r[:, 1]
           + points[..., 2:3] * r[:, 2])
    return out + translation.to(points.dtype)


def aabb_mask(points: torch.Tensor, x_bounds, y_bounds, z_bounds) -> torch.Tensor:
    """Inclusive axis-aligned bounding-box membership."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return ((x >= x_bounds[0]) & (x <= x_bounds[1])
            & (y >= y_bounds[0]) & (y <= y_bounds[1])
            & (z >= z_bounds[0]) & (z <= z_bounds[1]))


def masked_centroid(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over valid rows (zeros for an empty cloud)."""
    vf = valid.to(points.dtype)[..., None]
    n = torch.clamp_min(vf.sum(-2), 1.0)
    return (points * vf).sum(-2) / n


# ---------------------------------------------------------------------------
# Packed voxel keys
# ---------------------------------------------------------------------------


def packed_cells(voxel_size: float, bound_m: float) -> int:
    """Cells per axis for the packed grid: indices in [-half, half]."""
    return 2 * int(math.ceil(bound_m / voxel_size)) + 1


def packed_fits(voxel_size: float, bound_m: float) -> bool:
    return packed_cells(voxel_size, bound_m) ** 3 < 2**31 - 1


def quantize_packed(points: torch.Tensor, valid: torch.Tensor,
                    voxel_size: float, bound_m: float):
    """int32 linear voxel key per point; out-of-range or invalid points get
    the sentinel. Returns (key, cells per axis, half)."""
    n = packed_cells(voxel_size, bound_m)
    half = (n - 1) // 2
    p = points.float()
    q = torch.round(p / scalar_like(voxel_size, p)).to(torch.int32)
    in_range = ((q >= -half) & (q <= half)).all(-1) & valid
    qo = q + half
    key = (qo[..., 0] * n + qo[..., 1]) * n + qo[..., 2]
    key = torch.where(in_range, key, torch.full_like(key, INT_SENTINEL))
    return key, n, half


def decode_packed(key: torch.Tensor, n: int, half: int,
                  voxel_size: float) -> torch.Tensor:
    qz = key % n
    qy = (key // n) % n
    qx = key // (n * n)
    q = torch.stack([qx, qy, qz], dim=-1) - half
    return q.float() * voxel_size


def _run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """True where a run of equal keys starts (the first row always)."""
    start = torch.ones_like(sorted_keys, dtype=torch.bool)
    start[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return start


def _pad_to(x: torch.Tensor, size: int, value) -> torch.Tensor:
    if x.shape[0] >= size:
        return x[:size]
    return torch.cat([x, torch.full((size - x.shape[0],) + x.shape[1:], value,
                                    dtype=x.dtype, device=x.device)])


def _live_block_indices(blk_any: torch.Tensor, nb_cap: int):
    """(bsafe, bvalid): the first `nb_cap` live block indices in ascending
    order (clipped for gathering) and their validity."""
    nb = blk_any.shape[0]
    idx = torch.arange(nb, dtype=torch.int32, device=blk_any.device)
    idx = torch.where(blk_any, idx, torch.full_like(idx, INT_SENTINEL))
    sel = _pad_to(torch.sort(idx).values, nb_cap, INT_SENTINEL)
    bvalid = sel != INT_SENTINEL
    return torch.clamp(sel, 0, nb - 1).long(), bvalid


def compact_scalars(emit: torch.Tensor, payloads, capacity: int):
    """Compact (N,) payloads by an emit mask into (capacity,) buffers,
    emitted rows first, input order kept. Returns (payloads, count,
    overflow, valid)."""
    n = emit.shape[0]
    rank = torch.arange(n, dtype=torch.int32, device=emit.device)
    key = rank + torch.where(emit, 0, n).to(torch.int32)
    order = torch.sort(key).indices
    total = emit.sum(dtype=torch.int32)
    count = torch.clamp_max(total, capacity)
    valid = torch.arange(capacity, device=emit.device) < count
    outs = tuple(_pad_to(p[order], capacity, 0) for p in payloads)
    return outs, count, torch.clamp_min(total - capacity, 0), valid


def compact_points(points: torch.Tensor, emit: torch.Tensor, capacity: int
                   ) -> Tuple[PointBuffer, torch.Tensor]:
    """Stream-compact rows of `points` where `emit` into a fixed-capacity
    buffer; valid rows contiguous. Returns (buffer, overflow)."""
    (x, y, z), _, overflow, valid = compact_scalars(
        emit, (points[:, 0], points[:, 1], points[:, 2]), capacity)
    out = torch.where(valid[:, None], torch.stack([x, y, z], dim=-1), 0.0)
    return PointBuffer(points=out.to(points.dtype), valid=valid), overflow


def segmented_or_scan(word: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented OR-scan: position i gets the OR of `word` over
    its run (runs delimited by `start`), up to and including i."""
    n = word.shape[0]
    w, s = word, start
    k = 1
    while k < n:
        wp = torch.cat([torch.zeros(k, dtype=w.dtype, device=w.device), w[:-k]])
        sp = torch.cat([torch.zeros(k, dtype=torch.bool, device=s.device), s[:-k]])
        w = torch.where(s, w, wp | w)
        s = s | sp
        k *= 2
    return w


def _bit_histogram(word: torch.Tensor, d: int) -> torch.Tensor:
    """(d,) int32: how many elements of `word` have bit i set."""
    shifts = torch.arange(d, dtype=torch.int32, device=word.device)
    return ((word[:, None] >> shifts[None, :]) & 1).sum(0, dtype=torch.int32)


def _attributed_drops(d, word, w1, emit_word, w2, have_drops) -> torch.Tensor:
    """(d,) int32 per-detection counts of the two shared-buffer drops of the
    packed mask path (stage-1 block compaction, union shrink); zeros when
    nothing was dropped."""
    exact = (_bit_histogram(word, d) - _bit_histogram(w1, d)
             + _bit_histogram(emit_word, d) - _bit_histogram(w2, d))
    return torch.where(have_drops, exact, torch.zeros_like(exact))


# ---------------------------------------------------------------------------
# K1 / K2: windowed pre-dedupe over the image grid
# ---------------------------------------------------------------------------


def _window_offsets(dy_max: int, dx_max: int):
    for dy in range(dy_max + 1):
        for dx in (range(1, dx_max + 1) if dy == 0
                   else range(-dx_max, dx_max + 1)):
            yield dy, dx


def _shifted(a: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[r, c] = a[r - dy, c - dx], `fill` outside the grid."""
    h, w = a.shape
    out = torch.full_like(a, fill)
    if dy >= h or abs(dx) >= w:
        return out
    rs, cs = slice(dy, h), slice(max(dx, 0), w + min(dx, 0))
    out[rs, cs] = a[: h - dy, max(-dx, 0): w - max(dx, 0)]
    return out


def window_dedupe_plain(kg: torch.Tensor, dy_max: int = 4,
                        dx_max: int = 6) -> torch.Tensor:
    """Plain version of K1: keys equal to a row-major-preceding key inside
    the window become the sentinel."""
    dup = torch.zeros(kg.shape, dtype=torch.bool, device=kg.device)
    for dy, dx in _window_offsets(dy_max, dx_max):
        dup |= kg == _shifted(kg, dy, dx, INT_SENTINEL)
    return torch.where(dup, torch.full_like(kg, INT_SENTINEL), kg)


def _check_window(name: str, dy_max: int, dx_max: int) -> None:
    """The window kernels take up to 4 rows above and 6 columns each side."""
    if not (0 <= dy_max <= 4 and 0 <= dx_max <= 6):
        raise ValueError(f"{name}: the kernel takes dy_max <= 4 and "
                         f"dx_max <= 6, got {dy_max} and {dx_max}")


def window_dedupe(kg: torch.Tensor, dy_max: int = 4, dx_max: int = 6,
                  plain: bool = False) -> torch.Tensor:
    """K1 (replaces `_window_dedupe_kernel`, rt3d/geometry/pallas_ops.py):
    (H, W) int32 keys with window duplicates replaced by the sentinel. The
    kernel takes windows of up to 4 rows above and 6 columns each side."""
    if not kernels.use_kernel(kg, plain):
        return window_dedupe_plain(kg, dy_max, dx_max)
    kernels.check(kg, torch.int32, (-1, -1), "window_dedupe keys")
    _check_window("window_dedupe", dy_max, dx_max)
    h, w = kg.shape
    out = torch.empty_like(kg)
    kernels.launch("window_dedupe", "rt3d_window_dedupe", kg.data_ptr(),
                   out.data_ptr(), h, w, dy_max, dx_max, INT_SENTINEL)
    return out


def window_prev_or_plain(kg: torch.Tensor, wg: torch.Tensor, dy_max: int = 4,
                         dx_max: int = 6) -> torch.Tensor:
    """Plain version of K2: per pixel, the OR of the words of the preceding
    window pixels with the same key (out-of-grid: sentinel key, word 0)."""
    prev = torch.zeros_like(wg)
    for dy, dx in _window_offsets(dy_max, dx_max):
        same = kg == _shifted(kg, dy, dx, INT_SENTINEL)
        prev |= torch.where(same, _shifted(wg, dy, dx, 0), 0)
    return prev


def window_prev_or(kg: torch.Tensor, wg: torch.Tensor, dy_max: int = 4,
                   dx_max: int = 6, plain: bool = False) -> torch.Tensor:
    """K2 (replaces `_window_prev_or_kernel`, rt3d/geometry/pallas_ops.py):
    (H, W) int32 OR of preceding same-key window words. The kernel takes
    windows of up to 4 rows above and 6 columns each side."""
    if not kernels.use_kernel(kg, plain):
        return window_prev_or_plain(kg, wg, dy_max, dx_max)
    kernels.check(kg, torch.int32, (-1, -1), "window_prev_or keys")
    kernels.check(wg, torch.int32, tuple(kg.shape), "window_prev_or words")
    _check_window("window_prev_or", dy_max, dx_max)
    h, w = kg.shape
    out = torch.empty_like(kg)
    kernels.launch("window_prev_or", "rt3d_window_prev_or", kg.data_ptr(),
                   wg.data_ptr(), out.data_ptr(), h, w, dy_max, dx_max,
                   INT_SENTINEL)
    return out


# ---------------------------------------------------------------------------
# Voxel downsampling of image-grid clouds
# ---------------------------------------------------------------------------


def voxel_downsample_grid(points: torch.Tensor, valid: torch.Tensor,
                          voxel_size: float, capacity: int,
                          bound_m: float = DEFAULT_DEDUPE_BOUND_M,
                          window_dy: int = 4, window_dx: int = 6,
                          plain: bool = False) -> Tuple[PointBuffer, torch.Tensor]:
    """Voxel downsample of an (H, W) grid cloud: K1 pre-dedupe, one key sort,
    truncation to `capacity`. Output rows are the sorted keys' run heads
    (holes where the window missed a duplicate); overflow counts the unique
    voxels beyond capacity."""
    h, w = valid.shape
    if not packed_fits(voxel_size, bound_m):
        raise NotImplementedError(
            "voxel grids beyond the packed int32 key (1 mm voxels) are "
            "ROADMAP item 12")
    key, ncells, half = quantize_packed(points.reshape(-1, 3),
                                        valid.reshape(-1), voxel_size, bound_m)
    key2 = window_dedupe(key.reshape(h, w), window_dy, window_dx,
                         plain=plain).reshape(-1)
    skey = _pad_to(torch.sort(key2).values, max(key2.shape[0], capacity),
                   INT_SENTINEL)
    uniq_all = _run_starts(skey) & (skey != INT_SENTINEL)
    total_unique = uniq_all.sum(dtype=torch.int32)
    kc = skey[:capacity]
    uniq = uniq_all[:capacity]
    pts = torch.where(uniq[:, None],
                      decode_packed(kc, ncells, half, voxel_size), 0.0)
    return (PointBuffer(points=pts, valid=uniq),
            total_unique - uniq.sum(dtype=torch.int32))


def voxel_downsample_masks(points: torch.Tensor, valid: torch.Tensor,
                           masks: torch.Tensor, voxel_size: float,
                           capacity: int,
                           bound_m: float = DEFAULT_DEDUPE_BOUND_M,
                           stage1_capacity: int = 0, union_capacity: int = 0,
                           grid_hw: Optional[Tuple[int, int]] = None,
                           plain: bool = False
                           ) -> Tuple[PointBuffer, torch.Tensor]:
    """Voxel-downsample D masked subsets of one dense cloud at once:
    ``points (N, 3)``, ``valid (N,)``, ``masks (D, N)``. Returns a batched
    PointBuffer (D, capacity) and per-detection overflow (D,), exactly
    attributed. Packed path only (D <= 31, packed grid fits int32)."""
    n = points.shape[0]
    d = masks.shape[0]
    if not (d <= 31 and packed_fits(voxel_size, bound_m)):
        raise NotImplementedError(
            "mask downsampling with more than 31 detections or beyond the "
            "packed int32 key is ROADMAP item 12")
    default_s1 = max(2 * d * capacity, min(n // 4, 131072))
    s1 = stage1_capacity or default_s1
    return _voxel_masks_packed(points, valid, masks, voxel_size, capacity,
                               bound_m, s1, union_capacity or min(d * capacity, s1),
                               grid_hw, plain=plain)


def _voxel_masks_packed(points, valid, masks, voxel_size, capacity, bound_m,
                        stage1_capacity, union_capacity, grid_hw=None,
                        window_dy=4, window_dx=6, plain=False):
    """Bit-pack the D masks into one int32 word per pixel, K2 window
    pre-dedupe (grid clouds), block-compact the emitting pixels, sort the
    small buffer, segmented OR-scan, per-detection select."""
    n = points.shape[0]
    d = masks.shape[0]
    dev = points.device
    sent = INT_SENTINEL
    key, ncells, half = quantize_packed(points, valid, voxel_size, bound_m)
    shifts = torch.arange(d, dtype=torch.int32, device=dev)
    word = (masks.to(torch.int32) << shifts[:, None]).sum(0, dtype=torch.int32)
    sel = (word != 0) & (key != sent)
    key = torch.where(sel, key, sent)
    word = torch.where(sel, word, 0)
    if grid_hw is not None:
        h, w = grid_hw
        prev = window_prev_or(key.reshape(h, w), word.reshape(h, w),
                              window_dy, window_dx, plain=plain)
        word = (word.reshape(h, w) & ~prev).reshape(-1)
        sel = word != 0
        key = torch.where(sel, key, sent)

    blk = 128
    pad = (-n) % blk
    if pad:
        key = _pad_to(key, n + pad, sent)
        word = _pad_to(word, n + pad, 0)
        sel = _pad_to(sel, n + pad, False)
    nb = key.shape[0] // blk
    nb_cap = max(stage1_capacity // blk, 1)
    sel_b = sel.reshape(nb, blk)
    blk_any = sel_b.any(1)
    blk_cnt = sel_b.sum(1, dtype=torch.int32)
    bsafe, bvalid = _live_block_indices(blk_any, nb_cap)
    k1 = torch.where(bvalid[:, None], key.reshape(nb, blk)[bsafe], sent).reshape(-1)
    w1 = torch.where(bvalid[:, None], word.reshape(nb, blk)[bsafe], 0).reshape(-1)
    taken = torch.where(bvalid, blk_cnt[bsafe], 0).sum(dtype=torch.int32)
    drop_a = blk_cnt.sum(dtype=torch.int32) - taken

    skey, order = torch.sort(k1, stable=True)
    sword = w1[order]
    start = _run_starts(skey)
    or_incl = segmented_or_scan(sword, start)
    prev = torch.where(start, 0, torch.roll(or_incl, 1))
    emit_word = torch.where(skey != sent, sword & ~prev, 0)

    s2 = min(union_capacity, stage1_capacity)
    any_emit = emit_word != 0
    if grid_hw is not None:
        # the window pass left only emitting pixels live, so they sort to
        # the front: the shrink to `s2` rows is a truncation
        k2 = skey[:s2]
        w2 = emit_word[:s2]
        drop2 = any_emit.sum(dtype=torch.int32) - any_emit[:s2].sum(dtype=torch.int32)
    else:
        km = torch.where(any_emit, skey, sent)
        k2f, order2 = torch.sort(km, stable=True)
        w2f = torch.where(any_emit, emit_word, 0)[order2]
        total2 = any_emit.sum(dtype=torch.int32)
        cnt2 = torch.clamp_max(total2, s2)
        valid2 = torch.arange(s2, device=dev) < cnt2
        k2 = torch.where(valid2, _pad_to(k2f, s2, sent), sent)
        w2 = torch.where(valid2, _pad_to(w2f, s2, 0), 0)
        drop2 = total2 - cnt2
    k2 = _pad_to(k2, s2, sent)
    w2 = _pad_to(w2, s2, 0)

    bits = ((w2[None, :] >> shifts[:, None]) & 1) == 1
    keym = torch.where(bits, k2[None, :].expand(d, s2), sent)
    skeys_d = torch.sort(keym, dim=1).values
    counts = bits.sum(1, dtype=torch.int32)
    countc = torch.clamp_max(counts, capacity)
    valid_d = torch.arange(capacity, device=dev)[None, :] < countc[:, None]
    kd = skeys_d[:, :capacity]
    if kd.shape[1] < capacity:
        kd = torch.cat([kd, torch.full((d, capacity - kd.shape[1]), sent,
                                       dtype=kd.dtype, device=dev)], 1)
    pts = torch.where(valid_d[..., None],
                      decode_packed(kd, ncells, half, voxel_size), 0.0)
    drop_d = _attributed_drops(d, word, w1, emit_word, w2, (drop_a + drop2) > 0)
    overflow = torch.clamp_min(counts - capacity, 0) + drop_d
    return PointBuffer(points=pts, valid=valid_d), overflow
