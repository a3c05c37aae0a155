"""Padded-buffer point-cloud ops: backprojection, crop, voxel dedupe.

PyTorch port of `rt3d/geometry/ops.py`. The voxel semantics are the JAX
package's: ``round(p / voxel)`` with round-half-to-even, ascending
(qx, qy, qz) order in the output, the lexicographically smallest voxels
kept under capacity pressure, and every dropped voxel counted as overflow.
A voxel is one int32 packed key when the grid within `bound_m` fits it
(5 mm), else a two-word key (`_quantize_packed2`, 1 mm), sorted as one int64
`pair_key`, else its three indices, sorted lexicographically.

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
from rt3d_torch.runtime import trace

INT_SENTINEL = 2**31 - 1
PAIR_SENTINEL = (INT_SENTINEL << 32) | INT_SENTINEL  # `pair_key` of two sentinels
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


def packed2_fits(voxel_size: float, bound_m: float) -> bool:
    """The two-word key's hi word packs (qx, qy): it needs n^2 < 2^31 - 1
    (out to about 23 m bounds at 1 mm)."""
    return packed_cells(voxel_size, bound_m) ** 2 < 2**31 - 1


def _quantize_packed2(points: torch.Tensor, valid: torch.Tensor,
                      voxel_size: float, bound_m: float):
    """Two int32 words per voxel, ``hi = (qx + half) * n + (qy + half)`` and
    ``lo = qz + half``, whose lexicographic order is that of (qx, qy, qz);
    out-of-range or invalid rows get the sentinel in both words. Returns
    (hi, lo, cells per axis, half)."""
    n = packed_cells(voxel_size, bound_m)
    half = (n - 1) // 2
    p = points.float()
    q = torch.round(p / scalar_like(voxel_size, p)).to(torch.int32)
    in_range = ((q >= -half) & (q <= half)).all(-1) & valid
    qo = q + half
    sent = torch.full_like(qo[..., 0], INT_SENTINEL)
    hi = torch.where(in_range, qo[..., 0] * n + qo[..., 1], sent)
    lo = torch.where(in_range, qo[..., 2], sent)
    return hi, lo, n, half


def _decode_packed2(hi: torch.Tensor, lo: torch.Tensor, n: int, half: int,
                    voxel_size: float) -> torch.Tensor:
    q = torch.stack([hi // n, hi % n, lo], dim=-1) - half
    return q.float() * voxel_size


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 ``(hi << 32) | lo`` of two-word keys: both words are >= 0 or
    the sentinel, so one sort of it is the lexicographic (hi, lo) sort, and
    the sentinel pair sorts after every real pair."""
    return (hi.long() << 32) | lo.long()


def _run_starts(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """True where a run of equal rows of the lexicographically sorted key
    columns starts (the first row always)."""
    start = torch.zeros_like(sorted_keys[0], dtype=torch.bool)
    for k in sorted_keys:
        start[..., 1:] |= k[..., 1:] != k[..., :-1]
    # the Python scalar reaches the card through a blocking copy
    with trace.sync("ops.run_starts"):
        start[..., 0] = True
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


def segmented_sum_scan(val: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum-scan in `segmented_or_scan`'s contiguous-shift
    form: the same pass order as the JAX package's, so equal inputs in equal
    order give equal bits."""
    n = val.shape[0]
    v, s = val, start
    k = 1
    while k < n:
        vp = torch.cat([torch.zeros(k, dtype=v.dtype, device=v.device), v[:-k]])
        sp = torch.cat([torch.zeros(k, dtype=torch.bool, device=s.device), s[:-k]])
        v = torch.where(s, v, vp + v)
        s = s | sp
        k *= 2
    return v


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
    """The window kernels take any window of non-negative extents."""
    if dy_max < 0 or dx_max < 0:
        raise ValueError(f"{name}: the window's extents must be >= 0, "
                         f"got {dy_max} and {dx_max}")


def window_dedupe(kg: torch.Tensor, dy_max: int = 4, dx_max: int = 6,
                  plain: bool = False) -> torch.Tensor:
    """K1 (replaces `_window_dedupe_kernel`, rt3d/geometry/pallas_ops.py):
    (H, W) int32 keys with window duplicates replaced by the sentinel, for
    any window (the staged-tile kernel up to 4 rows above and 6 columns
    each side, the wide kernel beyond)."""
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
    (H, W) int32 OR of preceding same-key window words, for any window (as
    `window_dedupe`)."""
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
    voxels beyond capacity. Beyond the packed key, `voxel_downsample`."""
    h, w = valid.shape
    if not packed_fits(voxel_size, bound_m):
        return voxel_downsample(points.reshape(-1, 3), valid.reshape(-1),
                                voxel_size, capacity, bound_m=bound_m)
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
    attributed. Up to 31 detections the mask bits ride one int32 word per
    point: the packed key with K2's window pass on an image grid, else the
    two-word key (1 mm voxels; no window pass, a voxel's footprint there is
    under a pixel); beyond either, the lexicographic path."""
    n = points.shape[0]
    d = masks.shape[0]
    s1 = stage1_capacity or max(2 * d * capacity, min(n // 4, 131072))
    s2 = union_capacity or min(d * capacity, s1)
    if d <= 31 and packed_fits(voxel_size, bound_m):
        return _voxel_masks_packed(points, valid, masks, voxel_size, capacity,
                                   bound_m, s1, s2, grid_hw, plain=plain)
    if d <= 31 and packed2_fits(voxel_size, bound_m):
        return _voxel_masks_packed2(points, valid, masks, voxel_size, capacity,
                                    bound_m, s1, s2)
    return _voxel_masks_lex(points, valid, masks, voxel_size, capacity)


def _mask_words(masks: torch.Tensor) -> torch.Tensor:
    """(N,) int32: bit i set where detection i's mask (D <= 31, (D, N)) is."""
    shifts = torch.arange(masks.shape[0], dtype=torch.int32, device=masks.device)
    return (masks.to(torch.int32) << shifts[:, None]).sum(0, dtype=torch.int32)


def _voxel_masks_packed(points, valid, masks, voxel_size, capacity, bound_m,
                        stage1_capacity, union_capacity, grid_hw=None,
                        window_dy=4, window_dx=6, plain=False):
    """Bit-pack the D masks into one int32 word per pixel, K2 window
    pre-dedupe (grid clouds), then `_masks_from_keys`."""
    key, ncells, half = quantize_packed(points, valid, voxel_size, bound_m)
    word = _mask_words(masks)
    sel = (word != 0) & (key != INT_SENTINEL)
    key = torch.where(sel, key, INT_SENTINEL)
    word = torch.where(sel, word, 0)
    if grid_hw is not None:
        h, w = grid_hw
        prev = window_prev_or(key.reshape(h, w), word.reshape(h, w),
                              window_dy, window_dx, plain=plain)
        word = (word.reshape(h, w) & ~prev).reshape(-1)
        sel = word != 0
        key = torch.where(sel, key, INT_SENTINEL)
    return _masks_from_keys(
        key, word, sel, INT_SENTINEL, masks.shape[0], capacity, stage1_capacity,
        union_capacity, lambda k: decode_packed(k, ncells, half, voxel_size),
        truncate=grid_hw is not None)


def _voxel_masks_packed2(points, valid, masks, voxel_size, capacity, bound_m,
                         stage1_capacity, union_capacity):
    """`_voxel_masks_packed` on the two-word key, as one int64 `pair_key`,
    without the window pass."""
    hi, lo, ncells, half = _quantize_packed2(points, valid, voxel_size, bound_m)
    word = _mask_words(masks)
    sel = (word != 0) & (hi != INT_SENTINEL)
    key = torch.where(sel, pair_key(hi, lo), PAIR_SENTINEL)
    word = torch.where(sel, word, 0)
    return _masks_from_keys(
        key, word, sel, PAIR_SENTINEL, masks.shape[0], capacity, stage1_capacity,
        union_capacity,
        lambda k: _decode_packed2(k >> 32, k & 0xFFFFFFFF, ncells, half, voxel_size),
        truncate=False)


def _masks_from_keys(key, word, sel, sent, d, capacity, stage1_capacity,
                     union_capacity, decode, truncate):
    """The packed mask paths after the keys: block-compact the emitting
    pixels, sort the small buffer, segmented OR-scan, shrink to the union
    (a truncation when the window pass left only emitting pixels live),
    per-detection select. `sent` is the key's sentinel, `decode` maps keys
    to voxel centres."""
    n = key.shape[0]
    dev = key.device
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
    if truncate:
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

    shifts = torch.arange(d, dtype=torch.int32, device=dev)
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
    pts = torch.where(valid_d[..., None], decode(kd), 0.0)
    drop_d = _attributed_drops(d, word, w1, emit_word, w2, (drop_a + drop2) > 0)
    overflow = torch.clamp_min(counts - capacity, 0) + drop_d
    return PointBuffer(points=pts, valid=valid_d), overflow


def _voxel_masks_lex(points, valid, masks, voxel_size, capacity):
    """Any number of detections and any voxel grid: a lexicographic sort of
    the (qx, qy, qz) indices (input order within a voxel), each mask's first
    pixel of each voxel run by a cumulative count, one compaction per
    detection."""
    qx, qy, qz = _quantize(points, valid, voxel_size)
    order = _lex_order(qx, qy, qz)
    sx, sy, sz = qx[order], qy[order], qz[order]
    starts = _run_starts(sx, sy, sz)
    ms = masks[:, order]
    m_i = ms.to(torch.int32)
    inclusive = torch.cumsum(m_i, 1, dtype=torch.int32)
    base = torch.cummax(torch.where(starts[None, :], inclusive - m_i, -1), 1).values
    emit = ms & ((inclusive - base) == 1) & (sx != INT_SENTINEL)[None, :]
    snapped = torch.stack([sx, sy, sz], dim=-1).float() * voxel_size
    bufs, ovfs = zip(*(compact_points(snapped, e, capacity) for e in emit))
    return (PointBuffer(points=torch.stack([b.points for b in bufs]),
                        valid=torch.stack([b.valid for b in bufs])), torch.stack(ovfs))


# ---------------------------------------------------------------------------
# Voxel downsampling of any cloud
# ---------------------------------------------------------------------------


def _quantize(points: torch.Tensor, valid: torch.Tensor, voxel_size: float):
    """int32 voxel indices (qx, qy, qz), round half to even; invalid rows get
    the sentinel so they sort last."""
    p = points.float()
    q = torch.round(p / scalar_like(voxel_size, p)).to(torch.int32)
    sent = torch.full_like(q[..., 0], INT_SENTINEL)
    return tuple(torch.where(valid, q[..., i], sent) for i in range(3))


def _lex_order(*keys: torch.Tensor) -> torch.Tensor:
    """The stable permutation that sorts rows lexicographically by `keys`,
    the first most significant."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _emitted_keys(skey, emit, capacity, sent, decode):
    """The run heads `emit` of sorted keys `skey` as a buffer of `capacity`
    rows: in place when the capacity covers the input (valid rows then not
    contiguous), else compacted by a masked re-sort, keeping the smallest
    keys. Returns (buffer, overflow)."""
    if capacity >= skey.shape[0]:
        skey = _pad_to(skey, capacity, sent)
        emit = _pad_to(emit, capacity, False)
        pts = torch.where(emit[:, None], decode(skey), 0.0)
        return (PointBuffer(points=pts, valid=emit),
                torch.zeros((), dtype=torch.int32, device=skey.device))
    kc = torch.sort(torch.where(emit, skey, sent)).values[:capacity]
    total = emit.sum(dtype=torch.int32)
    valid = torch.arange(capacity, device=skey.device) < total
    pts = torch.where(valid[:, None], decode(kc), 0.0)
    return PointBuffer(points=pts, valid=valid), total - valid.sum(dtype=torch.int32)


def voxel_downsample(points: torch.Tensor, valid: torch.Tensor, voxel_size: float,
                     capacity: int, bound_m: float = DEFAULT_DEDUPE_BOUND_M
                     ) -> Tuple[PointBuffer, torch.Tensor]:
    """Exact voxel downsample of one padded (N, 3) cloud: the unique
    ``round(p / voxel) * voxel`` in ascending (qx, qy, qz) order, the smallest
    kept under capacity, overflow counted. The packed key when it fits, else
    the two-word key, else a lexicographic sort of the indices."""
    if packed_fits(voxel_size, bound_m):
        key, ncells, half = quantize_packed(points, valid, voxel_size, bound_m)
        skey = torch.sort(key).values
        return _emitted_keys(skey, _run_starts(skey) & (skey != INT_SENTINEL),
                             capacity, INT_SENTINEL,
                             lambda k: decode_packed(k, ncells, half, voxel_size))
    if packed2_fits(voxel_size, bound_m):
        hi, lo, ncells, half = _quantize_packed2(points, valid, voxel_size, bound_m)
        skey = torch.sort(pair_key(hi, lo)).values
        return _emitted_keys(
            skey, _run_starts(skey) & (skey != PAIR_SENTINEL), capacity, PAIR_SENTINEL,
            lambda k: _decode_packed2(k >> 32, k & 0xFFFFFFFF, ncells, half, voxel_size))
    qx, qy, qz = _quantize(points, valid, voxel_size)
    order = _lex_order(qx, qy, qz)
    sx, sy, sz = qx[order], qy[order], qz[order]
    emit = _run_starts(sx, sy, sz) & (sx != INT_SENTINEL)
    snapped = torch.stack([sx, sy, sz], dim=-1).float() * voxel_size
    return compact_points(snapped, emit, capacity)
