"""The least time each hand-written kernel of the port could take on its
inputs: a frozen copy of the bound arithmetic of the repository's chip smoke
test (`bound`, `window_ops`, `k4_pairs` and K3's operation count), applied
to the arguments of each kernel wrapper call that the traced frames made.
Which wrappers are bounded, and by which of these functions, is one file
each, `bounds/<wrapper>.py`: a new kernel is a new file.

Bytes are counted once (each input read once, each output written once);
operations are charged at their type's rate; work that depends on the data
(K1's live keys, K2's pixels with a word in their window, K3's valid pairs
within each slot, K4's pairs that survive its box tests) is counted from
the inputs themselves.

Peaks of one NVIDIA H100 SXM (data sheet): 3.35 TB/s of HBM3; at 1.98 GHz
132 SMs x 128 FP32 lanes issue 33.5e12 unfused f32 operations a second
(the 67 TFLOP/s of the data sheet counts a fused multiply-add as two; the
kernels' distances are unfused, for their bits), and 132 x 64 INT32 lanes
16.7e12 integer operations.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator, Optional, Tuple

import torch

from bench_port import spec

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 33.5e12
PEAK_INT32_OPS_PER_S = 16.7e12
INT_SENTINEL = 2**31 - 1


@functools.lru_cache(maxsize=None)
def kernel_bounds(here: str = spec.HERE) -> Dict:
    """The kernel wrappers whose launches get a bound, by name: each file
    `bounds/<wrapper>.py` names the program's module (`MODULE`) and
    function (`FUNCTION`) to wrap, the profiler's names of its CUDA kernels
    (`KERNELS`: a kernel name matches when it contains one of them), and
    `bound(args, kwargs)`, the bound of one call from its arguments as the
    caller passed them."""
    return {name: spec.load("bounds", name, here) for name in spec.names("bounds", here)}


def kernel_names(here: str = spec.HERE) -> Dict[str, Tuple[str, ...]]:
    return {name: tuple(b.KERNELS) for name, b in kernel_bounds(here).items()}


def is_kernel(name: str, here: str = spec.HERE) -> bool:
    return any(k in name for names in kernel_names(here).values() for k in names)


def bound(nbytes, f32_ops=0, int_ops=0) -> Dict:
    """The least time of `nbytes` moved once and of the operations at the
    card's rate for their type, and the larger of the two (`bound_ms`,
    `bound_by`)."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = (f32_ops / PEAK_F32_OPS_PER_S + int_ops / PEAK_INT32_OPS_PER_S) * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
                bytes_bound_ms=tb, ops_bound_ms=to)


def _window_offsets(dy_max: int, dx_max: int) -> Iterator[Tuple[int, int]]:
    for dy in range(dy_max + 1):
        for dx in (range(1, dx_max + 1) if dy == 0 else range(-dx_max, dx_max + 1)):
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


def window_ops(kg: torch.Tensor, wg: Optional[torch.Tensor] = None,
               window: Tuple[int, int] = (4, 6)) -> int:
    """Integer operations the window's data needs: K1 one compare for each
    of the window's offsets of each live key; K2 the compares of each pixel
    that has a non-zero word in its window, plus one OR for each same-key
    neighbour with a non-zero word."""
    offsets = list(_window_offsets(*window))
    if wg is None:
        return len(offsets) * int((kg != INT_SENTINEL).sum())
    need = torch.zeros_like(kg, dtype=torch.bool)
    ors = 0
    for dy, dx in offsets:
        nz = _shifted(wg, dy, dx, 0) != 0
        need |= nz
        ors += int((nz & (_shifted(kg, dy, dx, INT_SENTINEL) == kg)).sum())
    return len(offsets) * int(need.sum()) + ors


def k4_pairs(q, qv, r, rv, t2, block: int = 256, tile: int = 32) -> Tuple[int, int]:
    """(valid (query, reference) pairs, pairs left by K4's box tests at
    squared threshold `t2`): each `block` of queries against each `block`
    of references, then each `tile` (a warp) of queries against each
    `tile` of references, every box over valid rows only; a pair survives
    when neither its blocks' nor its tiles' boxes are farther apart than
    the threshold."""
    def boxes(p, v, size):
        n = -(-p.shape[0] // block) * block
        pp = torch.zeros((n, 3), device=p.device)
        vv = torch.zeros(n, dtype=torch.bool, device=p.device)
        pp[:p.shape[0]], vv[:p.shape[0]] = p, v
        pp, vv = pp.view(-1, size, 3), vv.view(-1, size)
        inf = torch.full((), float("inf"), device=p.device)
        return (torch.where(vv[..., None], pp, inf).amin(1),
                torch.where(vv[..., None], pp, -inf).amax(1), vv.sum(1))

    def near(a, b):
        (alo, ahi, an), (blo, bhi, bn) = a, b
        gap = torch.clamp_min(torch.maximum(blo[None] - ahi[:, None], alo[:, None] - bhi[None]), 0)
        g2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
        return ~(g2 > t2) & (an[:, None] > 0) & (bn[None, :] > 0)

    qb, rb = boxes(q, qv, block), boxes(r, rv, block)
    qt, rt = boxes(q, qv, tile), boxes(r, rv, tile)
    per = block // tile
    keep = near(qt, rt) & near(qb, rb).repeat_interleave(per, 0).repeat_interleave(per, 1)
    pairs = qt[2][:, None].double() * rt[2][None, :].double()
    return int(qv.sum()) * int(rv.sum()), int((pairs * keep).sum())


def k1_bound(kg, dy_max: int = 4, dx_max: int = 6) -> Dict:
    return bound(8 * kg.numel(), int_ops=window_ops(kg, window=(dy_max, dx_max)))


def k2_bound(kg, wg, dy_max: int = 4, dx_max: int = 6) -> Dict:
    return bound(12 * kg.numel(), int_ops=window_ops(kg, wg, (dy_max, dx_max)))


def k3_bound(pts, valid) -> Dict:
    """K3 over (S, cap, 3) slots: every row's point, validity, mean and
    saturation once; 10 f32 operations a valid pair within a slot."""
    s, cap = valid.shape
    pairs = int((valid.sum(-1).long() ** 2).sum())
    return bound(s * cap * (12 + 1 + 4 + 1), pairs * 10)


def k5_bound(pts, valid) -> Dict:
    return bound(pts.shape[0] * (12 + 1 + 4 + 1), int(valid.sum()) ** 2 * 10)


def k4_t2(threshold: float, device) -> torch.Tensor:
    """The f32 threshold^2 that the subtraction compares against."""
    t = torch.tensor(threshold, dtype=torch.float32, device=device)
    return t * t


def k4_bound(q, qv, r, rv, threshold: Optional[float]) -> Dict:
    """K4: queries' points, validity and distance, references' points and
    validity once; 9 f32 operations a pair that survives the box tests
    (every valid pair without a threshold)."""
    nbytes = q.shape[0] * (12 + 1 + 4) + r.shape[0] * (12 + 1)
    if qv is None:
        qv = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    if threshold is None:
        pairs = int(qv.sum()) * int(rv.sum())
    else:
        pairs = k4_pairs(q, qv, r, rv, k4_t2(threshold, q.device))[1]
    return bound(nbytes, pairs * 9)


def arg(args, kwargs, i, name, default=None):
    """Argument `i`, or keyword `name`, of a recorded call."""
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


def call_bound(wrapper: str, args, kwargs, here: str = spec.HERE) -> Dict:
    """The bound of one recorded call of a kernel wrapper, from its
    arguments as the caller passed them."""
    return kernel_bounds(here)[wrapper].bound(args, kwargs)
