"""Workspace minus objects: drop workspace points near any object point.

PyTorch port of `rt3d/geometry/subtract.py::subtract_min_dist`. The
per-query minimum squared distance is kernel K4 (`min_sqdist`, source
`rt3d_torch/csrc/min_d2.cu`), which replaces the Pallas `_min_d2_kernel`
and keeps its direct coordinate-difference form and its contract: given a
threshold, exact wherever d2 <= threshold^2 and some larger value
elsewhere, so the kernel may skip references provably beyond the
threshold. The JAX package's XLA fallback uses the matmul identity instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from bench_port.reference import kernels
from bench_port.reference.geometry.ops import PointBuffer, scalar_like

BIG = 3.4e38
_REF_CHUNK = 1024
_QUERY_CHUNK = 65536
_BOX_CHUNK = 256   # references under one box of min_d2.cu's first kernel
_BOX_FLOATS = 72   # floats of boxes a chunk: its own and its 8 tiles', as float4


def min_sqdist_plain(queries: torch.Tensor, refs: torch.Tensor,
                     ref_valid: torch.Tensor,
                     query_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4: (N,) min over valid refs of
    ((dx dx + dy dy) + dz dz), 3.4e38 when no ref is valid and on invalid
    queries. Exact on every valid query, which meets the kernel's contract
    for any threshold. Queries and refs are processed in chunks to bound the
    (query chunk, ref chunk) temporaries. On the CPU only the valid refs
    are visited; on the card invalid refs are set to infinity instead,
    which needs no host read (the minimum is the same either way)."""
    q = queries.float()
    if refs.device.type == "cpu":
        r = refs.float()[ref_valid]
    else:
        r = torch.where(ref_valid[:, None], refs.float(), float("inf"))
    acc = torch.full((q.shape[0],), BIG, dtype=torch.float32, device=q.device)
    for q0 in range(0, q.shape[0], _QUERY_CHUNK):
        qc = q[q0:q0 + _QUERY_CHUNK]
        for c0 in range(0, r.shape[0], _REF_CHUNK):
            rc = r[c0:c0 + _REF_CHUNK]
            dx = qc[:, 0:1] - rc[:, 0]
            dy = qc[:, 1:2] - rc[:, 1]
            dz = qc[:, 2:3] - rc[:, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            acc[q0:q0 + _QUERY_CHUNK] = torch.minimum(acc[q0:q0 + _QUERY_CHUNK], d2.amin(1))
    if query_valid is not None:
        acc = torch.where(query_valid, acc, torch.full_like(acc, BIG))
    return acc


def min_sqdist(queries: torch.Tensor, refs: torch.Tensor,
               ref_valid: torch.Tensor, threshold: Optional[float] = None,
               query_valid: Optional[torch.Tensor] = None,
               plain: bool = False) -> torch.Tensor:
    """K4 (replaces `_min_d2_kernel`, rt3d/geometry/pallas_ops.py): per-query
    squared distance to the nearest valid ref, (N, 3) x (M, 3) -> (N,).

    With `threshold`, t2 = f32(threshold) * f32(threshold) as the caller
    compares: exact (bit for bit with the plain version) on every valid
    query whose d2 <= t2, some value > t2 on every other valid query. Without
    it, exact on every valid query. Invalid queries (`query_valid` False) get
    3.4e38."""
    if not kernels.use_kernel(queries, plain):
        return min_sqdist_plain(queries, refs, ref_valid, query_valid)
    n, m = queries.shape[0], refs.shape[0]
    kernels.check(queries, torch.float32, (-1, 3), "min_sqdist queries")
    kernels.check(refs, torch.float32, (-1, 3), "min_sqdist refs")
    kernels.check(ref_valid, torch.bool, (m,), "min_sqdist ref_valid")
    if query_valid is not None:
        kernels.check(query_valid, torch.bool, (n,), "min_sqdist query_valid")
    t2 = float("inf")
    if threshold is not None:
        t = torch.tensor(threshold, dtype=torch.float32)
        t2 = float(t * t)
    out = torch.empty((n,), dtype=torch.float32, device=queries.device)
    boxes = torch.empty((-(-m // _BOX_CHUNK) * _BOX_FLOATS,), dtype=torch.float32,
                        device=queries.device)
    kernels.launch("min_sqdist", "rt3d_min_sqdist", queries.data_ptr(),
                   None if query_valid is None else query_valid.data_ptr(),
                   refs.data_ptr(), ref_valid.data_ptr(), boxes.data_ptr(),
                   out.data_ptr(), n, m, t2)
    return out


def subtract_min_dist(workspace: PointBuffer, objects: PointBuffer,
                      distance_threshold: float,
                      plain: bool = False) -> PointBuffer:
    """Keep workspace points farther than `distance_threshold` from every
    valid object point; with no valid object point everything is kept.
    K4 runs under the threshold's contract, as the JAX step calls its
    Pallas kernel: the keep mask is the same as from exact distances."""
    mind2 = min_sqdist(workspace.points, objects.points, objects.valid,
                       threshold=distance_threshold, query_valid=workspace.valid,
                       plain=plain)
    t = scalar_like(distance_threshold, mind2)
    keep = workspace.valid & (mind2 > t * t)
    return PointBuffer(points=workspace.points, valid=keep)
