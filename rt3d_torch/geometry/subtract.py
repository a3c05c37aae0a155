"""Workspace minus objects: drop workspace points near any object point.

PyTorch port of `rt3d/geometry/subtract.py::subtract_min_dist`. The
per-query minimum squared distance is kernel K4 (`min_sqdist`, source
`rt3d_torch/csrc/min_d2.cu`), which replaces the Pallas `_min_d2_kernel`
and keeps its direct coordinate-difference form: exact f32 distances, where
the JAX package's XLA fallback uses the matmul identity.
"""

from __future__ import annotations

import torch

from rt3d_torch import kernels
from rt3d_torch.geometry.ops import PointBuffer, scalar_like

BIG = 3.4e38
_REF_CHUNK = 1024


def min_sqdist_plain(queries: torch.Tensor, refs: torch.Tensor,
                     ref_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: (N,) min over valid refs of
    ((dx dx + dy dy) + dz dz), 3.4e38 when no ref is valid. Refs are
    processed in chunks to bound the (N, chunk) temporaries."""
    q = queries.float()
    inf = torch.full_like(refs, float("inf"), dtype=torch.float32)
    r = torch.where(ref_valid[:, None], refs.float(), inf)
    acc = torch.full((q.shape[0],), BIG, dtype=torch.float32, device=q.device)
    for c0 in range(0, r.shape[0], _REF_CHUNK):
        rc = r[c0:c0 + _REF_CHUNK]
        dx = q[:, 0:1] - rc[:, 0]
        dy = q[:, 1:2] - rc[:, 1]
        dz = q[:, 2:3] - rc[:, 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        acc = torch.minimum(acc, d2.amin(1))
    return acc


def min_sqdist(queries: torch.Tensor, refs: torch.Tensor,
               ref_valid: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """K4 (replaces `_min_d2_kernel`, rt3d/geometry/pallas_ops.py): per-query
    squared distance to the nearest valid ref, (N, 3) x (M, 3) -> (N,)."""
    if not kernels.use_kernel(queries, plain):
        return min_sqdist_plain(queries, refs, ref_valid)
    n, m = queries.shape[0], refs.shape[0]
    kernels.check(queries, torch.float32, (-1, 3), "min_sqdist queries")
    kernels.check(refs, torch.float32, (-1, 3), "min_sqdist refs")
    kernels.check(ref_valid, torch.bool, (m,), "min_sqdist ref_valid")
    out = torch.empty((n,), dtype=torch.float32, device=queries.device)
    kernels.launch("min_sqdist", "rt3d_min_sqdist", queries.data_ptr(),
                   refs.data_ptr(), ref_valid.data_ptr(), out.data_ptr(), n, m)
    return out


def subtract_min_dist(workspace: PointBuffer, objects: PointBuffer,
                      distance_threshold: float,
                      plain: bool = False) -> PointBuffer:
    """Keep workspace points farther than `distance_threshold` from every
    valid object point; with no valid object point everything is kept."""
    mind2 = min_sqdist(workspace.points, objects.points, objects.valid,
                       plain=plain)
    t = scalar_like(distance_threshold, mind2)
    keep = workspace.valid & (mind2 > t * t)
    return PointBuffer(points=workspace.points, valid=keep)
