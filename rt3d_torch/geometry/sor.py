"""Statistical outlier removal (SOR) over object slots.

PyTorch port of `rt3d/geometry/sor.py::sor_inlier_mask_slots` and
`_inlier_from_stats` (Open3D's ``remove_statistical_outlier``: per point the
mean distance to its k nearest neighbours, itself included, over k - 1; keep
points at or below mu + std_ratio * sigma of those means).

The k-nearest statistic is kernel K3 (`sor_knn_mean_slots`, source
`rt3d_torch/csrc/sor_knn.cu`), which replaces the Pallas `_sor_knn_kernel`
as launched by `sor_knn_mean_pallas_slots` and keeps its arithmetic:
invalid points at (1e5, 1e5, 1e5) and d2 = max(|q|^2 + |r|^2 - 2 q.r, 0).
The JAX package's CPU path (`_knn_mean_xla`) uses the same identity through
a matmul, so the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from rt3d_torch import kernels
from rt3d_torch.geometry.ops import scalar_like

FAR = 1.0e5
BIG = 3.4e38
# largest slot capacity the exact kNN handles (the JAX package windows
# larger clouds, which is not ported yet)
EXACT_MAX_N = 4096


def sor_knn_mean_slots_plain(points: torch.Tensor, valid: torch.Tensor,
                             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (mean (S, K), saturated (S, K)). Modeled on
    `rt3d/geometry/sor.py::_knn_mean_xla` (pairwise d2 by the identity, the
    k smallest, their square roots summed over k - 1) with the kernel's
    teleport of invalid points and its rounding: d2 from separate multiplies
    and adds in the order ((x x' + y y') + z z'), the k smallest summed in
    ascending order. Invalid rows report (3.4e38, True)."""
    p = torch.where(valid[..., None], points.float(),
                    torch.full_like(points, FAR, dtype=torch.float32))
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    n2 = (x * x + y * y) + z * z
    cross = ((x[:, :, None] * x[:, None, :] + y[:, :, None] * y[:, None, :])
             + z[:, :, None] * z[:, None, :])
    d2 = torch.clamp_min((n2[:, :, None] + n2[:, None, :]) - 2.0 * cross, 0.0)
    small = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
    acc = torch.zeros_like(n2)
    for i in range(k):
        acc = acc + torch.sqrt(torch.clamp_max(small[..., i], 1e30))
    mean = acc / scalar_like(float(max(k - 1, 1)), acc)
    sat = small[..., k - 1] >= FAR * FAR * 0.25
    mean = torch.where(valid, mean, torch.full_like(mean, BIG))
    return mean, sat | ~valid


def sor_knn_mean_slots(points: torch.Tensor, valid: torch.Tensor, k: int,
                       plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 (replaces `_sor_knn_kernel` via `sor_knn_mean_pallas_slots`,
    rt3d/geometry/pallas_ops.py): per slot of (S, K, 3) points, each valid
    point's k-nearest mean distance within its own slot and whether the
    slot ran out of valid neighbours."""
    if not kernels.use_kernel(points, plain):
        return sor_knn_mean_slots_plain(points, valid, k)
    s, cap, _ = points.shape
    kernels.check(points, torch.float32, (s, cap, 3), "sor_knn points")
    kernels.check(valid, torch.bool, (s, cap), "sor_knn valid")
    if not 1 <= k <= min(32, cap):
        raise ValueError(f"sor_knn kernel takes 1 <= k <= min(32, {cap}), got {k}")
    mean = torch.empty((s, cap), dtype=torch.float32, device=points.device)
    sat = torch.empty((s, cap), dtype=torch.bool, device=points.device)
    kernels.launch("sor_knn_slots", "rt3d_sor_knn_slots", points.data_ptr(),
                   valid.data_ptr(), mean.data_ptr(), sat.data_ptr(), s, cap, k)
    return mean, sat


def inlier_from_stats(valid, mean_d, saturated, std_ratio):
    """valid & (mean_d <= mu + std_ratio * sigma), statistics over the last
    axis among valid, unsaturated rows (sigma with ddof 1)."""
    mean_d = torch.where(saturated, torch.full_like(mean_d, BIG), mean_d)
    vf = valid & ~saturated
    nv = torch.clamp_min(vf.float().sum(-1), 1.0)
    mu = torch.where(vf, mean_d, 0.0).sum(-1) / nv
    var = torch.where(vf, (mean_d - mu[..., None]) ** 2, 0.0).sum(-1)
    sigma = torch.sqrt(var / torch.clamp_min(nv - 1.0, 1.0))
    thresh = mu + std_ratio * sigma
    return valid & (mean_d <= thresh[..., None])


def sor_inlier_mask_slots(points: torch.Tensor, valid: torch.Tensor,
                          nb_neighbors: int = 20, std_ratio: float = 1.5,
                          plain: bool = False) -> torch.Tensor:
    """Inlier mask (S, K) of every slot's cloud, one K3 launch for all."""
    s, cap, _ = points.shape
    if cap > EXACT_MAX_N:
        raise NotImplementedError(
            "SOR over slots of more than 4096 points (windowed kNN) is "
            "ROADMAP item 11")
    k = min(nb_neighbors, cap)
    mean_d, saturated = sor_knn_mean_slots(points, valid, k, plain=plain)
    return inlier_from_stats(valid, mean_d, saturated, std_ratio)
