"""Statistical outlier removal (SOR) on padded clouds.

PyTorch port of `rt3d/geometry/sor.py` (Open3D's
``remove_statistical_outlier``: per point the mean distance to its k nearest
neighbours, itself included, over k - 1; keep points at or below
mu + std_ratio * sigma of those means, sigma with ddof 1).

The k-nearest statistic has four forms, chosen by cloud size exactly as the
JAX package chooses them:

* K3 `sor_knn_mean_slots` over object slots and K5 `sor_knn_mean` over one
  cloud of 256..4096 points, both from `rt3d_torch/csrc/sor_knn.cu`, which
  replaces the Pallas `_sor_knn_kernel` and keeps its arithmetic: invalid
  points at (1e5, 1e5, 1e5) and d2 = max(|q|^2 + |r|^2 - 2 q.r, 0). They
  take every k from 1 to the cloud's rows, as the JAX package does: up to
  `REGISTER_MAX_K` the register path, above it the radix-select kernel.
  Their callers give them 256 to 4096 rows; the radix-select kernel's
  shared memory holds up to about 10 000 (beyond, its launch is refused
  and `kernels.launch` raises). Each has its plain PyTorch version,
  `sor_knn_mean_plain`.
* the exact form `knn_mean_xla` (the JAX package's `_knn_mean_xla`) for
  clouds and slots under 256 points, on every device: the same identity,
  with the diagonal set to 0 and invalid columns to 3.4e38.
* the Morton-window form `_knn_mean_windowed` for clouds over 4096 points:
  stock PyTorch, as the JAX package computes it in XLA.

The kernels and the exact form agree to rounding, not bit for bit; they
differ only in the means of saturated rows, which both fold to 3.4e38.
"""

from __future__ import annotations

import torch

from rt3d_torch import kernels
from rt3d_torch.geometry.ops import PointBuffer, scalar_like
from rt3d_torch.runtime import trace

FAR = 1.0e5
BIG = 3.4e38
# clouds above this many rows take the Morton-window form
EXACT_MAX_N = 4096
# clouds below this many rows take the exact form, not K5
KERNEL_MIN_N = 256
# largest k of the kernels' register path (`kMaxK`, sor_knn.cu); above it
# they take the radix-select kernel, counted apart in `kernels.LAUNCHES`
REGISTER_MAX_K = 32
# Morton key of invalid points: above every 30-bit code, so they sort last
INVALID_KEY = 0x7FFFFFFF


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """((a_x b_x + a_y b_y) + a_z b_z) over the last axis, broadcast; each
    product and sum rounded on its own, as the kernels do."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def sor_knn_mean_plain(points: torch.Tensor, valid: torch.Tensor,
                       k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 and K5 over (..., N, 3) clouds: (mean (..., N),
    saturated (..., N)). Modeled on `_knn_mean_xla` (pairwise d2 by the
    identity, the k smallest, their square roots summed over k - 1) with the
    kernel's teleport of invalid points and its rounding: d2 from separate
    multiplies and adds in the order ((x x' + y y') + z z'), the k smallest
    summed in ascending order. Invalid rows report (3.4e38, True)."""
    p = torch.where(valid[..., None], points.float(),
                    torch.full_like(points, FAR, dtype=torch.float32))
    n2 = _dot3(p, p)
    cross = _dot3(p[..., :, None, :], p[..., None, :, :])
    d2 = torch.clamp_min((n2[..., :, None] + n2[..., None, :]) - 2.0 * cross, 0.0)
    small = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
    acc = torch.zeros_like(n2)
    for i in range(k):
        acc = acc + torch.sqrt(torch.clamp_max(small[..., i], 1e30))
    mean = acc / scalar_like(float(max(k - 1, 1)), acc)
    sat = small[..., k - 1] >= FAR * FAR * 0.25
    mean = torch.where(valid, mean, torch.full_like(mean, BIG))
    return mean, sat | ~valid


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"sor_knn kernels take 1 <= k <= {n} (the rows), got {k}")


def _launch_names(name: str, k: int) -> tuple:
    """`name`, and its large-k count when k takes the radix-select kernel."""
    return (name, f"{name}_large_k") if k > REGISTER_MAX_K else (name,)


def sor_knn_mean_slots(points: torch.Tensor, valid: torch.Tensor, k: int,
                       plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 (replaces `_sor_knn_kernel` via `sor_knn_mean_pallas_slots`,
    rt3d/geometry/pallas_ops.py): per slot of (S, K, 3) points, each valid
    point's k-nearest mean distance within its own slot and whether the
    slot ran out of valid neighbours."""
    if not kernels.use_kernel(points, plain):
        return sor_knn_mean_plain(points, valid, k)
    s, cap, _ = points.shape
    kernels.check(points, torch.float32, (s, cap, 3), "sor_knn_slots points")
    kernels.check(valid, torch.bool, (s, cap), "sor_knn_slots valid")
    _check_k(k, cap)
    mean = torch.empty((s, cap), dtype=torch.float32, device=points.device)
    sat = torch.empty((s, cap), dtype=torch.bool, device=points.device)
    kernels.launch(_launch_names("sor_knn_slots", k), "rt3d_sor_knn_slots",
                   points.data_ptr(), valid.data_ptr(), mean.data_ptr(), sat.data_ptr(),
                   s, cap, k)
    return mean, sat


def sor_knn_mean(points: torch.Tensor, valid: torch.Tensor, k: int,
                 plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 (replaces `_sor_knn_kernel` via `sor_knn_mean_pallas`,
    rt3d/geometry/pallas_ops.py): K3's statistic over one cloud of (N, 3)
    points, with the bits K3 gives for the same cloud as a slot."""
    if not kernels.use_kernel(points, plain):
        return sor_knn_mean_plain(points, valid, k)
    n = points.shape[0]
    kernels.check(points, torch.float32, (n, 3), "sor_knn points")
    kernels.check(valid, torch.bool, (n,), "sor_knn valid")
    _check_k(k, n)
    mean = torch.empty((n,), dtype=torch.float32, device=points.device)
    sat = torch.empty((n,), dtype=torch.bool, device=points.device)
    kernels.launch(_launch_names("sor_knn", k), "rt3d_sor_knn", points.data_ptr(),
                   valid.data_ptr(), mean.data_ptr(), sat.data_ptr(), n, k)
    return mean, sat


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., Na, Nb) by the identity |a|^2 + |b|^2 - 2 a.b,
    clamped at 0. The dot products are summed elementwise, so no matmul
    precision setting (TF32 on the card) reaches them."""
    a, b = a.float(), b.float()
    cross = _dot3(a[..., :, None, :], b[..., None, :, :])
    return torch.clamp_min((_dot3(a, a)[..., :, None] + _dot3(b, b)[..., None, :])
                           - 2.0 * cross, 0.0)


def _mean_of_smallest(small: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The XLA forms' statistic from the k smallest d2 per row: the square
    roots below 1e18 summed over max(k - 1, 1), and whether a 3.4e38 entry
    (a missing neighbour) was among them."""
    dists = torch.sqrt(torch.clamp_min(small, 0.0))
    total = torch.where(dists < 1e18, dists, 0.0).sum(-1)
    return total / scalar_like(float(max(k - 1, 1)), total), (small >= BIG * 0.5).any(-1)


def knn_mean_xla(points: torch.Tensor, valid: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact form of (..., N, 3) clouds (`_knn_mean_xla`, vmapped over
    the leading axes): invalid points can never be neighbours, the
    self-distance is exactly 0."""
    d2 = torch.where(valid[..., None, :], pairwise_sqdist(points, points), BIG)
    d2.diagonal(dim1=-2, dim2=-1).fill_(0.0)
    small = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
    return _mean_of_smallest(small, k)


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


def sor_inlier_mask(points: torch.Tensor, valid: torch.Tensor,
                    nb_neighbors: int = 20, std_ratio: float = 1.5,
                    plain: bool = False) -> torch.Tensor:
    """Inlier mask (N,) of one padded (N, 3) cloud: above 4096 rows the
    Morton-window form, from 256 to 4096 rows K5 (its plain version on a
    CPU tensor or with ``plain=True``), below 256 rows the exact form."""
    n = points.shape[0]
    if n > EXACT_MAX_N:
        return sor_inlier_mask_windowed(points, valid, nb_neighbors, std_ratio)
    k = min(nb_neighbors, n)
    if n >= KERNEL_MIN_N:
        mean_d, saturated = sor_knn_mean(points, valid, k, plain=plain)
    else:
        mean_d, saturated = knn_mean_xla(points, valid, k)
    return inlier_from_stats(valid, mean_d, saturated, std_ratio)


def sor_inlier_mask_slots(points: torch.Tensor, valid: torch.Tensor,
                          nb_neighbors: int = 20, std_ratio: float = 1.5,
                          plain: bool = False) -> torch.Tensor:
    """Inlier mask (S, K) of every slot's cloud, sized as
    `sor_inlier_mask` sizes one cloud: from 256 to 4096 rows one K3 launch
    for all slots, below 256 rows the exact form batched over the slots.
    Slots of more than 4096 points take the Morton-window form on the
    present slots only, as the JAX package does: a padded slot would pay
    the whole windowed pass on `cap` rows of padding. Finding them reads the
    present count back to the host once; empty slots keep all False."""
    s, cap, _ = points.shape
    if cap > EXACT_MAX_N:
        with trace.sync("sor.slots_present"):
            present = valid.any(-1).nonzero().squeeze(-1)
        keep = torch.zeros_like(valid)
        keep[present] = sor_inlier_mask_windowed(points[present], valid[present],
                                                 nb_neighbors, std_ratio)
        return keep
    k = min(nb_neighbors, cap)
    if cap >= KERNEL_MIN_N:
        mean_d, saturated = sor_knn_mean_slots(points, valid, k, plain=plain)
    else:
        mean_d, saturated = knn_mean_xla(points, valid, k)
    return inlier_from_stats(valid, mean_d, saturated, std_ratio)


def sor_filter(buf: PointBuffer, nb_neighbors: int = 20, std_ratio: float = 1.5
               ) -> PointBuffer:
    """SOR that keeps the padded layout: rows stay, `valid` shrinks."""
    keep = sor_inlier_mask(buf.points, buf.valid, nb_neighbors, std_ratio)
    return PointBuffer(points=buf.points, valid=keep)


# ---------------------------------------------------------------------------
# Morton-window SOR for workspace-scale clouds
# ---------------------------------------------------------------------------


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 `x` to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """30-bit Morton key (..., N) per point of (..., N, 3) clouds, quantized
    over each cloud's valid bounding box; invalid points get `INVALID_KEY`."""
    v = valid[..., None]
    lo = torch.where(v, points, 1e30).amin(-2, keepdim=True)
    hi = torch.where(v, points, -1e30).amax(-2, keepdim=True)
    scale = scalar_like(1023.0, points) / torch.clamp_min(hi - lo, 1e-6)
    q = torch.clamp((points - lo) * scale, 0.0, 1023.0).to(torch.int32)
    key = (_part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1)
           | (_part1by2(q[..., 2]) << 2))
    return torch.where(valid, key, INVALID_KEY)


def _windows(x: torch.Tensor, window: int, fill) -> torch.Tensor:
    """(..., N) -> (..., N, 2 window + 1): row i holds x[i - window .. i +
    window], `fill` past either end (a view of one padded copy)."""
    pad = torch.full(x.shape[:-1] + (window,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x, pad], dim=-1).unfold(-1, 2 * window + 1, 1)


def _knn_mean_windowed(points: torch.Tensor, valid: torch.Tensor, k: int,
                       window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate k-nearest mean over (..., N, 3) clouds: sort each cloud
    along the Z-order curve (a stable sort by key, which is the JAX
    package's (key, index) sort) and take as candidates the `window`
    predecessors and successors of each point in curve order, plus itself
    at distance 0. A candidate out of range or invalid counts as 3.4e38.
    Saturation is folded into the mean (3.4e38) before the unsort."""
    key = morton_keys(points, valid)
    skey, idx = torch.sort(key, dim=-1, stable=True)
    ok = skey != INVALID_KEY
    d2 = None
    for c in range(3):
        x = torch.gather(points[..., c], -1, idx)
        dx = _windows(x, window, 0.0) - x[..., None]
        d2 = dx * dx if d2 is None else d2 + dx * dx
    d2 = torch.where(_windows(ok, window, False), d2, BIG)
    d2[..., window] = 0.0
    small = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
    mean_sorted, sat_sorted = _mean_of_smallest(small, k)
    folded = torch.where(sat_sorted, BIG, mean_sorted)
    mean_d = torch.empty_like(folded).scatter_(-1, idx, folded)
    return mean_d, mean_d >= BIG * 0.5


def sor_inlier_mask_windowed(points: torch.Tensor, valid: torch.Tensor,
                             nb_neighbors: int = 20, std_ratio: float = 1.5,
                             window: int = 64) -> torch.Tensor:
    """Workspace-scale SOR of (..., N, 3) clouds: Morton-window k-nearest
    means and each cloud's mu/sigma gate over all its N rows."""
    k = min(nb_neighbors, points.shape[-2])
    mean_d, saturated = _knn_mean_windowed(points, valid, k, window)
    return inlier_from_stats(valid, mean_d, saturated, std_ratio)


def sor_filter_windowed(buf: PointBuffer, nb_neighbors: int = 20,
                        std_ratio: float = 1.5, window: int = 64) -> PointBuffer:
    keep = sor_inlier_mask_windowed(buf.points, buf.valid, nb_neighbors,
                                    std_ratio, window)
    return PointBuffer(points=buf.points, valid=keep)
