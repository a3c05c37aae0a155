"""Constant-velocity Kalman filter over xyah boxes, batched over slots.

PyTorch port of `rt3d/tracking/kalman.py` (ByteTrack's `KalmanFilterXYAH`):
state [x, y, a, h, vx, vy, va, vh], observation [x, y, a, h], noise scaled
by box height. The 4x4 solves of the update and of DeepSORT's gating
distance use the same unrolled Cholesky as the JAX package, so both take
the same arithmetic path.
"""

from __future__ import annotations

from typing import Tuple

import torch

STD_POS = 1.0 / 20
STD_VEL = 1.0 / 160


def _motion(ref: torch.Tensor) -> torch.Tensor:
    f = torch.eye(8, dtype=torch.float32, device=ref.device)
    return f + torch.diag(torch.ones(4, dtype=torch.float32, device=ref.device), 4)


def xyxy_to_xyah(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    x = boxes[..., 0] + w / 2
    y = boxes[..., 1] + h / 2
    a = w / torch.clamp_min(h, 1e-6)
    return torch.stack([x, y, a, h], dim=-1)


def xyah_to_xyxy(xyah: torch.Tensor) -> torch.Tensor:
    x, y, a, h = xyah[..., 0], xyah[..., 1], xyah[..., 2], xyah[..., 3]
    w = a * h
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _diag_cov(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(std ** 2)


def kalman_initiate(measurement: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    h = measurement[..., 3]
    c1, c2 = torch.full_like(h, 1e-2), torch.full_like(h, 1e-5)
    std = torch.stack([2 * STD_POS * h, 2 * STD_POS * h, c1, 2 * STD_POS * h,
                       10 * STD_VEL * h, 10 * STD_VEL * h, c2, 10 * STD_VEL * h],
                      dim=-1)
    return mean, _diag_cov(std)


def kalman_predict(mean: torch.Tensor, cov: torch.Tensor):
    h = mean[..., 3]
    c1, c2 = torch.full_like(h, 1e-2), torch.full_like(h, 1e-5)
    std = torch.stack([STD_POS * h, STD_POS * h, c1, STD_POS * h,
                       STD_VEL * h, STD_VEL * h, c2, STD_VEL * h], dim=-1)
    f = _motion(mean)
    new_mean = torch.einsum("ij,...j->...i", f, mean)
    new_cov = torch.einsum("ij,...jk,lk->...il", f, cov, f) + _diag_cov(std)
    return new_mean, new_cov


def _chol_unrolled(s: torch.Tensor):
    """Lower Cholesky factor of (..., k, k) SPD matrices as a k x k list of
    (...,)-shaped entries."""
    k = s.shape[-1]
    l = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            acc = s[..., i, j]
            for m in range(j):
                acc = acc - l[i][m] * l[j][m]
            l[i][j] = torch.sqrt(acc) if i == j else acc / l[j][j]
    return l


def _forward_sub(l, b):
    z = [None] * len(l)
    for i in range(len(l)):
        acc = b[i]
        for m in range(i):
            acc = acc - l[i][m] * z[m]
        z[i] = acc / l[i][i]
    return z


def _backward_sub_t(l, y):
    k = len(l)
    x = [None] * k
    for i in reversed(range(k)):
        acc = y[i]
        for m in range(i + 1, k):
            acc = acc - l[m][i] * x[m]
        x[i] = acc / l[i][i]
    return x


def _project(mean: torch.Tensor, cov: torch.Tensor):
    h = mean[..., 3]
    std = torch.stack([STD_POS * h, STD_POS * h, torch.full_like(h, 1e-1),
                       STD_POS * h], dim=-1)
    return mean[..., :4], cov[..., :4, :4] + _diag_cov(std)


def gating_distance(mean: torch.Tensor, cov: torch.Tensor, measurements: torch.Tensor,
                     only_position: bool = False) -> torch.Tensor:
    """(S, D) squared Mahalanobis distance of each xyah measurement (D, 4)
    to each track's predicted measurement distribution (DeepSORT's gate);
    with `only_position`, over (x, y) only."""
    proj_mean, s = _project(mean, cov)
    if only_position:
        proj_mean, s = proj_mean[..., :2], s[..., :2, :2]
        measurements = measurements[..., :2]
    d = measurements[None, :, :] - proj_mean[:, None, :]
    l = _chol_unrolled(s)
    lb = [[e[:, None] if e is not None else None for e in row] for row in l]
    z = _forward_sub(lb, [d[..., i] for i in range(d.shape[-1])])
    return sum(zi * zi for zi in z)


def kalman_update(mean: torch.Tensor, cov: torch.Tensor,
                  measurement: torch.Tensor):
    """Measurement update with an xyah observation, batched."""
    proj_mean, s = _project(mean, cov)
    pht = cov[..., :, :4]
    l = _chol_unrolled(s)
    lb = [[e[..., None] if e is not None else None for e in row] for row in l]
    y = _forward_sub(lb, [pht[..., i] for i in range(4)])
    x = _backward_sub_t(lb, y)
    k = torch.stack(x, dim=-1)  # (..., 8, 4)
    innov = measurement - proj_mean
    new_mean = mean + torch.einsum("...ij,...j->...i", k, innov)
    new_cov = cov - torch.einsum("...ij,...jk,...lk->...il", k, s, k)
    return new_mean, new_cov
