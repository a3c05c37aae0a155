"""Image-space mask ops: binary erosion and dilation, random subsample.

PyTorch port of `rt3d/geometry/image.py`. Erosion and dilation are a
max-pool over a k x k window placed as the JAX package's `reduce_window`
places it (padding k // 2 before and (k - 1) // 2 after), taken as two 1-D
pools, 1 x k then k x 1, which give the same booleans with 2k compares a
pixel instead of k^2. The pools run in float16, exact for 0 and 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.geometry.ops import PointBuffer


def _max_window(mask: torch.Tensor, k: int) -> torch.Tensor:
    """OR over each pixel's k x k window of a (..., H, W) bool mask; cells
    past the border count as False."""
    h, w = mask.shape[-2:]
    lo, hi = k // 2, (k - 1) // 2
    x = mask.reshape(1, -1, h, w).to(torch.float16)
    x = F.max_pool2d(F.pad(x, (lo, hi, 0, 0)), (1, k), stride=1)
    x = F.max_pool2d(F.pad(x, (0, 0, lo, hi)), (k, 1), stride=1)
    return (x > 0).reshape(mask.shape)


def erode_mask(mask: torch.Tensor, kernel_size: int = 10) -> torch.Tensor:
    """Binary erosion with a square all-ones element (cv2.erode): a pixel
    stays iff every cell of its window is set. Cells past the border count
    as set, as cv2's default border value does, so borders do not erode."""
    return ~_max_window(~mask, kernel_size)


def dilate_mask(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Binary dilation: a pixel is set iff any cell of its window is."""
    return _max_window(mask, kernel_size)


def random_subsample(buf: PointBuffer, fraction: float,
                     generator: torch.Generator) -> PointBuffer:
    """Keep each valid point with probability `fraction`, drawn from
    `generator` (the JAX function takes a PRNG key); layout preserved."""
    u = torch.rand(buf.valid.shape, generator=generator,
                   device=buf.valid.device)
    return PointBuffer(points=buf.points, valid=buf.valid & (u < fraction))
