"""Device-side augmentation for detector training (port of
`rt3d/train/augment.py`).

Per step, every sample gets a fresh photometric jitter (gain, per-channel
balance, bias, sensor noise) and, where the letterbox pad is horizontally
symmetric, a random horizontal flip of the image and of its dense targets.
Both are geometry-exact, so the targets stay exact.

Each function is split into its draws (from an explicit `torch.Generator`
on the images' device) and a pure function of those draws, so that the
JAX package's own draws can be fed to the port. The bits of the draws
cannot match JAX's PRNG; their distributions do.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rt3d_torch.models.yolo import STRIDES


def photometric_draws(gen: torch.Generator, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The draws of `photometric_augment` for (B, H, W, 3) `images`: per
    sample a global gain U(0.7, 1.3), a per-channel scale U(0.9, 1.1), a
    bias U(-0.06, 0.06), a noise sigma U(0, 0.03), and unit Gaussian noise
    per pixel."""
    b, dev = images.shape[0], images.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    return {
        "gain": uniform((b, 1, 1, 1), 0.7, 1.3),
        "ch": uniform((b, 1, 1, 3), 0.9, 1.1),
        "bias": uniform((b, 1, 1, 1), -0.06, 0.06),
        "sigma": uniform((b, 1, 1, 1), 0.0, 0.03),
        "noise": torch.randn(images.shape, generator=gen, device=dev, dtype=images.dtype),
    }


def apply_photometric(images: torch.Tensor, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] jittered by the draws `d`, clipped to
    [0, 1]."""
    out = images * d["gain"] * d["ch"] + d["bias"] + d["noise"] * d["sigma"]
    return torch.clamp(out, 0.0, 1.0)


def photometric_augment(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> jittered images, same shape. The
    ranges bracket the hard domain's own per-scene lighting gain
    (0.75-1.15) and sensor noise (0.01-0.03)."""
    return apply_photometric(images, photometric_draws(gen, images))


def anchor_flip_perm(input_hw) -> np.ndarray:
    """(A,) permutation of the flattened anchor index under a horizontal
    image mirror: within each stride level's (gh, gw) grid, column j maps
    to gw-1-j."""
    h, w = input_hw
    parts, base = [], 0
    for s in STRIDES:
        gh, gw = h // s, w // s
        parts.append(np.arange(gh * gw).reshape(gh, gw)[:, ::-1].reshape(-1) + base)
        base += gh * gw
    return np.concatenate(parts).astype(np.int32)


def hflip_draws(gen: torch.Generator, images: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """(B,) bool: which samples `random_hflip` mirrors, each with
    probability `p`."""
    return torch.rand((images.shape[0],), generator=gen, device=images.device) < p


def apply_hflip(images: torch.Tensor, targets: dict, flip: torch.Tensor,
                perm: torch.Tensor, input_w: int):
    """Mirror the samples where `flip` is set: the image, and its targets.
    Anchors permute by `anchor_flip_perm`, ltrb distances swap l and r,
    instance masks mirror, instance boxes reflect about `input_w`; padded
    (all-zero) instance boxes stay zero, so flipping twice is the
    identity. Returns (images, targets) with the same structure."""
    b = images.shape[0]

    def sel(orig, flipped):
        return torch.where(flip.reshape((b,) + (1,) * (orig.ndim - 1)), flipped, orig)

    perm = perm.long()
    out_img = sel(images, images.flip(2))
    t = dict(targets)
    t["box"] = sel(targets["box"], targets["box"][:, perm][:, :, [2, 1, 0, 3]])
    t["box_w"] = sel(targets["box_w"], targets["box_w"][:, perm])
    t["inst_id"] = sel(targets["inst_id"], targets["inst_id"][:, perm])
    t["inst_mask"] = sel(targets["inst_mask"], targets["inst_mask"].flip(-1))
    ib = targets["inst_box"]
    ib_f = torch.stack([input_w - ib[..., 2], ib[..., 1], input_w - ib[..., 0], ib[..., 3]],
                       dim=-1)
    ib_f = torch.where(ib.abs().sum(-1, keepdim=True) > 0, ib_f, torch.zeros_like(ib_f))
    t["inst_box"] = sel(ib, ib_f)
    return out_img, t


def random_hflip(gen: torch.Generator, images: torch.Tensor, targets: dict,
                 perm: torch.Tensor, input_w: int, p: float = 0.5):
    """Per-sample horizontal flip of images and dense targets
    (`apply_hflip` on `hflip_draws`). Valid only when the letterbox pad is
    horizontally symmetric (pad_w even, 0 for HD720 into 384x640); the
    caller checks."""
    return apply_hflip(images, targets, hflip_draws(gen, images, p), perm, input_w)
