"""BoT-SORT extensions over the fixed-slot tracker state (port of
`rt3d/tracking/botsort.py`): appearance association, smoothed track
features and camera-motion compensation (GMC).

* The first association fuses the IoU cost with the embedding cosine
  distance, halved, set to 1 beyond `appearance_thresh` or where the IoU
  proximity fails: ``cost = min(iou_cost, appearance_cost)``.
* Track features are an EMA (alpha 0.9) of the matched detections',
  re-normalized; a new track takes its detection's feature.
* GMC estimates the inter-frame motion of downsampled grey frames by FFT
  phase correlation: one translation over the frame, or an affine warp
  fitted by weighted least squares to a grid of patch translations. The
  predicted tracks are warped by it before matching.

The FFTs are torch's (cuFFT on the card); the JAX package's run on pocketfft
on the CPU. They round differently, so a phase-correlation peak on a
near-tie may move by a pixel: the tests hold warps within a tolerance.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from rt3d_torch.geometry.ops import scalar_like
from rt3d_torch.runtime import trace


def embedding_distance(track_emb: torch.Tensor, det_emb: torch.Tensor) -> torch.Tensor:
    """Cosine distance matrix (S, D) of L2-normalized embeddings."""
    return 1.0 - track_emb.float() @ det_emb.float().T


def botsort_fuse_costs(iou_cost: torch.Tensor, emb_cost: torch.Tensor,
                       proximity_thresh: float, appearance_thresh: float) -> torch.Tensor:
    """BOTSORT.get_dists: emb / 2, 1 beyond the appearance threshold or where
    the IoU proximity fails; the cost is the smaller of the two."""
    emb = emb_cost / 2.0
    emb = torch.where(emb > appearance_thresh, 1.0, emb)
    emb = torch.where(iou_cost > proximity_thresh, 1.0, emb)
    return torch.minimum(iou_cost, emb)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)


def update_smooth_features(track_emb: torch.Tensor, det_emb: torch.Tensor,
                           slot_det: torch.Tensor, fresh: torch.Tensor,
                           alpha: float = 0.9) -> torch.Tensor:
    """EMA feature update (STrack.update_features): `slot_det` (S,) is the
    detection matched to each slot or -1; a `fresh` slot (new this frame)
    takes its detection's feature, other matched slots blend and
    re-normalize."""
    di = torch.clamp(slot_det, 0, det_emb.shape[0] - 1).long()
    f_new = det_emb[di]
    matched = (slot_det >= 0)[:, None]
    blended = _l2_normalize(alpha * track_emb + (1 - alpha) * f_new)
    out = torch.where(matched & ~fresh[:, None], blended, track_emb)
    return torch.where(fresh[:, None] & matched, f_new, out)


def _hann2d(h: int, w: int, device) -> torch.Tensor:
    def hann(n):
        x = (2 * math.pi) * torch.arange(n, dtype=torch.float32, device=device)
        x = x / scalar_like(float(n - 1), x)
        return 0.5 - 0.5 * torch.cos(x)

    return hann(h)[:, None] * hann(w)[None, :]


def _phase_corr_shift(prev: torch.Tensor, cur: torch.Tensor, max_shift: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFT phase-correlation peak of grey image pairs (..., h, w): ((..., 2)
    (dx, dy) of the scene's motion from `prev` to `cur`, clipped to
    `max_shift`; (...,) peak strength). A Hann window damps the patch
    borders."""
    h, w = prev.shape[-2:]
    win = _hann2d(h, w, prev.device)
    f1 = torch.fft.rfft2(prev.float() * win)
    f2 = torch.fft.rfft2(cur.float() * win)
    cross = f1 * torch.conj(f2)
    cross = cross / torch.clamp_min(torch.abs(cross), 1e-9)
    corr = torch.fft.irfft2(cross, s=(h, w)).flatten(-2)
    idx = torch.argmax(corr, dim=-1)
    peak = torch.gather(corr, -1, idx[..., None])[..., 0]
    dy, dx = idx // w, idx % w
    dy = torch.where(dy > h // 2, dy - h, dy)
    dx = torch.where(dx > w // 2, dx - w, dx)
    dx = torch.clamp(dx, -max_shift, max_shift)
    dy = torch.clamp(dy, -max_shift, max_shift)
    return torch.stack([-dx, -dy], dim=-1).float(), peak


def estimate_translation_gmc(prev_gray: torch.Tensor, cur_gray: torch.Tensor,
                             max_shift: int = 32) -> torch.Tensor:
    """Global translation (dx, dy) in pixels by phase correlation."""
    return _phase_corr_shift(prev_gray, cur_gray, max_shift)[0]


def identity_warp(device="cuda") -> torch.Tensor:
    with trace.sync("botsort.identity_upload"):
        return torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=torch.float32,
                            device=device)


def translation_warp(shift_xy: torch.Tensor) -> torch.Tensor:
    """(2,) shift -> (2, 3) warp [I | shift]."""
    return torch.cat([identity_warp(shift_xy.device)[:, :2], shift_xy[:, None].float()], 1)


def _median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` of a 1-D tensor: the linear quantile at 0.5, in its
    arithmetic."""
    s = torch.sort(x).values
    q = 0.5 * (x.shape[0] - 1)
    lo, hi = math.floor(q), math.ceil(q)
    wh = q - lo
    return s[lo] * (1.0 - wh) + s[hi] * wh


def estimate_affine_gmc(prev_gray: torch.Tensor, cur_gray: torch.Tensor,
                        grid: Tuple[int, int] = (3, 4), max_shift: int = 24,
                        prior_strength: float = 0.05) -> torch.Tensor:
    """Affine camera motion (2, 3) [A | b] from prev-frame to cur-frame
    pixels: phase correlation of a `grid` of patches (DC removed), then a
    weighted least-squares fit of the patch centres' motion with a prior
    toward the identity (`prior_strength` of the total weight), refitted
    once with the patches reweighted by their residual."""
    gy, gx = grid
    h, w = prev_gray.shape
    ph, pw = h // gy, w // gx
    dev = prev_gray.device

    def patches(img):
        p = img[:gy * ph, :gx * pw].reshape(gy, ph, gx, pw).permute(0, 2, 1, 3)
        p = p.reshape(gy * gx, ph, pw)
        return p - p.mean(dim=(1, 2), keepdim=True)

    shifts, peaks = _phase_corr_shift(patches(prev_gray), patches(cur_gray), max_shift)
    cy = (torch.arange(gy, dtype=torch.float32, device=dev) + 0.5) * ph
    cx = (torch.arange(gx, dtype=torch.float32, device=dev) + 0.5) * pw
    centers = torch.stack([cx.repeat(gy), cy.repeat_interleave(gx)], dim=-1)
    targets = centers + shifts
    x1 = torch.cat([centers, torch.ones((centers.shape[0], 1), device=dev)], dim=-1)
    w0 = torch.clamp_min(peaks, 0.0)
    with trace.sync("botsort.prior_upload"):
        prior = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], device=dev)
    eye = torch.eye(3, device=dev)

    def solve(weights):
        lam = prior_strength * weights.sum() + 1e-6
        n = x1.T @ (weights[:, None] * x1) + lam * eye
        rhs = x1.T @ (weights[:, None] * targets) + lam * prior
        # torch.linalg.solve reads its error flag back to the host
        with trace.sync("botsort.gmc_solve"):
            return torch.linalg.solve(n, rhs)

    coef = solve(w0)
    resid = ((x1 @ coef - targets) ** 2).sum(-1)
    sigma2 = torch.clamp_min(_median(resid), 1.0)
    coef = solve(w0 / (1.0 + resid / sigma2))
    return coef.T


def rescale_warp(warp: torch.Tensor, scale: float, offset_xy) -> torch.Tensor:
    """A warp of downsampled letterboxed coordinates (p_small = scale *
    p_orig + offset) in original pixels: b = (A offset + b - offset) /
    scale."""
    a, b = warp[:, :2], warp[:, 2]
    with trace.sync("botsort.offset_upload"):
        o = torch.tensor(offset_xy, dtype=torch.float32, device=warp.device)
    b_o = (a @ o + b - o) / scalar_like(scale, b)
    return torch.cat([a, b_o[:, None]], dim=1)


def apply_gmc_to_tracks(mean: torch.Tensor, warp: torch.Tensor,
                        cov: Optional[torch.Tensor] = None):
    """Warp predicted xyah track states by the (2, 3) camera-motion warp:
    centres map affinely, heights and their velocity scale by
    sqrt(|det A|), velocities rotate by A; `cov`, when given, becomes
    M cov M^T with M the (8, 8) linearization of the same map."""
    a, b = warp[:, :2], warp[:, 2]
    scale = torch.sqrt(torch.abs(torch.linalg.det(a)))
    new_mean = mean.clone()
    new_mean[:, 0:2] = mean[:, 0:2] @ a.T + b
    new_mean[:, 3] = mean[:, 3] * scale
    new_mean[:, 4:6] = mean[:, 4:6] @ a.T
    new_mean[:, 7] = mean[:, 7] * scale
    if cov is None:
        return new_mean
    m = torch.eye(8, dtype=cov.dtype, device=cov.device)
    m[0:2, 0:2] = a
    m[3, 3] = scale
    m[4:6, 4:6] = a
    m[7, 7] = scale
    return new_mean, torch.einsum("ij,njk,lk->nil", m, cov, m)
