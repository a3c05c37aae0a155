"""The port's kernels over the JAX package's whole input domain, on the CPU:
K3 and K5 at k above their register path's 32, K1 and K2 at windows wider
than 4 x 6, and a two-camera step with ``sor_nb_neighbors=50``.

On the CPU each wrapper takes its plain PyTorch version, which the card's
kernels equal bit for bit (`tests/test_torch_kernels_cuda.py`,
`chip_smoke.py`). Inputs are made with numpy from a seed. Tolerances, each
with its reason:

* K3/K5 means within 2e-3 relative of the JAX package's, keep masks exact
  outside a band of 2e-3 of the threshold around it: the f32 cancellation
  of d2 = |q|^2 + |r|^2 - 2 q.r, as in `tests/test_torch_sor.py`, whose
  clouds and band these tests reuse. Saturation is exact.
* K1/K2 outputs exact.
* The step: the tolerances of `tests/test_torch_step.py`, whose config and
  runner it reuses.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rt3d.geometry import ops as jops
from rt3d.geometry import pallas_ops
from rt3d.geometry import sor as jsor
from rt3d_torch import kernels
from rt3d_torch.geometry import ops, sor
from rt3d_torch.io import SyntheticSource
from tests.test_torch_geometry import _key_grid, interpret_pallas  # noqa: F401  (fixture)
from tests.test_torch_sor import EXACT_REL, _cloud, _outside_band
from tests.test_torch_step import WEIGHTS, run_both, small_config

SENT = ops.INT_SENTINEL


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_stats_match(mean, sat, jmean, jsat, valid):
    """Saturation exact on valid rows, means of valid unsaturated rows
    within 2e-3 relative."""
    np.testing.assert_array_equal(sat[valid], jsat[valid])
    ok = valid & ~sat
    np.testing.assert_allclose(mean[ok], jmean[ok], rtol=EXACT_REL)
    return ok


# ---------------------------------------------------------------------------
# K3 / K5 above k = 32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("k", [33, 48, 64, 256])
def test_sor_knn_mean_large_k_matches_jax(rng, interpret_pallas, reference, k):
    """K5's plain version on a 512-row cloud against `_knn_mean_xla` and the
    Pallas kernel in interpret mode."""
    pts, valid = _cloud(rng, 512)
    mean, sat = map(N, sor.sor_knn_mean(T(pts), T(valid), k))
    if reference == "xla":
        jmean, jsat = jsor._knn_mean_xla(jnp.asarray(pts), jnp.asarray(valid), k)
    else:
        jmean, jsat = pallas_ops.sor_knn_mean_pallas(jnp.asarray(pts), jnp.asarray(valid), k=k)
    ok = _assert_stats_match(mean, sat, N(jmean), N(jsat), valid)
    assert ok.sum() == valid.sum()


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("k", [33, 48, 64, 256])
def test_sor_knn_mean_slots_large_k_matches_jax(rng, interpret_pallas, reference, k):
    """K3's plain version on three slots of 256 rows (a cloud, one with
    fewer valid rows than k, an empty one) against `_knn_mean_xla` per slot
    and the slot-batched Pallas kernel in interpret mode. At k = 256 = cap
    the padding's copies close every row's k, so every valid row
    saturates."""
    cap = 256
    a, av = _cloud(rng, cap)
    c, cv = _cloud(rng, cap, n_valid=min(k - 1, 30))
    pts = np.stack([a, c, rng.normal(size=(cap, 3)).astype(np.float32)])
    valid = np.stack([av, cv, np.zeros(cap, bool)])
    mean, sat = map(N, sor.sor_knn_mean_slots(T(pts), T(valid), k))
    if reference == "xla":
        ref = [jsor._knn_mean_xla(jnp.asarray(p), jnp.asarray(v), k) for p, v in zip(pts, valid)]
        jmean, jsat = np.stack([N(r[0]) for r in ref]), np.stack([N(r[1]) for r in ref])
    else:
        jmean, jsat = map(N, pallas_ops.sor_knn_mean_pallas_slots(
            jnp.asarray(pts), jnp.asarray(valid), k=k))
    ok = _assert_stats_match(mean, sat, jmean, jsat, valid)
    assert sat[1][valid[1]].all()
    assert ok[0].sum() == (0 if k == cap else av.sum())


@pytest.mark.parametrize("n", [100, 300, 2048])
def test_sor_inlier_mask_at_50_neighbours_matches_jax(rng, n):
    """`sor_inlier_mask` and `sor_filter` at nb_neighbors = 50 (the exact
    form below 256 rows, K5 above) against the JAX package's, exact outside
    the band."""
    pts, valid = _cloud(rng, n)
    got = N(sor.sor_inlier_mask(T(pts), T(valid), 50, 1.5))
    exp = N(jsor.sor_inlier_mask(jnp.asarray(pts), jnp.asarray(valid), 50, 1.5))
    form = sor.sor_knn_mean if n >= sor.KERNEL_MIN_N else sor.knn_mean_xla
    mean, sat = map(N, form(T(pts), T(valid), 50))
    outside = _outside_band(mean, sat, valid, EXACT_REL)
    np.testing.assert_array_equal(got[outside], exp[outside])
    assert outside[valid].mean() > 0.95
    assert 0.8 * valid.sum() < got.sum() < valid.sum()
    np.testing.assert_array_equal(N(sor.sor_filter(ops.PointBuffer(T(pts), T(valid)), 50).valid),
                                  got)


@pytest.mark.parametrize("cap", [128, 512])
def test_sor_inlier_mask_slots_at_50_neighbours_matches_jax(rng, cap):
    """`sor_inlier_mask_slots` at nb_neighbors = 50, as the fused step calls
    it (the exact form at 128 rows, K3 at 512): a cloud, a slot with fewer
    valid rows than k and an empty one, against the JAX package's, exact
    outside the band, and slot by slot equal to `sor_inlier_mask`."""
    a, av = _cloud(rng, cap)
    c, cv = _cloud(rng, cap, n_valid=40)
    pts = np.stack([a, c, rng.normal(size=(cap, 3)).astype(np.float32)])
    valid = np.stack([av, cv, np.zeros(cap, bool)])
    got = N(sor.sor_inlier_mask_slots(T(pts), T(valid), 50, 1.5))
    exp = N(jsor.sor_inlier_mask_slots(jnp.asarray(pts), jnp.asarray(valid), 50, 1.5))
    form = sor.sor_knn_mean_slots if cap >= sor.KERNEL_MIN_N else sor.knn_mean_xla
    mean, sat = map(N, form(T(pts), T(valid), 50))
    outside = _outside_band(mean, sat, valid, EXACT_REL)
    np.testing.assert_array_equal(got[outside], exp[outside])
    assert 0 < got[0].sum() < valid[0].sum() and not got[1:].any()
    for s in range(3):
        np.testing.assert_array_equal(got[s], N(sor.sor_inlier_mask(T(pts[s]), T(valid[s]),
                                                                     50, 1.5)))


# ---------------------------------------------------------------------------
# K1 / K2 beyond 4 x 6
# ---------------------------------------------------------------------------

WIDE_WINDOWS = [(5, 6), (4, 7), (8, 12), (16, 3)]


@pytest.mark.parametrize("dy,dx", WIDE_WINDOWS)
def test_wide_window_kernels_match_pallas_and_xla(rng, dy, dx):
    """K1's and K2's plain versions at windows wider than 4 x 6 on a 48 x 256
    grid (the Pallas layout fits: H a multiple of 8 and 16, W of 128)
    against the Pallas kernels in interpret mode and the XLA forms."""
    kg, wg = _key_grid(rng, 48, 256)
    got_k1 = N(ops.window_dedupe(T(kg), dy, dx))
    got_k2 = N(ops.window_prev_or(T(kg), T(wg), dy, dx))
    pal_k1 = pallas_ops.window_dedupe_pallas(jnp.asarray(kg), SENT, dy, dx, interpret=True)
    pal_k2 = pallas_ops.window_prev_or_pallas(jnp.asarray(kg), jnp.asarray(wg), dy, dx,
                                              interpret=True)
    assert pal_k1 is not None and pal_k2 is not None
    np.testing.assert_array_equal(got_k1, N(pal_k1))
    np.testing.assert_array_equal(got_k1, N(jnp.where(
        jops._window_duplicate_mask(jnp.asarray(kg), dy, dx), SENT, kg)))
    np.testing.assert_array_equal(got_k2, N(pal_k2))
    np.testing.assert_array_equal(got_k2, N(jops._window_prev_or(jnp.asarray(kg),
                                                                 jnp.asarray(wg), dy, dx)))
    assert (got_k1 == SENT).sum() > (kg == SENT).sum()


@pytest.mark.parametrize("h,w,dy,dx", [(20, 50, dy, dx) for dy, dx in WIDE_WINDOWS]
                         + [(3, 5, 5, 6)])
def test_wide_window_kernels_match_xla_any_shape(rng, h, w, dy, dx):
    """Shapes the Pallas layout declines, words under sentinel keys, and (on
    the 3 x 5 grid) windows past every edge of the grid: equal to the XLA
    forms."""
    kg, _ = _key_grid(rng, h, w, nkeys=12)
    wg = rng.integers(0, 2**20, size=kg.shape).astype(np.int32)
    np.testing.assert_array_equal(
        N(ops.window_dedupe(T(kg), dy, dx)),
        N(jnp.where(jops._window_duplicate_mask(jnp.asarray(kg), dy, dx), SENT, kg)))
    np.testing.assert_array_equal(
        N(ops.window_prev_or(T(kg), T(wg), dy, dx)),
        N(jops._window_prev_or(jnp.asarray(kg), jnp.asarray(wg), dy, dx)))


def test_domain_on_cpu_launches_nothing(rng):
    """Large k and wide windows on CPU tensors take the plain versions."""
    kernels.reset_launches()
    pts, valid = _cloud(rng, 300)
    sor.sor_knn_mean(T(pts), T(valid), 100)
    sor.sor_knn_mean_slots(T(pts)[None], T(valid)[None], 300)
    kg, wg = _key_grid(rng, 8, 16)
    ops.window_dedupe(T(kg), 8, 12)
    ops.window_prev_or(T(kg), T(wg), 16, 3)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# A step with sor_nb_neighbors = 50
# ---------------------------------------------------------------------------

FRAMES = 2


@pytest.fixture(scope="module")
def runs50():
    src = SyntheticSource(num_cameras=2, num_frames=FRAMES, hw=(240, 320), num_objects=2)
    cfg = small_config(src.cameras())
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                sor_nb_neighbors=50))
    _, _, got, exp = run_both(cfg, WEIGHTS, src, FRAMES)
    return cfg, got, exp


def test_step_at_50_neighbours_matches_jax(runs50):
    """The tiny two-camera step (fused slots of 512 rows: K3's plain
    version at k = 50) against the JAX step op by op: detections as in
    `tests/test_torch_step.py`, the per-camera and fused object voxels and
    their keep masks exact; some fused slot keeps more than 50 points, so
    the statistic ran with k below the slot's count."""
    cfg, got, exp = runs50
    assert cfg.pipeline.sor_nb_neighbors == 50 and cfg.pipeline.max_points_fused_object >= 256
    for o, e in zip(got, exp):
        np.testing.assert_array_equal(N(o.detections.valid), N(e.detections.valid))
        np.testing.assert_allclose(N(o.detections.boxes), N(e.detections.boxes), atol=1e-3, rtol=0)
        np.testing.assert_array_equal(N(o.track_ids), N(e.track_ids))
        for name in ("per_camera_objects", "objects"):
            a, b = getattr(o, name), getattr(e, name)
            for f in ("points", "valid", "class_id", "present", "track_id"):
                np.testing.assert_array_equal(N(getattr(a, f)), N(getattr(b, f)),
                                              err_msg=f"{name}.{f}")
        np.testing.assert_array_equal(N(o.objects_flat.valid), N(e.objects_flat.valid))
        np.testing.assert_array_equal(N(o.workspace.points), N(e.workspace.points))
    assert N(got[-1].objects.valid).sum(-1).max() > 50
