"""Parity of the port's SOR (`rt3d_torch.geometry.sor`) with the JAX package.

Covers K5 (`sor_knn_mean`, through its plain version on the CPU), the
single-cloud entry points `sor_inlier_mask` and `sor_filter` on each branch
of their size dispatch, and the Morton-window form with the per-slot
fallback of `sor_inlier_mask_slots`. Clouds are made with numpy from a
seed: a noisy surface patch on a 5 mm lattice with a few far outliers, a
third of the rows invalid with garbage coordinates.

Tolerances, each with its reason:

* exact form and kernels: means within 2e-3 relative. Both sides evaluate
  d2 = |q|^2 + |r|^2 - 2 q.r in f32, whose cancellation error (about 1e-7
  m^2 at 0.5 m from the origin) is a few per mille of the 5 mm neighbour
  spacing's d2. Keep masks are exact outside a band of 2e-3 of the
  threshold around it.
* Morton-window form: both sides take coordinate differences, so means
  differ only by the order in which the 20 square roots are summed (XLA
  picks its own), a few ulps; the cloud's mu and sigma are sums over all
  rows in another order too. Means within 1e-5 relative, keep masks exact
  outside a band of 1e-5 of the threshold.

Saturation flags and Morton keys are exact everywhere.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt3d.geometry import ops as jops
from rt3d.geometry import pallas_ops
from rt3d.geometry import sor as jsor
from rt3d_torch import kernels
from rt3d_torch.geometry import ops, sor
from tests.test_torch_geometry import interpret_pallas  # noqa: F401  (fixture)

EXACT_REL = 2e-3
WINDOW_REL = 1e-5


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cloud(rng, n, invalid=1 / 3, n_valid=None, voxel=0.005):
    """(n, 3) f32 points, (n,) valid: a lattice surface patch with noise
    in z and 3 % far outliers, rows shuffled; invalid rows hold garbage."""
    side = int(np.ceil(np.sqrt(n)))
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"),
                 -1).reshape(-1, 2)[:n]
    z = np.round(rng.normal(0, 0.003, (n, 1)) / voxel) * voxel
    pts = np.concatenate([g * voxel, z], 1) + [0.2, 0.5, 0.1]
    out = rng.uniform(size=n) < 0.03
    pts[out] += rng.uniform(-0.1, 0.1, (out.sum(), 3))
    pts = pts[rng.permutation(n)].astype(np.float32)
    if n_valid is None:
        valid = rng.uniform(size=n) >= invalid
    else:
        valid = np.zeros(n, bool)
        valid[rng.choice(n, n_valid, replace=False)] = True
    pts[~valid] = rng.normal(size=((~valid).sum(), 3))
    return pts, valid


def _outside_band(mean, sat, valid, rel):
    """Rows whose mean lies farther than `rel` of the threshold from it
    (thresholds from the port's own means, over the last axis)."""
    mean = np.where(sat, np.float32(3.4e38), mean).astype(np.float64)
    ok = valid & ~sat
    thr = np.zeros(mean.shape[:-1] + (1,))
    for idx in np.ndindex(*mean.shape[:-1]):
        m = mean[idx][ok[idx]]
        if len(m) > 1:
            thr[idx] = m.mean() + 1.5 * m.std(ddof=1)
    return ~valid | (np.abs(mean - thr) > rel * thr)


def _port_stats(pts, valid, k):
    """The port's statistic from the form `sor_inlier_mask` takes at this
    size, and the tolerance of that form."""
    n = len(pts)
    if n > sor.EXACT_MAX_N:
        return (*map(N, sor._knn_mean_windowed(T(pts), T(valid), k, 64)), WINDOW_REL)
    if n >= sor.KERNEL_MIN_N:
        return (*map(N, sor.sor_knn_mean(T(pts), T(valid), k)), EXACT_REL)
    return (*map(N, sor.knn_mean_xla(T(pts), T(valid), k)), EXACT_REL)


# ---------------------------------------------------------------------------
# K5 and the exact form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("n,n_valid", [(300, None), (2048, None), (300, 12)])
def test_sor_knn_mean_matches_jax(rng, interpret_pallas, reference, n, n_valid):
    """K5's plain version against `_knn_mean_xla` and the Pallas kernel in
    interpret mode: saturation exact on valid rows, means of valid
    unsaturated rows within 2e-3 relative. (300, 12) has fewer valid
    points than k, so every valid row saturates."""
    pts, valid = _cloud(rng, n, n_valid=n_valid)
    k = 20
    mean, sat = map(N, sor.sor_knn_mean(T(pts), T(valid), k))
    if reference == "xla":
        jmean, jsat = jsor._knn_mean_xla(jnp.asarray(pts), jnp.asarray(valid), k)
    else:
        jmean, jsat = pallas_ops.sor_knn_mean_pallas(jnp.asarray(pts), jnp.asarray(valid), k=k)
    jmean, jsat = N(jmean), N(jsat)
    np.testing.assert_array_equal(sat[valid], jsat[valid])
    ok = valid & ~sat
    np.testing.assert_allclose(mean[ok], jmean[ok], rtol=EXACT_REL)
    assert ok.sum() == (0 if n_valid else valid.sum())


def test_exact_form_matches_jax(rng):
    """The exact form the port runs below 256 rows, on any device."""
    pts, valid = _cloud(rng, 100)
    mean, sat = map(N, sor.knn_mean_xla(T(pts), T(valid), 20))
    jmean, jsat = map(N, jsor._knn_mean_xla(jnp.asarray(pts), jnp.asarray(valid), 20))
    np.testing.assert_array_equal(sat, jsat)
    np.testing.assert_allclose(mean[~sat], jmean[~sat], rtol=EXACT_REL)
    # the identity's f32 rounding: a few ulps of |q|^2 + |r|^2 (up to 10 m^2
    # with the garbage rows), and 1e-6 m^2 absolute where d2 cancels to ~0
    np.testing.assert_allclose(N(sor.pairwise_sqdist(T(pts), T(pts))),
                               N(jsor.pairwise_sqdist(jnp.asarray(pts), jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# sor_inlier_mask / sor_filter: every branch of the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [100, 300, 2048, 6000])
def test_sor_inlier_mask_and_filter_match_jax(rng, n):
    """Keep masks equal the JAX package's outside the band of the form this
    size takes (exact form below 256, K5 up to 4096, windowed above);
    `sor_filter` keeps the layout and returns the same mask."""
    pts, valid = _cloud(rng, n)
    got = N(sor.sor_inlier_mask(T(pts), T(valid), 20, 1.5))
    exp = N(jax.jit(jsor.sor_inlier_mask)(jnp.asarray(pts), jnp.asarray(valid)))
    mean, sat, rel = _port_stats(pts, valid, 20)
    outside = _outside_band(mean, sat, valid, rel)
    np.testing.assert_array_equal(got[outside], exp[outside])
    assert outside[valid].mean() > 0.95  # the band holds few rows (none at these seeds)
    assert 0.8 * valid.sum() < got.sum() < valid.sum()
    buf = ops.PointBuffer(T(pts), T(valid))
    out = sor.sor_filter(buf)
    assert out.points is buf.points
    np.testing.assert_array_equal(N(out.valid), got)
    jout = jax.jit(jsor.sor_filter)(jops.PointBuffer(jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_array_equal(N(out.valid)[outside], N(jout.valid)[outside])


@pytest.mark.parametrize("n,form", [(100, "knn_mean_xla"), (255, "knn_mean_xla"),
                                    (256, "sor_knn_mean"), (4096, "sor_knn_mean"),
                                    (4097, "_knn_mean_windowed")])
def test_sor_inlier_mask_dispatch(rng, monkeypatch, n, form):
    """The JAX package's size dispatch: exact form below 256 rows, K5 from
    256 to 4096, the Morton window above."""
    calls = []
    for name in ("knn_mean_xla", "sor_knn_mean", "_knn_mean_windowed"):
        fn = getattr(sor, name)
        monkeypatch.setattr(sor, name, functools.partial(
            lambda fn, name, *a, **kw: calls.append(name) or fn(*a, **kw), fn, name))
    pts, valid = _cloud(rng, n)
    sor.sor_inlier_mask(T(pts), T(valid))
    assert calls == [form]


# ---------------------------------------------------------------------------
# Morton-window SOR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["cloud", "few_valid", "all_invalid"])
def test_windowed_sor_matches_jax(rng, case):
    """8192 rows: Morton keys and saturation exact, means within 1e-5
    relative, keep masks exact outside the 1e-5 band. With fewer valid
    points than k every row saturates and nothing is kept; with none valid
    nothing is kept either."""
    n = 8192
    pts, valid = _cloud(rng, n, n_valid={"cloud": None, "few_valid": 12,
                                         "all_invalid": 0}[case])
    tp, tv, jp, jv = T(pts), T(valid), jnp.asarray(pts), jnp.asarray(valid)
    np.testing.assert_array_equal(N(sor.morton_keys(tp, tv)), N(jsor.morton_keys(jp, jv)))
    mean, sat = map(N, sor._knn_mean_windowed(tp, tv, 20, 64))
    jmean, jsat = map(N, jax.jit(jsor._knn_mean_windowed, static_argnums=(2, 3))(jp, jv, 20, 64))
    np.testing.assert_array_equal(sat, jsat)
    np.testing.assert_allclose(mean[~sat], jmean[~sat], rtol=WINDOW_REL)
    got = N(sor.sor_inlier_mask_windowed(tp, tv))
    exp = N(jax.jit(jsor.sor_inlier_mask_windowed)(jp, jv))
    outside = _outside_band(mean, sat, valid, WINDOW_REL)
    np.testing.assert_array_equal(got[outside], exp[outside])
    if case == "cloud":
        assert 0.8 * valid.sum() < got.sum() < valid.sum()
        assert outside[valid].mean() > 0.99
    else:
        assert sat.all() and not got.any()
    buf = sor.sor_filter_windowed(ops.PointBuffer(tp, tv))
    np.testing.assert_array_equal(N(buf.valid), got)


def test_sor_inlier_mask_slots_windowed_fallback(rng):
    """Capacity 4608 takes the per-slot fallback: a cloud, an empty slot
    and a slot with fewer valid points than k. Equal to the JAX package
    outside the band, and bit for bit to the port's own single-cloud call
    per slot and to one batched windowed pass over every slot (the
    fallback runs the present slots only)."""
    cap = 4608
    a, av = _cloud(rng, cap)
    c, cv = _cloud(rng, cap, n_valid=15)
    pts = np.stack([a, rng.normal(size=(cap, 3)).astype(np.float32), c])
    valid = np.stack([av, np.zeros(cap, bool), cv])
    got = N(sor.sor_inlier_mask_slots(T(pts), T(valid), 20, 1.5))
    exp = N(jax.jit(jsor.sor_inlier_mask_slots)(jnp.asarray(pts), jnp.asarray(valid)))
    mean, sat = map(N, sor._knn_mean_windowed(T(pts), T(valid), 20, 64))
    outside = _outside_band(mean, sat, valid, WINDOW_REL)
    np.testing.assert_array_equal(got[outside], exp[outside])
    assert 0 < got[0].sum() < valid[0].sum() and not got[1:].any()
    for s in range(3):
        np.testing.assert_array_equal(got[s], N(sor.sor_inlier_mask(T(pts[s]), T(valid[s]))))
    np.testing.assert_array_equal(got, N(sor.sor_inlier_mask_windowed(T(pts), T(valid))))


def test_sor_inlier_mask_slots_fallback_all_empty(rng):
    """With no present slot the fallback runs nothing and keeps nothing,
    as the JAX package's per-slot skip does."""
    cap = 4608
    pts = rng.normal(size=(2, cap, 3)).astype(np.float32)
    valid = np.zeros((2, cap), bool)
    got = N(sor.sor_inlier_mask_slots(T(pts), T(valid)))
    exp = N(jax.jit(jsor.sor_inlier_mask_slots)(jnp.asarray(pts), jnp.asarray(valid)))
    assert got.shape == (2, cap) and not got.any() and not exp.any()


@pytest.mark.parametrize("k", [20, 40])
def test_sor_inlier_mask_slots_below_kernel_size(rng, k):
    """Capacity 128 takes the exact form batched over the slots, as
    `sor_inlier_mask` takes it for one cloud of 128 rows: equal to it slot
    by slot bit for bit, with any k (40 > the kernels' 32), and to the JAX
    package outside the exact form's band. Slots: a cloud, one with fewer
    valid points than k, an empty one."""
    cap = 128
    a, av = _cloud(rng, cap)
    c, cv = _cloud(rng, cap, n_valid=15)
    pts = np.stack([a, c, rng.normal(size=(cap, 3)).astype(np.float32)])
    valid = np.stack([av, cv, np.zeros(cap, bool)])
    got = N(sor.sor_inlier_mask_slots(T(pts), T(valid), k, 1.5))
    for s in range(3):
        np.testing.assert_array_equal(got[s], N(sor.sor_inlier_mask(T(pts[s]), T(valid[s]), k, 1.5)))
    exp = N(jsor.sor_inlier_mask_slots(jnp.asarray(pts), jnp.asarray(valid), k, 1.5))
    mean, sat = map(N, sor.knn_mean_xla(T(pts), T(valid), k))
    outside = _outside_band(mean, sat, valid, EXACT_REL)
    np.testing.assert_array_equal(got[outside], exp[outside])
    assert 0 < got[0].sum() < valid[0].sum() and not got[1:].any()


@pytest.mark.parametrize("cap,form", [(128, "knn_mean_xla"), (255, "knn_mean_xla"),
                                      (256, "sor_knn_mean_slots"), (4096, "sor_knn_mean_slots")])
def test_sor_inlier_mask_slots_dispatch(rng, monkeypatch, cap, form):
    """The slots are sized as one cloud is: the exact form below 256 rows,
    K3 from 256 to 4096."""
    calls = []
    for name in ("knn_mean_xla", "sor_knn_mean_slots"):
        fn = getattr(sor, name)
        monkeypatch.setattr(sor, name, functools.partial(
            lambda fn, name, *a, **kw: calls.append(name) or fn(*a, **kw), fn, name))
    pts, valid = _cloud(rng, cap)
    sor.sor_inlier_mask_slots(T(pts)[None], T(valid)[None])
    assert calls == [form]


def test_cpu_sor_launches_nothing(rng):
    kernels.reset_launches()
    pts, valid = _cloud(rng, 300)
    sor.sor_inlier_mask(T(pts), T(valid))
    sor.sor_knn_mean(T(pts), T(valid), 20)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
