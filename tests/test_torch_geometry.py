"""Parity of the port's geometry (`rt3d_torch.geometry`) with the JAX package.

Inputs are made with numpy from a seed and fed to both packages on the CPU,
where each port kernel wrapper takes its plain PyTorch version. The JAX side
runs its XLA fallbacks and, where the reference is a Pallas kernel, that
kernel in interpret mode. Integer outputs (voxel keys, masks, overflow
counts, matches) must be identical. Float tolerances are stated where they
are used, with their reason.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt3d.geometry import fusion as jfusion
from rt3d.geometry import ops as jops
from rt3d.geometry import pallas_ops
from rt3d.geometry import sor as jsor
from rt3d.geometry import subtract as jsub
from rt3d_torch import kernels
from rt3d_torch.geometry import fusion, ops, sor, subtract

SENT = ops.INT_SENTINEL


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run every `pl.pallas_call` of rt3d/geometry/pallas_ops.py in
    interpret mode (the JAX package itself is not edited)."""
    orig = pallas_ops.pl.pallas_call
    monkeypatch.setattr(pallas_ops.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _key_grid(rng, h, w, nkeys=40, sent_frac=0.2):
    kg = rng.integers(0, nkeys, size=(h, w)).astype(np.int32)
    kg[rng.uniform(size=(h, w)) < sent_frac] = SENT
    wg = rng.integers(1, 2**20, size=(h, w)).astype(np.int32)
    return kg, np.where(kg == SENT, 0, wg).astype(np.int32)


# ---------------------------------------------------------------------------
# K1 / K2: windowed pre-dedupe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dy,dx", [(4, 6), (2, 3), (0, 1)])
def test_window_kernels_match_pallas_and_xla(rng, dy, dx):
    kg, wg = _key_grid(rng, 24, 128)
    got_k1 = N(ops.window_dedupe(T(kg), dy, dx))
    got_k2 = N(ops.window_prev_or(T(kg), T(wg), dy, dx))
    pal_k1 = pallas_ops.window_dedupe_pallas(
        jnp.asarray(kg), SENT, dy, dx, interpret=True)
    pal_k2 = pallas_ops.window_prev_or_pallas(
        jnp.asarray(kg), jnp.asarray(wg), dy, dx, interpret=True)
    xla_k1 = jnp.where(jops._window_duplicate_mask(jnp.asarray(kg), dy, dx), SENT, kg)
    xla_k2 = jops._window_prev_or(jnp.asarray(kg), jnp.asarray(wg), dy, dx)
    assert pal_k1 is not None and pal_k2 is not None
    np.testing.assert_array_equal(got_k1, N(pal_k1))
    np.testing.assert_array_equal(got_k1, N(xla_k1))
    np.testing.assert_array_equal(got_k2, N(pal_k2))
    np.testing.assert_array_equal(got_k2, N(xla_k2))


def test_window_kernels_match_xla_any_width_and_words(rng):
    """Widths the Pallas layout declines, and nonzero words under sentinel
    keys: the port equals the XLA formulation everywhere."""
    kg, _ = _key_grid(rng, 20, 50, nkeys=12)
    wg = rng.integers(0, 2**20, size=kg.shape).astype(np.int32)
    np.testing.assert_array_equal(
        N(ops.window_dedupe(T(kg))),
        N(jnp.where(jops._window_duplicate_mask(jnp.asarray(kg), 4, 6), SENT, kg)))
    np.testing.assert_array_equal(
        N(ops.window_prev_or(T(kg), T(wg))),
        N(jops._window_prev_or(jnp.asarray(kg), jnp.asarray(wg), 4, 6)))


def _banded_key_grid(rng, h, w):
    """Keys with image locality (runs of equal keys over 2 x 3 pixels),
    sentinel in whole bands of 8 rows (the Pallas kernel's blocks) and in a
    column band, as the workspace grids have them."""
    r, c = np.arange(h)[:, None], np.arange(w)[None, :]
    kg = (r // 2 * 4096 + c // 3 + rng.integers(0, 2, size=(h, w))).astype(np.int32)
    sent = (((r // 8) % 3 == 1) | ((c >= 64) & (c < 128) & ((r // 8) % 3 == 0))
            | (rng.uniform(size=(h, w)) < 0.02))
    kg[sent] = SENT
    return kg


@pytest.mark.parametrize("dy,dx", [(4, 6), (1, 2)])
@pytest.mark.parametrize("h,w", [(24, 128), (40, 256)])
def test_window_dedupe_banded_matches_pallas_and_xla(rng, h, w, dy, dx):
    """K1's plain version on a grid with all-sentinel Pallas blocks beside
    live ones (both branches of the Pallas kernel run) equals the Pallas
    kernel in interpret mode and the XLA form."""
    kg = _banded_key_grid(rng, h, w)
    live_blocks = (kg != SENT).reshape(h // 8, -1).any(1)
    assert live_blocks.any() and not live_blocks.all()
    got = N(ops.window_dedupe(T(kg), dy, dx))
    pal = pallas_ops.window_dedupe_pallas(jnp.asarray(kg), SENT, dy, dx, interpret=True)
    xla = jnp.where(jops._window_duplicate_mask(jnp.asarray(kg), dy, dx), SENT, kg)
    assert pal is not None
    np.testing.assert_array_equal(got, N(pal))
    np.testing.assert_array_equal(got, N(xla))
    assert (got == SENT).sum() > (kg == SENT).sum()


@pytest.mark.parametrize("dy,dx", [(5, 6), (4, 7), (6, 9)])
def test_window_wrappers_take_wide_windows_on_cpu(rng, dy, dx):
    """Windows wider than 4 x 6 (the card's wide kernel): on the CPU the
    wrappers take them too and equal the XLA form there."""
    kg, wg = _key_grid(rng, 20, 40, nkeys=12)
    np.testing.assert_array_equal(
        N(ops.window_dedupe(T(kg), dy, dx)),
        N(jnp.where(jops._window_duplicate_mask(jnp.asarray(kg), dy, dx), SENT, kg)))
    np.testing.assert_array_equal(
        N(ops.window_prev_or(T(kg), T(wg), dy, dx)),
        N(jops._window_prev_or(jnp.asarray(kg), jnp.asarray(wg), dy, dx)))


def test_cpu_wrappers_launch_nothing(rng):
    kernels.reset_launches()
    kg, wg = _key_grid(rng, 8, 16)
    ops.window_dedupe(T(kg))
    ops.window_prev_or(T(kg), T(wg))
    subtract.min_sqdist(torch.zeros(4, 3), torch.zeros(2, 3), torch.ones(2, dtype=torch.bool))
    sor.sor_knn_mean_slots(torch.zeros(1, 8, 3), torch.ones(1, 8, dtype=torch.bool), 4)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# Elementwise and packing helpers
# ---------------------------------------------------------------------------


def test_backproject_strided_crop_centroid_match_jax(rng):
    depth = rng.uniform(0.2, 3.0, (2, 24, 40)).astype(np.float32)
    depth[0, 3, 5], depth[0, 4, 6], depth[1, 7, 8] = 0.0, np.nan, np.inf
    got = N(ops.strided_grid_downsample(T(depth), 2))
    np.testing.assert_array_equal(got, N(jops.strided_grid_downsample(jnp.asarray(depth), 2)))
    np.testing.assert_array_equal(N(ops.strided_grid_downsample(T(depth[:, :23]), 2)),
                                  depth[:, :23][:, ::2, ::2])
    fx, fy, cx, cy = (np.float32(v) for v in (500.0, 510.0, 20.5, 12.25))
    xyz, valid = ops.backproject_depth_grid(T(depth[0]), *(T(v) for v in (fx, fy, cx, cy)))
    jxyz, jvalid = jops.backproject_depth_grid(jnp.asarray(depth[0]), fx, fy, cx, cy)
    np.testing.assert_array_equal(N(xyz), N(jxyz))
    np.testing.assert_array_equal(N(valid), N(jvalid))
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    b = ((-0.5, 0.5), (-0.25, 0.75), (-1.0, 0.0))
    np.testing.assert_array_equal(N(ops.aabb_mask(T(pts), *b)),
                                  N(jops.aabb_mask(jnp.asarray(pts), *b)))
    v = rng.uniform(size=(4, 75)) < 0.5
    # sums over 75 rows in another order: a few f32 ulps
    np.testing.assert_allclose(
        N(ops.masked_centroid(T(pts.reshape(4, 75, 3)), T(v))),
        N(jops.masked_centroid(jnp.asarray(pts.reshape(4, 75, 3)), jnp.asarray(v))),
        rtol=1e-6, atol=1e-7)


def test_rigid_transform_matches_jax(rng):
    pts = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R, t = q.astype(np.float32), rng.normal(size=3).astype(np.float32)
    # the port sums ((x R0 + y R1) + z R2) + t without fused multiply-adds;
    # XLA's dot may fuse them, so the two differ by at most a few ulps
    np.testing.assert_allclose(
        N(ops.rigid_transform(T(pts), T(R), T(t))),
        N(jops.rigid_transform(jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t))),
        rtol=0, atol=4e-7)


@pytest.mark.parametrize("helper", ["quantize", "or_scan", "live_blocks",
                                    "compact", "bit_histogram"])
def test_packing_helpers_match_jax(rng, helper):
    if helper == "quantize":
        pts = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
        valid = rng.uniform(size=4000) < 0.8
        k, n, half = ops.quantize_packed(T(pts), T(valid), 0.005, 2.56)
        jk, jn, jhalf = jops._quantize_packed(jnp.asarray(pts), jnp.asarray(valid), 0.005, 2.56)
        np.testing.assert_array_equal(N(k), N(jk))
        assert (n, half) == (jn, jhalf)
        live = N(k) != SENT
        np.testing.assert_array_equal(
            N(ops.decode_packed(k, n, half, 0.005))[live],
            N(jops._decode_packed(jk, jn, jhalf, 0.005))[live])
    elif helper == "or_scan":
        word = rng.integers(0, 2**20, 1000).astype(np.int32)
        start = rng.uniform(size=1000) < 0.1
        np.testing.assert_array_equal(
            N(ops.segmented_or_scan(T(word), T(start))),
            N(jops.segmented_or_scan(jnp.asarray(word), jnp.asarray(start))))
    elif helper == "live_blocks":
        blk = rng.uniform(size=300) < 0.3
        for cap in (16, 300, 400):
            got = ops._live_block_indices(T(blk), cap)
            exp = jops._live_block_indices(jnp.asarray(blk), cap)
            for g, e in zip(got, exp):
                np.testing.assert_array_equal(N(g), N(e))
    elif helper == "compact":
        emit = rng.uniform(size=500) < 0.4
        vals = rng.normal(size=500).astype(np.float32)
        for cap in (50, 500, 700):
            (g,), gc, go, gv = ops.compact_scalars(T(emit), (T(vals),), cap)
            (e,), ec, eo, ev = jops.compact_scalars(jnp.asarray(emit), (jnp.asarray(vals),), cap)
            np.testing.assert_array_equal(N(g), N(e))
            np.testing.assert_array_equal(N(gv), N(ev))
            assert (int(gc), int(go)) == (int(ec), int(eo))
    else:
        word = rng.integers(0, 2**20, 700).astype(np.int32)
        np.testing.assert_array_equal(N(ops._bit_histogram(T(word), 20)),
                                      N(jops._bit_histogram(jnp.asarray(word), 20)))


# ---------------------------------------------------------------------------
# Voxel downsampling (K1 and K2 in context)
# ---------------------------------------------------------------------------


def _grid_cloud(rng, h, w, spread=0.3):
    pts = rng.uniform(-spread, spread, (h, w, 3)).astype(np.float32)
    return pts, rng.uniform(size=(h, w)) < 0.9


@pytest.mark.parametrize("capacity", [64, 256, 4096])
def test_voxel_downsample_grid_matches_jax(rng, capacity):
    """Same keys, same kept rows, same overflow, under capacity pressure
    too (64 and 256 keep only the smallest keys)."""
    pts, valid = _grid_cloud(rng, 40, 64)
    buf, ovf = ops.voxel_downsample_grid(T(pts), T(valid), 0.05, capacity)
    jbuf, jovf = jops.voxel_downsample_grid(jnp.asarray(pts), jnp.asarray(valid), 0.05, capacity)
    np.testing.assert_array_equal(N(buf.points), N(jbuf.points))
    np.testing.assert_array_equal(N(buf.valid), N(jbuf.valid))
    assert int(ovf) == int(jovf)


def _blob_masks(rng, d, h, w):
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((d, h, w), bool)
    for i in range(d):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(3, 10)
        masks[i] = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return masks


@pytest.mark.parametrize("case", ["roomy", "object_cap", "stage1_cap", "union_cap",
                                  "no_grid"])
def test_voxel_downsample_masks_matches_jax(rng, case):
    """Per-detection voxel sets and exactly attributed overflow, with each
    capacity of the packed path under pressure in turn."""
    h, w, d = 32, 64, 5
    pts, valid = _grid_cloud(rng, h, w, spread=0.1)
    masks = _blob_masks(rng, d, h, w)
    kw = dict(capacity=64, stage1_capacity=1024, union_capacity=512,
              grid_hw=(h, w))
    kw.update({"object_cap": dict(capacity=8), "stage1_cap": dict(stage1_capacity=256),
               "union_cap": dict(union_capacity=80), "no_grid": dict(grid_hw=None),
               "roomy": {}}[case])
    args = (pts.reshape(-1, 3), valid.reshape(-1), masks.reshape(d, -1))
    buf, ovf = ops.voxel_downsample_masks(*map(T, args), 0.02, **kw)
    jbuf, jovf = jops.voxel_downsample_masks(*map(jnp.asarray, args), 0.02, **kw)
    np.testing.assert_array_equal(N(buf.points), N(jbuf.points))
    np.testing.assert_array_equal(N(buf.valid), N(jbuf.valid))
    np.testing.assert_array_equal(N(ovf), N(jovf))
    if case != "roomy":
        assert N(ovf).sum() > 0


# ---------------------------------------------------------------------------
# K4: min-distance subtraction
# ---------------------------------------------------------------------------


def _lattice(rng, n, voxel=0.01, extent=30):
    return (rng.integers(-extent, extent, (n, 3)) * voxel).astype(np.float32)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_min_sqdist_matches_jax(rng, interpret_pallas, reference):
    """Voxel-lattice clouds, as in the pipeline, so many pairs sit exactly
    on the threshold sphere. Distances within the threshold agree to f32
    rounding of the formula each side uses; keep/drop decisions agree
    except at such ties: lattice pairs at exactly the threshold, which their
    f32 coordinates put within 1e-8 m^2 of it (lattice d2 values are 1e-4
    m^2 apart, so nothing else comes that close)."""
    thr = 0.06
    q = _lattice(rng, 1500)
    r = _lattice(rng, 2100)
    rv = rng.uniform(size=2100) < 0.3
    got = N(subtract.min_sqdist(T(q), T(r), T(rv)))
    if reference == "xla":
        exp = N(jsub.min_sqdist_to_set(jnp.asarray(q), jnp.ones(len(q), bool),
                                       jnp.asarray(r), jnp.asarray(rv)))
        # the matmul identity cancels |q|^2 + |r|^2 (<= 0.6 m^2 here)
        atol = 5e-7
    else:
        exp = N(pallas_ops.min_sqdist_pallas(jnp.asarray(q), jnp.asarray(r),
                                             jnp.asarray(rv), threshold=thr))
        # both use coordinate differences; only fused multiply-adds differ
        atol = 1e-9
    near = exp <= thr * thr
    np.testing.assert_allclose(got[near], exp[near], rtol=1e-6, atol=atol)
    d64 = ((q[:, None, :].astype(np.float64) - r[rv][None].astype(np.float64)) ** 2).sum(-1).min(1)
    tie = np.abs(d64 - thr * thr) < 1e-8
    keep_got, keep_exp = got > np.float32(thr) ** 2, exp > np.float32(thr) ** 2
    assert np.array_equal(keep_got[~tie], keep_exp[~tie])
    assert near.sum() > 100 and tie.sum() > 0


def _workspace_lattice(rng, n, n_valid, voxel=0.01):
    """Workspace-shaped queries: a voxel lattice sorted x-major by key,
    some rows holes at (0, 0, 0) and invalid, then an invalid zero tail."""
    lat = _lattice(rng, n_valid, voxel, int(round(0.3 / voxel)))
    lat = lat[np.lexsort((lat[:, 2], lat[:, 1], lat[:, 0]))]
    q = np.zeros((n, 3), np.float32)
    q[:n_valid] = lat
    valid = (np.arange(n) < n_valid) & (rng.uniform(size=n) >= 0.15)
    return np.where(valid[:, None], q, 0).astype(np.float32), valid


def _threshold_ties(q, r, rv, thr):
    d64 = ((q[:, None, :].astype(np.float64) - r[rv][None].astype(np.float64)) ** 2).sum(-1).min(1)
    return np.abs(d64 - thr * thr) < 1e-8


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_min_sqdist_threshold_matches_jax(rng, interpret_pallas, reference):
    """`min_sqdist` under the step's threshold and query validity, on
    workspace-shaped lattice queries with holes and an invalid tail: 3.4e38
    on invalid queries; on valid ones the tolerances and tie rule of
    `test_min_sqdist_matches_jax` against `min_sqdist_to_set` (given the
    same `query_valid`) and against `min_sqdist_pallas(threshold=thr)`,
    whose pruned rows are only promised to lie beyond the threshold."""
    thr = 0.06
    q, qv = _workspace_lattice(rng, 1700, 1300)
    r = _lattice(rng, 2100)
    rv = rng.uniform(size=2100) < 0.3
    got = N(subtract.min_sqdist(T(q), T(r), T(rv), threshold=thr, query_valid=T(qv)))
    assert (got[~qv] == np.float32(subtract.BIG)).all()
    if reference == "xla":
        exp = N(jsub.min_sqdist_to_set(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(r),
                                       jnp.asarray(rv)))
        atol = 5e-7
    else:
        exp = N(pallas_ops.min_sqdist_pallas(jnp.asarray(q), jnp.asarray(r),
                                             jnp.asarray(rv), threshold=thr))
        atol = 1e-9
    t2 = np.float32(thr) ** 2
    near = qv & (exp <= thr * thr)
    np.testing.assert_allclose(got[near], exp[near], rtol=1e-6, atol=atol)
    tie = _threshold_ties(q, r, rv, thr)
    ok = qv & ~tie
    assert np.array_equal((got > t2)[ok], (exp > t2)[ok])
    assert near.sum() > 100 and (qv & tie).sum() > 0


def test_min_sqdist_threshold_keeps_exact_rows(rng):
    """On the CPU the threshold changes no valid row: the plain version is
    exact everywhere, which meets the contract for any threshold."""
    q, qv = _workspace_lattice(rng, 900, 700)
    r = _lattice(rng, 500)
    rv = rng.uniform(size=500) < 0.5
    exact = N(subtract.min_sqdist(T(q), T(r), T(rv)))
    for thr in (0.06, 0.0, 1e3):
        got = N(subtract.min_sqdist(T(q), T(r), T(rv), threshold=thr, query_valid=T(qv)))
        np.testing.assert_array_equal(got[qv], exact[qv])
        assert (got[~qv] == np.float32(subtract.BIG)).all()


@pytest.mark.parametrize("voxel", [0.005, 0.01])
def test_subtract_min_dist_keep_matches_jax_with_holes(rng, voxel):
    """The keep mask of `subtract_min_dist` (now with the threshold and the
    workspace's validity passed to K4) against the JAX package's on lattice
    clouds with holes: equal except at threshold ties, and never keeping an
    invalid row."""
    thr = 0.06
    q, qv = _workspace_lattice(rng, 1500, 1200, voxel)
    r = _lattice(rng, 900, voxel, int(round(0.1 / voxel)))
    rv = np.arange(900) < 400
    ws, obj = ops.PointBuffer(T(q), T(qv)), ops.PointBuffer(T(r), T(rv))
    keep = N(subtract.subtract_min_dist(ws, obj, thr).valid)
    jkeep = N(jsub.subtract_min_dist(jops.PointBuffer(jnp.asarray(q), jnp.asarray(qv)),
                                     jops.PointBuffer(jnp.asarray(r), jnp.asarray(rv)), thr).valid)
    tie = _threshold_ties(q, r, rv, thr)
    assert np.array_equal(keep[~tie], jkeep[~tie])
    assert not keep[~qv].any() and 0 < keep.sum() < qv.sum()


def test_subtract_min_dist_matches_jax_and_empty_objects(rng):
    ws = ops.PointBuffer(T(_lattice(rng, 800)), T(rng.uniform(size=800) < 0.7))
    obj = ops.PointBuffer(T(_lattice(rng, 300)), torch.zeros(300, dtype=torch.bool))
    out = subtract.subtract_min_dist(ws, obj, 0.06)
    np.testing.assert_array_equal(N(out.valid), N(ws.valid))
    jout = jsub.subtract_min_dist(jops.PointBuffer(jnp.asarray(N(ws.points)), jnp.asarray(N(ws.valid))),
                                  jops.PointBuffer(jnp.asarray(N(obj.points)), jnp.asarray(N(obj.valid))),
                                  0.06)
    np.testing.assert_array_equal(N(out.valid), N(jout.valid))


# ---------------------------------------------------------------------------
# K3: slot-batched SOR
# ---------------------------------------------------------------------------


def _sor_slots(rng, s=3, cap=256):
    pts = np.zeros((s, cap, 3), np.float32)
    valid = np.zeros((s, cap), bool)
    # slot 0: a noisy 5 mm-voxel surface patch plus a few far outliers
    grid = np.stack(np.meshgrid(np.arange(14), np.arange(14), indexing="ij"), -1).reshape(-1, 2)
    surf = np.concatenate([grid * 0.005, rng.normal(0, 0.002, (len(grid), 1))], 1)
    pts[0, :196] = surf + [0.2, 0.5, 0.1]
    pts[0, 196:206] = rng.uniform(-0.5, 0.5, (10, 3)) + [0.2, 0.5, 0.1]
    valid[0, :206] = True
    # slot 1: fewer valid points than k -> saturated
    pts[1, :12] = rng.normal(0, 0.01, (12, 3))
    valid[1, :12] = True
    # slot 2: empty; invalid rows hold garbage coordinates
    pts[2] = rng.normal(size=(cap, 3))
    return pts, valid


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_sor_knn_matches_jax(rng, interpret_pallas, reference):
    """Means of valid, unsaturated rows agree within 2e-3 relative: both
    sides evaluate d2 = |q|^2 + |r|^2 - 2 q.r in f32, whose cancellation
    error (~1e-7 m^2 at 0.3 m from the origin) is a few per mille of the
    5 mm neighbour spacing's d2. Saturation flags agree exactly."""
    pts, valid = _sor_slots(rng)
    k = 20
    mean, sat = sor.sor_knn_mean_slots(T(pts), T(valid), k)
    if reference == "xla":
        jmean, jsat = jax.vmap(lambda p, v: jsor._knn_mean_xla(p, v, k))(
            jnp.asarray(pts), jnp.asarray(valid))
    else:
        jmean, jsat = pallas_ops.sor_knn_mean_pallas_slots(
            jnp.asarray(pts), jnp.asarray(valid), k=k)
    mean, sat, jmean, jsat = map(N, (mean, sat, jmean, jsat))
    np.testing.assert_array_equal(sat[valid], jsat[valid])
    ok = valid & ~sat
    assert ok.sum() == 206
    np.testing.assert_allclose(mean[ok], jmean[ok], rtol=2e-3)


def test_sor_inlier_mask_slots_matches_jax(rng):
    """Keep/drop decisions equal the JAX package's for every point whose
    mean lies outside the rounding band (2e-3 relative) of its slot's
    threshold."""
    pts, valid = _sor_slots(rng)
    got = N(sor.sor_inlier_mask_slots(T(pts), T(valid), 20, 1.5))
    exp = N(jsor.sor_inlier_mask_slots(jnp.asarray(pts), jnp.asarray(valid), 20, 1.5))
    mean, sat = map(N, sor.sor_knn_mean_slots(T(pts), T(valid), 20))
    ok = valid[0] & ~sat[0]
    mu = mean[0][ok].mean()
    thr = mu + 1.5 * mean[0][ok].std(ddof=1)
    band = np.abs(mean[0] - thr) < 2e-3 * thr
    np.testing.assert_array_equal(got[0][~band], exp[0][~band])
    np.testing.assert_array_equal(got[1:], exp[1:])
    assert 0 < got[0].sum() < valid[0].sum()


# ---------------------------------------------------------------------------
# Fusion
# ---------------------------------------------------------------------------


def _object_sets(rng, s1=6, s2=5, k=64, classes=(39, 41)):
    def one(s):
        pts = np.round(rng.uniform(0, 4, (s, k, 3))) * 0.05 + rng.normal(0, 1e-3, (s, k, 3))
        valid = rng.uniform(size=(s, k)) < 0.6
        cls = rng.choice(classes, s).astype(np.int32)
        present = rng.uniform(size=s) < 0.8
        tid = rng.integers(-1, 9, s).astype(np.int32)
        return pts.astype(np.float32), valid, cls, present, tid
    return one(s1), one(s2)


def _tsets(a):
    return fusion.ObjectSet(*(T(x) for x in a))


def _jsets(a):
    return jfusion.ObjectSet(*(jnp.asarray(x) for x in a))


@pytest.mark.parametrize("seed", range(6))
def test_greedy_match_matches_jax_rounds_and_scan(seed):
    """Tie-heavy centroids (one cloud point on a 5 cm lattice): the port's
    slot-order loop equals both JAX forms bit for bit."""
    rng = np.random.default_rng(seed)
    a, b = _object_sets(rng, k=1, classes=(39,) if seed % 2 else (39, 41))
    got = [N(x) for x in fusion.greedy_centroid_match(_tsets(a), _tsets(b), 0.12)]
    for fn in (jfusion.greedy_centroid_match, jfusion.greedy_centroid_match_scan):
        exp = [N(x) for x in fn(_jsets(a), _jsets(b), 0.12)]
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])


def test_fuse_and_flatten_match_jax(rng):
    a, b = _object_sets(rng, k=64)
    got = fusion.fuse_centroid(_tsets(a), _tsets(b), 0.3, apply_sor=False)
    exp = jfusion.fuse_centroid(_jsets(a), _jsets(b), 0.3, apply_sor=False)
    for f in ("points", "valid", "class_id", "present", "track_id"):
        np.testing.assert_array_equal(N(getattr(got, f)), N(getattr(exp, f)))
    flat, ovf = fusion.flatten_objects(got, capacity=300)
    jflat, jovf = jfusion.flatten_objects(exp, capacity=300)
    np.testing.assert_array_equal(N(flat.points), N(jflat.points))
    np.testing.assert_array_equal(N(flat.valid), N(jflat.valid))
    assert int(ovf) == int(jovf) > 0
