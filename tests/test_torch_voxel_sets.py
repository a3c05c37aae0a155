"""The port's 1 mm and accumulation path against the JAX package, on the
CPU: the general voxel downsample (packed, two-word and lexicographic
keys), the two-word and lexicographic mask paths, the segmented sum-scan,
voxel-set subtraction, the accumulator, and a small-frame 4-camera 1 mm
accumulating step run op by op on both sides.

Tolerances: voxel keys, points, valid masks and overflow counts exact; the
segmented sum-scan bit for bit; accumulator weights within 1e-6 relative
(f32 sums in another order: the JAX package sorts unstably), accumulator
keys exact, and the extracted voxels exact except those whose weight lies
within that band of `accum_min_weight`.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rt3d.geometry import ops as jops
from rt3d.geometry import voxel_sets as jvs
from rt3d.geometry.ops import PointBuffer as JPointBuffer
from rt3d_torch.geometry import ops, voxel_sets
from rt3d_torch.geometry.ops import PointBuffer
from rt3d_torch.io import SyntheticSource
from tests.test_torch_step import H, N, W, WEIGHTS, run_both, small_config

WEIGHT_RTOL = 1e-6
# voxel, bound: the packed key fits; only the two-word key fits; neither
BRANCHES = {"packed": (0.005, 2.56), "packed2": (0.001, 2.56), "lex": (0.0001, 2.56)}


def _cloud(rng, n=3000, voxel=0.005, spread=0.4):
    """Points clustered on a lattice of `voxel` (many share a voxel), a few
    far outside the bound, a third invalid."""
    lat = rng.integers(-40, 40, (n, 3)) * voxel * 0.6
    p = (lat + rng.normal(0, voxel * 0.3, (n, 3)) + rng.uniform(-spread, spread, (1, 3)))
    p[:5] += 10.0
    return p.astype(np.float32), rng.random(n) > 0.33


def _assert_buf(buf, jbuf):
    np.testing.assert_array_equal(N(buf.valid), N(jbuf.valid))
    np.testing.assert_array_equal(N(buf.points), N(jbuf.points))


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("capacity", [4096, 700])
def test_voxel_downsample_matches_jax(branch, capacity):
    """Each key branch, with a capacity that covers the input (rows in
    place) and one that cuts it (the smallest keys kept, overflow counted)."""
    voxel, bound = BRANCHES[branch]
    assert ops.packed_fits(voxel, bound) == (branch == "packed")
    assert ops.packed2_fits(voxel, bound) == (branch != "lex")
    pts, valid = _cloud(np.random.default_rng(0), voxel=voxel * 5)
    buf, ovf = ops.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid),
                                    voxel, capacity, bound)
    jbuf, jovf = jops.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), voxel,
                                       capacity, bound)
    _assert_buf(buf, jbuf)
    assert int(ovf) == int(jovf)
    assert (int(ovf) > 0) == (capacity == 700)


def test_voxel_downsample_grid_takes_the_general_path_at_1mm():
    """Beyond the packed key, the grid downsample is `voxel_downsample`."""
    rng = np.random.default_rng(1)
    pts, valid = _cloud(rng, n=48 * 80, voxel=0.003)
    buf, ovf = ops.voxel_downsample_grid(torch.from_numpy(pts).reshape(48, 80, 3),
                                         torch.from_numpy(valid).reshape(48, 80), 0.001, 2048)
    jbuf, jovf = jops.voxel_downsample_grid(jnp.asarray(pts).reshape(48, 80, 3),
                                            jnp.asarray(valid).reshape(48, 80), 0.001, 2048)
    _assert_buf(buf, jbuf)
    assert int(ovf) == int(jovf) > 0


def _masks(rng, n, d):
    """d overlapping masks of runs of rows."""
    m = np.zeros((d, n), bool)
    for i in range(d):
        a = rng.integers(0, n - 200)
        m[i, a:a + rng.integers(50, 600)] = True
    return m


MASK_CASES = {
    # name: (voxel, detections, capacity, stage-1 capacity, union capacity)
    "packed2": (0.001, 6, 256, 0, 0),
    "packed2_drops": (0.001, 6, 128, 512, 300),
    "lex_40_masks": (0.005, 40, 128, 0, 0),
    "lex_40_masks_1mm": (0.0001, 40, 64, 0, 0),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_voxel_masks_match_jax(case):
    """The two-word mask path (with and without shared-buffer drops,
    attributed per detection) and the lexicographic one, which takes more
    than 31 masks: per-detection voxels and overflow exact."""
    voxel, d, cap, s1, s2 = MASK_CASES[case]
    rng = np.random.default_rng(2)
    pts, valid = _cloud(rng, n=4000, voxel=max(voxel, 0.001) * 4)
    masks = _masks(rng, 4000, d)
    buf, ovf = ops.voxel_downsample_masks(torch.from_numpy(pts), torch.from_numpy(valid),
                                          torch.from_numpy(masks), voxel, cap,
                                          stage1_capacity=s1, union_capacity=s2)
    jbuf, jovf = jops.voxel_downsample_masks(jnp.asarray(pts), jnp.asarray(valid),
                                             jnp.asarray(masks), voxel, cap,
                                             stage1_capacity=s1, union_capacity=s2)
    _assert_buf(buf, jbuf)
    np.testing.assert_array_equal(N(ovf), N(jovf))
    assert N(buf.valid).sum() > 100
    if case == "packed2_drops":
        assert N(ovf).sum() > 0 and (N(ovf) == 0).any()


def test_segmented_sum_scan_bit_for_bit():
    rng = np.random.default_rng(3)
    val = rng.uniform(0, 3, 5000).astype(np.float32)
    start = rng.random(5000) < 0.1
    got = ops.segmented_sum_scan(torch.from_numpy(val), torch.from_numpy(start))
    exp = jops.segmented_sum_scan(jnp.asarray(val), jnp.asarray(start))
    np.testing.assert_array_equal(N(got), N(exp))


def test_subtract_voxel_sets_matches_jax():
    rng = np.random.default_rng(4)
    ws, wv = _cloud(rng, n=3000, voxel=0.004)
    ob, ov = _cloud(rng, n=600, voxel=0.004, spread=0.05)
    keep = voxel_sets.subtract_voxel_sets(
        PointBuffer(torch.from_numpy(ws), torch.from_numpy(wv)),
        PointBuffer(torch.from_numpy(ob), torch.from_numpy(ov)), 0.001).valid
    jkeep = jvs.subtract_voxel_sets(JPointBuffer(jnp.asarray(ws), jnp.asarray(wv)),
                                    JPointBuffer(jnp.asarray(ob), jnp.asarray(ov)), 0.001).valid
    np.testing.assert_array_equal(N(keep), N(jkeep))
    assert 0 < N(keep).sum() < wv.sum()


def _frames(rng, k=4, n=1500):
    """Clouds of a slowly drifting scene: each frame keeps most voxels of
    the last one (repeated rays included), moves some and adds others."""
    base, valid = _cloud(rng, n=n, voxel=0.003, spread=0.1)
    out = []
    for _ in range(k):
        moved = rng.random(n) < 0.2
        base = np.where(moved[:, None], base + rng.normal(0, 0.004, base.shape), base)
        out.append((base.astype(np.float32), valid & (rng.random(n) > 0.1)))
    return out


@pytest.mark.parametrize("capacity", [4096, 64])
def test_accumulate_and_extract_match_jax(capacity):
    """Four frames folded into the accumulator, without eviction and with
    it (capacity 64: the highest weights stay): keys exact and in order,
    weights within 1e-6 relative, overflow exact; the extracted voxels
    exact outside the weight band around the threshold."""
    voxel, min_w = 0.001, 1.5
    acc = voxel_sets.VoxelAccumulator.empty(capacity, "cpu")
    jacc = jvs.VoxelAccumulator.empty(capacity)
    for pts, valid in _frames(np.random.default_rng(5)):
        acc, ovf = voxel_sets.accumulate_voxels(acc, torch.from_numpy(pts),
                                                torch.from_numpy(valid), voxel, decay=0.9)
        jacc, jovf = jvs.accumulate_voxels(jacc, jnp.asarray(pts), jnp.asarray(valid),
                                           voxel, decay=0.9)
        np.testing.assert_array_equal(N(acc.keys_hi), N(jacc.keys_hi))
        np.testing.assert_array_equal(N(acc.keys_lo), N(jacc.keys_lo))
        np.testing.assert_allclose(N(acc.weight), N(jacc.weight), rtol=WEIGHT_RTOL, atol=0)
        assert int(ovf) == int(jovf)
        ext = voxel_sets.extract_accumulated(acc, voxel, min_weight=min_w)
        jext = jvs.extract_accumulated(jacc, voxel, min_weight=min_w)
        band = np.abs(N(jacc.weight) - min_w) <= WEIGHT_RTOL * min_w
        np.testing.assert_array_equal(N(ext.valid)[~band], N(jext.valid)[~band])
        np.testing.assert_array_equal(N(ext.points)[~band], N(jext.points)[~band])
    live = N(acc.keys_hi) != ops.INT_SENTINEL
    assert live.all() if capacity == 64 else 64 < live.sum() < capacity
    assert (int(ovf) > 0) == (capacity == 64)
    assert 0 < N(ext.valid).sum() < live.sum()


STRETCH = dict(voxel_size=0.001, workspace_stride=4, max_points_workspace=5120,
               max_points_workspace_fused=20480, max_union_voxels=4096,
               max_points_per_object=512, max_points_fused_object=1024,
               max_points_fused_flat=4096, workspace_accumulate=True,
               accum_skip_prededupe=True)


@pytest.fixture(scope="module", params=[65536, 64], ids=["no_eviction", "eviction"])
def stretch_runs(request):
    """The stretch preset's path at a small size: 4 synthetic cameras at
    240x320 (the n detector's smallest working size, `tests/test_torch_step`),
    1 mm voxels with accumulation fed by the snapped raw rays (stride 4: the
    60x80 grid fits the 5120-row buffer) and capacities cut to match; the
    accumulator holds 65536 voxels, or 64 so that every frame evicts. Two
    frames through the port and the JAX step, op by op."""
    src = SyntheticSource(num_cameras=4, num_frames=2, hw=(H, W), num_objects=2)
    cfg = small_config(src.cameras())
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, accum_capacity=request.param, **STRETCH))
    pipe, jpipe, got, exp, states = run_both(cfg, WEIGHTS, src, 2, states=True)
    return cfg, got, exp, states


def test_stretch_step_matches_jax(stretch_runs):
    """Detections (boxes within 1e-3 px, scores 1e-5), track IDs, per-camera
    and fused object voxels, the flat object buffer and the overflow exact;
    the accumulator's keys exact, its weights within 1e-6 relative; the
    published workspace (its voxels at or above `accum_min_weight`) exact
    outside that weight band."""
    cfg, got, exp, states = stretch_runs
    p = cfg.pipeline
    assert not ops.packed_fits(p.voxel_size, p.dedupe_bound_m)
    for o, e, (st, jst) in zip(got, exp, states):
        np.testing.assert_array_equal(N(o.detections.valid), N(e.detections.valid))
        np.testing.assert_array_equal(N(o.detections.classes), N(e.detections.classes))
        np.testing.assert_allclose(N(o.detections.boxes), N(e.detections.boxes), atol=1e-3, rtol=0)
        np.testing.assert_allclose(N(o.detections.scores), N(e.detections.scores), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(N(o.track_ids), N(e.track_ids))
        for name in ("per_camera_objects", "objects"):
            for f in ("points", "valid", "class_id", "present", "track_id"):
                np.testing.assert_array_equal(N(getattr(getattr(o, name), f)),
                                              N(getattr(getattr(e, name), f)), err_msg=name + f)
        np.testing.assert_array_equal(N(o.objects_flat.points), N(e.objects_flat.points))
        np.testing.assert_array_equal(N(o.objects_flat.valid), N(e.objects_flat.valid))
        assert int(o.overflow) == int(e.overflow)
        acc, jacc = st.accum, jst.accum
        np.testing.assert_array_equal(N(acc.keys_hi), N(jacc.keys_hi))
        np.testing.assert_array_equal(N(acc.keys_lo), N(jacc.keys_lo))
        np.testing.assert_allclose(N(acc.weight), N(jacc.weight), rtol=WEIGHT_RTOL, atol=0)
        band = np.abs(N(jacc.weight) - p.accum_min_weight) <= WEIGHT_RTOL * p.accum_min_weight
        np.testing.assert_array_equal(N(o.workspace.valid)[~band], N(e.workspace.valid)[~band])
        np.testing.assert_array_equal(N(o.workspace.points)[~band], N(e.workspace.points)[~band])
    assert N(got[-1].detections.valid).any() and N(got[-1].objects_flat.valid).sum() > 100
    live = N(acc.keys_hi) != ops.INT_SENTINEL
    assert live.sum() == min(p.accum_capacity, live.size) if p.accum_capacity == 64 \
        else 1000 < live.sum() < p.accum_capacity
    assert N(got[-1].workspace.valid).sum() > (10 if p.accum_capacity == 64 else 1000)


def test_stretch_raw_rays_are_the_dedupe_paths_voxels(stretch_runs):
    """The raw path's snapped rays are the coordinates the dedupe path
    publishes: per camera, the set of snapped valid rays equals the
    voxel-downsampled grid's points bit for bit."""
    cfg, _, _, _ = stretch_runs
    from rt3d_torch.pipeline.step import build_pipeline

    src = SyntheticSource(num_cameras=4, num_frames=1, hw=(H, W), num_objects=2)
    raw = build_pipeline(cfg, device="cpu")
    dedupe = build_pipeline(dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, accum_skip_prededupe=False)), device="cpu")
    depth = torch.from_numpy(src.get(0).depth)
    a, ovf = raw.workspace_clouds(depth, raw.calib())
    b, _ = dedupe.workspace_clouds(depth, dedupe.calib())
    assert int(ovf.sum()) == 0
    for c in range(4):
        ra = np.unique(N(a.points[c])[N(a.valid[c])].view(np.void(12)))
        rb = np.unique(N(b.points[c])[N(b.valid[c])].view(np.void(12)))
        assert len(ra) > 1000
        np.testing.assert_array_equal(ra, rb)
