"""The port's step under the CPU-variant preset against the JAX package's,
on the CPU, for 3 frames with carried state.

`reference_2cam_cpu_config` differs from the default in what it runs: 12x12
mask erosion, the Morton-window SOR of the fused workspace cloud, 1 cm
voxels, conf 0.25 on five classes. This test takes exactly those settings
onto `tests/test_torch_step.py`'s small config (the n weights at 240x320)
and runs both packages as that file does (the JAX step op by op, float32).
The scene is the synthetic source's seed 2, in which the n detector finds
both objects in every frame at conf 0.25 and each eroded object keeps
about 50 voxels. (In seed 0's first frame the one fused object keeps 19,
fewer than SOR's k = 20, so SOR removes it whole and the subtraction has
nothing to subtract.)

Tolerances: detections, track IDs and object clouds as in
`tests/test_torch_step.py`. The workspace SOR keep mask is exact outside a
band of 1e-5 of the threshold (the JAX package sums the 20 square roots
and the cloud's mu and sigma in its own order; `tests/test_torch_sor.py`).
The subtracted workspace differs only at those rows and at the lattice ties
of the subtraction threshold.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rt3d.geometry import sor as jsor
from rt3d.pipeline.step import CameraCalib as JCalib
from rt3d_torch import config
from rt3d_torch.geometry import sor
from rt3d_torch.geometry.ops import PointBuffer
from rt3d_torch.io import SyntheticSource
from tests.test_torch_step import H, N, WEIGHTS, W, run_both, small_config, threshold_ties

FRAMES = 3
BAND = 1e-5


def preset_config(cameras) -> config.Config:
    """The small config with the CPU-variant preset's own settings."""
    base, ref = small_config(cameras), config.reference_2cam_cpu_config()
    m, p = ref.model, ref.pipeline
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, conf_thresh=m.conf_thresh,
                                  class_filter=m.class_filter),
        pipeline=dataclasses.replace(base.pipeline, voxel_size=p.voxel_size,
                                     erode_kernel=p.erode_kernel,
                                     workspace_sor=p.workspace_sor))


@pytest.fixture(scope="module")
def runs():
    src = SyntheticSource(num_cameras=2, num_frames=FRAMES, hw=(H, W), num_objects=2,
                          seed=2)
    cfg = preset_config(src.cameras())
    assert (cfg.pipeline.erode_kernel, cfg.pipeline.workspace_sor) == (12, True)
    pipe, jpipe, got, exp = run_both(cfg, WEIGHTS, src, FRAMES)
    # the workspace SOR on its own: the fused workspace cloud of each frame
    # through each package's workspace stage and windowed SOR
    calib, jcalib = pipe.calib(), JCalib.from_config(jpipe.cfg)
    p = cfg.pipeline
    sors = []
    with torch.no_grad():
        for i in range(FRAMES):
            depth = src.get(i).depth
            ws, _ = pipe.workspace_clouds(torch.from_numpy(depth), calib)
            ws = PointBuffer(ws.points.reshape(-1, 3), ws.valid.reshape(-1))
            keep = N(pipe.workspace_sor(ws).valid)
            jws, _ = jpipe.workspace_clouds(jnp.asarray(depth), jcalib)
            jkeep = N(jsor.sor_inlier_mask_windowed(
                jws.points.reshape(-1, 3), jws.valid.reshape(-1),
                p.sor_nb_neighbors, p.sor_std_ratio))
            np.testing.assert_array_equal(N(ws.points), N(jws.points).reshape(-1, 3))
            mean, sat = map(N, sor._knn_mean_windowed(ws.points, ws.valid, 20, 64))
            sors.append((N(ws.valid), keep, jkeep, mean, sat))
    return cfg, got, exp, sors


def _outside_band(valid, mean, sat):
    ok = valid & ~sat
    m = mean[ok].astype(np.float64)
    thr = m.mean() + 1.5 * m.std(ddof=1)
    return ~valid | sat | (np.abs(mean - thr) > BAND * thr)


def test_cpu_preset_detections_and_ids_match_jax(runs):
    """Classes, slots and track IDs exact; boxes within 1e-3 px, scores
    within 1e-5 (f32 convolutions summed in another order)."""
    _, got, exp, _ = runs
    n = 0
    for o, e in zip(got, exp):
        for f in ("valid", "classes"):
            np.testing.assert_array_equal(N(getattr(o.detections, f)), N(getattr(e.detections, f)))
        np.testing.assert_allclose(N(o.detections.boxes), N(e.detections.boxes), atol=1e-3, rtol=0)
        np.testing.assert_allclose(N(o.detections.scores), N(e.detections.scores), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(N(o.track_ids), N(e.track_ids))
        n += int(N(o.detections.valid).sum())
    assert n == 4 * FRAMES and (N(got[-1].track_ids) > 0).sum() == 4


def test_cpu_preset_object_clouds_match_jax(runs):
    """Eroded-mask object voxels, fused objects with their SOR keep masks
    and the flattened object buffer: exact."""
    _, got, exp, _ = runs
    for o, e in zip(got, exp):
        for name in ("per_camera_objects", "objects"):
            a, b = getattr(o, name), getattr(e, name)
            for f in ("points", "valid", "class_id", "present", "track_id"):
                np.testing.assert_array_equal(N(getattr(a, f)), N(getattr(b, f)),
                                              err_msg=f"{name}.{f}")
        np.testing.assert_array_equal(N(o.objects_flat.points), N(e.objects_flat.points))
        np.testing.assert_array_equal(N(o.objects_flat.valid), N(e.objects_flat.valid))
    assert all(N(o.objects_flat.valid).sum() > 100 for o in got)


def test_cpu_preset_workspace_sor_matches_jax(runs):
    """The workspace SOR keep mask equals the JAX package's outside the
    band, and drops some points but not most."""
    *_, sors = runs
    for valid, keep, jkeep, mean, sat in sors:
        outside = _outside_band(valid, mean, sat)
        np.testing.assert_array_equal(keep[outside], jkeep[outside])
        assert outside[valid].mean() > 0.99
        assert 0.5 * valid.sum() < keep.sum() < valid.sum()


def test_cpu_preset_subtraction_matches_jax(runs):
    """Workspace points and overflow exact; the subtracted keep mask differs
    only at the threshold ties and inside the SOR band."""
    cfg, got, exp, sors = runs
    thr = cfg.pipeline.subtraction_threshold
    for o, e, (valid, keep_sor, _, mean, sat) in zip(got, exp, sors):
        assert int(o.overflow) == int(e.overflow)
        np.testing.assert_array_equal(N(o.workspace.points), N(e.workspace.points))
        keep, jkeep = N(o.workspace.valid), N(e.workspace.valid)
        assert not (keep & ~keep_sor).any()
        free = ~threshold_ties(o, thr) & _outside_band(valid, mean, sat)
        np.testing.assert_array_equal(keep[free], jkeep[free])
        assert keep.sum() > 1000
