"""The port's step under the 1-cam preset against the JAX package's, on the
CPU, for 2 frames with carried state.

`reference_1cam_config` runs one camera at 60 fps with yolo11l-seg, conf
0.3 on seven classes. This test takes exactly those settings onto
`tests/test_torch_step.py`'s small config (the committed l weights at
240x320 from one synthetic camera) and runs both packages as that file does
(the JAX step op by op, float32). With one camera there is no fusion and no
K3: the fused set is the camera's own 1024-point slots, flattened as they
are. Tolerances as in `tests/test_torch_step.py`.
"""

import dataclasses
import os

import numpy as np
import pytest

from rt3d_torch import config
from rt3d_torch.io import SyntheticSource
from tests.test_torch_step import H, N, W, run_both, small_config, threshold_ties

FRAMES = 2
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "yolo11l_synth_seg.npz")


def preset_config(cameras) -> config.Config:
    """The small config with the 1-cam preset's own settings."""
    base, ref = small_config(cameras), config.reference_1cam_config()
    cam, m = ref.rig.cameras[0], ref.model
    return dataclasses.replace(
        base,
        rig=config.RigConfig(cameras=tuple(
            dataclasses.replace(c, fps=cam.fps, depth_min_m=cam.depth_min_m)
            for c in base.rig.cameras)),
        model=dataclasses.replace(base.model, variant=m.variant, conf_thresh=m.conf_thresh,
                                  class_filter=m.class_filter))


@pytest.fixture(scope="module")
def runs():
    src = SyntheticSource(num_cameras=1, num_frames=FRAMES, hw=(H, W), num_objects=2)
    cfg = preset_config(src.cameras())
    assert cfg.rig.num_cameras == 1 and cfg.model.variant == "l"
    _, _, got, exp = run_both(cfg, WEIGHTS, src, FRAMES)
    return cfg, got, exp


def test_1cam_detections_and_ids_match_jax(runs):
    """Classes, slots and track IDs exact; boxes within 1e-3 px, scores
    within 1e-5 (f32 convolutions summed in another order)."""
    _, got, exp = runs
    n = 0
    for o, e in zip(got, exp):
        for f in ("valid", "classes"):
            np.testing.assert_array_equal(N(getattr(o.detections, f)), N(getattr(e.detections, f)))
        np.testing.assert_allclose(N(o.detections.boxes), N(e.detections.boxes), atol=1e-3, rtol=0)
        np.testing.assert_allclose(N(o.detections.scores), N(e.detections.scores), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(N(o.track_ids), N(e.track_ids))
        n += int(N(o.detections.valid).sum())
    assert n > 0 and (N(got[-1].track_ids) > 0).any()


def test_1cam_objects_pass_unfused(runs):
    """The fused set is the camera's own set, unfiltered, and equals the JAX
    package's, as does the flattened object buffer."""
    _, got, exp = runs
    for o, e in zip(got, exp):
        for f in ("points", "valid", "class_id", "present", "track_id"):
            a = N(getattr(o.objects, f))
            np.testing.assert_array_equal(a, N(getattr(e.objects, f)), err_msg=f)
            np.testing.assert_array_equal(a, N(getattr(o.per_camera_objects, f))[0], err_msg=f)
        np.testing.assert_array_equal(N(o.objects_flat.points), N(e.objects_flat.points))
        np.testing.assert_array_equal(N(o.objects_flat.valid), N(e.objects_flat.valid))
    assert N(got[-1].objects_flat.valid).sum() > 100


def test_1cam_workspace_matches_jax(runs):
    """Workspace voxels and overflow exact; the subtracted keep mask differs
    only at the lattice ties of the subtraction threshold."""
    cfg, got, exp = runs
    thr = cfg.pipeline.subtraction_threshold
    for o, e in zip(got, exp):
        assert int(o.overflow) == int(e.overflow)
        np.testing.assert_array_equal(N(o.workspace.points), N(e.workspace.points))
        tie = threshold_ties(o, thr)
        keep, jkeep = N(o.workspace.valid), N(e.workspace.valid)
        np.testing.assert_array_equal(keep[~tie], jkeep[~tie])
        assert keep.sum() > 1000
