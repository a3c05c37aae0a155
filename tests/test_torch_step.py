"""The port's fused step (`rt3d_torch.pipeline.step`) against the JAX
package's `Pipeline.step`, on the CPU, for 3 frames with carried state.

Both sides get the same config (built from one dict), the committed n
weights and the same synthetic frames. Both run in float32. The JAX step
runs op by op: under `jax.jit` XLA fuses the backprojection into the voxel
quantization with fused multiply-adds, which moves some voxel keys by one
voxel against the JAX package's own eager result; eager, the JAX package
rounds each op as IEEE does, which the port reproduces bit for bit.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rt3d.config as jconfig
from rt3d.models.yolo import core as ycore
from rt3d.models.yolo.convert import load_params
from rt3d.pipeline.step import CameraCalib as JCalib
from rt3d.pipeline.step import build_pipeline as jbuild_pipeline
from rt3d_torch import config
from rt3d_torch.io import SyntheticSource
from rt3d_torch.pipeline.step import build_pipeline
from tests.tiny import tiny_config

H, W = 240, 320
FRAMES = 3
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "yolo11n_synth_seg.npz")


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_config(cameras) -> config.Config:
    """`tests/tiny.py`'s config (n model, 1 cm voxels, small capacities: the
    workspace buffer overflows, so capacity cuts are exercised too) with the
    synthetic rig's cameras at 240x320, a (192, 256) model input, at which
    the trained n detector finds the objects, and float32 everywhere. Built
    as a JAX-package config and carried over through its dict."""
    d = tiny_config().to_dict()
    d["rig"] = {"cameras": [dataclasses.asdict(c) for c in cameras]}
    d["model"].update(input_hw=(192, 256), compute_dtype="float32",
                      preprocess_dtype="float32", mask_resize_dtype="float32")
    return config.Config.from_dict(d)


@pytest.fixture(scope="module")
def runs():
    src = SyntheticSource(num_cameras=2, num_frames=FRAMES, hw=(H, W), num_objects=2)
    cfg = small_config(src.cameras())
    pipe = build_pipeline(cfg, weights=WEIGHTS, device="cpu")
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jpipe = jbuild_pipeline(jcfg)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in load_params(WEIGHTS).items()}
    state, calib = pipe.init_state(), pipe.calib()
    jstate, jcalib = jpipe.init_state(), JCalib.from_config(jcfg)
    got, exp = [], []
    ycore.set_compute_dtype(jnp.float32)
    try:
        for i in range(FRAMES):
            pkt = src.get(i)
            state, out = pipe.step(state, torch.from_numpy(pkt.rgb),
                                   torch.from_numpy(pkt.depth), calib)
            jstate, jout = jpipe.step(params, jstate, jnp.asarray(pkt.rgb),
                                      jnp.asarray(pkt.depth), jcalib)
            got.append(out)
            exp.append(jout)
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)
    return cfg, got, exp


def test_config_round_trips_through_jax_dict():
    for cfg in (config.Config(), config.reference_2cam_cpu_config(),
                config.reference_1cam_config()):
        d = jconfig.Config.from_dict(cfg.to_dict()).to_dict()
        assert config.Config.from_dict(d) == cfg
    assert config.Config.from_dict(jconfig.reference_2cam_config().to_dict()) == config.Config()


def test_step_detections_match_jax(runs):
    """Classes and slots exact; boxes within 1e-3 px and scores within 1e-5
    (f32 convolutions summed in another order)."""
    _, got, exp = runs
    n = 0
    for o, e in zip(got, exp):
        np.testing.assert_array_equal(N(o.detections.valid), N(e.detections.valid))
        np.testing.assert_array_equal(N(o.detections.classes), N(e.detections.classes))
        np.testing.assert_allclose(N(o.detections.boxes), N(e.detections.boxes), atol=1e-3, rtol=0)
        np.testing.assert_allclose(N(o.detections.scores), N(e.detections.scores), atol=1e-5, rtol=0)
        n += int(N(o.detections.valid).sum())
    assert n > 0


def test_step_track_ids_match_jax(runs):
    _, got, exp = runs
    ids = np.stack([N(o.track_ids) for o in got])
    np.testing.assert_array_equal(ids, np.stack([N(e.track_ids) for e in exp]))
    assert (ids > 0).any()


def test_step_object_clouds_match_jax(runs):
    """Per-camera and fused object voxels, their SOR keep masks and the
    flattened object buffer: exact."""
    _, got, exp = runs
    for o, e in zip(got, exp):
        for name in ("per_camera_objects", "objects"):
            a, b = getattr(o, name), getattr(e, name)
            for f in ("points", "valid", "class_id", "present", "track_id"):
                np.testing.assert_array_equal(N(getattr(a, f)), N(getattr(b, f)),
                                              err_msg=f"{name}.{f}")
        np.testing.assert_array_equal(N(o.objects_flat.points), N(e.objects_flat.points))
        np.testing.assert_array_equal(N(o.objects_flat.valid), N(e.objects_flat.valid))
    assert N(got[-1].objects_flat.valid).sum() > 100


def test_step_workspace_matches_jax(runs):
    """Workspace voxels and overflow exact. The subtraction keeps the same
    points except where a workspace voxel lies exactly at the 6 cm
    threshold from an object voxel (on a 1 cm lattice such ties are many):
    there the port's coordinate-difference distance (the Pallas kernel's
    form) and the JAX CPU fallback's matmul identity round either way."""
    cfg, got, exp = runs
    thr = cfg.pipeline.subtraction_threshold
    for o, e in zip(got, exp):
        assert int(o.overflow) == int(e.overflow) > 0
        ws, jws = N(o.workspace.points), N(e.workspace.points)
        np.testing.assert_array_equal(ws, jws)
        obj = N(o.objects_flat.points)[N(o.objects_flat.valid)].astype(np.float64)
        d64 = ((ws[:, None, :].astype(np.float64) - obj[None]) ** 2).sum(-1).min(1)
        tie = np.abs(d64 - thr * thr) < 1e-8
        keep, jkeep = N(o.workspace.valid), N(e.workspace.valid)
        np.testing.assert_array_equal(keep[~tie], jkeep[~tie])
        assert keep.sum() > 1000 and (keep != jkeep).sum() <= tie.sum()


@pytest.mark.parametrize("change", ["erode", "workspace_sor", "accumulate", "botsort",
                                    "dedupe_center"])
def test_unported_branches_raise(change):
    """Branches outside the slice raise instead of running something else."""
    base = small_config(SyntheticSource(num_cameras=2, hw=(H, W)).cameras())
    p, m, t = base.pipeline, base.model, base.tracker
    cfg = {
        "erode": dataclasses.replace(base, pipeline=dataclasses.replace(p, erode_kernel=3)),
        "workspace_sor": dataclasses.replace(base, pipeline=dataclasses.replace(p, workspace_sor=True)),
        "accumulate": dataclasses.replace(base, pipeline=dataclasses.replace(p, workspace_accumulate=True)),
        "botsort": dataclasses.replace(base, tracker=dataclasses.replace(t, tracker_type="botsort")),
        "dedupe_center": dataclasses.replace(base, model=dataclasses.replace(m, dedupe_center_px=24.0)),
    }[change]
    pipe = build_pipeline(cfg, device="cpu")
    src = SyntheticSource(num_cameras=2, num_frames=1, hw=(H, W))
    pkt = src.get(0)
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        pipe.step(pipe.init_state(), torch.from_numpy(pkt.rgb), torch.from_numpy(pkt.depth),
                  pipe.calib())


@pytest.mark.parametrize("domain", ["easy", "hard"])
def test_synthetic_source_copy_matches_jax_package(domain):
    """The port's copy of the synthetic scenes renders the same frames."""
    from rt3d.io.synthetic import SyntheticSource as JSyntheticSource

    kw = dict(num_cameras=2, hw=(120, 160), num_objects=2, domain=domain, seed=3)
    a, b = SyntheticSource(**kw).get(5), JSyntheticSource(**kw).get(5)
    np.testing.assert_array_equal(a.rgb, b.rgb)
    np.testing.assert_array_equal(a.depth, b.depth)
