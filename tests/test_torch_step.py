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


def run_both(cfg, weights, src, frames, states=False):
    """Step the port and the JAX package (float32, op by op) over the same
    `frames` of `src` with carried state. Returns (port pipeline, JAX
    pipeline, port outputs, JAX outputs) per frame, and with `states` the
    (port, JAX) state after each frame too."""
    pipe = build_pipeline(cfg, weights=weights, device="cpu")
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jpipe = jbuild_pipeline(jcfg)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in load_params(weights).items()}
    state, calib = pipe.init_state(), pipe.calib()
    jstate, jcalib = jpipe.init_state(), JCalib.from_config(jcfg)
    got, exp, both = [], [], []
    ycore.set_compute_dtype(jnp.float32)
    try:
        for i in range(frames):
            pkt = src.get(i)
            state, out = pipe.step(state, torch.from_numpy(pkt.rgb),
                                   torch.from_numpy(pkt.depth), calib)
            jstate, jout = jpipe.step(params, jstate, jnp.asarray(pkt.rgb),
                                      jnp.asarray(pkt.depth), jcalib)
            got.append(out)
            exp.append(jout)
            both.append((state, jstate))
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)
    return (pipe, jpipe, got, exp) + ((both,) if states else ())


def threshold_ties(out, thr):
    """Workspace rows of a port output whose float64 squared distance to the
    nearest object voxel lies within 1e-8 m^2 of thr^2."""
    ws = N(out.workspace.points).astype(np.float64)
    obj = N(out.objects_flat.points)[N(out.objects_flat.valid)].astype(np.float64)
    if not len(obj):
        return np.zeros(len(ws), bool)
    d64 = ((ws[:, None, :] - obj[None]) ** 2).sum(-1).min(1)
    return np.abs(d64 - thr * thr) < 1e-8


@pytest.fixture(scope="module")
def runs():
    src = SyntheticSource(num_cameras=2, num_frames=FRAMES, hw=(H, W), num_objects=2)
    cfg = small_config(src.cameras())
    _, _, got, exp = run_both(cfg, WEIGHTS, src, FRAMES)
    return cfg, got, exp


def test_config_round_trips_through_jax_dict():
    for cfg in (config.Config(), config.reference_2cam_cpu_config(),
                config.reference_1cam_config()):
        d = jconfig.Config.from_dict(cfg.to_dict()).to_dict()
        assert config.Config.from_dict(d) == cfg
    for port_fn, jax_fn in ((config.reference_2cam_config, jconfig.reference_2cam_config),
                            (config.reference_2cam_cpu_config, jconfig.reference_2cam_cpu_config),
                            (config.reference_1cam_config, jconfig.reference_1cam_config)):
        assert config.Config.from_dict(jax_fn().to_dict()) == port_fn()


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
        np.testing.assert_array_equal(N(o.workspace.points), N(e.workspace.points))
        tie = threshold_ties(o, thr)
        keep, jkeep = N(o.workspace.valid), N(e.workspace.valid)
        np.testing.assert_array_equal(keep[~tie], jkeep[~tie])
        assert keep.sum() > 1000 and (keep != jkeep).sum() <= tie.sum()


@pytest.mark.parametrize("flag", ["with_reid", "gmc"])
def test_bytetrack_ignores_reid_and_gmc_flags(runs, flag):
    """ByteTrack uses neither ReID nor GMC, so the JAX package ignores both
    flags for it (`_use_reid`, `_use_gmc`): the port steps with either set
    and gives the flags-off run's outputs exactly."""
    cfg, got, _ = runs
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, **{flag: True}))
    pipe = build_pipeline(cfg, weights=WEIGHTS, device="cpu")
    src = SyntheticSource(num_cameras=2, num_frames=2, hw=(H, W), num_objects=2)
    state, calib = pipe.init_state(), pipe.calib()
    for i in range(2):
        pkt = src.get(i)
        state, out = pipe.step(state, torch.from_numpy(pkt.rgb), torch.from_numpy(pkt.depth), calib)
        for f in ("valid", "classes", "boxes", "scores"):
            np.testing.assert_array_equal(N(getattr(out.detections, f)),
                                          N(getattr(got[i].detections, f)), err_msg=f)
        np.testing.assert_array_equal(N(out.track_ids), N(got[i].track_ids))
        np.testing.assert_array_equal(N(out.objects.valid), N(got[i].objects.valid))
        np.testing.assert_array_equal(N(out.workspace.valid), N(got[i].workspace.valid))
    assert (N(out.track_ids) > 0).any()


def _assert_accumulators_match(acc, jacc, outs, pcfg):
    """The port's accumulator against the JAX package's after the frames of
    `outs`, under pipeline config `pcfg`: the same voxels with weights
    within 1e-6 relative, none within that band of `accum_min_weight` (so
    the published voxels are the same), except voxels within 1e-8 m^2 of
    the threshold's square from the object voxels of one of those frames (a
    tie, which either side may have kept)."""
    from rt3d_torch.golden import _min_d2

    def rows(a):
        hi, lo, w = N(a.keys_hi), N(a.keys_lo), N(a.weight)
        live = hi != 2**31 - 1
        return {(int(h), int(l)): float(x) for h, l, x in zip(hi[live], lo[live], w[live])}

    thr, min_weight = pcfg.subtraction_threshold, pcfg.accum_min_weight
    mine, theirs = rows(acc), rows(jacc)
    keys = sorted(set(mine) | set(theirs))
    n = 2 * int(np.ceil(pcfg.dedupe_bound_m / pcfg.voxel_size)) + 1
    q = np.array([[h // n, h % n, lo] for h, lo in keys], np.int64) - (n - 1) // 2
    pts = q.astype(np.float32) * np.float32(pcfg.voxel_size)
    tie = np.zeros(len(keys), bool)
    for o in outs:
        obj = N(o.objects_flat.points)[N(o.objects_flat.valid)]
        tie |= np.abs(_min_d2(pts, obj) - thr * thr) < 1e-8
    for k, t in zip(keys, tie):
        if t:
            continue
        assert k in mine and k in theirs, k
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-6)
        assert abs(theirs[k] - min_weight) > 1e-6 * min_weight
    assert len(mine) > 1000 and tie.sum() < 0.05 * len(keys)


@pytest.mark.parametrize("change", ["accumulate", "botsort"])
def test_accumulation_and_botsort_match_jax(change):
    """Two frames of the JAX package's step: workspace accumulation on this
    config's 1 cm grid (the dedupe path feeds the accumulator), and BoT-SORT
    with ReID and GMC. Track IDs, the accumulator's keys and the
    published workspace exact (weights within 1e-6 relative, no weight in
    that band of the threshold), outside threshold ties: a voxel whose
    keep decision was a tie in some frame (`_assert_accumulators_match`)."""
    src = SyntheticSource(num_cameras=2, num_frames=2, hw=(H, W), num_objects=2)
    base = small_config(src.cameras())
    p, t = base.pipeline, base.tracker
    cfg = {
        "accumulate": dataclasses.replace(base, pipeline=dataclasses.replace(p, workspace_accumulate=True)),
        "botsort": dataclasses.replace(base, tracker=dataclasses.replace(
            t, tracker_type="botsort", with_reid=True, gmc=True)),
    }[change]
    _, _, got, exp, states = run_both(cfg, WEIGHTS, src, 2, states=True)
    thr = cfg.pipeline.subtraction_threshold
    both_seen = []
    for o, e, (st, jst) in zip(got, exp, states):
        np.testing.assert_array_equal(N(o.track_ids), N(e.track_ids))
        np.testing.assert_array_equal(N(o.objects_flat.points), N(e.objects_flat.points))
        assert int(o.overflow) == int(e.overflow)
        if change == "accumulate":
            _assert_accumulators_match(st.accum, jst.accum, got[:len(both_seen) + 1],
                                       cfg.pipeline)
            both_seen.append(o)
        else:
            tie = threshold_ties(o, thr)
            np.testing.assert_array_equal(N(o.workspace.valid)[~tie], N(e.workspace.valid)[~tie])
    assert (N(got[-1].track_ids) > 0).any() and N(got[-1].workspace.valid).sum() > 1000


@pytest.mark.parametrize("domain", ["easy", "hard"])
def test_synthetic_source_copy_matches_jax_package(domain):
    """The port's copy of the synthetic scenes renders the same frames."""
    from rt3d.io.synthetic import SyntheticSource as JSyntheticSource

    kw = dict(num_cameras=2, hw=(120, 160), num_objects=2, domain=domain, seed=3)
    a, b = SyntheticSource(**kw).get(5), JSyntheticSource(**kw).get(5)
    np.testing.assert_array_equal(a.rgb, b.rgb)
    np.testing.assert_array_equal(a.depth, b.depth)
