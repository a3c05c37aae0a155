"""The port's replay driver (`rt3d_torch.runtime.driver.PipelineDriver`)
against the JAX package's, on the CPU, over a recorded `.rts` sequence.

The sequence: 5 frames of the synthetic rig's 2 cameras at 240x320, camera
1 of frame 2 with status 7 (a failed capture, which both drivers skip). The
config is `tests/test_torch_step.py`'s (the n weights, float32, model input
(192, 256)). The JAX driver runs fused with ``pipeline_depth=2`` under
`jax.disable_jit()` in float32, so its step runs op by op as
`tests/test_torch_step.py` explains; its outputs are held against the
port's driver with that file's tolerances: classes, slots, track IDs,
object voxels, workspace voxels and overflow exact, boxes within 1e-3 px,
scores within 1e-5, workspace keep decisions exact but at threshold ties
(within 1e-8 m^2 of the threshold squared).

The port's own modes are held against each other bit for bit: scan mode
(two frames a call: the bad frame inside a chunk, an odd last chunk) and
profile mode equal fused mode, the latter also with the CPU-variant
preset's workspace SOR on.
"""

import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rt3d.config as jconfig
from rt3d.io.source import ReplaySource as JReplaySource
from rt3d.models.yolo import core as ycore
from rt3d.models.yolo.convert import load_params
from rt3d.pipeline.step import build_pipeline as jbuild_pipeline
from rt3d.runtime.driver import PipelineDriver as JPipelineDriver
from rt3d_torch.io import ReplaySource, SyntheticSource, write_sequence
from rt3d_torch.io.format import camera_meta
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.runtime import PipelineDriver
from tests.test_torch_step import H, N, WEIGHTS, W, small_config, threshold_ties
from tests.test_torch_step_cpu_preset import preset_config

FRAMES = 5
BAD = 2
GOOD = [i for i in range(FRAMES) if i != BAD]


def record(path, frames=FRAMES, hw=(H, W), bad=BAD):
    """Record `frames` frames of the synthetic rig (2 cameras, 2 objects)
    with the port's recorder; camera 1 of frame `bad` gets status 7."""
    src = SyntheticSource(num_cameras=2, num_frames=frames, hw=hw, num_objects=2)
    pkts = [src.get(i) for i in range(frames)]
    status = np.zeros((frames, 2), np.uint32)
    status[bad, 1] = 7
    meta = {"cameras": [
        camera_meta(c.intrinsics.fx, c.intrinsics.fy, c.intrinsics.cx, c.intrinsics.cy,
                    [list(r) for r in c.extrinsics.rotation], list(c.extrinsics.translation),
                    serial=c.serial, fps=c.fps) for c in src.cameras()]}
    write_sequence(str(path), np.stack([p.rgb for p in pkts]),
                   np.stack([p.depth for p in pkts]), meta, status)
    return str(path)


def drive(pipe, path, frames=FRAMES, **kw):
    """Run the port's driver over `path`; returns (driver, [(index, outputs)])."""
    seen = []
    drv = PipelineDriver(pipe, **kw)
    src = ReplaySource(path)
    try:
        res = drv.run(src, frames, warmup=1, on_frame=lambda i, o: seen.append((i, o)))
    finally:
        src.close()
    assert res.skipped_frames == (1 if frames > BAD else 0)
    return drv, seen


def assert_same(a, b):
    """Two port outputs equal bit for bit, every tensor."""
    def walk(x, y, path):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
            return
        if x is None:
            assert y is None, path
            return
        for f in x.__dataclass_fields__:
            walk(getattr(x, f), getattr(y, f), f"{path}.{f}")
    walk(a, b, "out")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    path = record(tmp_path_factory.mktemp("seq") / "seq.rts")
    src = ReplaySource(path)
    cams = src.cameras()
    src.close()
    return path, small_config(cams)


@pytest.fixture(scope="module")
def fused(seq):
    path, cfg = seq
    pipe = build_pipeline(cfg, weights=WEIGHTS, device="cpu")
    drv, seen = drive(pipe, path, pipeline_depth=2)
    return pipe, drv, seen


@pytest.fixture(scope="module")
def jax_run(seq):
    path, cfg = seq
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    params = {k: jnp.asarray(v, jnp.float32) for k, v in load_params(WEIGHTS).items()}
    seen = []
    ycore.set_compute_dtype(jnp.float32)
    src = JReplaySource(path)
    try:
        with jax.disable_jit():
            drv = JPipelineDriver(jbuild_pipeline(jcfg), params, mode="fused",
                                  pipeline_depth=2)
            res = drv.run(src, FRAMES, warmup=1, on_frame=lambda i, o: seen.append((i, o)))
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)
        src.close()
    return res, seen


def test_driver_skips_and_orders_frames_as_jax(fused, jax_run):
    _, drv, seen = fused
    res, jseen = jax_run
    assert [i for i, _ in seen] == [i for i, _ in jseen] == GOOD
    assert drv.skipped_frames == res.skipped_frames == 1


def test_driver_detections_and_ids_match_jax(fused, jax_run):
    _, _, seen = fused
    n = 0
    for (_, o), (_, e) in zip(seen, jax_run[1]):
        np.testing.assert_array_equal(N(o.detections.valid), N(e.detections.valid))
        np.testing.assert_array_equal(N(o.detections.classes), N(e.detections.classes))
        np.testing.assert_allclose(N(o.detections.boxes), N(e.detections.boxes), atol=1e-3, rtol=0)
        np.testing.assert_allclose(N(o.detections.scores), N(e.detections.scores), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(N(o.track_ids), N(e.track_ids))
        n += int(N(o.detections.valid).sum())
    assert n > 0 and (N(seen[-1][1].track_ids) > 0).any()


def test_driver_clouds_match_jax(fused, jax_run, seq):
    _, cfg = seq
    thr = cfg.pipeline.subtraction_threshold
    for (_, o), (_, e) in zip(fused[2], jax_run[1]):
        for name in ("per_camera_objects", "objects"):
            a, b = getattr(o, name), getattr(e, name)
            for f in ("points", "valid", "class_id", "present", "track_id"):
                np.testing.assert_array_equal(N(getattr(a, f)), N(getattr(b, f)),
                                              err_msg=f"{name}.{f}")
        np.testing.assert_array_equal(N(o.objects_flat.points), N(e.objects_flat.points))
        np.testing.assert_array_equal(N(o.objects_flat.valid), N(e.objects_flat.valid))
        assert int(o.overflow) == int(e.overflow)
        np.testing.assert_array_equal(N(o.workspace.points), N(e.workspace.points))
        tie = threshold_ties(o, thr)
        keep, jkeep = N(o.workspace.valid), N(e.workspace.valid)
        np.testing.assert_array_equal(keep[~tie], jkeep[~tie])
        assert keep.sum() > 1000


def test_scan_mode_equals_frame_mode(fused, seq):
    """Two frames a call: chunks (0, 1), (2 bad, 3), (4); the bad frame is
    computed and its state dropped, and the tracker counts good frames only."""
    pipe, drv, seen = fused
    sdrv, sseen = drive(pipe, seq[0], frames_per_dispatch=2)
    assert [i for i, _ in sseen] == GOOD
    for (_, a), (_, b) in zip(sseen, seen):
        assert_same(a, b)
    for s, f in zip(sdrv.state.trackers, drv.state.trackers):
        assert int(s.frame_id) == int(f.frame_id) == len(GOOD)
        assert torch.equal(s.track_id, f.track_id) and torch.equal(s.mean, f.mean)


def test_scan_mode_keeps_the_accumulator_on_a_bad_frame(seq):
    """With workspace accumulation on and BoT-SORT's GMC (whose previous
    grey image is state as well), scan mode (two frames a call, the bad
    frame inside a chunk) gives each good frame the outputs of plain steps
    over the good frames only, and ends with their accumulator and grey
    images and trackers; stepping the bad frame too would have changed the
    accumulator and, through GMC from its grey image, the tracks."""
    path, cfg = seq
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a dozen small steps: no pool to wake per op
    try:
        _check_scan_keeps_the_accumulator(path, cfg)
    finally:
        torch.set_num_threads(threads)


def _check_scan_keeps_the_accumulator(path, cfg):
    import dataclasses

    cfg = dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, workspace_accumulate=True),
        tracker=dataclasses.replace(cfg.tracker, tracker_type="botsort", with_reid=True,
                                    gmc=True))
    pipe = build_pipeline(cfg, weights=WEIGHTS, device="cpu")
    sdrv, sseen = drive(pipe, path, frames_per_dispatch=2)
    assert [i for i, _ in sseen] == GOOD
    src = ReplaySource(path)
    try:
        calib = pipe.calib()
        ref = every = pipe.init_state()
        outs = {}
        for i in range(FRAMES):
            pkt = src.get(i)
            rgb, depth = torch.from_numpy(pkt.rgb), torch.from_numpy(pkt.depth)
            every, _ = pipe.step(every, rgb, depth, calib)
            if i in GOOD:
                ref, outs[i] = pipe.step(ref, rgb, depth, calib)
    finally:
        src.close()
    for i, o in sseen:
        assert_same(o, outs[i])
    acc, racc = sdrv.state.accum, ref.accum
    for f in ("keys_hi", "keys_lo", "weight"):
        assert torch.equal(getattr(acc, f), getattr(racc, f)), f
    assert torch.equal(sdrv.state.prev_gray, ref.prev_gray)
    assert int((acc.keys_hi != 2**31 - 1).sum()) > 1000
    for t, rt, et in zip(sdrv.state.trackers, ref.trackers, every.trackers):
        assert torch.equal(t.mean, rt.mean) and torch.equal(t.emb, rt.emb)
    assert not torch.equal(every.accum.weight, racc.weight)
    assert not torch.equal(every.trackers[0].mean, ref.trackers[0].mean)


def test_profile_mode_equals_fused_mode(fused, seq):
    """Profile mode's stage-split step gives fused mode's outputs, overflow
    included, and fills the reference's stage rows."""
    pipe, _, seen = fused
    pdrv, pseen = drive(pipe, seq[0], mode="profile")
    for (i, a), (j, b) in zip(pseen, seen):
        assert i == j
        assert_same(a, b)
    summary = pdrv.log.summary_ms()
    for stage in ("YOLO11 Inference", "Mask Processing", "Point Cloud Processing",
                  "Point Cloud Fusion", "Subtraction"):
        assert summary[stage] > 0, stage


def test_profile_mode_runs_the_workspace_sor(seq):
    """With the CPU-variant preset's workspace SOR on (which the JAX
    package's profile mode leaves out), profile mode still equals fused
    mode: frames 0-2, the last one bad."""
    path, _ = seq
    src = ReplaySource(path)
    cfg = preset_config(src.cameras())
    src.close()
    assert cfg.pipeline.workspace_sor
    pipe = build_pipeline(cfg, weights=WEIGHTS, device="cpu")
    _, seen = drive(pipe, path, frames=3)
    _, pseen = drive(pipe, path, frames=3, mode="profile")
    assert [i for i, _ in pseen] == [0, 1]
    for (_, a), (_, b) in zip(pseen, seen):
        assert_same(a, b)


def test_step_leaves_its_input_state_untouched(fused, seq):
    """`Pipeline.step` builds new tracker tensors: the state it was given
    is unchanged after it, which `step_scan`'s drop of a bad frame's state
    relies on."""
    pipe, _, _ = fused
    src = ReplaySource(seq[0])
    try:
        state, calib = pipe.init_state(), pipe.calib()
        for i in (0, 1):
            pkt = src.get(i)
            before = [{f: getattr(t, f).clone() for f in t.__dataclass_fields__}
                      for t in state.trackers]
            new, _ = pipe.step(state, torch.from_numpy(pkt.rgb), torch.from_numpy(pkt.depth),
                               calib)
            for t, snap in zip(state.trackers, before):
                for f, v in snap.items():
                    assert torch.equal(getattr(t, f), v), f
            state = new
    finally:
        src.close()
    assert int(state.trackers[0].frame_id) == 2


def _uploaders():
    return [t for t in threading.enumerate() if t.name.startswith("rt3d-upload")]


def test_uploader_is_joined_after_run(fused, seq):
    pipe, _, _ = fused
    before = threading.active_count()
    drive(pipe, seq[0], frames=2, pipeline_depth=2)
    assert not _uploaders() and threading.active_count() == before


def test_uploader_is_joined_after_on_frame_raises(fused, seq):
    pipe, _, _ = fused
    before = threading.active_count()

    def boom(i, out):
        raise RuntimeError(f"on_frame failed at frame {i}")

    src = ReplaySource(seq[0])
    try:
        with pytest.raises(RuntimeError, match="on_frame failed at frame 0"):
            PipelineDriver(pipe, pipeline_depth=2).run(src, FRAMES, on_frame=boom)
    finally:
        src.close()
    assert not _uploaders() and threading.active_count() == before


def test_driver_refuses_unknown_modes(fused):
    pipe = fused[0]
    with pytest.raises(ValueError, match="unknown driver mode"):
        PipelineDriver(pipe, mode="eager")
    with pytest.raises(ValueError, match="frames_per_dispatch requires"):
        PipelineDriver(pipe, mode="profile", frames_per_dispatch=2)
