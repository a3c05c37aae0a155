"""The port's CLI entry points (`rt3d_torch.apps`) and their runtime and
export pieces, on the CPU (``--device cpu``) with `tests/tiny.py`'s config
as JSON, against the JAX package's where the JAX package writes the same
thing:

- `two_cam` and `one_cam` on a synthetic and on a recorded source, with the
  CSV checks of `tests/test_cli_apps.py`;
- `save_ply` and the timing CSVs byte for byte against the JAX package's;
- ``--live`` and ``--save-frames``, and the accumulation, tracker and
  ``--quantize`` flags, whose configs equal the JAX apps' (with
  ``--quantize`` also the calibrated scales);
- `track_only` against the JAX app's per-box lines, `viewer --once`
  against the JAX viewer's, the `plots` CLI, and the ZED adapter over a
  fake SDK against the JAX package's frames;
- `record` against the JAX recorder, byte for byte but for `generator`;
- `convert_weights` against the JAX converter, array for array, and a
  `.pt` weights path against its `.npz`.
"""

import argparse
import csv
import dataclasses
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from rt3d.io.format import read_header as jread_header
from rt3d.runtime.timing import TimingLog as JTimingLog
from rt3d.viz.cloud import load_ply as jload_ply
from rt3d.viz.cloud import save_ply as jsave_ply
from rt3d_torch.apps import convert_weights, one_cam, record, two_cam
from rt3d_torch.config import Config
from rt3d_torch.io.format import read_header
from rt3d_torch.models.yolo import YoloSeg, load_weights
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.runtime import STAGES, TimingLog, format_op_times, profile_op_times
from rt3d_torch.viz.cloud import load_ply, save_ply
from tests.tiny import H, W, tiny_config

APPS = {"two_cam": (two_cam, 2), "one_cam": (one_cam, 1)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rts(tmp_path_factory):
    """A 3-frame, 2-camera recording at the tiny config's size, by the port's
    recorder."""
    path = tmp_path_factory.mktemp("rec") / "seq.rts"
    assert record.main([str(path), "--frames", "3", "--height", str(H),
                        "--width", str(W)]) == 0
    return str(path)


def config_json(tmp_path, cams):
    path = tmp_path / f"tiny{cams}.json"
    tiny_config(num_cameras=cams).to_json(str(path))
    return str(path)


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("source", ["synthetic", "rts"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_app_runs_and_logs(app, source, rts, tmp_path, capsys):
    mod, cams = APPS[app]
    log_dir = tmp_path / "runs"
    before = threading.active_count()
    assert mod.main([
        "--source", rts if source == "rts" else "synthetic", "--frames", "3",
        "--config", config_json(tmp_path, cams), "--device", "cpu", "--warmup", "1",
        "--log-dir", str(log_dir)]) == 0
    assert threading.active_count() == before
    out = capsys.readouterr().out
    assert "frames=3 mean_fps=" in out
    assert ("backend native" in out) == (source == "rts")
    fps_rows = read_csv(log_dir / "fps_log.csv")
    assert fps_rows[0] == ["Timestamp", "FPS"] and len(fps_rows) == 1 + 3
    timing_rows = read_csv(log_dir / "timings.csv")
    assert timing_rows[0] == ["Step", "Timings"]
    rows = {r[0]: r[1].split(",") for r in timing_rows[1:]}
    assert len(rows["Total Time per Iteration"]) == len(rows["Frame Retrieval"]) == 3


def test_two_cam_profile_mode_fills_stage_rows(rts, tmp_path):
    log_dir = tmp_path / "runs"
    assert two_cam.main(["--source", rts, "--frames", "2", "--config",
                         config_json(tmp_path, 2), "--device", "cpu", "--mode", "profile",
                         "--log-dir", str(log_dir)]) == 0
    rows = {r[0] for r in read_csv(log_dir / "timings.csv")[1:]}
    assert rows == set(STAGES) - {"Depth Retrieval"}


@pytest.mark.parametrize("app", sorted(APPS))
def test_save_ply_writes_workspace_and_objects(app, rts, tmp_path):
    mod, cams = APPS[app]
    log_dir = tmp_path / "runs"
    keep_all = ["--subsample", "1.0"] if app == "one_cam" else []
    assert mod.main(["--source", rts, "--frames", "1", "--config", config_json(tmp_path, cams),
                     "--device", "cpu", "--log-dir", str(log_dir), "--save-ply",
                     *keep_all]) == 0
    names = sorted(p.name for p in log_dir.glob("*.ply"))
    assert names == (["objects_00000.ply", "workspace_00000.ply"] if app == "two_cam"
                     else ["objects_00000.ply"])
    pts, _ = jload_ply(str(log_dir / names[-1]))
    assert len(pts) > 0 and np.isfinite(pts).all()


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("colors", [False, True])
def test_save_ply_bytes_equal_jax(binary, colors, tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    col = rng.integers(0, 256, (57, 3), dtype=np.uint8) if colors else None
    ours, theirs = tmp_path / "port.ply", tmp_path / "jax.ply"
    save_ply(str(ours), pts, col, binary=binary)
    jsave_ply(str(theirs), pts, col, binary=binary)
    assert ours.read_bytes() == theirs.read_bytes()


def test_timing_csvs_match_jax_layout(tmp_path):
    """The same spans give the JAX package's `timings.csv` byte for byte, and
    an `fps_log.csv` of its header and FPS column."""
    logs = {}
    for name, cls in (("port", TimingLog), ("jax", JTimingLog)):
        d = tmp_path / name
        d.mkdir()
        log = cls(str(d / "fps_log.csv"), str(d / "timings.csv"))
        for i in range(4):
            log.add("Frame Retrieval", 0.001 * (i + 1))
            log.add("YOLO11 Inference", 0.02 + 0.001 * i)
            log.end_iteration(0.05 + 0.01 * i)
        log.write_timings()
        logs[name] = (d, log.summary_ms())
    (pd, psum), (jd, jsum) = logs["port"], logs["jax"]
    assert (pd / "timings.csv").read_bytes() == (jd / "timings.csv").read_bytes()
    prow, jrow = read_csv(pd / "fps_log.csv"), read_csv(jd / "fps_log.csv")
    assert prow[0] == jrow[0] == ["Timestamp", "FPS"]
    assert [r[1] for r in prow] == [r[1] for r in jrow] and len(prow) == 5
    assert psum == jsum


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("flag", ["--live", "--save-frames"])
def test_live_and_save_frames_run(app, flag, rts, tmp_path):
    """``--live`` and ``--save-frames`` (refused until the port had the
    spool and the drawing) run over 6 recorded frames: ``--live`` fills the
    spool as the JAX apps do (every 5th frame for two_cam, every 30th for
    one_cam; a status, the annotated frame, the cloud); ``--save-frames``
    writes two_cam's annotated side-by-side frame 0, and nothing in one_cam,
    whose JAX app reads the flag nowhere."""
    mod, cams = APPS[app]
    spool, log_dir = tmp_path / "spool", tmp_path / "runs"
    flags = ["--live", str(spool)] if flag == "--live" else [flag]
    assert mod.main(["--source", rts, "--frames", "6", "--config", config_json(tmp_path, cams),
                     "--device", "cpu", "--warmup", "1", "--log-dir", str(log_dir),
                     *flags]) == 0
    if flag == "--live":
        status = json.loads((spool / "status.json").read_text())
        assert status["frame"] == (5 if app == "two_cam" else 0)
        assert status.keys() == {"frame", "fps", "timestamp", "objects", "workspace_points"}
        assert (spool / "frame.png").exists()
        pts, cols = load_ply(str(spool / "cloud.ply"))
        assert len(pts) == status["workspace_points"] + int(np.sum(cols[:, 0] == 255))
        return
    import cv2

    frames = sorted(p.name for p in log_dir.glob("frame_*.png"))
    assert frames == (["frame_00000.png"] if app == "two_cam" else [])
    if frames:
        assert cv2.imread(str(log_dir / frames[0])).shape == (H // 2, W, 3)


def test_save_frames_without_cv2_fails_as_jax(rts, tmp_path, monkeypatch):
    """Where cv2 is missing, ``--save-frames`` fails at its import, as the
    JAX app's does: no fallback."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        two_cam.main(["--source", rts, "--frames", "1", "--config", config_json(tmp_path, 2),
                      "--device", "cpu", "--log-dir", str(tmp_path / "runs"), "--save-frames"])


def _jax_config(flags, tmp_path, cams):
    """The JAX apps' config for the same flags and config file."""
    import argparse

    from rt3d.apps import common as jcommon

    ap = argparse.ArgumentParser()
    jcommon.add_common_args(ap)
    return jcommon.load_config(ap.parse_args(["--config", config_json(tmp_path, cams), *flags]))


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("flags", [["--accumulate"], ["--accumulate", "--accum-raw"]])
def test_accumulate_flags_run(app, flags, rts, tmp_path, monkeypatch):
    """``--accumulate`` and ``--accum-raw`` set the JAX apps' config (the
    raw feed only with the flag) and the app steps two frames with it."""
    mod, cams = APPS[app]
    built = []
    monkeypatch.setattr("rt3d_torch.pipeline.step.build_pipeline",
                        lambda cfg, **kw: built.append(cfg) or build_pipeline(cfg, **kw))
    assert mod.main(["--source", rts, "--frames", "2", "--config", config_json(tmp_path, cams),
                     "--device", "cpu", "--log-dir", str(tmp_path / "runs"), *flags]) == 0
    cfg = built[0]
    assert cfg.pipeline.workspace_accumulate
    assert cfg.pipeline.accum_skip_prededupe == ("--accum-raw" in flags)
    assert cfg.pipeline == Config.from_dict(_jax_config(flags, tmp_path, cams).to_dict()).pipeline


@pytest.mark.parametrize("app", sorted(APPS))
def test_quantize_flag_runs(app, rts, tmp_path, monkeypatch, capsys):
    """``--quantize``, refused before the int8 slice, runs: with the
    weights' sidecar stale the app recalibrates live on the first 4 frames
    of the recording, as the JAX apps do, and steps two frames with the
    backbone int8. Its config equals the JAX apps' for the same flags, and
    its activation scales the JAX app's (`maybe_quantize_params` on the same
    recording, float32 on both sides) within 1e-5 relative."""
    import shutil

    from rt3d.apps import common as jcommon
    from rt3d.io.source import ReplaySource as JReplaySource
    from rt3d.models.yolo import core as ycore
    from rt3d.pipeline.step import build_pipeline as jbuild_pipeline
    from rt3d_torch.models import quant

    mod, cams = APPS[app]
    cfg_path = tmp_path / "tiny_f32.json"
    d = tiny_config(num_cameras=cams).to_dict()
    d["model"].update(compute_dtype="float32", preprocess_dtype="float32",
                      mask_resize_dtype="float32")
    Config.from_dict(d).to_json(str(cfg_path))
    weights = tmp_path / "yolo11n.npz"
    shutil.copy(os.path.join(ROOT, "weights", "yolo11n_synth_seg.npz"), weights)
    quant.save_act_scales(quant.sidecar_path(str(weights)), {"1/conv": 1.0}, weights_path=rts)
    built = []
    monkeypatch.setattr("rt3d_torch.pipeline.step.build_pipeline",
                        lambda cfg, **kw: built.append(build_pipeline(cfg, **kw)) or built[-1])
    flags = ["--config", str(cfg_path), "--weights", str(weights), "--quantize"]
    assert mod.main(["--source", rts, "--frames", "2", "--device", "cpu",
                     "--log-dir", str(tmp_path / "runs"), *flags]) == 0
    assert "stale sidecar" in capsys.readouterr().err
    pipe = built[0]
    scales = quant.model_act_scales(pipe.model)
    assert quant.is_quantized(pipe.model) and len(scales) == 43
    ap = argparse.ArgumentParser()
    jcommon.add_common_args(ap)
    args = ap.parse_args(["--source", rts, *flags])
    jcfg = jcommon.load_config(args, num_cameras=cams)
    assert Config.from_dict(jcfg.to_dict()).model == pipe.cfg.model
    assert Config.from_dict(jcfg.to_dict()).pipeline == pipe.cfg.pipeline
    jsrc = JReplaySource(rts, loop=True)
    jcfg = jcommon.adopt_source_calibration(jcfg, jsrc)
    jpipe = jbuild_pipeline(jcfg)
    ycore.set_compute_dtype(jax.numpy.float32)
    try:
        jq = jcommon.maybe_quantize_params(jpipe, jcommon.load_model_params(jpipe, jcfg),
                                           jsrc, args)
    finally:
        ycore.set_compute_dtype(jax.numpy.bfloat16)
    jscales = {k[:-len("/act_scale")]: float(v) for k, v in jq.items()
               if k.endswith("/act_scale")}
    assert jscales.keys() == scales.keys()
    assert max(abs(scales[k] - jscales[k]) / jscales[k] for k in scales) < 1e-5


@pytest.mark.parametrize("tracker", ["botsort", "deepsort"])
def test_other_trackers_reach_the_pipeline_error(tracker, rts, tmp_path, monkeypatch):
    """``--tracker botsort|deepsort``, which reached the pipeline's refusal
    before the tracker slice, now sets the JAX apps' tracker config
    (botsort with ReID and GMC, deepsort with ReID) and `two_cam` steps two
    recorded frames with it, leaving no thread behind."""
    built = []
    monkeypatch.setattr("rt3d_torch.pipeline.step.build_pipeline",
                        lambda cfg, **kw: built.append(cfg) or build_pipeline(cfg, **kw))
    before = threading.active_count()
    flags = ["--tracker", tracker]
    assert two_cam.main(["--source", rts, "--frames", "2", "--config",
                         config_json(tmp_path, 2), "--device", "cpu",
                         "--log-dir", str(tmp_path / "runs"), *flags]) == 0
    assert threading.active_count() == before
    t = built[0].tracker
    assert (t.tracker_type, t.with_reid, t.gmc) == (tracker, True, tracker == "botsort")
    assert t == Config.from_dict(_jax_config(flags, tmp_path, 2).to_dict()).tracker


def test_apps_default_to_the_card(tmp_path):
    """Without ``--device`` the apps ask for CUDA; where there is none they
    fail rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        two_cam.main(["--frames", "1", "--config", config_json(tmp_path, 2),
                      "--log-dir", str(tmp_path / "runs")])


def test_profile_op_times_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profile_op_times(lambda: None)
    text = format_op_times(1.5, {"kernel_a": 1.0, "kernel_b": 0.5, "tiny": 0.01})
    assert text.splitlines() == ["device total: 1.50 ms/iter", "top ops:",
                                 "     1.000 ms  kernel_a", "     0.500 ms  kernel_b"]


def test_record_writes_the_jax_recorders_bytes(tmp_path, monkeypatch, capsys):
    from rt3d.apps import record as jrecord

    args = ["--frames", "2", "--cameras", "2", "--objects", "2", "--height", "48",
            "--width", "64", "--seed", "3"]
    ours, theirs = tmp_path / "port.rts", tmp_path / "jax.rts"
    assert record.main([str(ours), *args]) == 0
    monkeypatch.setattr(sys, "argv", ["record", str(theirs), *args])
    assert jrecord.main() == 0
    assert "2 frames x 2 cams" in capsys.readouterr().out
    a, b = read_header(str(ours)), jread_header(str(theirs))
    assert a.meta.pop("generator") == "rt3d_torch.apps.record synthetic"
    assert b.meta.pop("generator") == "rt3d.apps.record synthetic"
    assert a.meta == b.meta and json.dumps(a.meta)
    assert (a.n_cams, a.n_frames, a.height, a.width, a.has_depth) == (
        b.n_cams, b.n_frames, b.height, b.width, b.has_depth)
    assert ours.read_bytes()[a.data_offset:] == theirs.read_bytes()[b.data_offset:]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from tests import torch_yolo

    torch.manual_seed(0)
    tm = torch_yolo.SegModel("n", 80)
    torch_yolo.populate_bn_stats(tm, seed=0, hw=(64, 96))
    path = tmp_path_factory.mktemp("ckpt") / "yolo11n-seg.pt"
    torch.save({"model": tm, "epoch": -1}, str(path))
    return path


def test_convert_weights_matches_jax_converter(checkpoint, tmp_path, capsys):
    from rt3d.models.yolo.convert import convert_checkpoint as jconvert
    from rt3d.models.yolo.model import YoloSeg as JYoloSeg

    out = tmp_path / "n.npz"
    assert convert_weights.main([str(checkpoint), "--variant", "n", "--input-hw", "64,96",
                                 "--out", str(out)]) == 0
    assert "exact 1:1 coverage" in capsys.readouterr().out
    want = jconvert(str(checkpoint), JYoloSeg(variant="n", num_classes=80, input_hw=(64, 96)))
    with np.load(str(out)) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want) and len(got) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    load_weights(YoloSeg(variant="n", input_hw=(64, 96)), str(out))  # strict


def test_pt_weights_build_the_npz_pipeline(checkpoint, tmp_path):
    npz = tmp_path / "n.npz"
    assert convert_weights.main([str(checkpoint), "--variant", "n", "--input-hw", "64,96",
                                 "--out", str(npz)]) == 0
    cfg = Config.from_dict(tiny_config().to_dict())
    a = build_pipeline(cfg, weights=str(checkpoint), device="cpu").model.state_dict()
    b = build_pipeline(cfg, weights=str(npz), device="cpu").model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_converter_refuses_a_model_it_does_not_cover(checkpoint):
    from rt3d_torch.models.convert import convert_checkpoint

    with pytest.raises(ValueError, match="conversion mismatch"):
        convert_checkpoint(str(checkpoint), YoloSeg(variant="s", input_hw=(64, 96)))


@pytest.fixture(scope="module")
def rts_1cam(tmp_path_factory):
    """A 4-frame, 1-camera, 240x320 recording of two objects, by the port's
    recorder: the size at which the n detector finds them."""
    path = tmp_path_factory.mktemp("rec1") / "seq1.rts"
    assert record.main([str(path), "--frames", "4", "--cameras", "1", "--objects", "2",
                        "--height", "240", "--width", "320"]) == 0
    return str(path)


def test_track_only_prints_the_jax_apps_lines(rts_1cam, tmp_path, monkeypatch, capsys):
    """`track_only` on a recording, against the JAX app on the same
    recording, weights and config (n model at (192, 256), float32 on both
    sides): the same per-box lines (track ID, class, score, centre depth)
    frame by frame, the FPS lines aside; with ``--live`` a spool of every
    5th frame (`publish_frame`'s status with the detection count) and with
    ``--save-frames`` the annotated frame 0."""
    from rt3d.apps import track_only as jtrack_only
    from rt3d.models.yolo import core as ycore
    from rt3d_torch.apps import track_only

    d = tiny_config(num_cameras=1).to_dict()
    d["model"].update(input_hw=(192, 256), compute_dtype="float32",
                      preprocess_dtype="float32", mask_resize_dtype="float32")
    cfg = tmp_path / "cfg.json"
    Config.from_dict(d).to_json(str(cfg))
    flags = ["--source", rts_1cam, "--frames", "4", "--config", str(cfg), "--weights",
             os.path.join(ROOT, "weights", "yolo11n_synth_seg.npz")]
    spool, log_dir = tmp_path / "spool", tmp_path / "runs"
    assert track_only.main([*flags, "--device", "cpu", "--log-dir", str(log_dir),
                            "--live", str(spool), "--save-frames"]) == 0
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["track_only", *flags, "--log-dir", str(tmp_path / "j")])
    ycore.set_compute_dtype(jax.numpy.float32)
    try:
        assert jtrack_only.main() == 0
    finally:
        ycore.set_compute_dtype(jax.numpy.bfloat16)
    exp = capsys.readouterr().out.splitlines()
    boxes = [ln for ln in got if " id=" in ln]
    assert boxes == [ln for ln in exp if " id=" in ln] and len(boxes) >= 4
    assert [ln.split(":")[0] for ln in got if ln.endswith("FPS")] == ["frame 0"]
    status = json.loads((spool / "status.json").read_text())
    assert status["frame"] == 0 and status["detections"] == sum(
        ln.startswith("frame 0:") for ln in boxes)
    assert (spool / "frame.png").exists() and (log_dir / "track_00000.png").exists()


def test_viewer_once_prints_the_jax_viewers_line(tmp_path, monkeypatch, capsys):
    """`viewer --once` on a spool, headless (no DISPLAY): exit 0, the JAX
    viewer's status line, the rendered scene; the `plots` CLI writes both
    charts of an app's logs, as the JAX CLI does."""
    from rt3d.apps import plots as jplots_app
    from rt3d.apps import viewer as jviewer
    from rt3d_torch.apps import plots as plots_app
    from rt3d_torch.apps import viewer
    from rt3d_torch.viz.live import LiveSpool

    monkeypatch.delenv("DISPLAY", raising=False)
    spool = tmp_path / "spool"
    LiveSpool(str(spool), every=1).publish_frame(7, panel=np.zeros((4, 4, 3), np.uint8),
                                                  objects=2, workspace_points=30)
    assert viewer.main([str(spool), "--once", "--out-dir", str(tmp_path / "v")]) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["viewer", str(spool), "--once"])
    assert jviewer.main() == 0
    assert got == capsys.readouterr().out
    assert got.startswith("frame 7 ") and "2 objects  30 workspace pts" in got

    logs = tmp_path / "logs"
    logs.mkdir()
    log = TimingLog(str(logs / "fps_log.csv"), str(logs / "timings.csv"))
    for i in range(20):
        log.add("YOLO11 Inference", 0.02 + 0.001 * i)
        log.end_iteration(0.05)
    log.write_timings()
    assert plots_app.main(["--log-dir", str(logs)]) == 0
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["plots", "--log-dir", str(logs), "--out-dir",
                                      str(tmp_path / "jplots")])
    assert jplots_app.main() == 0
    assert sorted(os.listdir(logs / "plots")) == sorted(os.listdir(tmp_path / "jplots")) == [
        "average_timing_per_step.png", "fps_over_time_smoothed_30s.png"]
    assert out.startswith("wrote:") and out.count(".png") == 2


def _fake_zed(src):
    """A `pyzed.sl`-shaped SDK module and camera class serving `src`'s
    frames as the SDK does: BGRA images, NaN holes in depth, a status per
    grab (`tests/test_cli_apps.py::test_mock_zed_sdk_live_adapter`)."""

    class Ns:
        pass

    class Mat:
        def __init__(self):
            self._d = None

        def get_data(self):
            return self._d

    sl = Ns()
    sl.Mat = Mat
    sl.VIEW = Ns()
    sl.VIEW.LEFT = 1
    sl.MEASURE = Ns()
    sl.MEASURE.DEPTH = 2
    sl.ERROR_CODE = Ns()
    sl.ERROR_CODE.SUCCESS = 0

    class Zed:
        def __init__(self, cam, fail_at=()):
            self._c, self._fail, self._grabs, self._cur = cam, set(fail_at), 0, None

        def grab(self, runtime=None):
            i = self._grabs
            self._grabs += 1
            if i in self._fail:
                return 9
            self._cur = src.get(i % 4)
            return 0

        def retrieve_image(self, mat, view):
            assert view == sl.VIEW.LEFT
            bgr = self._cur.rgb[self._c]
            mat._d = np.concatenate([bgr, np.full((*bgr.shape[:2], 1), 255, np.uint8)], -1)

        def retrieve_measure(self, mat, measure):
            assert measure == sl.MEASURE.DEPTH
            dep = np.array(self._cur.depth[self._c], np.float32)
            dep[:2, :2] = np.nan
            dep[3, 3] = np.inf
            mat._d = dep

        def get_camera_information(self):
            intr = src.cameras()[self._c].intrinsics
            info = Ns()
            info.camera_configuration = Ns()
            info.camera_configuration.calibration_parameters = Ns()
            lc = Ns()
            lc.fx, lc.fy, lc.cx, lc.cy = intr.fx, intr.fy, intr.cx, intr.cy
            info.camera_configuration.calibration_parameters.left_cam = lc
            return info

    return sl, Zed


def test_zed_adapter_gives_the_jax_frames(tmp_path):
    """`zed_sdk_source` over a fake SDK, against the JAX package's over an
    identical one: the factory intrinsics, and over 6 grabs (camera 1
    failing at 2 and 4) the same frames: alpha stripped, NaN and inf depth
    as 0, a failed grab a zero frame with status 1. The port's
    `PipelineDriver` then runs over it and skips the failed frames."""
    from rt3d.io.live import zed_sdk_source as jzed_sdk_source
    from rt3d.io.synthetic import SyntheticSource as JSyntheticSource
    from rt3d_torch.config import with_cameras
    from rt3d_torch.io.live import CallbackSource, zed_sdk_source
    from rt3d_torch.runtime import PipelineDriver

    src = JSyntheticSource(num_cameras=2, num_frames=4, hw=(H, W), num_objects=1)
    sources = {}
    for name, fn in (("port", zed_sdk_source), ("jax", jzed_sdk_source)):
        sl, Zed = _fake_zed(src)
        sources[name] = fn(sl, [Zed(0), Zed(1, fail_at={2, 4})], hw=(H, W))
    live, jlive = sources["port"], sources["jax"]
    assert isinstance(live, CallbackSource) and live.num_cameras == 2
    assert live.frame_hw == (H, W) and live.num_frames is None
    for a, b in zip(live.cameras(), jlive.cameras()):
        assert a.name == b.name and dataclasses.asdict(a.intrinsics) == dataclasses.asdict(
            b.intrinsics)
    for i in range(6):
        p, q = live.get(i), jlive.get(i)
        for k in ("rgb", "depth", "status"):
            np.testing.assert_array_equal(getattr(p, k), getattr(q, k))
        assert p.rgb.shape == (2, H, W, 3) and p.rgb.dtype == np.uint8 and p.index == i
        assert np.isfinite(p.depth).all() and p.depth.dtype == np.float32
        assert p.status.tolist() == [0, 1 if i in (2, 4) else 0]
        if i in (2, 4):
            assert not p.rgb[1].any() and not p.depth[1].any()

    sl, Zed = _fake_zed(src)
    fresh = zed_sdk_source(sl, [Zed(0), Zed(1, fail_at={2, 4})], hw=(H, W))
    cfg = with_cameras(Config.from_dict(tiny_config().to_dict()), fresh.cameras())
    res = PipelineDriver(build_pipeline(cfg, device="cpu"), pipeline_depth=2).run(
        fresh, num_frames=6, warmup=1)
    assert res.skipped_frames == 2 and res.mean_fps > 0
