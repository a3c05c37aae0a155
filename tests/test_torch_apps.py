"""The port's CLI entry points (`rt3d_torch.apps`) and their runtime and
export pieces, on the CPU (``--device cpu``) with `tests/tiny.py`'s config
as JSON, against the JAX package's where the JAX package writes the same
thing:

- `two_cam` and `one_cam` on a synthetic and on a recorded source, with the
  CSV checks of `tests/test_cli_apps.py`;
- `save_ply` and the timing CSVs byte for byte against the JAX package's;
- every flag the port refuses, with its ROADMAP item, and the
  accumulation and tracker flags, whose configs equal the JAX apps';
- `record` against the JAX recorder, byte for byte but for `generator`;
- `convert_weights` against the JAX converter, array for array, and a
  `.pt` weights path against its `.npz`.
"""

import csv
import json
import sys
import threading

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
from rt3d_torch.viz.cloud import save_ply
from tests.tiny import H, W, tiny_config

APPS = {"two_cam": (two_cam, 2), "one_cam": (one_cam, 1)}


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


REFUSED = [
    (["--quantize"], "ROADMAP item 14"),
    (["--live", "spool"], "ROADMAP item 15"),
    (["--save-frames"], "ROADMAP item 15"),
]


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("flags,item", REFUSED)
def test_unported_flags_are_refused(app, flags, item, tmp_path):
    mod, cams = APPS[app]
    with pytest.raises(NotImplementedError, match=item):
        mod.main(["--frames", "1", "--config", config_json(tmp_path, cams), "--device", "cpu",
                  "--log-dir", str(tmp_path / "runs"), *flags])


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
