"""The port's host-side visualization and log tools (`rt3d_torch.viz`,
`rt3d_torch.bench.compare`) against the JAX package's (`rt3d.viz`,
`rt3d.bench.compare`), on the CPU, each fed the same inputs:

- `annotate_frame` and `side_by_side` pixel for pixel, with cv2 and with it
  hidden (the numpy-only path the card's machine takes);
- `load_ply` on what both packages' `save_ply` write;
- `LiveSpool.publish` / `publish_frame`: the spool's files byte for byte
  (the binary `cloud.ply` with its seeded subsample, `frame.png` or
  `frame.npy`), `status.json`'s keys, the `every` skipping (a skipped
  frame touches neither the outputs nor the frame callback) and the
  empty-frame unlink;
- `ViewerState.tick` and `render_scene`, with and without matplotlib;
- `read_timings`, the FPS log reader, `plot_fps`, `plot_stage_timings`;
- `compare_runs` and its CLI on synthetic CSV logs, a missing reference
  directory included.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import rt3d.viz.draw as jdraw
from rt3d.bench import compare as jcompare
from rt3d.viz import live as jlive
from rt3d.viz import plots as jplots
from rt3d.viz.cloud import load_ply as jload_ply
from rt3d.viz.cloud import save_ply as jsave_ply
from rt3d.viz.render import render_scene as jrender_scene
from rt3d_torch.bench import compare
from rt3d_torch.geometry.fusion import ObjectSet
from rt3d_torch.geometry.ops import PointBuffer
from rt3d_torch.models.postprocess import Detections
from rt3d_torch.pipeline.step import FrameOutputs
from rt3d_torch.viz import draw, live, plots
from rt3d_torch.viz.cloud import load_ply, save_ply
from rt3d_torch.viz.render import render_scene

H, W, D = 48, 64, 5


@pytest.fixture
def no_cv2(monkeypatch):
    """cv2 hidden from both packages: the JAX module bound it at import,
    the port imports it at each use."""
    monkeypatch.setattr(jdraw, "cv2", None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def detections(seed, cams=2):
    """Per-camera padded detections: boxes inside the frame (some past its
    edge), scores, classes among the COCO names and others, a valid mask,
    track IDs with -1s."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-4, [W - 8, H - 8], (cams, D, 2))
    wh = rng.uniform(4, 30, (cams, D, 2))
    return dict(boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
                scores=rng.uniform(0.1, 1, (cams, D)).astype(np.float32),
                classes=rng.choice([39, 41, 3, 45], (cams, D)).astype(np.int32),
                valid=rng.uniform(size=(cams, D)) < 0.7,
                ids=rng.integers(-1, 12, (cams, D)).astype(np.int32))


def frames(seed, cams=2):
    return np.random.default_rng(seed).integers(0, 256, (cams, H, W, 3), dtype=np.uint8)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_annotate_frame_and_side_by_side_equal_jax(with_cv2, request):
    if not with_cv2:
        request.getfixturevalue("no_cv2")
    d, rgb = detections(0), frames(1)
    masks = np.random.default_rng(2).uniform(size=(D, H, W)) < 0.2
    for kw in ({}, {"masks": masks, "fps": 12.345}, {"track_ids": None}):
        ids = kw.pop("track_ids", d["ids"][0])
        args = (rgb[0], d["boxes"][0], d["scores"][0], d["classes"][0], d["valid"][0], ids)
        got = draw.annotate_frame(*args, **kw)
        exp = jdraw.annotate_frame(*args, **kw)
        assert got.dtype == exp.dtype == np.uint8
        np.testing.assert_array_equal(got, exp)
        assert with_cv2 == (not np.array_equal(got, rgb[0])) or "masks" in kw
    for scale in (0.5, 1.0):
        np.testing.assert_array_equal(draw.side_by_side(rgb[0], rgb[1], scale),
                                      jdraw.side_by_side(rgb[0], rgb[1], scale))
    assert draw.side_by_side(rgb[0], rgb[1]).shape == (
        (H // 2, W, 3) if with_cv2 else (H, 2 * W, 3))
    assert draw.COCO_NAMES == jdraw.COCO_NAMES and draw._PALETTE == jdraw._PALETTE


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("colors", [False, True])
def test_load_ply_reads_both_packages_files(binary, colors, tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (57, 3), dtype=np.uint8) if colors else None
    for name, save in (("port", save_ply), ("jax", jsave_ply)):
        path = str(tmp_path / f"{name}.ply")
        save(path, pts, cols, binary=binary)
        got, exp = load_ply(path), jload_ply(path)
        np.testing.assert_array_equal(got[0], exp[0])
        assert (got[1] is None) == (exp[1] is None) == (not colors)
        if colors:
            np.testing.assert_array_equal(got[1], exp[1])
        if binary:
            np.testing.assert_array_equal(got[0], pts)
    empty = str(tmp_path / "empty.ply")
    save_ply(empty, np.zeros((0, 3)), binary=binary)
    assert load_ply(empty)[0].shape == jload_ply(empty)[0].shape == (0, 3)


def frame_outputs(seed, cams=2, n_ws=300, n_obj=40, empty=False):
    """A `FrameOutputs` of CPU tensors: detections, fused objects and their
    flat cloud, a workspace with invalid rows. `empty` leaves no valid
    point."""
    rng = np.random.default_rng(seed)
    d = detections(seed, cams)
    t = torch.from_numpy
    det = Detections(boxes=t(d["boxes"]), scores=t(d["scores"]), classes=t(d["classes"]),
                     coeffs=torch.zeros(cams, D, 4), valid=t(d["valid"]))
    ws_valid = rng.uniform(size=n_ws) < (0 if empty else 0.8)
    flat_valid = rng.uniform(size=n_obj) < (0 if empty else 0.6)
    objs = ObjectSet(points=torch.zeros(3, 8, 3), valid=torch.zeros(3, 8, dtype=torch.bool),
                     class_id=torch.zeros(3, dtype=torch.int32),
                     present=t(np.array([True, False, not empty])),
                     track_id=torch.zeros(3, dtype=torch.int32))
    return FrameOutputs(
        detections=det, track_ids=t(d["ids"]), objects=objs,
        objects_flat=PointBuffer(t(rng.normal(size=(n_obj, 3)).astype(np.float32)),
                                 t(flat_valid)),
        workspace=PointBuffer(t(rng.normal(size=(n_ws, 3)).astype(np.float32)), t(ws_valid)),
        per_camera_objects=objs, overflow=torch.zeros((), dtype=torch.int32))


class Untouchable:
    """Outputs a skipped frame must not read."""

    def __getattr__(self, name):
        raise AssertionError(f"a skipped frame read outputs.{name}")


@pytest.mark.parametrize("with_cv2", [True, False])
def test_live_spool_writes_the_jax_spool(with_cv2, tmp_path, request):
    """Both spools over the same frames (every 2, subsample 0.25, seed 7):
    after each publish their `cloud.ply` bytes and frame files are equal,
    `status.json` has the same keys and values (the clock's aside); frames
    1 and 3 are skipped without touching the outputs or calling the frame
    callback; an empty frame unlinks the cloud in both."""
    if not with_cv2:
        request.getfixturevalue("no_cv2")
    spools = {"port": live.LiveSpool(str(tmp_path / "port"), every=2, subsample=0.25, seed=7),
              "jax": jlive.LiveSpool(str(tmp_path / "jax"), every=2, subsample=0.25, seed=7)}
    calls = []
    for i in range(6):
        out = Untouchable() if i % 2 else frame_outputs(i, empty=(i == 4))
        rgb = frames(10 + i)
        for name, sp in spools.items():
            sp.publish(i, out, rgb_fn=lambda: calls.append(i) or rgb)
        statuses = {}
        for name in spools:
            d = tmp_path / name
            with open(d / "status.json") as f:
                statuses[name] = json.load(f)
        assert statuses["port"].keys() == statuses["jax"].keys() == {
            "frame", "fps", "timestamp", "objects", "workspace_points"}
        for k in ("frame", "objects", "workspace_points"):
            assert statuses["port"][k] == statuses["jax"][k]
        assert statuses["port"]["frame"] == i - i % 2
        p, j = tmp_path / "port", tmp_path / "jax"
        assert (p / "cloud.ply").exists() == (j / "cloud.ply").exists() == (i not in (4, 5))
        if i not in (4, 5):
            assert (p / "cloud.ply").read_bytes() == (j / "cloud.ply").read_bytes()
        frame = "frame.png" if with_cv2 else "frame.npy"
        assert (p / frame).read_bytes() == (j / frame).read_bytes()
        assert sorted(os.listdir(p)) == sorted(os.listdir(j))
    assert calls == [0, 0, 2, 2, 4, 4]
    if not with_cv2:
        assert np.load(tmp_path / "port" / "frame.npy").shape == (H, 2 * W, 3)


def test_publish_frame_matches_jax(tmp_path):
    spools = {"port": live.LiveSpool(str(tmp_path / "port"), every=3),
              "jax": jlive.LiveSpool(str(tmp_path / "jax"), every=3)}
    built = []
    for i in range(5):
        panel = frames(i, 1)[0]
        for sp in spools.values():
            sp.publish_frame(i, panel_fn=lambda: built.append(i) or panel, detections=i)
    s = {k: json.loads((tmp_path / k / "status.json").read_text()) for k in spools}
    assert s["port"]["frame"] == s["jax"]["frame"] == 3
    assert s["port"]["detections"] == 3 and s["port"].keys() == s["jax"].keys()
    assert built == [0, 0, 3, 3]
    assert (tmp_path / "port" / "frame.png").read_bytes() == \
        (tmp_path / "jax" / "frame.png").read_bytes()


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_viewer_state_ticks_as_jax(with_matplotlib, tmp_path, monkeypatch):
    """Over a spool the port wrote: the first tick of each viewer returns
    the status and (with matplotlib) renders `viewer_scene.png`; a tick
    with no new frame returns None; without a cloud it returns the status
    and renders nothing. `render_scene` returns None without matplotlib,
    as the JAX package's does."""
    if not with_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    spool = live.LiveSpool(str(tmp_path / "spool"), every=1)
    spool.publish(0, frame_outputs(0), rgb=frames(0))
    states = {"port": live.ViewerState(str(tmp_path / "spool"), str(tmp_path / "v_port")),
              "jax": jlive.ViewerState(str(tmp_path / "spool"), str(tmp_path / "v_jax"))}
    for name, st in states.items():
        s = st.tick()
        assert s["frame"] == 0 and st.tick() is None and st.azim == 316.0
        assert (tmp_path / f"v_{name}" / "viewer_scene.png").exists() == with_matplotlib
    spool.publish(1, frame_outputs(1, empty=True), rgb=frames(1))
    for name, st in states.items():
        assert st.tick()["frame"] == 1 and st.azim == 316.0
    pts = np.random.default_rng(0).normal(size=(20, 3))
    got = render_scene([(pts, "0.5", "a")], str(tmp_path / "r.png"))
    exp = jrender_scene([(pts, "0.5", "a")], str(tmp_path / "j.png"))
    assert (got is None) == (exp is None) == (not with_matplotlib)
    assert live.read_status(str(tmp_path / "none")) is None
    assert live.load_cloud(str(tmp_path / "none")) == (None, None)


def write_logs(d, seed, frames_n=24, stages=("Frame Retrieval", "YOLO11 Inference", "Total")):
    """An `fps_log.csv` and a `timings.csv` in the reference's schema."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "fps_log.csv"), "w") as f:
        f.write("Timestamp,FPS\n")
        for i in range(frames_n):
            f.write(f"{1000.0 + 0.07 * i},{rng.uniform(8, 20)}\n")
    with open(os.path.join(d, "timings.csv"), "w") as f:
        f.write("Step,Timings\n")
        for s in stages:
            vals = ",".join(str(v) for v in rng.uniform(0.001, 0.05, frames_n))
            f.write(f'{s},"{vals}"\n')
        f.write("Empty,\n")


def test_plots_and_readers_match_jax(tmp_path):
    d = str(tmp_path / "logs")
    write_logs(d, 0)
    fps_csv, tim_csv = os.path.join(d, "fps_log.csv"), os.path.join(d, "timings.csv")
    got, exp = plots.read_timings(tim_csv), jplots.read_timings(tim_csv)
    assert got.keys() == exp.keys() and "Empty" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], exp[k])
    for a, b in zip(plots._read_fps_log(fps_csv), jplots._read_fps_log(fps_csv)):
        np.testing.assert_array_equal(a, b)
    for fn, jfn, src in ((plots.plot_fps, jplots.plot_fps, fps_csv),
                         (plots.plot_stage_timings, jplots.plot_stage_timings, tim_csv)):
        out = str(tmp_path / f"{fn.__name__}.png")
        assert fn(src, out) == out and os.path.getsize(out) > 1000
        assert jfn(src, str(tmp_path / "j.png")) is not None
    short = str(tmp_path / "short.csv")
    with open(short, "w") as f:
        f.write("Timestamp,FPS\n")
    assert plots.plot_fps(short, str(tmp_path / "s.png")) is None


def test_compare_runs_matches_jax(tmp_path, capsys):
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    write_logs(ours, 1)
    write_logs(ref, 2, stages=("Frame Retrieval", "Subtraction"))
    names = dict(ours_name="ours", ref_name="reference")
    for refdir in (ref, str(tmp_path / "missing")):
        for warm in (0, 1, 30):
            got = compare.compare_runs(ours, refdir, drop_warmup=warm, **names)
            assert got == jcompare.compare_runs(ours, refdir, drop_warmup=warm, **names)
    summary = compare.load_run_summary(ours, "x", drop_warmup=30)
    assert np.isnan(summary.fps_mean) and summary.stage_ms == {}
    assert compare.main(["--ours", ours, "--reference", ref]) == 0
    text = capsys.readouterr().out
    assert "FPS mean" in text and "Subtraction (ms)" in text and "faster" in text
    assert compare.compare_runs(ours, None, **names) == compare.compare_runs(
        ours, str(tmp_path / "missing"), **names)
    assert compare.main(["--ours", ours]) == 0
    assert "FPS mean" in capsys.readouterr().out
