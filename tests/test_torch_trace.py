"""The step's spans and host-sync counters (`rt3d_torch.runtime.trace`) and
the benchmark's readers of them, on the CPU at a tiny size.

The step is `tests/test_torch_step.py`'s: two synthetic cameras at
240x320, the n weights at a (192, 256) model input, float32. Tracing must
leave the outputs bit for bit as they are, hand the `stage` hook exactly
its five groups, record nothing when off, nest every span under its group,
count each host sync where it happens, and show every span to a recording
`torch.profiler` on a clock one constant offset from the spans' own.
"""

import contextlib
import dataclasses
import gc
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port import spec
from rt3d_torch import config
from rt3d_torch.io import SyntheticSource
from rt3d_torch.models.postprocess import Detections
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.runtime import graphs, trace
from rt3d_torch.tracking.bytetrack import bytetrack_init, bytetrack_step
from tests.test_torch_detect_graph import StandInGraph
from tests.tiny import tiny_config

H, W = 240, 320
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "yolo11n_synth_seg.npz")
# the proto path runs no SAM: its counts stay 0 in every record
NO_SAM = {"sam_encoder_images": 0, "sam_prompt_slots": 0}
# the CPU's trackers run eagerly: the track graph's counts stay 0
NO_TRACK_GRAPH = {"track_graph_replays": 0, "track_graph_captures": 0}
STAGES = ("YOLO11 Inference", "Mask Processing", "Point Cloud Processing",
          "Point Cloud Fusion", "Subtraction")
# every span of a ByteTrack step and the span it opens under
PARENT = {
    "YOLO11 Inference": "step", "preprocess": "YOLO11 Inference",
    "detect.forward": "YOLO11 Inference", "detect.decode_nms": "YOLO11 Inference",
    "track.camera": "YOLO11 Inference", "sync.assignment.greedy_round": "track.camera",
    "Mask Processing": "step", "masks": "Mask Processing", "object_clouds": "Mask Processing",
    "Point Cloud Processing": "step", "workspace_clouds": "Point Cloud Processing",
    "workspace_sor": "Point Cloud Processing",
    "Point Cloud Fusion": "step", "fuse": "Point Cloud Fusion",
    "fuse.flatten": "Point Cloud Fusion",
    "Subtraction": "step", "subtract": "Subtraction", "accumulate": "Subtraction",
    # a voxel dedupe's run starts: once a camera in each dedupe, and in the accumulator
    "sync.ops.run_starts": ("object_clouds", "workspace_clouds", "accumulate"),
}
# BoT-SORT with ReID and GMC adds these
BOTSORT_PARENT = {
    "detect.embed": "YOLO11 Inference", "track.gmc": "YOLO11 Inference",
    "sync.botsort.identity_upload": "track.gmc", "sync.botsort.prior_upload": "track.gmc",
    "sync.botsort.gmc_solve": "track.gmc", "sync.botsort.offset_upload": "track.gmc",
}


def small_config(cameras, tracker=None, **pipeline) -> config.Config:
    """`tests/test_torch_step.py`'s config, its tracker and pipeline fields
    overridden."""
    d = tiny_config().to_dict()
    d["rig"] = {"cameras": [dataclasses.asdict(c) for c in cameras]}
    d["model"].update(input_hw=(192, 256), compute_dtype="float32",
                      preprocess_dtype="float32", mask_resize_dtype="float32")
    d["tracker"].update(tracker or {})
    d["pipeline"].update(pipeline)
    return config.Config.from_dict(d)


@pytest.fixture(scope="module")
def src():
    return SyntheticSource(num_cameras=2, num_frames=2, hw=(H, W), num_objects=2)


@pytest.fixture(scope="module")
def frames(src):
    return [tuple(torch.from_numpy(a) for a in (p.rgb, p.depth))
            for p in (src.get(i) for i in range(2))]


@pytest.fixture(scope="module")
def pipe(src):
    return build_pipeline(small_config(src.cameras()), weights=WEIGHTS, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch runs on one thread meanwhile: many small ops, and the test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def run(pipe, frames, stage=None):
    """Every frame stepped from the initial state: (outputs, last state)."""
    state, calib, outs = pipe.init_state(), pipe.calib(), []
    for rgb, depth in frames:
        state, out = pipe.step(state, rgb, depth, calib, stage=stage)
        outs.append(out)
    return outs, state


def tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    if x is None:
        return []
    return [t for f in dataclasses.fields(x) for t in tensors(getattr(x, f.name))]


@pytest.fixture(scope="module")
def runs(pipe, frames):
    """The two frames untraced, then traced through a `stage` hook that
    notes every name it is handed; the records of the traced steps."""
    trace.disable()
    trace.clear()
    plain = run(pipe, frames)
    names = []

    def stage(name):
        names.append(name)
        return contextlib.nullcontext()

    traced = run(pipe, frames, stage=stage)
    recs = trace.records()
    trace.disable()
    return plain, traced, names, recs


def test_hook_gets_five_groups_and_outputs_stay_bit_equal(runs):
    plain, traced, names, recs = runs
    assert names == list(STAGES) * 2
    a, b = tensors(plain), tensors(traced)
    assert len(a) == len(b) > 0
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert [r["step"] for r in recs] == [recs[0]["step"], recs[0]["step"] + 1]


def check_nesting(rec, parents):
    spans = rec["spans"]
    assert spans[0].name == "step" and spans[0].parent is None
    for s in spans[1:]:
        assert s.thread == spans[0].thread
        p = spans[s.parent]
        allowed = parents[s.name]
        assert p.name in ((allowed,) if isinstance(allowed, str) else allowed), (s.name, p.name)
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert [s.name for s in spans if s.parent == 0] == list(STAGES)


def test_spans_nest_under_their_parents(runs):
    recs = runs[3]
    for rec in recs:
        check_nesting(rec, PARENT)
        names = [s.name for s in rec["spans"]]
        assert set(names) == set(PARENT) | {"step"}
        assert names.count("track.camera") == 2
        assert names.count("sync.assignment.greedy_round") == rec["host_syncs"][
            "assignment.greedy_round"]
        # the CPU's detect is eager
        assert rec["counts"] == {"detect_graph_replays": 0, "detect_graph_captures": 0,
                                 **NO_SAM, **NO_TRACK_GRAPH}


def test_traced_graph_steps_count_and_time_the_replay(src, frames, monkeypatch):
    """Detect's and track's graph paths, taken on the CPU through the
    stand-in for the captured graph of `tests/test_torch_detect_graph.py`:
    the first traced step captures and replays each, the next only replay;
    the replay is the span `detect.graph` under `YOLO11 Inference`, the
    capture a sync inside it."""
    monkeypatch.setattr(graphs, "replayable", lambda device: not torch.is_grad_enabled())
    monkeypatch.setattr(graphs, "CapturedGraph", StandInGraph)
    pipe = build_pipeline(small_config(src.cameras()), weights=WEIGHTS, device="cpu")
    trace.enable()
    state, calib = pipe.init_state(), pipe.calib()
    for rgb, depth in frames + frames[:1]:
        state, _ = pipe.step(state, rgb, depth, calib)
    recs = trace.records()
    assert [r["counts"] for r in recs] == [
        {"detect_graph_replays": 1, "detect_graph_captures": 1, **NO_SAM,
         "track_graph_replays": 1, "track_graph_captures": 1}] + [
        {"detect_graph_replays": 1, "detect_graph_captures": 0, **NO_SAM,
         "track_graph_replays": 1, "track_graph_captures": 0}] * 2
    for site in ("step.detect_capture", "step.track_capture"):
        assert [r["host_syncs"].get(site, 0) for r in recs] == [1, 0, 0]
    for rec in recs:
        spans = rec["spans"]
        graph = [s for s in spans if s.name == "detect.graph"]
        assert len(graph) == 1 and spans[graph[0].parent].name == "YOLO11 Inference"
        for s in spans:
            if s.name.startswith("detect.") and s.name != "detect.graph":
                # the stand-in's core runs inside the replay's span
                assert spans[s.parent].name in ("detect.graph", "sync.step.detect_capture")


def test_botsort_spans_nest_and_count_their_syncs(src, frames):
    """BoT-SORT with ReID and GMC on the first frame: `detect.embed`,
    `track.gmc` and the affine GMC's host syncs (two uploads and two solves
    a camera; the identity is uploaded only by the translation form)."""
    cfg = small_config(src.cameras(), tracker=dict(tracker_type="botsort", with_reid=True,
                                                   gmc=True, emb_dim=16))
    pipe = build_pipeline(cfg, weights=WEIGHTS, device="cpu")
    trace.enable()
    run(pipe, frames[:1])
    rec = trace.records()[-1]
    check_nesting(rec, {**PARENT, **BOTSORT_PARENT})
    assert rec["host_syncs"] == {"botsort.prior_upload": 2, "botsort.gmc_solve": 4,
                                 "botsort.offset_upload": 2, "assignment.greedy_round": 6,
                                 "ops.run_starts": 4}


def test_off_records_nothing_opens_nothing(pipe, frames, monkeypatch):
    """Off, with PyTorch's flag of a recording profiler up: no record, no
    span object, no `record_function`, no `gc` callback; a traced step's
    tracing ends at the next step handed no hook."""
    run(pipe, frames[:1], stage=lambda name: contextlib.nullcontext())
    assert trace.ON and trace._gc_callback in gc.callbacks
    trace.clear()

    def refuse(*a, **k):
        raise AssertionError("a span was opened with tracing off")

    monkeypatch.setattr(trace, "_Span", refuse)
    monkeypatch.setattr(trace, "_Step", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    run(pipe, frames[:1])
    assert not trace.ON and trace._gc_callback not in gc.callbacks
    assert trace.records() == []


def test_stages_called_outside_a_step_are_no_steps(pipe, frames):
    """Tracing on, a stage called on its own (as the sharded step calls
    them) adds nothing to the last step's record."""
    trace.enable()
    run(pipe, frames[:1])
    before = trace.records()[-1]
    pipe.detect(pipe.preprocess(frames[0][0]))
    assert trace.records()[-1] == before


def test_spans_of_many_threads_all_land():
    """Sixteen threads (more than the cores) open spans with syncs inside
    into one step's record at a switch interval of a microsecond: none is
    lost, each sync sits under its own thread's span."""
    def work():
        for _ in range(200):
            with trace.span("upload"), trace.sync("x"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.step(True):
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = trace.records()[-1]
    spans = rec["spans"]
    assert rec["host_syncs"] == {"x": 3200}
    assert [s.name for s in spans].count("upload") == 3200
    for s in spans:
        if s.name == "sync.x":
            p = spans[s.parent]
            assert p.name == "upload" and p.thread == s.thread and s.end_ns
        elif s.name == "upload":
            assert s.parent is None and s.end_ns >= s.start_ns > 0


def test_host_syncs_of_known_detections():
    """ByteTrack on three far-apart detections: on the first frame every
    association round finds no track and reads back once; on the second,
    the first round claims all three in one greedy round and reads back
    twice, the other two rounds once each."""
    cfg = config.TrackerConfig(max_tracks=8)
    boxes = torch.tensor([[10.0, 10, 50, 60], [200, 40, 260, 120], [400, 300, 470, 380],
                          [0, 0, 0, 0]])
    det = Detections(boxes=boxes, scores=torch.tensor([0.9, 0.8, 0.85, 0.0]),
                     classes=torch.tensor([0, 1, 0, 0], dtype=torch.int32),
                     coeffs=torch.zeros(4, 32), valid=torch.tensor([True, True, True, False]))
    ts = bytetrack_init(cfg.max_tracks, device="cpu")
    counts = []
    for shift in (0.0, 2.0):
        with trace.step(True):
            ts, ids = bytetrack_step(ts, det.replace(boxes=boxes + shift), cfg)
        counts.append(trace.records()[-1]["host_syncs"])
    assert counts == [{"assignment.greedy_round": 3}, {"assignment.greedy_round": 4}]
    assert (ids[:3] >= 1).all() and ids[3] == -1


def test_host_syncs_of_the_accumulating_step(src, frames):
    """The 1 mm accumulating path with fused slots above 4096 rows: on the
    first frame, one greedy read-back per association round and camera,
    the slot SOR fallback's `nonzero` once per fusion fold, the
    accumulator's count once, and the run starts of the two-word keys once
    a camera's object clouds and once in the accumulator (the raw rays
    skip the workspace's dedupe)."""
    cfg = small_config(src.cameras(), voxel_size=0.001, workspace_stride=4,
                       max_points_workspace=5120, max_points_workspace_fused=20480,
                       max_union_voxels=4096, max_points_per_object=2100,
                       max_points_fused_object=4200, max_points_fused_flat=4096,
                       workspace_accumulate=True, accum_skip_prededupe=True,
                       accum_capacity=4096)
    pipe = build_pipeline(cfg, weights=WEIGHTS, device="cpu")
    run(pipe, frames[:1], stage=lambda name: contextlib.nullcontext())
    assert trace.records()[-1]["host_syncs"] == {
        "assignment.greedy_round": 6, "sor.slots_present": 1, "voxel_sets.accum_count": 1,
        "ops.run_starts": 3}


def test_spans_are_profiler_ranges_on_one_clock(pipe, frames):
    """Under a CPU profiler each span is a `record_function` range of its
    name inside its parent's range, and one offset between the profiler's
    clock and the spans' `perf_counter` stamps holds every span inside its
    range to within 0.2 ms. A range opens before its span's stamp and
    closes after it, so a pause of the thread between the two (a
    collection, the scheduler) widens a range and moves no bound."""
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(pipe, frames[:1])
    spans = trace.records()[-1]["spans"]
    names = {s.name for s in spans}
    events = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == [s.name for s in spans]
    for s, e in zip(spans, events):
        if s.parent is not None:
            p = events[s.parent].time_range
            assert p.start <= e.time_range.start <= e.time_range.end <= p.end, s.name
    # the least offset that starts no span before its range, the greatest
    # that ends none after it
    least = max(e.time_range.start * 1e3 - s.start_ns for s, e in zip(spans, events))
    greatest = min(e.time_range.end * 1e3 - s.end_ns for s, e in zip(spans, events))
    assert least - greatest < 0.2e6


def test_profile_mode_traces_and_keeps_its_csv(pipe, src, tmp_path):
    """The driver's profile mode hands the step its hook, so its steps are
    traced, the uploader's copy of each frame an `upload` span on its own
    thread; `timings.csv` keeps its rows, `fps_log.csv` one a frame."""
    from rt3d_torch.runtime import PipelineDriver

    timings, fps = tmp_path / "timings.csv", tmp_path / "fps_log.csv"
    drv = PipelineDriver(pipe, mode="profile", timings_path=str(timings),
                         fps_log_path=str(fps))
    drv.run(src, 2, warmup=0)
    recs = trace.records()
    assert len(recs) == 2
    for rec in recs:
        assert [s.name for s in rec["spans"] if s.parent == 0] == list(STAGES)
    uploads = [s for rec in recs for s in rec["spans"] if s.name == "upload"]
    assert uploads and all(s.parent is None and s.thread.startswith("rt3d-upload")
                           for s in uploads)
    rows = [line.split(",")[0] for line in timings.read_text().splitlines()]
    assert rows == ["Step", "Frame Retrieval", "Point Cloud Processing", "YOLO11 Inference",
                    "Mask Processing", "Point Cloud Fusion", "Subtraction",
                    "Total Time per Iteration"]
    assert len(fps.read_text().splitlines()) == 3


# -- the benchmark's readers, on synthetic records ----------------------------

MS = 1_000_000  # ns


def synthetic_step(i, t0, scale):
    """Program step `i` from `t0` ns: preprocess 1, forward 2, decode 1 and
    two cameras' trackers 0.5 each (a 0.1 sync inside each), all times
    `scale` ms; syncs {a: 2, b: scale}; one collection of 0.3 ms."""
    T = trace.Span
    u = scale * MS
    spans = [T("step", i, None, "MainThread", t0, t0 + 10 * u),
             T("YOLO11 Inference", i, 0, "MainThread", t0, t0 + 5 * u),
             T("preprocess", i, 1, "MainThread", t0, t0 + u),
             T("detect.forward", i, 1, "MainThread", t0 + u, t0 + 3 * u),
             T("detect.decode_nms", i, 1, "MainThread", t0 + 3 * u, t0 + 4 * u),
             T("track.camera", i, 1, "MainThread", t0 + 4 * u, t0 + 4.5 * u),
             T("sync.a", i, 5, "MainThread", t0 + 4 * u, t0 + 4.1 * u),
             T("track.camera", i, 1, "MainThread", t0 + 4.5 * u, t0 + 5 * u),
             T("sync.a", i, 7, "MainThread", t0 + 4.5 * u, t0 + 4.6 * u),
             T("upload", i, None, "rt3d-upload_0", t0 + u, t0 + 9 * u)]
    return dict(step=i, spans=spans, host_syncs={"a": 2, "b": scale}, launches={},
                gc=[(0, t0 + 6 * u, t0 + 6 * u + 0.3 * MS)])


def bench_record(frames, t0, t1):
    """The harness's record of window frames `frames` whose host stage spans
    run from `t0` to `t1` ns (just inside the steps' own)."""
    n = len(frames)
    dt = (t1 - t0) / n
    spans = [(name, f, (t0 + k * dt) * 1e-9 + 1e-6, (t0 + (k + 1) * dt) * 1e-9 - 1e-6)
             for k, f in enumerate(frames) for name in STAGES]
    return dict(frames=frames, spans=spans)


@pytest.mark.parametrize("metric,value", [("detect_ms", 8.0), ("track_ms", 2.0),
                                          ("host_syncs", 4.0), ("host_sync_ms", 0.4),
                                          ("gc_pause_ms", 0.3)])
def test_readers_take_the_windows_steps_by_time(metric, value, monkeypatch):
    """Six program steps 20 ms apart, each 10 units long (a unit 1 ms, 2 ms
    in steps 2 and 3): steps 2 and 3 are the window's frames 40 and 41,
    chosen by time, not by their numbers; without the ring's cover of both,
    no value."""
    t0 = 10**12
    steps = [synthetic_step(i, t0 + 20 * MS * i, 2 if i in (2, 3) else 1)
             for i in range(6)]
    read = spec.metric_reader(metric)
    record = bench_record([40, 41], t0 + 40 * MS, t0 + 80 * MS)
    monkeypatch.setattr(trace, "records", lambda: steps)
    assert read(record) == pytest.approx(value)
    monkeypatch.setattr(trace, "records", lambda: steps[3:])
    assert read(record) is None


def test_detect_ms_counts_the_graph_span_once(monkeypatch):
    """Steps whose detect replays the graph: `detect.graph` in place of the
    forward and decode spans, with the capture's sync and the eager spans it
    runs nested inside (the capturing step), counted once beside
    `preprocess`."""
    t0 = 10**12
    steps = []
    for i in range(6):
        rec = synthetic_step(i, t0 + 20 * MS * i, 2 if i in (2, 3) else 1)
        spans, u = rec["spans"], (2 if i in (2, 3) else 1) * MS
        graph = trace.Span("detect.graph", i, 1, "MainThread", spans[3].start_ns,
                           spans[4].end_ns)
        inner = [trace.Span("sync.step.detect_capture", i, 3, "MainThread", graph.start_ns,
                            graph.start_ns + u),
                 trace.Span("detect.forward", i, 4, "MainThread", graph.start_ns,
                            graph.start_ns + u // 2),
                 trace.Span("detect.decode_nms", i, 3, "MainThread", graph.start_ns + u,
                            graph.end_ns)]
        # the track spans keep their parents (indices 1, 5 and 7 stay where they were)
        rec["spans"] = spans[:3] + [graph, inner[0]] + spans[5:] + inner[1:]
        steps.append(rec)
    monkeypatch.setattr(trace, "records", lambda: steps)
    record = bench_record([40, 41], t0 + 40 * MS, t0 + 80 * MS)
    assert spec.metric_reader("detect_ms")(record) == pytest.approx(8.0)
    assert spec.metric_reader("host_sync_ms")(record) == pytest.approx(2.4)
