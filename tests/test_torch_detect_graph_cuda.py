"""`Pipeline.detect`'s CUDA graph against its eager path, on the card.

Marked ``cuda``; each test skips without a CUDA device (this module imports
no JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_detect_graph_cuda.py

For the benchmark's presets (`2cam`: the x model in bf16, two HD720
cameras; `stretch_4cam_1mm`: the n model, four cameras) and `2cam_int8`
(the x backbone int8, calibrated live), over four consecutive frames: the
graph path's outputs equal the eager path's (autograd on takes it) bit for
bit, the detections handed out for frame t stay as they were after frame
t+1's replay, and whole steps through the graph equal whole eager steps.
The capture succeeds while another thread copies to the card on a stream of
its own, as the driver's uploader does; a model quantized after the capture
is captured again and gives the int8 eager bits.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from rt3d_torch.models.quant import quantize_pipeline, synth_calib_batches
from rt3d_torch.pipeline.presets import (
    CALIB_FRAMES, preset_config, preset_source, preset_weights, synthetic_preset,
)
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.runtime import graphs, trace

pytestmark = pytest.mark.cuda

FRAMES = 4
PRESETS = ("2cam", "stretch_4cam_1mm", "2cam_int8")
# the proto path runs no SAM: its counts stay 0 in every record
NO_SAM = {"sam_encoder_images": 0, "sam_prompt_slots": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    if x is None:
        return []
    return [t for f in dataclasses.fields(x) for t in tensors(getattr(x, f.name))]


def bit_equal(a, b) -> bool:
    a, b = tensors(a), tensors(b)
    return len(a) == len(b) > 0 and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def card_frames(src, n):
    return [(torch.from_numpy(p.rgb).cuda(), torch.from_numpy(p.depth).cuda())
            for p in (src.get(i) for i in range(n))]


@pytest.mark.parametrize("preset", PRESETS)
def test_graph_detect_equals_eager_over_four_frames(card, preset):
    pipe, src = synthetic_preset(preset, FRAMES)
    images = [pipe.preprocess(rgb) for rgb, _ in card_frames(src, FRAMES)]
    with torch.enable_grad():
        eager = [pipe.detect(im) for im in images]
    assert pipe._detect_graph is None
    got, kept = [], []
    with torch.no_grad():
        for im in images:
            out = pipe.detect(im)
            kept.append(tuple(t.clone() for t in tensors(out)))
            got.append(out)
            if len(got) == 1:
                graph = pipe._detect_graph
    torch.cuda.synchronize()
    assert graph is not None and pipe._detect_graph is graph  # one capture
    for t, (g, e, k) in enumerate(zip(got, eager, kept)):
        assert bit_equal(k, e), f"frame {t}"
        assert bit_equal(g[0], e[0]), f"frame {t}'s detections after the later replays"
    assert got[0][1] is got[-1][1]  # the protos live in the graph's memory
    assert not bit_equal(eager[0][0], eager[1][0])
    print(f"{preset}: detections valid a frame "
          f"{[int(e[0].valid.sum()) for e in eager]}")


@pytest.mark.parametrize("preset", PRESETS)
def test_graph_steps_equal_eager_steps(card, preset, monkeypatch):
    """Four whole steps from the initial state: every output and the state
    bit for bit; traced, each step replays once and only the first
    captures."""
    pipe, src = synthetic_preset(preset, FRAMES)
    frames, calib = card_frames(src, FRAMES), pipe.calib()

    def run():
        state, outs = pipe.init_state(), []
        for rgb, depth in frames:
            state, out = pipe.step(state, rgb, depth, calib)
            outs.append(out)
        torch.cuda.synchronize()
        return outs, state

    trace.clear()
    trace.enable()
    try:
        graph = run()
    finally:
        trace.disable()
    recs = trace.records()
    trace.clear()
    # ByteTrack's greedy step replays its own graph beside detect's
    assert [r["counts"] for r in recs] == [
        {"detect_graph_replays": 1, "detect_graph_captures": 1, **NO_SAM,
         "track_graph_replays": 1, "track_graph_captures": 1}] + [
        {"detect_graph_replays": 1, "detect_graph_captures": 0, **NO_SAM,
         "track_graph_replays": 1, "track_graph_captures": 0}] * (FRAMES - 1)
    assert all([s.name for s in r["spans"]].count("detect.graph") == 1 for r in recs)
    monkeypatch.setattr(graphs, "replayable", lambda device: False)
    eager = run()
    assert bit_equal(graph, eager)


def test_capture_while_a_thread_copies_on_its_own_stream(card):
    """The uploader's work (pin a frame, copy it on a stream of its own,
    record an event) goes on in another thread all through the capture."""
    pipe, src = synthetic_preset("2cam", 1)
    images = pipe.preprocess(card_frames(src, 1)[0][0])
    with torch.enable_grad():
        eager = pipe.detect(images)
    torch.cuda.synchronize()
    frame = np.random.default_rng(0).integers(0, 255, (2, 720, 1280, 3), dtype=np.uint8)
    stop, copies = threading.Event(), [0]

    def uploader():
        stream = torch.cuda.Stream()
        while not stop.is_set():
            with torch.cuda.stream(stream):
                t = torch.from_numpy(frame).pin_memory().to("cuda", non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
            ready.synchronize()
            del t
            copies[0] += 1

    thread = threading.Thread(target=uploader)
    thread.start()
    try:
        while copies[0] < 3:
            stop.wait(0.01)
        before = copies[0]
        with torch.no_grad():
            got = pipe.detect(images)
        during = copies[0] - before
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert pipe._detect_graph is not None
    assert during > 0, "no copy ran during the capture"
    assert bit_equal(got, eager)
    print(f"{during} uploads during the capture")


def test_quantize_after_capture_gives_the_int8_eager_bits(card):
    src = preset_source("2cam_int8", CALIB_FRAMES)
    weights = preset_weights("2cam_int8")
    pipe = build_pipeline(preset_config("2cam_int8", src), weights=weights, device="cuda")
    images = pipe.preprocess(card_frames(src, 1)[0][0])
    with torch.no_grad():
        fp = tuple(t.clone() for t in tensors(pipe.detect(images)))
    first = pipe._detect_graph
    quantize_pipeline(pipe, weights, synth_calib_batches(pipe, src, range(CALIB_FRAMES)))
    with torch.no_grad():
        got = pipe.detect(images)
    assert pipe._detect_graph is not None and pipe._detect_graph is not first
    with torch.enable_grad():
        eager = pipe.detect(images)
    assert bit_equal(got, eager)
    assert not bit_equal(got, fp)
