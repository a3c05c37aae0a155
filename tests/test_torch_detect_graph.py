"""`Pipeline.detect`'s CUDA graph path, on the CPU: what the card's test
(`tests/test_torch_detect_graph_cuda.py`) cannot show without a card.

On the CPU `detect` runs eagerly and counts no replay. The graph path's
bookkeeping (when it captures, what it counts and times, that the
detections it returns are its own and not the graph's memory) is driven
here through a stand-in for the captured graph: its capture runs
`_detect_core` once and keeps the outputs, and each replay writes the new
results into those same tensors, as a CUDA graph's replay writes its memory.

The pipeline: two synthetic cameras at 96x160, the n weights at a
(64, 96) model input, float32.
"""

import dataclasses
import os

import pytest
import torch

from rt3d_torch import config, tree
from rt3d_torch.io import SyntheticSource
from rt3d_torch.models import quant
from rt3d_torch.models.yolo import Conv, QConv, cast_for_inference, load_weights
from rt3d_torch.pipeline.presets import PRESETS
from rt3d_torch.pipeline.step import build_pipeline, class_mask
from rt3d_torch.runtime import graphs, trace
from tests.tiny import tiny_config

H, W = 96, 160
# the proto path runs no SAM: its counts stay 0 in every record
NO_SAM = {"sam_encoder_images": 0, "sam_prompt_slots": 0}
# the CPU's trackers run eagerly: the track graph's counts stay 0
NO_TRACK_GRAPH = {"track_graph_replays": 0, "track_graph_captures": 0}
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "yolo11n_synth_seg.npz")


def small_config(cameras) -> config.Config:
    d = tiny_config().to_dict()
    d["rig"] = {"cameras": [dataclasses.asdict(c) for c in cameras]}
    d["model"].update(compute_dtype="float32", preprocess_dtype="float32",
                      mask_resize_dtype="float32", conf_thresh=0.01)
    return config.Config.from_dict(d)


@pytest.fixture(scope="module")
def src():
    return SyntheticSource(num_cameras=2, num_frames=4, hw=(H, W), num_objects=2)


@pytest.fixture(scope="module")
def frames(src):
    return [tuple(torch.from_numpy(a) for a in (p.rgb, p.depth))
            for p in (src.get(i) for i in range(4))]


def new_pipe(src):
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


class StandInGraph:
    """`graphs.CapturedGraph` without a card: the capture runs `fn` on
    copies of the argument tree and keeps its outputs, a replay copies the
    new leaves in, runs `fn` again and writes the results into those same
    tensors."""

    def __init__(self, fn, args, key):
        self.key, self.fn = key, fn
        self.args = tree.map(torch.clone, args)
        self.outputs = fn(*self.args)

    def replay(self, args):
        for mine, new in zip(tree.leaves(self.args), tree.leaves(args), strict=True):
            mine.copy_(new)
        for kept, new in zip(tensors(self.outputs), tensors(self.fn(*self.args))):
            kept.copy_(new)
        return self.outputs


@pytest.fixture
def graph_path(monkeypatch):
    """The graph path taken on the CPU, through `StandInGraph`."""
    monkeypatch.setattr(graphs, "replayable", lambda device: not torch.is_grad_enabled())
    monkeypatch.setattr(graphs, "CapturedGraph", StandInGraph)


def old_class_mask(num_classes, class_filter):
    """The mask as `detect` built it on every call before it was cached."""
    mask = torch.full((num_classes,), not class_filter)
    for c in class_filter:
        mask[c] = True
    return mask


@pytest.mark.parametrize("name", sorted(PRESETS) + ["empty"])
def test_cached_class_mask_equals_the_per_call_one(name):
    """Every preset's `class_filter`, and an empty filter (all true)."""
    m = PRESETS[name].config().model if name != "empty" else \
        dataclasses.replace(config.Config().model, class_filter=())
    got = class_mask(m.num_classes, m.class_filter, "cpu")
    assert got.dtype == torch.bool and torch.equal(got, old_class_mask(m.num_classes,
                                                                       m.class_filter))
    assert bool(got.all()) == (not m.class_filter)


def test_pipeline_builds_its_class_mask_once(src):
    pipe = new_pipe(src)
    m = pipe.cfg.model
    assert torch.equal(pipe.class_mask, old_class_mask(m.num_classes, m.class_filter))
    mask = pipe.class_mask
    pipe.detect(pipe.preprocess(src_frame(src)))
    assert pipe.class_mask is mask


def src_frame(src, i=0):
    return torch.from_numpy(src.get(i).rgb)


def test_cpu_detect_is_eager_and_counts_no_replay(src, frames):
    """A traced step on the CPU: no `detect.graph` span, both counts 0, no
    graph kept; the eager spans as before."""
    pipe = new_pipe(src)
    trace.enable()
    state, calib = pipe.init_state(), pipe.calib()
    for rgb, depth in frames[:2]:
        state, _ = pipe.step(state, rgb, depth, calib)
    for rec in trace.records():
        assert rec["counts"] == {"detect_graph_replays": 0, "detect_graph_captures": 0,
                                 **NO_SAM, **NO_TRACK_GRAPH}
        names = [s.name for s in rec["spans"]]
        assert "detect.graph" not in names and "detect.forward" in names
    assert pipe._detect_graph is None


def test_calibration_sees_every_conv_hook(src):
    """`collect_act_scales` calls the model itself, with a pre-hook on every
    conv that reads its input: after `detect` has run, every conv's hook
    still fires once a batch and every conv gets a scale."""
    pipe = new_pipe(src)
    batches = [pipe.preprocess(src_frame(src, i)) for i in range(2)]
    with torch.no_grad():
        pipe.detect(batches[0])
    convs = {n: m for n, m in pipe.model.named_modules() if isinstance(m, (Conv, QConv))}
    calls = dict.fromkeys(convs, 0)

    def counter(name):
        def pre(mod, args):
            calls[name] += 1
        return pre

    handles = [m.register_forward_pre_hook(counter(n)) for n, m in convs.items()]
    try:
        scales = quant.collect_act_scales(pipe.model, batches)
    finally:
        for h in handles:
            h.remove()
    assert calls == dict.fromkeys(convs, 2)
    assert set(scales) == {n.replace(".", "/") for n in convs}
    assert all(v > 0 for v in scales.values())


def test_graph_path_is_bit_equal_and_hands_out_its_own_detections(src, frames, graph_path):
    """Four frames through the graph path against the eager path (autograd
    on): bit for bit, one capture; frame t's detections unchanged after
    frame t+1's replay wrote the graph's outputs; the protos are the
    graph's, rewritten by the next replay."""
    pipe = new_pipe(src)
    images = [pipe.preprocess(rgb) for rgb, _ in frames]
    with torch.enable_grad():
        eager = [pipe.detect(im) for im in images]
    assert pipe._detect_graph is None
    got, kept = [], []
    with torch.no_grad():
        for im in images:
            out = pipe.detect(im)
            kept.append(tuple(t.clone() for t in tensors(out)))
            got.append(out)
    graph = pipe._detect_graph
    assert isinstance(graph, StandInGraph)
    for g, e, k in zip(got, eager, kept):
        assert bit_equal(k, e)
        assert bit_equal(g[0], e[0])  # the detections, after every later replay
    assert got[0][1] is got[-1][1] is graph.outputs[1]
    assert not bit_equal(eager[0][0], eager[1][0])  # the frames differ


def swap_quantize(pipe):
    quant.quantize_pipeline(pipe, WEIGHTS, act_scales={
        p: 1.0 for p in quant._conv_paths(pipe.model) if not quant.default_exclude(p)})


SWAPS = {
    "quantize_pipeline": swap_quantize,
    "load_weights": lambda pipe: load_weights(pipe.model, WEIGHTS),
    "set_compute_dtype": lambda pipe: pipe.model.set_compute_dtype(torch.float64),
    "cast_for_inference": lambda pipe: cast_for_inference(pipe.model, torch.float64, "cpu"),
}


@pytest.mark.parametrize("swap", sorted(SWAPS))
def test_a_swapped_model_is_captured_again(src, frames, graph_path, swap):
    """After each place that swaps the model's modules, parameter storage
    or compute dtype, the next `detect` captures again and gives the eager
    path's bits of the changed model; an in-place `load_state_dict` keeps
    the graph."""
    pipe = new_pipe(src)
    images = pipe.preprocess(frames[0][0])
    with torch.no_grad():
        pipe.detect(images)
        first = pipe._detect_graph
        pipe.model.load_state_dict(pipe.model.state_dict())
        pipe.detect(images)
        assert pipe._detect_graph is first
        SWAPS[swap](pipe)
        got = pipe.detect(images)
    assert pipe._detect_graph is not first
    with torch.enable_grad():
        eager = pipe.detect(images)
    assert bit_equal(got, eager)
