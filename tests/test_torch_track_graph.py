"""`Pipeline.track`'s CUDA graph path, on the CPU: which tracker steps take
it, and its bookkeeping. The card's test (`tests/test_torch_track_graph_cuda.py`)
holds the captured graph against the eager path.

On the CPU `track` runs eagerly and counts no replay. The graph path's
copies (the states and detections into its static buffers, the new states
and ids out of its memory) are driven here through a stand-in for the
captured graph: its capture runs the core once and keeps the outputs,
and each replay writes the new results into those same tensors, as a
CUDA graph's replay writes its memory.

`scene` makes every camera's detections for a run of frames: objects that
move, enter, drop to a low score, vanish for two frames (lost, then found
again) or for six (lost, then expired: `TRACKER` keeps lost tracks three
frames), and one-frame false detections (tracks that are never confirmed
and are removed). `events` names what a run of states went through.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rt3d_torch import tree
from rt3d_torch.config import Config
from rt3d_torch.models.postprocess import Detections
from rt3d_torch.pipeline.step import Pipeline
from rt3d_torch.runtime import graphs, trace
from rt3d_torch.tracking.bytetrack import EMPTY, LOST, TRACKED

D = 20            # detection slots a camera
OBJECTS = 8       # objects a camera
TRACKER = dict(track_buffer=3)  # at 30 fps a lost track expires after 3 frames
EVENTS = ("spawn", "round2", "round3", "lost", "refound", "removed", "expired")


def scene(cameras: int, frames: int, seed: int = 0, device="cpu") -> list:
    """`frames` batches of `Detections` (cameras, D), boxes in 1280 x 720
    pixels, score-sorted slots as NMS leaves them."""
    out = [[] for _ in range(frames)]
    for c in range(cameras):
        rng = np.random.default_rng([seed, c])
        pos = rng.uniform((60, 60), (1000, 480), (OBJECTS, 2))
        size = rng.uniform(60, 200, (OBJECTS, 2))
        vel = rng.uniform(-8, 8, (OBJECTS, 2))
        enter = rng.integers(0, 12, OBJECTS)
        gap = enter + rng.integers(3, 20, OBJECTS)
        gap_len = rng.choice([2, 6], OBJECTS)
        for t in range(frames):
            dets = []
            for k in range(OBJECTS):
                if t < enter[k] or gap[k] <= t < gap[k] + gap_len[k]:
                    continue
                u = rng.random()
                if u > 0.9:
                    continue  # missed for a frame
                score = rng.uniform(0.65, 0.95) if u < 0.75 else rng.uniform(0.1, 0.55)
                xy = pos[k] + vel[k] * t + rng.normal(0, 2, 2)
                dets.append((*xy, *(xy + size[k]), score, k % 2))
            if rng.random() < 0.35:  # a false detection, seen once
                xy = rng.uniform((0, 0), (1100, 560))
                dets.append((*xy, *(xy + rng.uniform(40, 120, 2)), 0.75, 0))
            dets.sort(key=lambda d: -d[4])
            a = np.zeros((D, 6), np.float32)
            a[:len(dets)] = np.asarray(dets, np.float32).reshape(-1, 6)
            out[t].append((a, len(dets)))
    dets = []
    for per_cam in out:
        a = np.stack([x for x, _ in per_cam])
        valid = np.stack([np.arange(D) < n for _, n in per_cam])

        def t_(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=device)

        dets.append(Detections(boxes=t_(a[..., :4], torch.float32),
                               scores=t_(a[..., 4], torch.float32),
                               classes=t_(a[..., 5], torch.int32),
                               coeffs=torch.zeros((cameras, D, 4), device=device),
                               valid=t_(valid, torch.bool)))
    return dets


def events(states, high_thresh: float) -> set:
    """What a run of one camera's tracker states went through: new tracks
    (`spawn`), low-score matches (`round2`), unconfirmed tracks confirmed
    (`round3`), tracks lost, lost tracks found again, unconfirmed tracks
    removed, lost tracks expired."""
    seen = set()
    for a, b in zip(states, states[1:]):
        sa, sb = a.state.cpu(), b.state.cpu()
        act_a, act_b = a.activated.cpu(), b.activated.cpu()
        fresh = b.last_update.cpu() == b.frame_id.cpu()
        tr = sb == TRACKED
        checks = {
            "spawn": (sa == EMPTY) & tr,
            "round2": tr & fresh & (b.score.cpu() < high_thresh),
            "round3": (sa == TRACKED) & ~act_a & tr & act_b,
            "lost": (sa == TRACKED) & (sb == LOST),
            "refound": (sa == LOST) & tr & (a.track_id.cpu() == b.track_id.cpu()),
            "removed": (sa == TRACKED) & ~act_a & (sb == EMPTY),
            "expired": (sa == LOST) & (sb == EMPTY),
        }
        seen |= {name for name, hit in checks.items() if bool(hit.any())}
    return seen


def track_pipeline(cameras: int = 2, device="cpu", **tracker) -> Pipeline:
    """A pipeline for `Pipeline.track` alone (no model): `cameras` copies
    of the default camera, `TRACKER` and `tracker` over the default
    tracker configuration."""
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, rig=dataclasses.replace(cfg.rig, cameras=(cfg.rig.cameras[0],) * cameras),
        tracker=dataclasses.replace(cfg.tracker, **{**TRACKER, **tracker}))
    return Pipeline(cfg=cfg, model=None, device=torch.device(device))


def tracker_tensors(states):
    return [getattr(ts, f.name) for ts in states for f in dataclasses.fields(ts)]


def bit_equal(a, b) -> bool:
    return len(a) == len(b) > 0 and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def graph_cameras(graph) -> int:
    """How many cameras' states a track graph takes: its arguments are the
    cameras' tracker states, then the detections."""
    trackers, _ = graph.args
    return len(trackers)


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
        for kept, new in zip(tree.leaves(self.outputs), tree.leaves(self.fn(*self.args))):
            kept.copy_(new)
        return self.outputs


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


# what `Pipeline.track` hands the rule: (tracker overrides, the pipeline's
# plain_kernels, the device, autograd on) -> whether the graph engages
RULE_CASES = {
    "bytetrack": ({}, False, "cuda", False, True),
    "botsort_plain": (dict(tracker_type="botsort"), False, "cuda", False, True),
    "cpu": ({}, False, "cpu", False, False),
    "autograd": ({}, False, "cuda", True, False),
    "plain_kernels": ({}, True, "cuda", False, False),
    "refined": (dict(assignment="refined"), False, "cuda", False, False),
    "exact": (dict(assignment="exact"), False, "cuda", False, False),
    "botsort_gmc": (dict(tracker_type="botsort", gmc=True), False, "cuda", False, False),
    "botsort_reid": (dict(tracker_type="botsort", with_reid=True), False, "cuda", False, False),
    "deepsort": (dict(tracker_type="deepsort", with_reid=True), False, "cuda", False, False),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_graph_rule(case):
    """The graph engages on the card with autograd off for greedy ByteTrack
    and BoT-SORT without ReID or GMC; the CPU, autograd, the plain kernels,
    `refined`, `exact`, GMC, ReID and DeepSORT stay eager. The embeddings
    and warps are what `track` passes for the configuration."""
    tracker, plain, device, grad, want = RULE_CASES[case]
    pipe = track_pipeline(**tracker)
    pipe.plain_kernels = plain
    c = pipe.cfg.rig.num_cameras
    emb = torch.zeros((c, D, 64)) if pipe._use_reid else None
    warps = [torch.zeros((2, 3))] * c if pipe._use_gmc else [None] * c
    with torch.set_grad_enabled(grad):
        assert pipe._track_replays(torch.device(device), emb, warps) is want


def test_cpu_track_is_eager_and_counts_no_replay():
    """On the CPU: no `track.graph` span, both counts 0 (and in `COUNTS`),
    no graph kept, the greedy solves on the plain loop."""
    from rt3d_torch import kernels

    pipe = track_pipeline()
    state, det = pipe.init_state(), scene(2, 1)[0]
    before = kernels.LAUNCHES["greedy_match"]
    with torch.no_grad(), trace.step(True):
        pipe.track(state, det)
    rec = trace.records()[-1]
    assert {"track_graph_replays", "track_graph_captures"} <= set(trace.COUNTS)
    assert rec["counts"]["track_graph_replays"] == rec["counts"]["track_graph_captures"] == 0
    names = [s.name for s in rec["spans"]]
    assert "track.graph" not in names and names.count("track.camera") == 2
    assert rec["host_syncs"]["assignment.greedy_round"] > 0
    assert pipe._track_graph is None
    assert kernels.LAUNCHES["greedy_match"] == before


def test_graph_path_is_bit_equal_and_hands_out_its_own_states(monkeypatch):
    """Twelve frames of two cameras through the graph path (the stand-in)
    against the eager path (autograd on): every state field and the ids
    bit for bit, one capture; what frame t handed out is unchanged after
    the later replays. A third camera captures again."""
    monkeypatch.setattr(graphs, "replayable", lambda device: not torch.is_grad_enabled())
    monkeypatch.setattr(graphs, "CapturedGraph", StandInGraph)
    pipe = track_pipeline()
    dets = scene(2, 12)
    eager, graph = pipe.init_state(), pipe.init_state()
    kept, handed = [], []
    for det in dets:
        with torch.enable_grad():
            eager, e_ids = pipe.track(eager, det)
        with torch.no_grad(), trace.step(True):
            graph, g_ids = pipe.track(graph, det)
        assert bit_equal(tracker_tensors(graph.trackers) + [g_ids],
                         tracker_tensors(eager.trackers) + [e_ids])
        handed.append(tracker_tensors(graph.trackers) + [g_ids])
        kept.append([t.clone() for t in handed[-1]])
        if len(handed) == 1:
            first = pipe._track_graph
    assert isinstance(first, StandInGraph) and pipe._track_graph is first
    for h, k in zip(handed, kept):
        assert bit_equal(h, k)
    recs = trace.records()
    assert [(r["counts"]["track_graph_replays"], r["counts"]["track_graph_captures"])
            for r in recs] == [(1, 1)] + [(1, 0)] * 11
    assert all([s.name for s in r["spans"]].count("track.graph") == 1 for r in recs)
    assert not bit_equal(handed[0], handed[-1])

    # one camera of the two, as a rank of the sharded step hands it
    one = dataclasses.replace(graph, trackers=graph.trackers[:1])
    det = Detections(*(getattr(dets[0], f.name)[:1] for f in dataclasses.fields(Detections)))
    with torch.no_grad():
        one, ids = pipe.track(one, det)
    assert pipe._track_graph is not first and graph_cameras(pipe._track_graph) == 1
    assert len(one.trackers) == 1 and ids.shape == (1, D)


@pytest.mark.parametrize("assignment", ["greedy", "refined"])
def test_build_refuses_slots_over_the_greedy_kernel(assignment):
    """On the card the greedy solves run only on the kernel, which holds a
    matrix of at most 32 768 entries: a configuration over it is refused
    when the pipeline is built, before anything touches the device."""
    from rt3d_torch.pipeline.step import build_pipeline
    from rt3d_torch.tracking.assignment import greedy_fits

    assert greedy_fits(64, 20) and greedy_fits(1024, 32) and greedy_fits(4096, 8)
    assert not greedy_fits(2048, 32) and not greedy_fits(8192, 1)
    cfg = track_pipeline(max_tracks=2048, assignment=assignment).cfg
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, max_detections=32))
    with pytest.raises(ValueError, match="greedy matching kernel"):
        build_pipeline(cfg, device="cuda")
