"""The greedy matching kernel and `Pipeline.track`'s CUDA graph, on the card.

Marked ``cuda``; each test skips without a CUDA device (this module imports
no JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_track_graph_cuda.py

The kernel (`rt3d_torch/csrc/greedy_match.cu`) against the plain loop, on
the card and on the CPU, pair for pair: seeded 64 x 20 matrices, matrices of
a few values (ties), nothing feasible, NaN entries, wide, tall, 1 x 1 and
empty shapes, entries at the threshold, and a matrix that needs more than
48 KiB of shared memory; the wrapper refuses what the kernel cannot take.
The track stage's graph against its eager path (autograd on), over 40
frames of `tests/test_torch_track_graph.py`'s scene for two and four
cameras: every state field and the ids bit for bit, what a frame handed
out unchanged by the later replays, one capture, no host sync and no
kernel call from Python in a replay, and a new capture when the cameras
change.
"""

import dataclasses

import pytest
import torch

from rt3d_torch import kernels
from rt3d_torch.models.postprocess import Detections
from rt3d_torch.runtime import trace
from rt3d_torch.tracking import assignment
from test_torch_track_graph import (
    EVENTS, bit_equal, events, graph_cameras, scene, track_pipeline, tracker_tensors,
)

pytestmark = pytest.mark.cuda

FRAMES = 40


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _rand(seed, shape):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _masked_iou_cost(seed):
    """A tracker's round: 1 - IoU of 64 slots and 20 detections, rows and
    columns outside the round at 1e6."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((84, 2), generator=g) * 400
    boxes = torch.cat([xy, xy + 40 + torch.rand((84, 2), generator=g) * 80], 1)
    from rt3d_torch.models.postprocess import box_iou_matrix

    cost = 1.0 - box_iou_matrix(boxes[:64], boxes[64:])
    rows = torch.rand(64, generator=g) < 0.5
    cols = torch.rand(20, generator=g) < 0.8
    return torch.where(rows[:, None] & cols[None, :], cost, 1e6)


def _nan(seed):
    c = _rand(seed, (64, 20))
    return torch.where(_rand(seed + 1, (64, 20)) < 0.2, float("nan"), c)


def _at_thresh(seed):
    """Entries at f32(0.7), just under it and just over it."""
    t = torch.tensor(0.7, dtype=torch.float32)
    vals = torch.stack([t, torch.nextafter(t, torch.tensor(0.0)),
                        torch.nextafter(t, torch.tensor(1.0)), t * 0.5])
    idx = torch.randint(0, 4, (64, 20), generator=torch.Generator().manual_seed(seed))
    return vals[idx]


# name -> (cost (CPU), threshold)
CASES = {
    **{f"random_{s}": (lambda s=s: (_rand(s, (64, 20)) * 1.2, 0.8)) for s in range(8)},
    **{f"ties_{s}": (lambda s=s: (torch.randint(
        0, 4, (64, 20), generator=torch.Generator().manual_seed(s)) / 4.0, 0.7))
       for s in range(4)},
    "ties_binary": (lambda: (torch.randint(
        0, 2, (64, 20), generator=torch.Generator().manual_seed(9)).float(), 0.5)),
    "all_equal": (lambda: (torch.full((64, 20), 0.25), 0.7)),
    "infeasible": (lambda: (torch.full((64, 20), 2.0), 0.8)),
    "nan": (lambda: (_nan(3), 0.8)),
    "all_nan": (lambda: (torch.full((64, 20), float("nan")), 0.8)),
    "tracker_round": (lambda: (_masked_iou_cost(5), 0.7)),
    "at_thresh": (lambda: (_at_thresh(6), 0.7)),
    "wide": (lambda: (_rand(11, (5, 40)), 0.9)),
    "tall": (lambda: (_rand(12, (200, 7)), 0.9)),
    "one": (lambda: (torch.tensor([[0.3]]), 0.5)),
    "one_infeasible": (lambda: (torch.tensor([[0.6]]), 0.5)),
    "no_rows": (lambda: (torch.zeros((0, 20)), 0.5)),
    "no_cols": (lambda: (torch.zeros((64, 0)), 0.5)),
    "large_smem": (lambda: (_rand(13, (1024, 32)), 0.95)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_kernel_equals_plain(card, case):
    cost, thresh = CASES[case]()
    r, c = cost.shape
    on_kernel = r * c > 0
    before = kernels.LAUNCHES["greedy_match"]
    got = assignment.solve_matching_greedy(cost.cuda(), thresh)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["greedy_match"] == before + on_kernel
    want_card = assignment.solve_matching_greedy_plain(cost.cuda(), thresh)
    want_cpu = assignment.solve_matching_greedy_plain(cost, thresh)
    for g, w, w_cpu in zip(got, want_card, want_cpu):
        assert g.dtype == torch.int32 and g.is_cuda
        assert torch.equal(g, w) and torch.equal(g.cpu(), w_cpu), case
    matched = int((got[0] >= 0).sum())
    print(f"{case}: {r} x {c}, {matched} pairs")


# name -> a cost matrix on the card the kernel cannot take, and the error
REFUSED = {
    "over_limit": (lambda: _rand(14, (2048, 32)).cuda(), ValueError),
    "long_side": (lambda: _rand(15, (8192, 1)).cuda(), ValueError),
    "float64": (lambda: _rand(16, (64, 20)).double().cuda(), TypeError),
    "strided": (lambda: _rand(17, (20, 64)).cuda().t(), ValueError),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_greedy_kernel_refuses_what_it_cannot_hold(card, case):
    """On the card every greedy solve runs on the kernel: a matrix over its
    limit, of another dtype or not contiguous is an error, not a silent
    plain loop; ``plain=True`` still solves it."""
    make, error = REFUSED[case]
    cost = make()
    before = kernels.LAUNCHES["greedy_match"]
    with pytest.raises(error, match="greedy_match"):
        assignment.solve_matching_greedy(cost, 0.9)
    assert kernels.LAUNCHES["greedy_match"] == before
    got = assignment.solve_matching_greedy(cost, 0.9, plain=True)
    want = assignment.solve_matching_greedy_plain(cost.cpu(), 0.9)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_greedy_kernel_many_seeds(card):
    """200 seeded 64 x 20 matrices, half of them of four values."""
    for s in range(200):
        cost = _rand(1000 + s, (64, 20))
        if s % 2:
            cost = (cost * 4).floor() / 4
        got = assignment.solve_matching_greedy(cost.cuda(), 0.7)
        want = assignment.solve_matching_greedy_plain(cost, 0.7)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), s


def _run(pipe, dets, graph_path: bool):
    """`pipe.track` over `dets` from the initial state: per frame, what it
    handed out (the state and the ids), its launches of the kernel, and
    copies of what it handed out, taken before the next frame."""
    state, out = pipe.init_state(), []
    for t, det in enumerate(dets):
        before = kernels.LAUNCHES["greedy_match"]
        if graph_path:
            with torch.no_grad(), trace.step(True):
                if t >= 2:  # a steady replay waits on nothing
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    state, ids = pipe.track(state, det)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        else:
            with torch.enable_grad():
                state, ids = pipe.track(state, det)
        out.append((state, ids, kernels.LAUNCHES["greedy_match"] - before,
                    [t.clone() for t in tracker_tensors(state.trackers) + [ids]]))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("cameras", [2, 4])
def test_graph_track_equals_eager(card, cameras):
    pipe = track_pipeline(cameras, "cuda")
    dets = scene(cameras, FRAMES, seed=cameras, device="cuda")
    eager = _run(pipe, dets, graph_path=False)
    assert pipe._track_graph is None
    trace.clear()
    graph = _run(pipe, dets, graph_path=True)
    recs = trace.records()
    for t, ((gs, gi, gl, kept), (es, ei, el, _)) in enumerate(zip(graph, eager)):
        assert bit_equal(tracker_tensors(gs.trackers) + [gi],
                         tracker_tensors(es.trackers) + [ei]), f"frame {t}"
        # unchanged by the later replays
        assert bit_equal(tracker_tensors(gs.trackers) + [gi], kept), f"frame {t} kept"
        # the eager path calls the kernel 3 times a camera; the graph's
        # warm-up and capture 3 times a camera each, a replay never
        assert el == 3 * cameras and gl == (6 * cameras if t == 0 else 0), t
    assert [(r["counts"]["track_graph_replays"], r["counts"]["track_graph_captures"])
            for r in recs] == [(1, 1)] + [(1, 0)] * (FRAMES - 1)
    assert recs[0]["host_syncs"] == {"step.track_capture": 1}
    assert all(r["host_syncs"] == {} for r in recs[1:])
    seen = set()
    for c in range(cameras):
        seen |= events([g[0].trackers[c] for g in graph], pipe.cfg.tracker.track_high_thresh)
    assert seen == set(EVENTS), seen
    print(f"{cameras} cameras: {FRAMES} frames, ids handed out "
          f"{int((graph[-1][1] >= 0).sum())} on the last, events {sorted(seen)}")


def test_recapture_when_the_cameras_change(card):
    """Four cameras, then the first two (a rank's block in the sharded
    step), then four again: each change captures anew, and the two-camera
    replay equals the eager step of those cameras."""
    pipe = track_pipeline(4, "cuda")
    dets = scene(4, 3, seed=1, device="cuda")
    state = pipe.init_state()
    caps = []
    with torch.no_grad():
        for det in dets[:2]:
            with trace.step(True):
                state, _ = pipe.track(state, det)
            caps.append(trace.records()[-1]["counts"]["track_graph_captures"])
        four = pipe._track_graph
        half = dataclasses.replace(state, trackers=state.trackers[:2])
        det2 = Detections(*(getattr(dets[2], f.name)[:2] for f in dataclasses.fields(Detections)))
        with trace.step(True):
            got, got_ids = pipe.track(half, det2)
        caps.append(trace.records()[-1]["counts"]["track_graph_captures"])
        assert pipe._track_graph is not four and graph_cameras(pipe._track_graph) == 2
        with trace.step(True):
            pipe.track(state, dets[2])
        caps.append(trace.records()[-1]["counts"]["track_graph_captures"])
    assert caps == [1, 0, 1, 1]
    with torch.enable_grad():
        want, want_ids = pipe.track(half, det2)
    assert bit_equal(tracker_tensors(got.trackers) + [got_ids],
                     tracker_tensors(want.trackers) + [want_ids])
