"""The port's other trackers against the JAX package, on the CPU: the exact
(Hungarian) and refined solvers, DeepSORT's gating distance and cost,
BoT-SORT's appearance fusion, feature smoothing and camera-motion
compensation (GMC), `bytetrack_step` with embeddings and warps,
`deepsort_step`, and small-size BoT-SORT and DeepSORT pipeline steps.

Tolerances, each stated where it is held: matchings exact (ties included);
Mahalanobis distances and costs within 1e-5 relative; GMC phase-correlation
shifts exact, peaks within 1e-4 relative and fitted warps within 1e-3 on
textured images (the FFTs and the window's cosine round differently, and
whitening amplifies that in weak frequency bins); track IDs exact over
every sequence; track states within the stated bands.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra.numpy import arrays
from scipy import ndimage

from rt3d.config import TrackerConfig as JTrackerConfig
from rt3d.models.yolo.postprocess import Detections as JDetections
from rt3d.tracking import assignment as jassign
from rt3d.tracking import botsort as jbot
from rt3d.tracking import bytetrack as jbt
from rt3d.tracking import deepsort as jds
from rt3d.tracking import kalman as jkalman
from rt3d_torch.config import TrackerConfig
from rt3d_torch.io import SyntheticSource
from rt3d_torch.models.postprocess import Detections
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.tracking import assignment, botsort, bytetrack, deepsort, kalman
from tests.test_torch_step import H, N, W, WEIGHTS, run_both, small_config, threshold_ties
from tests.test_torch_tracking import _sequence

_JAX_SOLVERS = {m: jax.jit(lambda c, t, m=m: jassign.solve_matching(c, t, method=m),
                           static_argnums=1)
                for m in ("greedy", "refined", "exact")}


def _assert_matching(cost, thresh, method):
    got = assignment.solve_matching(torch.from_numpy(cost), thresh, method=method)
    exp = _JAX_SOLVERS[method](jnp.asarray(cost), thresh)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(N(g), N(e))
    return got


@pytest.mark.parametrize("method", ["exact", "refined"])
@pytest.mark.parametrize("seed", range(3))
def test_solvers_match_jax_on_seeded_costs(method, seed):
    """Tracking-shaped costs (1 - IoU-like in [0, 1.2], a third infeasible),
    tall, wide and square: the same pairs."""
    rng = np.random.default_rng(seed)
    for r, c in ((12, 5), (5, 12), (8, 8)):
        cost = rng.uniform(0, 1.2, (r, c)).astype(np.float32)
        col, _ = _assert_matching(cost, 0.8, method)
        assert (N(col) >= 0).any()


def test_hungarian_is_optimal():
    """On a square feasible matrix the exact solver's cost is scipy's."""
    from scipy.optimize import linear_sum_assignment

    cost = np.random.default_rng(7).uniform(0, 1, (9, 9)).astype(np.float32)
    col = N(assignment.hungarian(torch.from_numpy(cost)))
    r, c = linear_sum_assignment(cost)
    assert abs(cost[np.arange(9), col].sum() - cost[r, c].sum()) < 1e-5


@settings(max_examples=30, deadline=None)
@given(cost=arrays(np.float32, (6, 4), elements=st.integers(0, 5).map(lambda v: v / 8.0)),
       method=st.sampled_from(["greedy", "refined", "exact"]))
def test_solvers_match_jax_on_ties(cost, method):
    """Tie-heavy integer costs (eighths, 0.625 and above infeasible): every
    solver gives the JAX package's pairs, lowest index on ties."""
    _assert_matching(cost, 0.6, method)
    _assert_matching(np.ascontiguousarray(cost.T), 0.6, method)


def _tracks(rng, s=10):
    meas = np.abs(rng.normal([300, 200, 0.6, 80], [80, 60, 0.1, 10], (s, 4))).astype(np.float32)
    m, c = jkalman.kalman_initiate(jnp.asarray(meas))
    m, c = jkalman.kalman_predict(m, c)
    return np.array(m), np.array(c)


@pytest.mark.parametrize("only_position", [False, True])
def test_gating_distance_matches_jax(only_position):
    """Squared Mahalanobis distances within 1e-5 relative."""
    rng = np.random.default_rng(1)
    m, c = _tracks(rng)
    z = (m[:7, :4] + rng.normal(0, [3, 3, 0.02, 2], (7, 4))).astype(np.float32)
    got = kalman.gating_distance(torch.from_numpy(m), torch.from_numpy(c), torch.from_numpy(z),
                                 only_position)
    exp = jkalman.gating_distance(jnp.asarray(m), jnp.asarray(c), jnp.asarray(z), only_position)
    np.testing.assert_allclose(N(got), N(exp), rtol=1e-5, atol=0)


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _state_pair(rng, s=10, e=16):
    """A port and a JAX tracker state with the same means, covariances,
    embeddings and ages."""
    m, c = _tracks(rng, s)
    emb = _unit(rng, (s, e))
    last = rng.integers(0, 4, s).astype(np.int32)
    ts = bytetrack.bytetrack_init(s, e, device="cpu").replace(
        mean=torch.from_numpy(m), cov=torch.from_numpy(c), emb=torch.from_numpy(emb),
        last_update=torch.from_numpy(last), frame_id=torch.tensor(5, dtype=torch.int32))
    jts = jbt.bytetrack_init(s, e).replace(mean=jnp.asarray(m), cov=jnp.asarray(c),
                                           emb=jnp.asarray(emb), last_update=jnp.asarray(last),
                                           frame_id=jnp.int32(5))
    return ts, jts


@pytest.mark.parametrize("lam,only_position", [(0.0, False), (0.3, True)])
def test_deepsort_cost_matches_jax(lam, only_position):
    """The appearance cost under the chi-square gate, with and without the
    motion blend: the same entries gated, the rest within 1e-5 relative."""
    rng = np.random.default_rng(2)
    ts, jts = _state_pair(rng)
    z = (N(ts.mean)[:6, :4] + rng.normal(0, [4, 4, 0.02, 3], (6, 4))).astype(np.float32)
    emb = np.concatenate([N(ts.emb)[:4] + rng.normal(0, 0.1, (4, 16)), _unit(rng, (2, 16))])
    emb = (emb / np.linalg.norm(emb, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(motion_lambda=lam, gate_only_position=only_position, max_cosine_distance=0.3)
    got = deepsort.deepsort_cost(ts, torch.from_numpy(z), torch.from_numpy(emb),
                                 TrackerConfig(**kw))
    exp = jds.deepsort_cost(jts, jnp.asarray(z), jnp.asarray(emb), JTrackerConfig(**kw))
    got, exp = N(got), N(exp)
    np.testing.assert_array_equal(got >= 1e6, exp >= 1e6)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=0)
    assert (got < 1e6).sum() >= 3


def test_appearance_fusion_and_smoothing_match_jax():
    """Embedding distance, BoT-SORT's cost fusion and the EMA feature update
    within 1e-6."""
    rng = np.random.default_rng(3)
    te, de = _unit(rng, (8, 16)), _unit(rng, (5, 16))
    iou = rng.uniform(0, 1, (8, 5)).astype(np.float32)
    got = botsort.botsort_fuse_costs(torch.from_numpy(iou), botsort.embedding_distance(
        torch.from_numpy(te), torch.from_numpy(de)), 0.5, 0.25)
    exp = jbot.botsort_fuse_costs(jnp.asarray(iou), jbot.embedding_distance(
        jnp.asarray(te), jnp.asarray(de)), 0.5, 0.25)
    np.testing.assert_allclose(N(got), N(exp), atol=1e-6, rtol=0)
    slot_det = np.array([2, -1, 0, 4, -1, 1, -1, 3], np.int32)
    fresh = np.array([0, 0, 1, 0, 0, 0, 0, 1], bool)
    got = botsort.update_smooth_features(torch.from_numpy(te), torch.from_numpy(de),
                                         torch.from_numpy(slot_det), torch.from_numpy(fresh))
    exp = jbot.update_smooth_features(jnp.asarray(te), jnp.asarray(de), jnp.asarray(slot_det),
                                      jnp.asarray(fresh))
    np.testing.assert_allclose(N(got), N(exp), atol=1e-6, rtol=0)


def _textured(rng, h=96, w=160, pad=20):
    return ndimage.gaussian_filter(rng.random((h + 2 * pad, w + 2 * pad)), 1.0) * 255


def test_translation_gmc_matches_jax():
    """A shift of (5, -3) px recovered exactly by both."""
    img = _textured(np.random.default_rng(4))
    prev = img[20:116, 20:180].astype(np.float32)
    cur = np.roll(img, (-3, 5), (0, 1))[20:116, 20:180].astype(np.float32)
    got = botsort.estimate_translation_gmc(torch.from_numpy(prev), torch.from_numpy(cur))
    exp = jbot.estimate_translation_gmc(jnp.asarray(prev), jnp.asarray(cur))
    np.testing.assert_array_equal(N(got), N(exp))
    np.testing.assert_array_equal(N(got), [5.0, -3.0])


@pytest.mark.parametrize("angle,scale", [(0.02, 1.01), (-0.03, 0.98)])
def test_affine_gmc_matches_jax(angle, scale):
    """An affinely warped textured image: the patch shifts exact, the peaks
    within 1e-4 relative, the fitted warp within 1e-3 of the JAX
    package's, and near the true one (rotation within 0.02, translation
    within 1.5 px: the patch shifts are whole pixels)."""
    img = _textured(np.random.default_rng(5))[20:116, 20:180]
    a = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]) * scale
    off = np.array([80, 48]) - a @ np.array([80, 48]) + np.array([2.0, -1.5])
    ai = np.linalg.inv(a)
    cur = ndimage.affine_transform(img, ai[::-1, ::-1], offset=(-(ai @ off))[::-1], order=1,
                                   mode="nearest").astype(np.float32)
    prev = img.astype(np.float32)
    patches = prev[:96, :160].reshape(3, 32, 4, 40).transpose(0, 2, 1, 3).reshape(12, 32, 40)
    cpatch = cur[:96, :160].reshape(3, 32, 4, 40).transpose(0, 2, 1, 3).reshape(12, 32, 40)
    p0 = patches - patches.mean((1, 2), keepdims=True)
    c0 = cpatch - cpatch.mean((1, 2), keepdims=True)
    s, pk = botsort._phase_corr_shift(torch.from_numpy(p0), torch.from_numpy(c0), 24)
    js, jpk = jax.vmap(lambda x, y: jbot._phase_corr_shift(x, y, 24))(jnp.asarray(p0),
                                                                        jnp.asarray(c0))
    np.testing.assert_array_equal(N(s), N(js))
    np.testing.assert_allclose(N(pk), N(jpk), rtol=1e-4)
    got = N(botsort.estimate_affine_gmc(torch.from_numpy(prev), torch.from_numpy(cur)))
    exp = N(jbot.estimate_affine_gmc(jnp.asarray(prev), jnp.asarray(cur)))
    np.testing.assert_allclose(got, exp, atol=1e-3, rtol=0)
    assert np.abs(got[:, :2] - a).max() < 0.02
    assert np.abs(got[:, 2] - off).max() < 1.5


def test_warp_rescale_and_track_warp_match_jax():
    """`rescale_warp` and `apply_gmc_to_tracks` (means and covariances)
    within 1e-5 relative."""
    rng = np.random.default_rng(6)
    warp = np.array([[1.01, -0.02, 3.0], [0.015, 0.99, -2.0]], np.float32)
    got = botsort.rescale_warp(torch.from_numpy(warp), 0.125, (0.0, 12.0))
    exp = jbot.rescale_warp(jnp.asarray(warp), 0.125, (0.0, 12.0))
    np.testing.assert_allclose(N(got), N(exp), rtol=1e-6, atol=1e-6)
    m, c = _tracks(rng)
    gm, gc = botsort.apply_gmc_to_tracks(torch.from_numpy(m), got, torch.from_numpy(c))
    em, ec = jbot.apply_gmc_to_tracks(jnp.asarray(m), exp, jnp.asarray(c))
    np.testing.assert_allclose(N(gm), N(em), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(gc), N(ec), rtol=1e-5, atol=1e-5)


def _embeddings(rng, seq, d=8, e=16):
    """Per detection slot, its object's fixed embedding plus noise; the
    objects are told apart by the boxes' order in `_sequence`, so each box
    keeps its own object's embedding through a nearest-centre match."""
    out, centres, protos = [], None, None
    for boxes, _, _, _, valid in seq:
        c = (boxes[:, :2] + boxes[:, 2:]) / 2
        if protos is None:
            protos = _unit(rng, (d, e))
            centres = c
        near = np.argmin(((c[:, None] - centres[None]) ** 2).sum(-1), 1)
        centres = np.where(valid[:, None], c, centres)
        v = protos[near] + rng.normal(0, 0.05, (d, e))
        out.append((v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32))
    return out


@pytest.mark.parametrize("tracker", ["botsort", "deepsort"])
@pytest.mark.parametrize("seed", range(2))
def test_tracker_id_histories_match_jax(tracker, seed):
    """24 frames of moving boxes with embeddings and a small camera motion
    each frame (a translation and a slight rotation), through BoT-SORT's
    `bytetrack_step` (ReID and GMC) or `deepsort_step`: track IDs, states
    and activation exact each frame; means within 1e-3 px relative 1e-4;
    features within 1e-5."""
    rng = np.random.default_rng(seed)
    seq = _sequence(rng)
    embs = _embeddings(rng, seq)
    kw = dict(max_tracks=16, track_buffer=4, emb_dim=16, tracker_type=tracker, with_reid=True,
              gmc=True, max_cosine_distance=0.4)
    cfg, jcfg = TrackerConfig(**kw), JTrackerConfig(**kw)
    step = {"botsort": bytetrack.bytetrack_step, "deepsort": deepsort.deepsort_step}[tracker]
    jfn = {"botsort": jbt.bytetrack_step, "deepsort": jds.deepsort_step}[tracker]
    jstep = jax.jit(lambda s, d, e, w: jfn(s, d, jcfg, det_emb=e, gmc_warp=w))
    ts = bytetrack.bytetrack_init(16, 16, device="cpu")
    jts = jbt.bytetrack_init(16, 16)
    ids, jids = [], []
    for t, ((boxes, scores, classes, coeffs, valid), emb) in enumerate(zip(seq, embs)):
        a = 0.002 * np.sin(t)
        warp = np.array([[np.cos(a), -np.sin(a), 1.5], [np.sin(a), np.cos(a), -0.5]], np.float32)
        det = Detections(*(torch.from_numpy(x) for x in (boxes, scores, classes, coeffs, valid)))
        jdet = JDetections(*(jnp.asarray(x) for x in (boxes, scores, classes, coeffs, valid)))
        ts, i = step(ts, det, cfg, det_emb=torch.from_numpy(emb),
                     gmc_warp=torch.from_numpy(warp))
        jts, ji = jstep(jts, jdet, jnp.asarray(emb), jnp.asarray(warp))
        ids.append(N(i))
        jids.append(N(ji))
        for f in ("track_id", "state", "activated", "last_update"):
            np.testing.assert_array_equal(N(getattr(ts, f)), N(getattr(jts, f)), err_msg=f)
        np.testing.assert_allclose(N(ts.mean), N(jts.mean), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(N(ts.emb), N(jts.emb), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.stack(ids), np.stack(jids))
    assert int(N(ts.next_id)) == int(N(jts.next_id)) > 3
    assert (np.stack(ids) > 0).sum() > 40


@pytest.fixture(scope="module", params=["botsort", "deepsort"])
def tracker_runs(request):
    """`tests/test_torch_step`'s small config (2 synthetic cameras at
    240x320, the n weights, float32) with the `2cam_botsort` or
    `2cam_deepsort` preset's tracker: two frames through the port and the
    JAX step, op by op."""
    src = SyntheticSource(num_cameras=2, num_frames=2, hw=(H, W), num_objects=2)
    cfg = small_config(src.cameras())
    over = {"botsort": dict(tracker_type="botsort", with_reid=True, gmc=True),
            "deepsort": dict(tracker_type="deepsort", with_reid=True)}[request.param]
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, **over))
    _, _, got, exp, states = run_both(cfg, WEIGHTS, src, 2, states=True)
    return cfg, got, exp, states


def test_tracker_steps_match_jax(tracker_runs):
    """Detections as `tests/test_torch_step` holds them, track IDs, slots
    and object voxels exact; the workspace keep mask exact but at threshold
    ties; each camera's tracker: IDs, states and activation exact, means
    within 1e-2 px (GMC's warp), features within 1e-4; GMC's grey image
    within 1e-4 of the JAX package's resize."""
    cfg, got, exp, states = tracker_runs
    thr = cfg.pipeline.subtraction_threshold
    for o, e, (st, jst) in zip(got, exp, states):
        np.testing.assert_array_equal(N(o.detections.valid), N(e.detections.valid))
        np.testing.assert_array_equal(N(o.detections.classes), N(e.detections.classes))
        np.testing.assert_allclose(N(o.detections.boxes), N(e.detections.boxes), atol=1e-3, rtol=0)
        np.testing.assert_array_equal(N(o.track_ids), N(e.track_ids))
        for f in ("points", "valid", "class_id", "present", "track_id"):
            np.testing.assert_array_equal(N(getattr(o.objects, f)), N(getattr(e.objects, f)))
        tie = threshold_ties(o, thr)
        np.testing.assert_array_equal(N(o.workspace.valid)[~tie], N(e.workspace.valid)[~tie])
        for c, ts in enumerate(st.trackers):
            for f in ("track_id", "state", "activated", "last_update"):
                np.testing.assert_array_equal(N(getattr(ts, f)), N(getattr(jst.tracker, f))[c])
            np.testing.assert_allclose(N(ts.mean), N(jst.tracker.mean)[c], rtol=0, atol=1e-2)
            np.testing.assert_allclose(N(ts.emb), N(jst.tracker.emb)[c], rtol=0, atol=1e-4)
        np.testing.assert_allclose(N(st.prev_gray), N(jst.prev_gray), rtol=0, atol=1e-4)
    assert (N(got[-1].track_ids) > 0).any()
    assert (N(states[-1][0].trackers[0].emb) != 0).any()


def test_unknown_tracker_type_is_refused():
    """`build_pipeline` refuses a tracker it does not know, as the JAX
    package's does."""
    cfg = small_config(SyntheticSource(num_cameras=2, hw=(H, W)).cameras())
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, tracker_type="sort"))
    with pytest.raises(ValueError, match="unknown tracker_type"):
        build_pipeline(cfg, device="cpu")
