"""Parity of the port's ByteTrack (`rt3d_torch.tracking`) with the JAX
package: identical ID histories over multi-frame detection sequences."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt3d.config import TrackerConfig as JTrackerConfig
from rt3d.models.yolo.postprocess import Detections as JDetections
from rt3d.tracking import assignment as jassign
from rt3d.tracking import bytetrack as jbt
from rt3d.tracking import kalman as jkalman
from rt3d_torch.config import TrackerConfig
from rt3d_torch.models.postprocess import Detections
from rt3d_torch.tracking import assignment, bytetrack, kalman


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_matching_matches_jax(seed):
    """Tie-heavy integer costs: greedy pairs identical, lowest index on ties."""
    rng = np.random.default_rng(seed)
    for r, c in ((16, 6), (6, 16), (9, 9)):
        cost = (rng.integers(0, 6, (r, c)) / 8.0).astype(np.float32)
        got = assignment.solve_matching_greedy(torch.from_numpy(cost), 0.7)
        exp = jassign.solve_matching_greedy(jnp.asarray(cost), 0.7)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(N(g), N(e))


def test_kalman_matches_jax(rng):
    """Predict/update chains agree to f32 rounding (8x8 products summed in
    another order)."""
    meas = np.abs(rng.normal([300, 200, 0.6, 80], [50, 50, 0.1, 10], (5, 4))).astype(np.float32)
    m, c = kalman.kalman_initiate(torch.from_numpy(meas))
    jm, jc = jkalman.kalman_initiate(jnp.asarray(meas))
    for _ in range(3):
        m, c = kalman.kalman_predict(m, c)
        jm, jc = jkalman.kalman_predict(jm, jc)
        z = meas + rng.normal(0, 2, meas.shape).astype(np.float32)
        m, c = kalman.kalman_update(m, c, torch.from_numpy(z))
        jm, jc = jkalman.kalman_update(jm, jc, jnp.asarray(z))
    np.testing.assert_allclose(N(m), N(jm), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(N(c), N(jc), rtol=1e-4, atol=1e-4)


def _sequence(rng, frames=24, d=8, n_obj=6):
    """Objects moving with noise; each drops out for a few frames, scores
    spread over the high, low and rejected bands; one object is born late."""
    pos = rng.uniform([50, 50], [500, 300], (n_obj, 2))
    vel = rng.normal(0, 4, (n_obj, 2))
    size = rng.uniform([30, 50], [80, 120], (n_obj, 2))
    gone = {k: set(range(s, s + rng.integers(2, 6))) for k, s in
            enumerate(rng.integers(3, frames, n_obj))}
    seq = []
    for t in range(frames):
        boxes = np.zeros((d, 4), np.float32)
        scores = np.zeros(d, np.float32)
        valid = np.zeros(d, bool)
        slot = 0
        for k in rng.permutation(n_obj):
            if t in gone[k] or (k == n_obj - 1 and t < 8):
                continue
            c = pos[k] + vel[k] * t + rng.normal(0, 1.5, 2)
            wh = size[k] * rng.uniform(0.95, 1.05, 2)
            boxes[slot] = [*(c - wh / 2), *(c + wh / 2)]
            scores[slot] = rng.choice([rng.uniform(0.6, 0.95), rng.uniform(0.1, 0.6),
                                       rng.uniform(0.0, 0.05)], p=[0.7, 0.25, 0.05])
            valid[slot] = True
            slot += 1
        order = np.argsort(-scores, kind="stable")
        classes = np.full(d, 39, np.int32)
        coeffs = np.zeros((d, 32), np.float32)
        seq.append((boxes[order], scores[order] * valid[order], classes, coeffs, valid[order]))
    return seq


@pytest.mark.parametrize("seed", range(3))
def test_bytetrack_id_histories_match_jax(seed):
    rng = np.random.default_rng(seed)
    cfg_kw = dict(max_tracks=16, track_buffer=4)
    cfg, jcfg = TrackerConfig(**cfg_kw), JTrackerConfig(**cfg_kw)
    ts = bytetrack.bytetrack_init(cfg.max_tracks, device="cpu")
    jts = jbt.bytetrack_init(jcfg.max_tracks)
    jstep = jax.jit(lambda s, d: jbt.bytetrack_step(s, d, jcfg))
    ids, jids = [], []
    for boxes, scores, classes, coeffs, valid in _sequence(rng):
        det = Detections(*(torch.from_numpy(x) for x in (boxes, scores, classes, coeffs, valid)))
        jdet = JDetections(*(jnp.asarray(x) for x in (boxes, scores, classes, coeffs, valid)))
        ts, i = bytetrack.bytetrack_step(ts, det, cfg)
        jts, ji = jstep(jts, jdet)
        ids.append(N(i))
        jids.append(N(ji))
        for f in ("track_id", "state", "activated", "last_update"):
            np.testing.assert_array_equal(N(getattr(ts, f)), N(getattr(jts, f)), err_msg=f)
        np.testing.assert_allclose(N(ts.mean), N(jts.mean), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.stack(ids), np.stack(jids))
    assert int(N(ts.next_id)) == int(N(jts.next_id)) > 3
