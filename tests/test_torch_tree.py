"""`rt3d_torch.tree` over the step's own trees, and the checkpoint format
that its leaf paths are (`rt3d_torch.runtime.checkpoint`).

The round trips run over every tree the step hands around: flattening and
rebuilding gives the same tree, and stacking then indexing gives each tree
back. The checkpoint's `.npz` keys of a small pipeline state and a small
train state are pinned as literal lists, so files written before stay
loadable.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rt3d_torch import tree
from rt3d_torch.geometry.fusion import ObjectSet
from rt3d_torch.geometry.ops import PointBuffer
from rt3d_torch.geometry.voxel_sets import VoxelAccumulator
from rt3d_torch.models.postprocess import Detections
from rt3d_torch.pipeline.step import CameraCalib, FrameOutputs, PipelineState
from rt3d_torch.runtime.checkpoint import load_pytree, save_pytree
from rt3d_torch.tracking.bytetrack import bytetrack_init
from rt3d_torch.train.step import TrainState


def randomised(t, seed: int):
    """A tree like `t` with every leaf drawn anew from `seed`, each dtype
    kept."""
    gen = torch.Generator().manual_seed(seed)

    def draw(x):
        if x.dtype == torch.bool:
            return torch.rand(x.shape, generator=gen) > 0.5
        if x.dtype.is_floating_point:
            return torch.randn(x.shape, generator=gen).to(x.dtype)
        return torch.randint(-5, 100, x.shape, generator=gen, dtype=x.dtype)

    return tree.map(draw, t)


def detections(c=2, d=4):
    return Detections(boxes=torch.zeros((c, d, 4)), scores=torch.zeros((c, d)),
                      classes=torch.zeros((c, d), dtype=torch.int32),
                      coeffs=torch.zeros((c, d, 3)), valid=torch.zeros((c, d), dtype=torch.bool))


def objects(s=3, k=5):
    return ObjectSet(points=torch.zeros((s, k, 3)), valid=torch.zeros((s, k), dtype=torch.bool),
                     class_id=torch.zeros((s,), dtype=torch.int32),
                     present=torch.zeros((s,), dtype=torch.bool),
                     track_id=torch.zeros((s,), dtype=torch.int32))


def frame_outputs(logits: bool):
    buf = PointBuffer(points=torch.zeros((7, 3)), valid=torch.zeros((7,), dtype=torch.bool))
    return FrameOutputs(
        detections=detections(), track_ids=torch.zeros((2, 4), dtype=torch.int32),
        objects=objects(), objects_flat=buf, workspace=buf,
        per_camera_objects=tree.stack([objects(), objects()]),
        overflow=torch.zeros((), dtype=torch.int32),
        low_res_logits=torch.zeros((2, 4, 8, 8), dtype=torch.bfloat16) if logits else None)


TREES = {
    "frame_outputs": lambda: frame_outputs(True),
    "frame_outputs_no_logits": lambda: frame_outputs(False),
    "tracker_state": lambda: bytetrack_init(6, emb_dim=4, device="cpu"),
    "object_set": objects,
    "detections": detections,
    "camera_calib": lambda: CameraCalib(
        fx=torch.zeros(2), fy=torch.zeros(2), cx=torch.zeros(2), cy=torch.zeros(2),
        rotation=torch.zeros((2, 3, 3)), translation=torch.zeros((2, 3))),
}


def same(a, b) -> bool:
    """Equal trees: the same types and structure, every leaf bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if a is None:
        return b is None
    return type(a) is type(b) and all(
        same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))


def resolve(t, path: str):
    """The node at `path`: field names, tuple indices and dict keys."""
    for part in path.split("/"):
        t = t[int(part)] if isinstance(t, (tuple, list)) else (
            t[part] if isinstance(t, dict) else getattr(t, part))
    return t


@pytest.mark.parametrize("name", sorted(TREES))
def test_round_trips(name):
    """Leaves and back, `map`, and `stack` then `index` give each tree back;
    each leaf's path leads to it; a None field stays None and has no leaf."""
    a, b = randomised(TREES[name](), 1), randomised(TREES[name](), 2)
    assert same(tree.unflatten(a, tree.leaves(a)), a)
    assert same(tree.map(lambda x, y: y, a, b), b)
    both = tree.stack([a, b])
    assert all(x.shape[0] == 2 for x in tree.leaves(both))
    assert same(tree.index(both, 0), a) and same(tree.index(both, 1), b)
    assert same(tree.index(both, slice(1, 2)), tree.stack([b]))
    paths = list(tree.leaves_with_paths(a))
    assert len({p for p, _ in paths}) == len(paths) == len(tree.leaves(a))
    assert all(resolve(a, p) is t for p, t in paths)
    if name.startswith("frame_outputs"):
        assert ("low_res_logits" in dict(paths)) == (name == "frame_outputs")


def test_unflatten_refuses_a_leaf_too_many():
    a = detections()
    with pytest.raises(ValueError):
        tree.unflatten(a, tree.leaves(a) + [torch.zeros(1)])


def small_pipeline_state():
    return PipelineState(trackers=tuple(bytetrack_init(3, emb_dim=2, device="cpu")
                                        for _ in range(2)),
                         prev_gray=torch.zeros((2, 1, 1)),
                         accum=VoxelAccumulator.empty(4, "cpu"))


def small_train_state():
    def p(*shape):
        return torch.zeros(shape)

    return TrainState(params={"b0/conv/kernel": p(3, 3), "head/bias": p(3)},
                      opt_state={"count": torch.zeros((), dtype=torch.int32),
                                 "mu": {"b0/conv/kernel": p(3, 3), "head/bias": p(3)},
                                 "nu": {"b0/conv/kernel": p(3, 3),
                                        "head/bias": p(3).to(torch.bfloat16)}},
                      step=torch.zeros((), dtype=torch.int32))


TRACKER_KEYS = ["mean", "cov", "score", "cls", "track_id", "state", "activated",
                "last_update", "emb", "frame_id", "next_id"]
CHECKPOINT_KEYS = {
    "pipeline_state": [f"trackers/{c}/{k}" for c in (0, 1) for k in TRACKER_KEYS]
    + ["prev_gray", "accum/keys_hi", "accum/keys_lo", "accum/weight"],
    "train_state": ["params/b0/conv/kernel", "params/head/bias", "opt_state/count",
                    "opt_state/mu/b0/conv/kernel", "opt_state/mu/head/bias",
                    "opt_state/nu/b0/conv/kernel", "opt_state/nu/head/bias", "step"],
}
STATES = {"pipeline_state": small_pipeline_state, "train_state": small_train_state}


@pytest.mark.parametrize("name", sorted(STATES))
def test_checkpoint_keys_are_pinned(tmp_path, name):
    """`save_pytree` writes one key a leaf under the pinned names, in order;
    an `.npz` written under those names by numpy alone (as a file written
    before loads) comes back bit for bit, bfloat16 from its int16 bits."""
    state = randomised(STATES[name](), 3)
    path = tmp_path / "a.npz"
    save_pytree(str(path), state)
    with np.load(path) as z:
        assert list(z.files) == CHECKPOINT_KEYS[name]
    arrays = {k: (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
              for k, t in zip(CHECKPOINT_KEYS[name], tree.leaves(state), strict=True)}
    np.savez(tmp_path / "b.npz", **arrays)
    back = load_pytree(str(tmp_path / "b.npz"), STATES[name]())
    assert type(back) is type(state)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree.leaves(back), tree.leaves(state), strict=True))
