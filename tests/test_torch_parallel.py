"""The port's multi-device paths (`rt3d_torch.parallel`, the mesh branch of
`rt3d_torch.train.step.make_train_step`) on the CPU, over gloo process
groups of spawned ranks (`tests/test_torch_parallel_ranks.py`, one torch
thread each), against the port's single-process steps and the JAX
package's:

- the camera-sharded step at world 2 equals `Pipeline.step` bit for bit
  on 2 frames, outputs and carried state: the default config, a 4-camera
  1 mm accumulating config (two cameras a rank) and a quantized pipeline,
  as `tests/test_parallel.py` does for the JAX package; a
  ``workspace_sor=True`` config equals the single-process step with
  ``workspace_sor=False`` (the JAX sharded step has no workspace SOR);
  cameras that do not split over the ranks are refused. Both sides run
  with oneDNN off: its convolution's bits depend on the batch size, and
  the sharded step convolves one camera where the single step convolves
  two;
- the FSDP placement rule picks the same logical axis of every parameter
  of the n model as the JAX package's `fsdp_param_shardings`, at fsdp 2
  and 4 (on the 8-device CPU mesh of `tests/conftest.py`);
- the dp 2 x fsdp 2 train step (4 ranks, n model, 4 classes, 64x96,
  global batch 4, float32) over five steps of the trainer's chain, with a
  clip that triggers, on batches of both mask schemes whose counts differ
  from rank to rank, equals the unsharded port step and JAX's, and under
  SGD the loss falls.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt3d.models.yolo.model import YoloSeg as JYoloSeg
from rt3d.parallel.mesh import fsdp_param_shardings
from rt3d.parallel.mesh import make_mesh as jmake_mesh
from rt3d_torch.config import Config
from rt3d_torch.io import SyntheticSource
from rt3d_torch.models import quant
from rt3d_torch.models.postprocess import anchor_grid, letterbox_params
from rt3d_torch.models.yolo import (
    YoloSeg, flat_from_model, flat_from_named, init_random, state_dict_from_npz,
)
from rt3d_torch.parallel.mesh import fsdp_dim, fsdp_placements, jax_order
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.train.data import targets_for_masks
from rt3d_torch.train.loss import seg_detection_loss
from rt3d_torch.train.step import make_train_step, synth_optimizer
from tests import test_torch_parallel_ranks as worker
from tests.tiny import tiny_config

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "yolo11n_synth_seg.npz")
NC, INPUT_HW = 4, (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The single-process references run with one torch thread, as the
    ranks do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_config(cameras, **pipeline) -> dict:
    """`tests/tiny.py`'s config on the source's cameras, with the
    (192, 256) model input at which the trained n detector finds the
    objects, float32 everywhere (`tests/test_torch_step.py`)."""
    d = tiny_config().to_dict()
    d["rig"] = {"cameras": [dataclasses.asdict(c) for c in cameras]}
    d["model"].update(input_hw=(192, 256), compute_dtype="float32",
                      preprocess_dtype="float32", mask_resize_dtype="float32")
    d["pipeline"].update(pipeline)
    return d


def stretch_config(cameras) -> dict:
    """`tests/test_parallel.py`'s moderate stretch: 1 mm voxels (two-word
    keys), persistent accumulation fed the raw rays (here on 120x160
    frames)."""
    return small_config(cameras, voxel_size=0.001, max_points_workspace=16384,
                        max_points_workspace_fused=65536, workspace_accumulate=True,
                        accum_capacity=65536, accum_skip_prededupe=True)


def case(name, cfg, src, frames=2, act_scales=None):
    pkts = [src.get(i) for i in range(frames)]
    return worker.ShardCase(name, cfg, WEIGHTS, act_scales, np.stack([p.rgb for p in pkts]),
                            np.stack([p.depth for p in pkts]))


@pytest.fixture(scope="module")
def ranks():
    """One gloo group of 4 spawned ranks: the dp 2 x fsdp 2 train step of
    `test_mesh_train_step_equals_single_device_step`, then every sharded
    case on ranks 0 and 1, and its single-device reference on ranks 2 and
    3 (`test_torch_parallel_ranks.parallel_run`)."""
    src2 = SyntheticSource(num_cameras=2, num_frames=2, hw=(240, 320), num_objects=2)
    src4 = SyntheticSource(num_cameras=4, num_frames=2, hw=(120, 160), num_objects=2)
    src3 = SyntheticSource(num_cameras=3, num_frames=1, hw=(48, 64), num_objects=1)
    base = small_config(src2.cameras())
    pipe = build_pipeline(Config.from_dict(base), weights=WEIGHTS, device="cpu")
    scales = quant.collect_act_scales(pipe.model, quant.synth_calib_batches(pipe, src2, (0, 1)))
    cases = [case("default", base, src2),
             case("accumulate", stretch_config(src4.cameras()), src4),
             case("quantized", base, src2, act_scales=scales),
             case("workspace_sor", small_config(src2.cameras(), workspace_sor=True), src2),
             case("three_cameras", small_config(src3.cameras()), src3, frames=1)]
    references = [(2, cases[0]), (3, cases[1]), (2, cases[2]),
                  (2, case("workspace_sor", base, src2))]
    model_kw = dict(variant="n", num_classes=NC, input_hw=INPUT_HW)
    train = (model_kw, flat_from_model(init_random(YoloSeg(**model_kw), 0)),
             [box_batch()] * 3 + [inst_batch()] * 2, CHAIN)
    res = worker.run_ranks(worker.parallel_run, 4, cases, references, train)
    return {"sharded": [r["sharded"] for r in res[:2]],
            "single": {**res[2]["single"], **res[3]["single"]},
            "train": res[0]["train"], "train_args": train}


def assert_tree_equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert np.asarray(a).dtype == np.asarray(b).dtype, where


PER_CAMERA = ("detections", "track_ids", "per_camera_objects")


@pytest.mark.parametrize("name", ["default", "accumulate", "quantized", "workspace_sor"])
def test_sharded_step_equals_single_step(ranks, name):
    """Rank r's per-camera outputs and tracker state equal the single
    step's cameras of that rank; its fused outputs, overflow and the
    replicated accumulator equal the single step's on both ranks; bit for
    bit, frame by frame. The single step of the ``workspace_sor`` case runs
    with the SOR off."""
    ref = ranks["single"][name]
    cams = ref[0][0]["track_ids"].shape[0]
    for r, res in enumerate(ranks["sharded"]):
        lo, hi = res[name]["cameras"]
        assert (lo, hi) == (r * cams // 2, (r + 1) * cams // 2)
        for f, ((out, state), (rout, rstate)) in enumerate(zip(res[name]["frames"], ref)):
            for k in out:
                exp = rout[k]
                if k in PER_CAMERA:
                    exp = jax.tree_util.tree_map(lambda x: x[lo:hi], exp)
                assert_tree_equal(out[k], exp, f"{name} rank {r} frame {f} {k}")
            assert_tree_equal(state["trackers"], rstate["trackers"][lo:hi],
                              f"{name} rank {r} frame {f} trackers")
            assert_tree_equal(state["prev_gray"], rstate["prev_gray"][lo:hi], "prev_gray")
            assert_tree_equal(state["accum"], rstate["accum"], f"{name} frame {f} accum")
    last = ref[-1][0]
    assert last["detections"]["valid"].sum() > 0 and last["workspace"]["valid"].sum() > 0
    if name == "accumulate":
        assert last["workspace"]["valid"].sum() > 1000 and cams == 4


def test_sharded_step_refuses_uneven_cameras(ranks):
    for res in ranks["sharded"]:
        assert res["three_cameras"] == "3 cameras do not split evenly over 2 ranks"


@pytest.mark.parametrize("size", [2, 4])
def test_fsdp_rule_picks_jax_axes(size):
    """Per parameter of the n model (4 classes), the port's `Shard(d)`
    names the JAX dimension that `fsdp_param_shardings` shards, and
    `Replicate()` the parameters it replicates. The layouts make the
    difference: on some kernels the rule applied in the port's OIHW order
    would pick another logical axis."""
    jm = JYoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    shapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, (s, _) in jm.param_shapes().items()}
    jspec = fsdp_param_shardings(shapes, jmake_mesh({"fsdp": size}), "fsdp")
    tm = YoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    got = fsdp_placements(tm, size)
    assert len(got) == len(jspec)
    naive = 0
    for name, p in tm.named_parameters():
        path, leaf = name.rsplit(".", 1)
        jname = f"{path.replace('.', '/')}/{'kernel' if leaf == 'weight' else leaf}"
        spec = tuple(jspec[jname].spec) + (None,) * (p.ndim - len(jspec[jname].spec))
        jdim = spec.index("fsdp") if "fsdp" in spec else None
        perm = jax_order(name, p.ndim)
        pl = got[name]
        assert (None if pl.is_replicate() else perm[pl.dim]) == jdim, name
        wrong = fsdp_dim(p.shape, size)
        naive += wrong is not None and jdim is not None and perm[wrong] != jdim
    assert naive > 10


# few positives (35 in all): a global gradient norm over the clip's 5
BOXES = [((40, 24, 64, 48), 1), ((30, 20, 46, 36), 2), ((8, 8, 24, 24), 0), ((60, 30, 84, 54), 3)]


def box_batch(seed=0) -> dict:
    """A global batch of 4 single-box images (legacy mask scheme) with
    different boxes, classes and positive counts, so that the counts that
    normalize the loss differ between the ranks' slices."""
    pts, strides = anchor_grid(INPUT_HW)
    px, py, st = (pts[:, 0] * strides).numpy(), (pts[:, 1] * strides).numpy(), strides.numpy()
    out = {k: [] for k in ("images", "cls", "box", "box_w", "mask")}
    for i, ((x1, y1, x2, y2), c) in enumerate(BOXES):
        inside = (px >= x1) & (px < x2) & (py >= y1) & (py < y2)
        cls = np.zeros((len(px), NC), np.float32)
        cls[inside, c] = 1.0
        ltrb = np.stack([px - x1, py - y1, x2 - px, y2 - py], -1) / st[:, None]
        img = np.random.default_rng(seed + i).uniform(0, 1, (*INPUT_HW, 3)).astype(np.float32)
        img[y1:y2, x1:x2] += 1.0
        mask = np.zeros((16, 24), np.float32)
        mask[y1 // 4:y2 // 4, x1 // 4:x2 // 4] = 1.0
        for k, v in (("images", img), ("cls", cls), ("box_w", inside.astype(np.float32)),
                     ("box", np.clip(ltrb, 0, 15.0 - 1e-3).astype(np.float32)), ("mask", mask)):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


# two instances on images 0 and 2, one on 1 and 3, of different sizes
INSTANCES = [[((40, 24, 64, 48), 1), ((8, 8, 24, 24), 0)], [((30, 20, 46, 36), 2)],
             [((60, 30, 84, 54), 3), ((16, 36, 40, 60), 1)], [((44, 8, 92, 56), 0)]]


def inst_batch(seed=4) -> dict:
    """A global batch of 4 images in the trainer's instance scheme
    (elliptic masks, `targets_for_masks`), without ``cls``, so that the
    class targets are weighted by the alignment quality: the positive,
    assignment-weight and top-k counts differ between the ranks' slices."""
    meta = letterbox_params(INPUT_HW, INPUT_HW)
    ys, xs = np.mgrid[:INPUT_HW[0], :INPUT_HW[1]] + 0.5
    out = []
    for i, objs in enumerate(INSTANCES):
        masks = np.stack([((xs - (x1 + x2) / 2) / ((x2 - x1) / 2)) ** 2
                          + ((ys - (y1 + y2) / 2) / ((y2 - y1) / 2)) ** 2 <= 1
                          for (x1, y1, x2, y2), _ in objs])
        t = targets_for_masks(masks, np.array([c for _, c in objs]), meta, INPUT_HW, NC, 2)
        del t["cls"]
        img = np.random.default_rng(seed + i).uniform(0, 1, (*INPUT_HW, 3)).astype(np.float32)
        img[masks.any(0)] += 1.0
        out.append({"images": img, **t})
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


# the chain of `tests/test_torch_train_step.py`: lr 1e-3 with a 2-step
# warm-up. The sharded step sums the same numbers as the unsharded one in
# another order (the counts, the gradient over the ranks, the norm over the
# shards): parameters within 1e-6, a tenth of that test's bound against JAX
# (1 % of one step's move); 3.0e-8 measured over the five steps.
CHAIN = dict(lr=1e-3, warmup=2, steps=10)
PARAM_ATOL = 1e-6


def test_mesh_train_step_equals_single_device_step(ranks):
    """Five steps of the trainer's chain (zero_nans, the global-norm clip
    at 5, which the first step's gradient exceeds, AdamW on the warm-up
    schedule) on the dp 2 x fsdp 2 mesh, one sample a rank, from the
    port's seed-0 parameters, three on the legacy-mask batch and two on
    the instance-scheme batch, each with counts that differ from rank to
    rank: after each step the loss and its parts equal
    the unsharded port step's within 1e-6 relative and the parameters
    within PARAM_ATOL, so the mesh step is held to JAX's through the
    unsharded one (`tests/test_torch_train_step.py::
    test_tool_chain_matches_optax_with_warmup_clip_and_nan`). Every
    parameter is sharded over fsdp (the n model has no parameter the rule
    replicates) and replicated over dp. Under SGD the loss falls, as in
    `tests/test_parallel.py::test_fsdp_train_step_runs_and_shards`."""
    model_kw, flat, batches, chain = ranks["train_args"]
    res = ranks["train"]
    inst = batches[-1]
    assert len({float(w.sum()) for w in inst["box_w"]}) == 4
    assert min(float(w.sum()) for w in inst["box_w"]) < 32   # the top-k weights differ too
    tm = YoloSeg(**model_kw)
    tm.load_state_dict(state_dict_from_npz(flat))
    tbs = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    tb = tbs[0]
    loss, _ = seg_detection_loss(tm, tb["images"], tb)
    grads = [g for g in torch.autograd.grad(loss, list(tm.parameters()), allow_unused=True)
             if g is not None]
    assert float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))) > 5.0
    init_fn, step_fn = make_train_step(tm, synth_optimizer(**chain))
    state = init_fn(0)
    tm.load_state_dict(state_dict_from_npz(flat))
    assert len(res["chain"]) == len(tbs) == 5
    for i, ((metrics, full), tb) in enumerate(zip(res["chain"], tbs)):
        state, m = step_fn(state, tb)
        assert metrics.keys() == m.keys()
        for k, v in m.items():
            np.testing.assert_allclose(metrics[k], float(v), rtol=1e-6, err_msg=f"{i} {k}")
        port = flat_from_model(tm)
        mesh = flat_from_named((k, torch.from_numpy(v)) for k, v in full.items())
        assert max(float(np.abs(mesh[k] - port[k]).max()) for k in port) < PARAM_ATOL, i
    assert "iou" in res["chain"][-1][0]
    assert res["count"] == 5 and res["step"] == 2
    assert all(pl[0] == "Replicate()" for pl in res["placements"].values())
    fsdp = [pl[1] for pl in res["placements"].values()]
    assert all(p.startswith("Shard") for p in fsdp)
    assert sum(p == "Shard(dim=1)" for p in fsdp) > 10
    assert res["sgd"][1] < res["sgd"][0], res["sgd"]


def test_mesh_layouts_and_refusals(ranks):
    """`replicated` and `batch_sharding` are the placements of JAX's
    `P()`, `P("dp")` and `P(("dp", "fsdp"))`; `make_mesh` refuses a mesh larger than the group, with the JAX
    package's message, and one smaller; `make_train_step` a mesh whose axes
    are not ``("dp", "fsdp")``; `step_fn` before `init_fn`."""
    assert ranks["train"]["layouts"] == ["(Replicate(), Replicate())",
                                         "(Shard(dim=0), Replicate())",
                                         "(Shard(dim=0), Shard(dim=0))"]
    assert ranks["train"]["refusals"] == [
        "mesh needs 8 devices, have 4",
        "mesh of 2 devices on a process group of 4: start the group with the mesh's size",
        "the train mesh's axes must be ('dp', 'fsdp'), not ('fsdp', 'dp')"]
    tm = YoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    with pytest.raises(RuntimeError, match="init_fn"):
        make_train_step(tm)[1](None, {})
