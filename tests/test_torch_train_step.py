"""The port's train step, optimizers, checkpoint, evaluation and trainer
(`rt3d_torch.train.{step,eval}`, `rt3d_torch.apps.train_synth`) against
the JAX package's (`rt3d.train.step`, optax, `tools/eval_synth.py`,
`tools/train_synth.py`), on the CPU.

The model is yolo11n-seg with 4 classes at 64x96 in float32, its
parameters JAX's `init` carried across by `state_dict_from_npz`, the batch
the single-box batch of `tests/test_train.py`. Tolerances are stated at
each test.
"""

import ast
import contextlib
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from rt3d.models.yolo import core as ycore
from rt3d.models.yolo.convert import load_params as jload_params
from rt3d.models.yolo.model import YoloSeg as JYoloSeg
from rt3d.models.yolo.postprocess import anchor_grid as janchor_grid
from rt3d.train.loss import seg_detection_loss as jloss_fn
from rt3d.train.step import make_train_step as jmake_train_step
from rt3d_torch.apps import train_synth
from rt3d_torch.models.convert import save_params
from rt3d_torch.models.postprocess import decode_predictions
from rt3d_torch.models.yolo import YoloSeg, flat_from_model, load_weights, state_dict_from_npz
from rt3d_torch.runtime.checkpoint import load_pytree, save_pytree
from rt3d_torch.train import eval as teval
from rt3d_torch.train.loss import seg_detection_loss
from rt3d_torch.train.step import (
    AdamW, make_train_step, synth_optimizer, warmup_cosine_decay_schedule,
)
from tools import eval_synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 4
INPUT_HW = (64, 96)
# parameters after up to three Adam steps of lr 1e-3: 1 % of one step's
# move. An update element is lr * g / (|g| + eps) early on, whose slope in
# g peaks at |g| = eps = 1e-8, the size of the backbone's gradients at
# JAX's init: there the f32 rounding of a gradient (summed in other orders
# by the two packages) moves the update by up to lr times its relative
# error / 4. Measured 2.4e-6 with one torch thread, 1.9e-6 with eight.
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU steps: one torch thread, no pool to wake per op (under
    the test run's parallel workers a contended pool costs more than it
    gives)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def jax_f32():
    ycore.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)


def single_box_batch(seed: int = 0, cls_id: int = 2, box=(30, 20, 70, 48)) -> dict:
    """`tests/test_train.py`'s batch: anchors inside a bright box are
    positives of class `cls_id`; the legacy mask scheme."""
    jm = JYoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    pts, strides = janchor_grid(INPUT_HW)
    px = np.asarray(pts[:, 0]) * np.asarray(strides)
    py = np.asarray(pts[:, 1]) * np.asarray(strides)
    x1, y1, x2, y2 = box
    inside = (px >= x1) & (px < x2) & (py >= y1) & (py < y2)
    cls = np.zeros((jm.num_anchors, NC), np.float32)
    cls[inside, cls_id] = 1.0
    ltrb = np.stack([px - x1, py - y1, x2 - px, y2 - py], axis=-1) / np.asarray(strides)[:, None]
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, *INPUT_HW, 3)).astype(np.float32)
    img[:, y1:y2, x1:x2] += 1.0
    mask = np.zeros((1, 16, 24), np.float32)
    mask[:, 5:12, 7:18] = 1.0
    return {"images": img, "cls": cls[None],
            "box": np.clip(ltrb, 0, 15.0 - 1e-3).astype(np.float32)[None],
            "box_w": inside.astype(np.float32)[None], "mask": mask}


@pytest.fixture(scope="module")
def jax_init():
    jm = JYoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    return jm, jm.init(jax.random.PRNGKey(0))


def port_model(params) -> YoloSeg:
    tm = YoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    tm.load_state_dict(state_dict_from_npz({k: np.asarray(v) for k, v in params.items()}))
    return tm


def T(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}


def max_param_diff(tm: YoloSeg, jparams) -> float:
    got = flat_from_model(tm)
    return max(float(np.abs(got[k] - np.asarray(v)).max()) for k, v in jparams.items())


def test_schedule_equals_optax():
    """The warm-up cosine schedule in float32, as optax's, at every count
    through the warm-up, the decay and past its end, and with no
    warm-up."""
    for lr, warmup, steps in ((1e-3, 3, 10), (5e-5, 0, 7)):
        got = warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.05)
        exp = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                                 decay_steps=steps, end_value=lr * 0.05)
        for c in range(steps + 3):
            np.testing.assert_allclose(got(c), float(exp(jnp.int32(c))), rtol=1e-6, atol=0)
    assert warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10)(0) == 0.0


def test_three_adamw_steps_match_optax(jax_init):
    """`make_train_step` with `AdamW(1e-3)` against the JAX package's
    `make_train_step` with `optax.adamw(1e-3)`: the loss and each part
    within 1e-5 relative, and every parameter within PARAM_ATOL, after each
    of three steps."""
    jm, params = jax_init
    batch = single_box_batch()
    with jax_f32():
        jinit, jstep = jmake_train_step(jm, optax.adamw(1e-3))
        jstate = jinit(jax.random.PRNGKey(0))
        jstate = jstate.replace(params=params, opt_state=optax.adamw(1e-3).init(params))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jout = []
        for _ in range(3):
            jstate, jm_ = jstep(jstate, jbatch)
            jout.append(({k: float(v) for k, v in jm_.items()}, jax.device_get(jstate.params)))
    tm = port_model(params)
    init_fn, step_fn = make_train_step(tm, AdamW(1e-3))
    state = init_fn(0)
    tm.load_state_dict(port_model(params).state_dict())
    tb = T(batch)
    for i, (jmetrics, jparams) in enumerate(jout):
        state, metrics = step_fn(state, tb)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, err_msg=f"step {i} {k}")
        assert max_param_diff(tm, jparams) < PARAM_ATOL, i
    assert int(state.step) == 3 and int(state.opt_state["count"]) == 3


def test_tool_chain_matches_optax_with_warmup_clip_and_nan(jax_init):
    """The optimizer of `tools/train_synth.py` (`synth_optimizer`: zero_nans,
    clip_by_global_norm(5), adamw on the warm-up cosine schedule, b2 0.95,
    wd 1e-4) against optax's chain over three steps of lr 1e-3 with a
    2-step warm-up. The clip triggers on the first two steps (a batch whose
    global norm is over 5) and passes the third's gradients unchanged (a
    batch under 5);
    the second step's gradient has a NaN injected into one element of one
    leaf on both sides, which both zero. The first update moves
    nothing (its learning rate is 0); after every step the parameters
    agree within PARAM_ATOL and the losses within 1e-5 relative."""
    jm, params = jax_init
    # a small box (13 positives) makes the global norm 7.7, the usual one 4.0
    batches = [single_box_batch(seed=1, cls_id=1, box=(40, 24, 64, 48))] * 2 + [
        single_box_batch(seed=1, cls_id=1)]
    chain = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(5.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=2, decay_steps=10,
                                           end_value=1e-3 * 0.05), b2=0.95, weight_decay=1e-4))
    nan_leaf = "23/cv2/0/2/bias"
    with jax_f32():
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: jloss_fn(jm, p, b["images"], b), has_aux=True))
        update = jax.jit(lambda g, o, p: (lambda u, o2: (optax.apply_updates(p, u), o2))(
            *chain.update(g, o, p)))
        jparams, jopt, jout, norms = params, chain.init(params), [], []
        for i, batch in enumerate(batches):
            (loss, _), g = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
            if i == 1:
                g = dict(g)
                g[nan_leaf] = g[nan_leaf].at[3].set(jnp.nan)
            norms.append(float(optax.global_norm({k: jnp.nan_to_num(v) for k, v in g.items()})))
            jparams, jopt = update(g, jopt, jparams)
            jout.append((float(loss), jax.device_get(jparams)))

    tm = port_model(params)
    named = dict(tm.named_parameters())
    opt = synth_optimizer(1e-3, 2, 10)
    state, engine = opt.init(named), opt.make(named)
    before = flat_from_model(tm)
    nan_param = "23.cv2.0.2.bias"
    for i, ((jloss, jp), batch) in enumerate(zip(jout, batches)):
        tb = T(batch)
        loss, _ = seg_detection_loss(tm, tb["images"], tb)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(loss, list(named.values()), allow_unused=True), named.values())]
        if i == 1:
            grads[list(named).index(nan_param)][3] = float("nan")
        with torch.no_grad():
            opt.step(engine, named, grads, state)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, err_msg=f"step {i}")
        assert all(torch.isfinite(p).all() for p in named.values())
        assert max_param_diff(tm, jp) < PARAM_ATOL, i
        if i == 0:
            after = flat_from_model(tm)
            assert all(np.array_equal(after[k], before[k]) for k in before)
            assert all(np.array_equal(np.asarray(jp[k]), np.asarray(params[k])) for k in before)
    assert int(state["count"]) == 3
    assert norms[0] > 5.0 and norms[1] > 5.0 and norms[2] < 5.0, norms


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """Three steps, a checkpoint of the `TrainState` (`save_pytree`), three
    more; then the checkpoint restored into a fresh state
    (`load_pytree`) continues with exactly the same losses and
    parameters (`tests/test_train.py::test_train_checkpoint_resume_bitexact`)."""
    tm = YoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    init_fn, step_fn = make_train_step(tm, AdamW(1e-3))
    state = init_fn(0)
    batch = T(single_box_batch(seed=1, cls_id=1))
    for _ in range(3):
        state, _ = step_fn(state, batch)
    ckpt = str(tmp_path / "train.npz")
    save_pytree(ckpt, state)
    losses_a = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        losses_a.append(float(m["loss"]))
    params_a = {k: v.clone() for k, v in state.params.items()}

    tm2 = YoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    init2, step2 = make_train_step(tm2, AdamW(1e-3))
    resumed = load_pytree(ckpt, init2(5))
    assert int(resumed.step) == 3 and int(resumed.opt_state["count"]) == 3
    losses_b = []
    for _ in range(3):
        resumed, m = step2(resumed, batch)
        losses_b.append(float(m["loss"]))
    assert losses_a == losses_b
    assert all(torch.equal(params_a[k], v) for k, v in resumed.params.items())


def test_overfit_single_box(jax_init):
    """`tests/test_train.py::test_overfit_single_box` on the port: 200 steps
    of Adam (AdamW with no decay) at 2e-3 from the same initial
    parameters; the loss falls below 0.6 of its start, the class loss
    below 0.15 of its start, and the trained model scores the box's class
    on its anchors over twice as high as elsewhere."""
    _, params = jax_init
    tm = port_model(params)
    init_fn, step_fn = make_train_step(tm, AdamW(2e-3, weight_decay=0.0))
    state = init_fn(0)
    tm.load_state_dict(port_model(params).state_dict())
    batch = T(single_box_batch())
    losses, cls_hist = [], []
    for _ in range(200):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        cls_hist.append(float(m["cls"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])
    assert cls_hist[-1] < 0.15 * cls_hist[0], (cls_hist[0], cls_hist[-1])
    with torch.no_grad():
        box_l, cls_l, _, _ = tm(batch["images"])
    _, scores = decode_predictions(INPUT_HW, box_l, cls_l)
    s = scores[0].numpy()
    pos = batch["box_w"][0].numpy() > 0
    assert s[pos, 2].mean() > 2 * s[~pos, 2].mean()


def test_port_weights_load_into_jax(jax_init, tmp_path):
    """One port step, its parameters saved as the trainer saves them (fp16
    `.npz` in the JAX layout), load with the JAX package's `load_params`;
    JAX's forward on them equals the port's within
    `tests/test_torch_parity.py`'s float32 tolerance (2e-3)."""
    jm, params = jax_init
    tm = port_model(params)
    init_fn, step_fn = make_train_step(tm, AdamW(1e-3))
    state = init_fn(0)
    tm.load_state_dict(port_model(params).state_dict())
    batch = T(single_box_batch())
    step_fn(state, batch)
    path = str(tmp_path / "w.npz")
    save_params({k: v.astype(np.float16) for k, v in flat_from_model(tm).items()}, path)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in jload_params(path).items()}
    assert sorted(jp) == sorted(params)
    moved = sum(not np.array_equal(np.asarray(jp[k]), np.asarray(params[k], np.float16)
                                   .astype(np.float32)) for k in params)
    assert moved > 100
    with jax_f32():
        jout = jm.forward(jp, jnp.asarray(batch["images"].numpy()))
    fresh = load_weights(YoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW), path)
    with torch.no_grad():
        tout = fresh(batch["images"])
    for name, j, t in zip(("box", "cls", "coeffs", "protos"), jout, tout):
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=2e-3, atol=2e-3, err_msg=name)


def test_mask_iou_and_match_frame_equal_the_tool():
    """`mask_iou` and `match_frame` against `tools/eval_synth.py`'s on the
    same masks: predictions that are true, duplicate, misclassified and
    ghost, an invalid slot, and a camera with no ground truth."""
    rng = np.random.default_rng(3)
    h, w = 40, 60
    gt = np.zeros((3, h, w), bool)
    gt[0, 5:20, 5:25] = True
    gt[1, 20:35, 30:55] = True
    gt[2, 2:10, 40:58] = True
    gt_cls = np.array([39, 41, 73])
    pred = np.stack([gt[0], gt[0] | (rng.uniform(size=(h, w)) < 0.05), gt[1], gt[2],
                     np.roll(gt[1], 30, axis=1), gt[1]])
    valid = np.array([True, True, True, True, True, False])
    pcls = np.array([39, 39, 39, 73, 41, 41])
    for a in pred:
        for b in gt:
            assert teval.mask_iou(a, b) == eval_synth.mask_iou(a, b)
    got = teval.match_frame(gt, gt_cls, pred, valid, pcls)
    assert got == eval_synth.match_frame(gt, gt_cls, pred, valid, pcls)
    assert got["tp"] >= 1 and got["fp_dup"] >= 1 and got["fp_misclass"] >= 1
    empty = (np.zeros((0, h, w), bool), np.zeros((0,), int))
    assert teval.match_frame(*empty, pred, valid, pcls) == eval_synth.match_frame(
        *empty, pred, valid, pcls)


def _tool_manifest_keys() -> list:
    """The keys of the manifest dict `tools/train_synth.py` writes."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "train_synth.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "manifest"
                and isinstance(node.value, ast.Dict)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no manifest in tools/train_synth.py")


def test_train_synth_cli_writes_weights_and_manifest(tmp_path):
    """`python -m rt3d_torch.apps.train_synth --device cpu` on a tiny setting
    (n model, 2 steps, 1 scene of 96x160 frames, an eval of 1 frame)
    writes the fp16 `.npz`, which JAX's `load_params` reads, and a
    manifest with exactly the JAX tool's keys; a CUDA device without a
    card is refused."""
    out = str(tmp_path / "n.npz")
    argv = ["--device", "cpu", "--variant", "n", "--steps", "2", "--batch", "2",
            "--scenes", "1", "--frames-per-scene", "1", "--eval-frames", "1",
            "--hw", "96", "160", "--input-hw", "64", "96", "--out", out]
    assert train_synth.main(argv) == 0
    with open(str(tmp_path / "n.json")) as f:
        manifest = json.load(f)
    assert list(manifest) == _tool_manifest_keys()
    assert manifest["steps"] == 2 and manifest["eval"]["domain"] == "hard"
    assert manifest["eval_easy"]["domain"] == "easy" and manifest["dtype"] == "float16"
    flat = jload_params(out)
    assert all(v.dtype == np.float16 for v in flat.values())
    assert sorted(flat) == sorted(flat_from_model(YoloSeg(variant="n", input_hw=(64, 96))))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_synth.main(argv[2:])
