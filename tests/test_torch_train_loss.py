"""The port's training data, augmentation and objective
(`rt3d_torch.train.{data,augment,loss}`) against the JAX package's
(`rt3d.train`), on the CPU.

Both sides get the same seeded numpy inputs; the JAX side computes in
float32 (`ycore.set_compute_dtype`, restored after) and its parameters are
carried to the port by `state_dict_from_npz`. The data are equal bit for
bit; the augmentation fed JAX's own draws exactly (the flip) or within
1e-6 (the jitter); the loss and each part within 1e-5 relative; the
gradients within the tolerances stated at each test.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt3d.models.yolo import core as ycore
from rt3d.models.yolo.model import YoloSeg as JYoloSeg
from rt3d.models.yolo.postprocess import letterbox_params as jletterbox_params
from rt3d.train import augment as jaugment
from rt3d.train import data as jdata
from rt3d.train import loss as jloss
from rt3d_torch.models.postprocess import letterbox_params
from rt3d_torch.models.yolo import YoloSeg, flat_from_named, state_dict_from_npz
from rt3d_torch.train import augment, data, loss

NC = 4
INPUT_HW = (64, 96)
SRC_HW = (96, 144)   # letterboxes to 64x96 with no pad
A = 8 * 12 + 4 * 6 + 2 * 3
HP, WP = 16, 24
M = 4


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


def T(x):
    return torch.from_numpy(np.asarray(x).copy())


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hand_masks():
    """Two images' instance masks at SRC_HW: image 0 a large ellipse
    (class 1, more than 32 positive anchors) and a small box (class 3);
    image 1 two overlapping boxes (classes 0 and 2, the second occluding
    the first) and a 3-pixel speck (dropped: under 4 pixels)."""
    h, w = SRC_HW
    yy, xx = np.mgrid[:h, :w]
    m0 = np.zeros((2, h, w), bool)
    m0[0] = ((yy - 50) / 40.0) ** 2 + ((xx - 70) / 60.0) ** 2 < 1
    m0[1, 5:20, 110:135] = True
    m0[0] &= ~m0[1]
    m1 = np.zeros((3, h, w), bool)
    m1[0, 20:70, 10:60] = True
    m1[1, 40:90, 40:100] = True
    m1[0] &= ~m1[1]
    m1[2, 5, 5:8] = True
    return [(m0, np.array([1, 3])), (m1, np.array([0, 2, 1]))]


def instance_targets(jax_side: bool = True) -> dict:
    """The instance-scheme targets of `hand_masks`, stacked (B = 2),
    from the JAX package's `targets_for_masks`."""
    meta = jletterbox_params(SRC_HW, INPUT_HW)
    ts = [jdata.targets_for_masks(m, c, meta, INPUT_HW, NC, M) for m, c in hand_masks()]
    return {k: np.stack([t[k] for t in ts]) for k in ts[0] if k != "cls"}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _assert_same_arrays(got: dict, exp: dict):
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert got[k].dtype == exp[k].dtype, k
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)


def test_targets_for_masks_equal_jax():
    """Every target array bit for bit, on masks with a large instance,
    occlusion and a speck under 4 pixels, at two letterboxes (no pad, and
    a vertical pad)."""
    for src_hw, masks_of in ((SRC_HW, hand_masks()), ((72, 144), None)):
        if masks_of is None:
            masks_of = [(m[:, :72], c) for m, c in hand_masks()]
        jmeta = jletterbox_params(src_hw, INPUT_HW)
        meta = letterbox_params(src_hw, INPUT_HW)
        assert (meta.ratio, meta.pad_top, meta.pad_left, meta.new_hw) == (
            jmeta.ratio, jmeta.pad_top, jmeta.pad_left, jmeta.new_hw)
        for masks, classes in masks_of:
            _assert_same_arrays(
                data.targets_for_masks(masks, classes, meta, INPUT_HW, NC, M),
                jdata.targets_for_masks(masks, classes, jmeta, INPUT_HW, NC, M))


@pytest.mark.parametrize("domain", ["easy", "hard", "mix"])
def test_build_synth_dataset_equal_jax(domain):
    """Images and targets bit for bit: 2 scenes x 2 frames x 2 cameras of
    96x160 frames, the port's synthetic source against the JAX
    package's."""
    kw = dict(num_scenes=2, frames_per_scene=2, hw=(96, 160), seed=3, domain=domain)
    got = data.build_synth_dataset(SimpleNamespace(input_hw=INPUT_HW, num_classes=80), **kw)
    exp = jdata.build_synth_dataset(JYoloSeg(variant="n", num_classes=80, input_hw=INPUT_HW),
                                    **kw)
    _assert_same_arrays(got, exp)
    assert got["box_w"].sum() > 0 and len(got["images"]) == 8


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------


def test_anchor_flip_perm_equal_jax():
    for hw in (INPUT_HW, (384, 640)):
        np.testing.assert_array_equal(augment.anchor_flip_perm(hw), jaugment.anchor_flip_perm(hw))


def _flip_batch(b: int = 4):
    t = instance_targets()
    rng = np.random.default_rng(5)
    t = {k: np.concatenate([v, v[::-1]])[:b] for k, v in t.items()}
    imgs = rng.uniform(0, 1, (b, *INPUT_HW, 3)).astype(np.float32)
    return imgs, t


def test_random_hflip_on_jax_draws_is_exact():
    """Fed JAX's own Bernoulli draws (a key whose draws mix flipped and
    kept samples), the port's flip equals `random_hflip` on every array;
    and flipping every sample twice is the identity (instance boxes within
    one rounding).""" 
    imgs, t = _flip_batch()
    perm = augment.anchor_flip_perm(INPUT_HW)
    key = jax.random.PRNGKey(2)
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (4,)))
    assert flip.any() and not flip.all()
    jimg, jt = jaugment.random_hflip(key, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in t.items()},
                                     jnp.asarray(perm), INPUT_HW[1])
    tt = {k: T(v) for k, v in t.items()}
    img, got = augment.apply_hflip(T(imgs), tt, T(flip), T(perm), INPUT_HW[1])
    np.testing.assert_array_equal(N(img), np.asarray(jimg))
    for k in t:
        assert N(got[k]).dtype == np.asarray(jt[k]).dtype, k
        np.testing.assert_array_equal(N(got[k]), np.asarray(jt[k]), err_msg=k)
    every = torch.ones(4, dtype=torch.bool)
    img2, twice = augment.apply_hflip(*augment.apply_hflip(T(imgs), tt, every, T(perm),
                                                           INPUT_HW[1]), every, T(perm),
                                      INPUT_HW[1])
    np.testing.assert_array_equal(N(img2), imgs)
    for k in t:
        if k != "inst_box":
            np.testing.assert_array_equal(N(twice[k]), t[k], err_msg=k)
    # boxes go through input_w - (input_w - x): one f32 rounding at 96 px;
    # the padded (all-zero) slots stay exactly zero
    np.testing.assert_allclose(N(twice["inst_box"]), t["inst_box"], rtol=0, atol=1e-5)
    pad = np.abs(t["inst_box"]).sum(-1) == 0
    assert pad.any() and (N(twice["inst_box"])[pad] == 0).all()


def test_photometric_on_jax_draws_within_1e6():
    """`apply_photometric` on the draws `photometric_augment` makes from its
    key (the same splits and calls) equals it within 1e-6."""
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (3, 16, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    k_gain, k_ch, k_bias, k_sig, k_noise = jax.random.split(key, 5)
    draws = {
        "gain": jax.random.uniform(k_gain, (3, 1, 1, 1), minval=0.7, maxval=1.3),
        "ch": jax.random.uniform(k_ch, (3, 1, 1, 3), minval=0.9, maxval=1.1),
        "bias": jax.random.uniform(k_bias, (3, 1, 1, 1), minval=-0.06, maxval=0.06),
        "sigma": jax.random.uniform(k_sig, (3, 1, 1, 1), minval=0.0, maxval=0.03),
        "noise": jax.random.normal(k_noise, imgs.shape, jnp.float32),
    }
    exp = np.asarray(jaugment.photometric_augment(key, jnp.asarray(imgs)))
    got = N(augment.apply_photometric(T(imgs), {k: T(v) for k, v in draws.items()}))
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)
    assert 0 < (got == 0).sum() + (got == 1).sum() or got.min() >= 0


def test_generator_augmentation_deterministic_and_bounded():
    rng = np.random.default_rng(2)
    imgs = T(rng.uniform(0, 1, (4, 32, 48, 3)).astype(np.float32))

    def run(seed):
        return augment.photometric_augment(torch.Generator().manual_seed(seed), imgs)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    flips = [augment.hflip_draws(torch.Generator().manual_seed(s), torch.zeros(64, 1))
             for s in (0, 0, 1)]
    assert torch.equal(flips[0], flips[1]) and 10 < int(flips[0].sum()) < 54


# ---------------------------------------------------------------------------
# the objective on given head outputs: ties and exact zeros
# ---------------------------------------------------------------------------


class _Given:
    """A JAX-package model whose forward returns its parameters."""

    def forward(self, params, images):
        return params


def head_outputs(rng):
    """Head outputs (B = 2) with exact zeros and ties: image 0's box logits
    all zero on the first 40 anchors (their decoded ltrb is exactly 7.5,
    which some targets equal), class logits with exact zeros, and zero
    coefficients on some anchors (mask logits exactly 0)."""
    box = rng.normal(0, 2, (2, A, 64)).astype(np.float32)
    box[0, :40] = 0.0
    cls = rng.normal(-2, 2, (2, A, NC)).astype(np.float32)
    cls[:, ::3, 1] = 0.0
    coeffs = rng.normal(0, 1, (2, A, 32)).astype(np.float32)
    coeffs[:, ::4] = 0.0
    protos = rng.normal(0, 1, (2, HP, WP, 32)).astype(np.float32)
    return box, cls, coeffs, protos


def dense_targets(rng, scheme: str) -> dict:
    """Dense targets of both schemes with more than 32 positives in image 0
    (every box_w 1.0: `top_k` ties), box targets at 0, at integers and at
    7.5 (where image 0's decoded boxes tie), an instance with no anchor
    (segment max -inf) and class ids that need no one-hot clipping."""
    w = (rng.uniform(size=(2, A)) < 0.2).astype(np.float32)
    w[0, :50] = 1.0
    box = rng.uniform(0, 14.9, (2, A, 4)).astype(np.float32)
    box[:, ::5] = 0.0
    box[:, 1::7] = np.float32(7.0)
    box[0, :40:2] = np.float32(7.5)
    box *= w[..., None] > 0
    t = {"box": box, "box_w": w}
    if scheme == "legacy":
        t["cls"] = (rng.uniform(size=(2, A, NC)) < 0.1).astype(np.float32) * w[..., None]
        t["mask"] = (rng.uniform(size=(2, HP, WP)) < 0.3).astype(np.float32)
        return t
    inst = rng.integers(0, M - 1, (2, A)).astype(np.int32)   # instance M-1 has none
    t["inst_id"] = np.where(w > 0, inst, -1).astype(np.int32)
    t["inst_cls"] = rng.integers(0, NC, (2, M)).astype(np.int32)
    t["inst_mask"] = (rng.uniform(size=(2, M, HP, WP)) < 0.4).astype(np.float32)
    xy = rng.uniform(0, 60, (2, M, 2)).astype(np.float32)
    t["inst_box"] = np.concatenate([xy, xy + rng.uniform(4, 40, (2, M, 2)).astype(np.float32)],
                                   -1)
    return t


@pytest.mark.parametrize("scheme", ["legacy", "instance"])
def test_loss_on_head_outputs_with_ties(scheme):
    """The loss and each part within 1e-5 relative, and its gradient with
    respect to each head output within 1e-5 of the largest element of
    JAX's (relative) plus 1e-8, on outputs and targets with exact zeros
    and ties; the JAX side is `seg_detection_loss` itself over a model
    whose forward returns the outputs."""
    rng = np.random.default_rng(11)
    outs = head_outputs(rng)
    t = dense_targets(rng, scheme)
    assert (t["box_w"][0] > 0).sum() > 32
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jloss.seg_detection_loss(_Given(), p, None, {k: jnp.asarray(v)
                                                              for k, v in t.items()}),
        has_aux=True)(tuple(jnp.asarray(o) for o in outs))
    touts = [T(o).requires_grad_(True) for o in outs]
    tl, tparts = loss.seg_detection_loss(lambda images: touts, None, {k: T(v) for k, v in t.items()})
    grads = [torch.zeros_like(o) if g is None else g
             for g, o in zip(torch.autograd.grad(tl, touts, allow_unused=True), touts)]
    assert sorted(tparts) == sorted(jparts)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    for name, g, e in zip(("box", "cls", "coeffs", "protos"), grads, jg):
        e = np.asarray(e)
        assert np.abs(e).max() > 0 or (scheme, name) == ("legacy", "coeffs"), name
        np.testing.assert_allclose(N(g), e, rtol=0, atol=1e-5 * np.abs(e).max() + 1e-8,
                                   err_msg=name)


def test_tie_gradients_split_like_jax():
    """At exact ties `jnp.maximum`/`jnp.minimum` give each input half the
    gradient; the port's helpers do too (`clamp` would give one side all
    of it), and `_abs` has `jnp.abs`'s slope +1 at 0: the BCE at a zero
    logit, and the IoU where the decoded box (7.5) equals the target."""
    x = np.array([0.0, 0.0, 1.5, -2.0], np.float32)
    tgt = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    jg = jax.grad(lambda v: jloss._bce(v, jnp.asarray(tgt)).sum())(jnp.asarray(x))
    tx = T(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(loss._bce(tx, T(tgt)).sum(), tx)
    np.testing.assert_allclose(N(tg), np.asarray(jg), rtol=1e-6)
    assert float(tg[0]) == 0.0   # 0.5 - 0 - 0.5: the split makes the tie exact
    box = np.zeros((1, 3, 64), np.float32)
    t = {"box": np.full((1, 3, 4), 7.5, np.float32), "box_w": np.ones((1, 3), np.float32)}
    t["box"][0, 1] = [7.5, 3.0, 9.0, 7.5]
    jg = jax.grad(lambda b: jloss._pred_box_iou(b, {k: jnp.asarray(v) for k, v in t.items()}
                                                ).sum())(jnp.asarray(box))
    tb = T(box).requires_grad_(True)
    (tg,) = torch.autograd.grad(loss._pred_box_iou(tb, {k: T(v) for k, v in t.items()}).sum(),
                                tb)
    np.testing.assert_allclose(N(tg), np.asarray(jg), rtol=1e-6, atol=1e-9)


def test_alignment_quality_empty_instance_and_top_k_order():
    """`segment_max` leaves -inf on an instance with no anchor, and the
    port's scatter does too; the quality equals JAX's. The mask loss's
    top-k keeps the lowest indices among equal weights (XLA's stable
    top-k), with more than 32 positives."""
    rng = np.random.default_rng(4)
    t = dense_targets(rng, "instance")
    iou = (rng.uniform(size=(2, A)).astype(np.float32) * t["box_w"])
    exp = np.asarray(jloss._alignment_quality(jnp.asarray(iou),
                                              {k: jnp.asarray(v) for k, v in t.items()}))
    got = N(loss._alignment_quality(T(iou), {k: T(v) for k, v in t.items()}))
    np.testing.assert_array_equal(got, exp)
    w = T(t["box_w"])
    vals, idx = loss._top_k(w, 32)
    jvals, jidx = jax.lax.top_k(jnp.asarray(t["box_w"]), 32)
    np.testing.assert_array_equal(N(idx), np.asarray(jidx))
    assert torch.equal(idx[0], torch.arange(32))
    sid = T(t["inst_id"]).clamp_min(0).long()
    inst_max = torch.full((2, M), float("-inf")).scatter_reduce(1, sid, T(iou), "amax",
                                                                include_self=True)
    assert torch.isinf(inst_max[:, M - 1]).all()


# ---------------------------------------------------------------------------
# the objective through the model: every parameter's gradient
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_pair():
    jm = JYoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    params = jm.init(jax.random.PRNGKey(0))
    tm = YoloSeg(variant="n", num_classes=NC, input_hw=INPUT_HW)
    tm.load_state_dict(state_dict_from_npz({k: np.asarray(v) for k, v in params.items()}))
    return jm, params, tm


def model_batch(scheme: str) -> dict:
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (2, *INPUT_HW, 3)).astype(np.float32)
    if scheme == "instance":
        t = instance_targets()
    else:
        t = dense_targets(rng, "legacy")
    return {"images": imgs, **t}


@pytest.fixture(scope="module")
def jax_grads(model_pair):
    """JAX's loss, parts and gradients (jitted `value_and_grad`, float32)
    of both schemes on `model_batch`."""
    jm, params, _ = model_pair
    out = {}
    with jax_f32():
        for scheme in ("legacy", "instance"):
            b = {k: jnp.asarray(v) for k, v in model_batch(scheme).items()}
            f = jax.jit(jax.value_and_grad(
                lambda p, b: jloss.seg_detection_loss(jm, p, b["images"], b), has_aux=True))
            (l, parts), g = f(params, b)
            out[scheme] = (float(l), {k: float(v) for k, v in parts.items()},
                           {k: np.asarray(v) for k, v in g.items()})
    return out


@pytest.mark.parametrize("scheme", ["legacy", "instance"])
def test_model_loss_and_every_gradient_match_jax(model_pair, jax_grads, scheme):
    """The n model (4 classes, 64x96, batch 2) in float32: the loss and
    each part within 1e-5 relative; each of the 200 parameters' gradients
    within 2e-5 of its largest element in JAX's plus 1e-9 (f32 convs and
    their backward sum in other orders: 2.6e-6 measured), names mapped by
    `flat_from_named`, the layout of `flat_from_model`. The instance batch has more than
    32 positives in image 0."""
    _, _, tm = model_pair
    b = {k: T(v) for k, v in model_batch(scheme).items()}
    if scheme == "instance":
        assert (b["box_w"][0] > 0).sum() > 32
    jl, jparts, jg = jax_grads[scheme]
    tm.zero_grad()
    tl, tparts = loss.seg_detection_loss(tm, b["images"], b)
    tl.backward()
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    assert sorted(tparts) == sorted(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), jparts[k], rtol=1e-5, err_msg=k)

    # the legacy scheme leaves the coefficient branch unused: JAX's zeros
    got = flat_from_named((n, torch.zeros_like(p) if p.grad is None else p.grad)
                          for n, p in tm.named_parameters())
    assert sorted(got) == sorted(jg)
    worst = 0.0
    for k, e in jg.items():
        scale = np.abs(e).max()
        err = np.abs(got[k] - e).max()
        worst = max(worst, err / max(scale, 1e-30))
        assert err <= 2e-5 * scale + 1e-9, (k, err, scale)
    assert worst < 2e-5
