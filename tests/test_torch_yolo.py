"""Parity of the port's YOLO11-seg and post-processing with the JAX package.

Weights come from the committed ``weights/yolo11?_synth_seg.npz`` files and
are turned into the port's state_dict in memory. Both sides run in float32
on the CPU; inputs are made with numpy from a seed.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt3d.models.yolo import core as ycore
from rt3d.models.yolo import postprocess as jpost
from rt3d.models.yolo.convert import load_params
from rt3d.models.yolo.model import YoloSeg as JYoloSeg
from rt3d_torch.models import postprocess as post
from rt3d_torch.models.yolo import YoloSeg, load_weights, state_dict_from_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weights(variant):
    return os.path.join(ROOT, "weights", f"yolo11{variant}_synth_seg.npz")


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def jax_f32():
    ycore.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)


@pytest.mark.parametrize("variant", ["n", "l", "x"])
def test_weights_load_strictly(variant):
    """Every array of the npz lands on exactly one parameter of the same
    size, and the module tree has no parameter the npz lacks."""
    model = YoloSeg(variant=variant)
    with np.load(_weights(variant)) as z:
        sd = state_dict_from_npz({k: z[k] for k in z.files})
        assert len(sd) == len(z.files)
        for key in z.files:
            path, leaf = key.rsplit("/", 1)
            name = path.replace("/", ".") + (".weight" if leaf == "kernel" else ".bias")
            assert sd[name].numel() == z[key].size
    model.load_state_dict(sd, strict=True)


def _forward_pair(variant, hw, seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    model = load_weights(YoloSeg(variant=variant, input_hw=hw), _weights(variant)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    jm = JYoloSeg(variant=variant, input_hw=hw)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in load_params(_weights(variant)).items()}
    exp = jax.jit(jm.forward)(params, jnp.asarray(images))
    return [N(g) for g in got], [N(e) for e in exp]


def _assert_heads_close(got, exp, rtol, atol):
    for name, g, e in zip(("box", "cls", "coeff", "proto"), got, exp):
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g, e, rtol=rtol, atol=atol, err_msg=name)


def test_forward_matches_jax_n(jax_f32):
    """n weights at (64, 96), f32 both sides. The two frameworks' f32
    convolutions sum in different orders; over ~100 layers the logits
    drift by at most ~1e-4 of their scale."""
    got, exp = _forward_pair("n", (64, 96), seed=0)
    _assert_heads_close(got, exp, rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_forward_matches_jax_x_full_size(jax_f32):
    """x weights at the main path's (384, 640) input, f32 both sides."""
    got, exp = _forward_pair("x", (384, 640), seed=1)
    _assert_heads_close(got, exp, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("src_hw,dst_hw", [((720, 1280), (384, 640)), ((96, 160), (64, 96))])
def test_preprocess_matches_jax(rng, src_hw, dst_hw):
    """Antialiased letterbox resize in f32: equal to float rounding."""
    frame = rng.integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    meta = post.letterbox_params(src_hw, dst_hw)
    jmeta = jpost.letterbox_params(src_hw, dst_hw)
    assert (meta.ratio, meta.pad_top, meta.pad_left, meta.new_hw) == (
        jmeta.ratio, jmeta.pad_top, jmeta.pad_left, jmeta.new_hw)
    got = N(post.preprocess_frame(torch.from_numpy(frame), meta))
    exp = N(jpost.preprocess_frame(jnp.asarray(frame), jmeta))
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


def test_decode_and_nms_match_jax(rng):
    """Scores quantized to 1/64 so that ties are common: the candidate and
    survivor orders (ties to the lower index) must match exactly."""
    hw, nc, nm = (64, 96), 80, 32
    a = sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))
    box_l = rng.normal(0, 2, (1, a, 64)).astype(np.float32)
    cls_l = (np.round(rng.normal(-3, 2, (1, a, nc)) * 64) / 64).astype(np.float32)
    coeffs = rng.normal(size=(a, nm)).astype(np.float32)
    boxes, scores = post.decode_predictions(hw, torch.from_numpy(box_l), torch.from_numpy(cls_l))
    jboxes, jscores = jpost.decode_predictions(JYoloSeg(variant="n", input_hw=hw),
                                               jnp.asarray(box_l), jnp.asarray(cls_l))
    np.testing.assert_allclose(N(boxes), N(jboxes), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(N(scores), N(jscores), rtol=1e-6, atol=1e-7)
    # NMS on identical inputs (the JAX decode) so only NMS is compared
    jb, js = np.array(N(jboxes)[0]), np.array(N(jscores)[0])
    for class_filter in ((), (39, 41)):
        mask = np.zeros(nc, bool)
        mask[list(class_filter) or slice(None)] = True
        det = post.nms_fixed(torch.from_numpy(jb), torch.from_numpy(js), torch.from_numpy(coeffs),
                             0.05, 0.7, 20, 128, torch.from_numpy(mask))
        jdet = jpost.nms_fixed(jnp.asarray(jb), jnp.asarray(js), jnp.asarray(coeffs),
                               0.05, 0.7, 20, 128, jnp.asarray(mask))
        for f in ("boxes", "scores", "classes", "coeffs", "valid"):
            np.testing.assert_array_equal(N(getattr(det, f)), N(getattr(jdet, f)), err_msg=f)
        assert N(det.valid).sum() > 0


def test_boxes_and_retina_masks_match_jax(rng):
    """Masks from identical prototypes: a pixel may differ only where the
    JAX probability is within 1e-5 of the 0.5 threshold (f32 resize
    rounding)."""
    src_hw, dst_hw = (96, 160), (64, 96)
    meta, jmeta = post.letterbox_params(src_hw, dst_hw), jpost.letterbox_params(src_hw, dst_hw)
    d, nm = 4, 32
    protos = rng.normal(0, 1, (16, 24, nm)).astype(np.float32)
    coeffs = rng.normal(0, 0.5, (d, nm)).astype(np.float32)
    boxes_in = rng.uniform(0, [48, 32, 96, 64], (d, 4)).astype(np.float32)
    boxes = post.boxes_to_original(torch.from_numpy(boxes_in), meta)
    jboxes = jpost.boxes_to_original(jnp.asarray(boxes_in), jmeta)
    np.testing.assert_allclose(N(boxes), N(jboxes), rtol=1e-6, atol=1e-5)
    got = N(post.assemble_masks_retina(torch.from_numpy(protos), torch.from_numpy(coeffs),
                                       torch.from_numpy(np.array(N(jboxes))), meta))
    exp = N(jpost.assemble_masks_retina(jnp.asarray(protos), jnp.asarray(coeffs), jboxes, jmeta))
    logits = np.einsum("dn,hwn->dhw", coeffs, protos)
    m = 1 / (1 + np.exp(-logits[:, 0:14, 0:24].astype(np.float64)))
    prob = N(jax.image.resize(jnp.asarray(m, jnp.float32), (d, *src_hw), "bilinear"))
    diff = got != exp
    assert np.all(np.abs(prob[diff] - 0.5) < 1e-5)
    assert diff.sum() <= 3 and got.sum() > 100


@pytest.mark.parametrize("seed", range(4))
def test_suppress_center_duplicates_matches_jax(seed):
    """Exact against the JAX package: boxes on a coarse grid so that centre
    distances tie with the radius, forced same-class near-duplicates,
    different-class neighbours at the same centre and invalid slots."""
    rs = np.random.default_rng(seed)
    d = 20
    c = rs.integers(0, 6, (d, 2)).astype(np.float32) * 8.0 + 100.0
    c[2] = 400.0  # apart from the grid: slot 2 survives, then kills slot 5
    c[5], c[9] = c[2] + [3.0, 4.0], c[2]
    half = rs.uniform(10, 30, (d, 2)).astype(np.float32)
    boxes = np.concatenate([c - half, c + half], 1).astype(np.float32)
    classes = rs.choice([39, 41], d).astype(np.int32)
    classes[5], classes[9] = classes[2], 80 - classes[2]
    valid = rs.uniform(size=d) < 0.85
    valid[[2, 5, 9]] = True
    scores = np.sort(rs.uniform(0.1, 1.0, d))[::-1].astype(np.float32)
    coeffs = rs.normal(size=(d, 32)).astype(np.float32)
    args = (boxes, scores, classes, coeffs, valid)
    got = post.suppress_center_duplicates(post.Detections(*map(torch.from_numpy, args)), 8.0)
    exp = jpost.suppress_center_duplicates(jpost.Detections(*map(jnp.asarray, args)), 8.0)
    for f in ("boxes", "scores", "classes", "coeffs", "valid"):
        np.testing.assert_array_equal(N(getattr(got, f)), N(getattr(exp, f)), err_msg=f)
    keep = N(got.valid)
    assert not keep[5] and keep[9] and keep.sum() < valid.sum()
