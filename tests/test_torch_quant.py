"""The port's int8 W8A8 path (`rt3d_torch.models.quant`, `models.yolo.QConv`)
against the JAX package's (`rt3d/models/yolo/quant.py` and the quantized
branch of `core.conv2d`), on the CPU, and the port's checkpoint of a
quantized pipeline.

Inputs come from numpy seeds; the JAX side runs in float32 with its int8
convolution (XLA's s8 x s8 -> s32 `conv_general_dilated`). The int8
weights, scales and the convolution's int32 sums must be the JAX package's
bit for bit; float outputs agree within the tolerances each test states.
Calibrated scales agree only as closely as the two f32 forwards do
(1.5e-6 relative at most on the n model here).
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rt3d.config as jconfig
from rt3d.models.yolo import core as ycore
from rt3d.models.yolo import quant as jquant
from rt3d.models.yolo.convert import load_params
from rt3d.models.yolo.model import YoloSeg as JYoloSeg
from rt3d.pipeline.step import CameraCalib as JCalib
from rt3d.pipeline.step import build_pipeline as jbuild_pipeline
from rt3d_torch import golden
from rt3d_torch.io import SyntheticSource
from rt3d_torch.models import quant
from rt3d_torch.models.yolo import (
    QConv, YoloSeg, cast_for_inference, flat_from_model, load_weights, state_dict_from_npz,
)
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.runtime.checkpoint import load_pytree, save_pytree
from tests.test_torch_step import small_config
from tests.tiny import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_N = os.path.join(ROOT, "weights", "yolo11n_synth_seg.npz")
HW = tiny_config().model.input_hw  # (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch runs on one thread meanwhile: many small ops, and the test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def jax_f32():
    ycore.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)


def _flat_f32(path=WEIGHTS_N):
    return {k: np.asarray(v, np.float32) for k, v in load_params(path).items()}


def _sidecar_scales():
    return quant.load_act_scales(quant.sidecar_path(WEIGHTS_N))


def _images(seed, n=2, hw=HW):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32) for _ in range(n)]


def test_default_exclude_matches_jax_on_every_x_path():
    """The x model's 185 convs: the same paths and group counts on both
    packages, the same exclusions, 98 quantized (96 plain, the 2 depthwise
    `pe` convs)."""
    jmeta = jquant.collect_conv_meta(JYoloSeg(variant="x"))
    meta = quant.collect_conv_meta(YoloSeg(variant="x"))
    assert meta == jmeta and len(meta) == 185
    assert all(quant.default_exclude(p) == jquant.default_exclude(p) for p in meta)
    kept = [p for p in meta if not quant.default_exclude(p)]
    assert len(kept) == 98
    assert sorted(p for p in kept if meta[p]["groups"] > 1) == [
        "10/m/0/attn/pe/conv", "10/m/1/attn/pe/conv"]


@pytest.mark.parametrize("exclude_grouped", [False, True])
def test_quantized_params_equal_jax_bit_for_bit(exclude_grouped):
    """The n weights against the n sidecar's fixed scales: every key, dtype
    and bit of the quantized dict equal `quant.quantize_params`'s."""
    scales = _sidecar_scales()
    flat = _flat_f32()
    jm = JYoloSeg(variant="n", input_hw=HW)
    exp = jquant.quantize_params(jm, {k: jnp.asarray(v) for k, v in flat.items()}, (),
                                 act_scales=scales, exclude_grouped=exclude_grouped)
    got = quant.quantize_params(YoloSeg(variant="n", input_hw=HW), flat, (),
                                act_scales=scales, exclude_grouped=exclude_grouped)
    assert got.keys() == exp.keys()
    for k in exp:
        e = np.asarray(exp[k])
        assert got[k].dtype == e.dtype and np.array_equal(got[k], e), k
    n_q8 = sum(k.endswith("/kernel_q8") for k in got)
    assert n_q8 == (42 if exclude_grouped else 43)  # the n model has one `pe` conv


# (cin, cout, k, stride, groups, hw): a 1x1, a 3x3 at stride 2, a depthwise
# 3x3, and a 3x3 whose K (27) and cout (6) are not multiples of 8 over 9
# output rows, which the int8 GEMM pads
CONVS = {"1x1": (32, 48, 1, 1, 1, (9, 14)), "3x3_s2": (24, 40, 3, 2, 1, (11, 16)),
         "depthwise": (64, 64, 3, 1, 64, (7, 10)), "padded": (3, 6, 3, 2, 1, (5, 6))}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_quantized_conv_matches_jax(name, jax_f32):
    """One quantized conv against `core.conv2d`'s quantized branch: the
    int8 input and the int32 sum exact, the SiLU output within 1e-6 (the
    two packages' sigmoids differ by an ulp)."""
    cin, cout, k, s, g, hw = CONVS[name]
    rng = np.random.default_rng(len(name))
    x = (rng.standard_normal((2, *hw, cin)) * 2).astype(np.float32)
    wq = rng.integers(-127, 128, (k, k, cin // g, cout)).astype(np.int8)
    params = {"c/kernel_q8": wq,
              "c/kernel_scale": rng.uniform(1e-3, 2e-2, cout).astype(np.float32),
              "c/act_scale": np.float32(np.abs(x).max() * 0.8),  # some inputs clip
              "c/bias": rng.standard_normal(cout).astype(np.float32)}
    ctx = ycore.ParamCtx(params={kk: jnp.asarray(v) for kk, v in params.items()})
    exp = ycore.conv2d(ctx, "c", jnp.asarray(x), cout, k, s, g)
    a = params["c/act_scale"]
    jxq = jnp.clip(jnp.round(jnp.asarray(x) * (127.0 / jnp.asarray(a))), -127, 127).astype(jnp.int8)
    jacc = jax.lax.conv_general_dilated(
        jxq, jnp.asarray(wq), (s, s), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g,
        preferred_element_type=jnp.int32)

    conv = QConv(cin, cout, k, s, g)
    conv.load_state_dict({kk[2:]: v for kk, v in state_dict_from_npz(params).items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    xq = conv.quantize_input(xt)
    acc = conv.int_conv(xq)
    np.testing.assert_array_equal(N(xq.permute(0, 2, 3, 1)), N(jxq))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(N(acc.permute(0, 2, 3, 1)), N(jacc))
    got = conv(xt, act=True)
    np.testing.assert_allclose(N(got.permute(0, 2, 3, 1)), N(exp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pct", [None, 99.9])
def test_collect_act_scales_matches_jax(pct, jax_f32):
    """Per-conv scales of the n model over two seeded batches: the same
    paths, within 1e-5 relative of JAX's (the forwards' f32 drift reaches
    1.5e-6 in max mode). On one tensor the max is JAX's bit for bit and the
    linear percentile through `kthvalue` within 1e-6 relative of
    `jnp.percentile` (XLA folds the constants of its index arithmetic,
    which moves the interpolation weight by an ulp)."""
    imgs = _images(1)
    jm = JYoloSeg(variant="n", input_hw=HW)
    params = {k: jnp.asarray(v) for k, v in _flat_f32().items()}
    exp = jquant.collect_act_scales(jm, params, [jnp.asarray(i) for i in imgs], pct=pct)
    model = load_weights(YoloSeg(variant="n", input_hw=HW), WEIGHTS_N).eval()
    got = quant.collect_act_scales(model, [torch.from_numpy(i) for i in imgs], pct=pct)
    assert got.keys() == exp.keys()
    rel = max(abs(got[k] - exp[k]) / exp[k] for k in exp)
    assert rel < 1e-5, rel
    ax = np.abs(np.random.default_rng(2).standard_normal((3, 7, 11, 13))).astype(np.float32)
    ax[0, 0, 0, :4] = ax.max()  # ties at the top
    for p in (50.0, 99.9, 100.0) if pct else (None,):
        e = jnp.max(ax) if p is None else jnp.percentile(jnp.asarray(ax), p)
        g = torch.amax(torch.from_numpy(ax)) if p is None else \
            quant._percentile(torch.from_numpy(ax), p)
        if p is None:
            assert N(g).tobytes() == N(e).astype(np.float32).tobytes()
        else:
            np.testing.assert_allclose(N(g), N(e), rtol=1e-6, atol=0, err_msg=str(p))


def test_quantized_forward_matches_jax(jax_f32, tmp_path):
    """The tiny config's n model, quantized against the sidecar's scales on
    both packages, forward on a seeded batch: every head within the f32
    forward test's 1e-3 (`tests/test_torch_yolo.py`). The JAX quantized
    dict saved as an ``.npz`` loads into the port (`load_weights`) as the
    same model."""
    scales = _sidecar_scales()
    flat = _flat_f32()
    jm = JYoloSeg(variant="n", input_hw=HW)
    qp = jquant.quantize_params(jm, {k: jnp.asarray(v) for k, v in flat.items()}, (),
                                act_scales=scales)
    (img,) = _images(3, 1)
    exp = jax.jit(jm.forward)(qp, jnp.asarray(img))
    model = load_weights(YoloSeg(variant="n", input_hw=HW), WEIGHTS_N).eval()
    quant.quantize_model(model, flat, scales)
    assert quant.is_quantized(model) and quant.model_act_scales(model) == {
        p: float(np.float32(scales[p])) for p in scales
        if not quant.default_exclude(p)}
    path = tmp_path / "q.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in qp.items()})
    loaded = load_weights(YoloSeg(variant="n", input_hw=HW), str(path)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(img))
        again = loaded(torch.from_numpy(img))
    for name, g, a, e in zip(("box", "cls", "coeff", "proto"), got, again, exp):
        assert torch.equal(g, a), name
        np.testing.assert_allclose(N(g), N(e), rtol=1e-3, atol=1e-3, err_msg=name)


def test_flat_from_model_inverts_the_npz():
    """`flat_from_model`, which the apps quantize when no weights file is
    given (the JAX apps quantize their random parameters), gives back the
    n weights file's arrays as float32."""
    model = load_weights(YoloSeg(variant="n", input_hw=HW), WEIGHTS_N)
    flat, exp = flat_from_model(model), _flat_f32()
    assert flat.keys() == exp.keys()
    assert all(flat[k].dtype == np.float32 and np.array_equal(flat[k], exp[k]) for k in exp)


def test_quantized_conv_keeps_f32_scales_through_the_cast():
    """`cast_for_inference` to bf16 casts the float convs but leaves a
    `QConv`'s bias and scales f32 and its weight int8, as the JAX package
    keeps them."""
    model = load_weights(YoloSeg(variant="n", input_hw=HW), WEIGHTS_N)
    quant.quantize_model(model, _flat_f32(), _sidecar_scales())
    bias = model.get_submodule("1.conv").bias.clone()
    model = cast_for_inference(model, torch.bfloat16, "cpu")
    q = model.get_submodule("1.conv")
    assert isinstance(q, QConv) and model.compute_dtype == torch.bfloat16
    assert (q.weight.dtype, q.kernel_scale.dtype, q.act_scale.dtype, q.bias.dtype) == (
        torch.int8, torch.float32, torch.float32, torch.float32)
    assert torch.equal(q.bias, bias)
    assert model.get_submodule("0.conv").weight.dtype == torch.bfloat16
    with torch.no_grad():
        out = model(torch.from_numpy(_images(4, 1)[0]))
    assert all(bool(torch.isfinite(o).all()) for o in out)


def _quantized_pipes(cfg, src, frames):
    """The port's and the JAX package's pipelines on `cfg` with the n
    weights quantized against the port's calibration on `frames` (both
    quantize the same f32 weights against the same scales)."""
    pipe = build_pipeline(cfg, weights=WEIGHTS_N, device="cpu")
    scales = quant.quantize_pipeline(pipe, WEIGHTS_N,
                                     quant.synth_calib_batches(pipe, src, frames))
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jpipe = jbuild_pipeline(jcfg)
    qp = jquant.quantize_params(jpipe.model, {k: jnp.asarray(v) for k, v in _flat_f32().items()},
                                (), act_scales=scales)
    return pipe, jpipe, qp, jcfg


def test_quantized_step_matches_jax(jax_f32):
    """The quantized step of the small step config (`tests/test_torch_step.py`,
    n model at (192, 256), 240x320 cameras) over 2 frames, the JAX step op
    by op: within the golden's float32 bands (`rt3d_torch.golden`):
    detections, classes and track IDs exact, boxes within 1e-3 px, fused
    voxels within 1 %, workspace differences only at threshold ties."""
    src = SyntheticSource(num_cameras=2, num_frames=2, hw=(240, 320), num_objects=2)
    cfg = small_config(src.cameras())
    pipe, jpipe, qp, jcfg = _quantized_pipes(cfg, src, range(2))
    state, calib = pipe.init_state(), pipe.calib()
    jstate, jcalib = jpipe.init_state(), JCalib.from_config(jcfg)
    got, exp = [], []
    for i in range(2):
        pkt = src.get(i)
        state, out = pipe.step(state, torch.from_numpy(pkt.rgb), torch.from_numpy(pkt.depth),
                               calib)
        jstate, jout = jpipe.step(qp, jstate, jnp.asarray(pkt.rgb), jnp.asarray(pkt.depth),
                                  jcalib)
        got.append(out)
        exp.append(jout)
    thr = cfg.pipeline.subtraction_threshold
    m = golden.measure(golden.record(got, thr), golden.record(exp, thr))
    golden.check_bands(m)
    assert m["frames"] == 2 and sum(int(N(o.detections.valid).sum()) for o in exp) > 0


def test_act_scale_sidecar_fingerprint(tmp_path):
    """`tests/test_quant.py::test_act_scale_sidecar_fingerprint` on the
    port: a stale sidecar loads as None, a legacy bare dict and a
    fingerprint-less sidecar load as they are, the calibration record rides
    along; and the committed sidecars read the same on both packages."""
    w = tmp_path / "model.npz"
    w.write_bytes(b"weights-v1")
    sp = str(tmp_path / "model.act_scales.json")
    scales = {"0/conv": 1.5, "1/conv": 2.0}
    quant.save_act_scales(sp, scales, weights_path=str(w))
    assert quant.load_act_scales(sp, weights_path=str(w)) == scales
    assert quant.load_act_scales(sp) == scales
    w.write_bytes(b"weights-v2")
    assert quant.load_act_scales(sp, weights_path=str(w)) is None
    with open(sp, "w") as f:
        json.dump(scales, f)
    assert quant.load_act_scales(sp, weights_path=str(w)) == scales
    quant.save_act_scales(sp, scales)
    assert quant.load_act_scales(sp, weights_path=str(w)) == scales
    quant.save_act_scales(sp, scales, weights_path=str(w),
                          calibration={"mode": "pct", "pct": 99.9})
    assert quant.load_act_scales(sp, weights_path=str(w)) == scales
    with open(sp) as f:
        assert json.load(f)["calibration"] == {"mode": "pct", "pct": 99.9}
    for v in ("n", "x"):
        wp = os.path.join(ROOT, "weights", f"yolo11{v}_synth_seg.npz")
        sp = quant.sidecar_path(wp)
        assert sp == jquant.sidecar_path(wp)
        assert quant.weights_fingerprint(wp) == jquant.weights_fingerprint(wp)
        assert quant.load_act_scales(sp, weights_path=wp) == jquant.load_act_scales(
            sp, weights_path=wp)
    # the x sidecar is stale against the committed x weights, the n one not
    x = os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz")
    assert quant.load_act_scales(quant.sidecar_path(x), weights_path=x) is None
    assert quant.load_act_scales(quant.sidecar_path(WEIGHTS_N), weights_path=WEIGHTS_N)


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """A quantized pipeline stepped over 3 frames, its state and model
    (int8 weights, f32 scales) checkpointed after frame 1 and restored into
    a fresh pipeline quantized against other scales: frame 2 from the
    restored state gives the uninterrupted run's outputs bit for bit. A
    missing leaf or a wrong shape is refused."""
    src = SyntheticSource(num_cameras=2, num_frames=3, hw=(240, 320), num_objects=2)
    cfg = small_config(src.cameras())
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, tracker_type="botsort", with_reid=True, gmc=True))
    pipe = build_pipeline(cfg, weights=WEIGHTS_N, device="cpu")
    quant.quantize_pipeline(pipe, WEIGHTS_N, quant.synth_calib_batches(pipe, src, range(2)))
    state, calib = pipe.init_state(), pipe.calib()
    pkts = [src.get(i) for i in range(3)]
    ckpt = str(tmp_path / "ckpt.npz")
    for i, pkt in enumerate(pkts):
        state, out = pipe.step(state, torch.from_numpy(pkt.rgb), torch.from_numpy(pkt.depth),
                               calib)
        if i == 1:
            save_pytree(ckpt, {"state": state, "model": pipe.model.state_dict()})
    fresh = build_pipeline(cfg, weights=WEIGHTS_N, device="cpu")
    quant.quantize_pipeline(fresh, WEIGHTS_N, act_scales={p: 1.0 for p in
                                                          quant.collect_conv_meta(fresh.model)})
    like = {"state": fresh.init_state(), "model": fresh.model.state_dict()}
    tree = load_pytree(ckpt, like)
    fresh.model.load_state_dict(tree["model"], strict=True)
    assert quant.model_act_scales(fresh.model) == quant.model_act_scales(pipe.model)
    _, again = fresh.step(tree["state"], torch.from_numpy(pkts[2].rgb),
                          torch.from_numpy(pkts[2].depth), calib)
    flat = lambda o: dict(golden.record([o], 0.06))  # noqa: E731
    a, b = flat(out), flat(again)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert int(N(out.detections.valid).sum()) > 0
    assert torch.equal(out.track_ids, again.track_ids)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(ckpt, {"state": dataclasses.replace(
            like["state"], prev_gray=torch.zeros(1, 2, 2)), "model": like["model"]})
    with pytest.raises(KeyError, match="missing"):
        load_pytree(ckpt, {**like, "extra": torch.zeros(1)})
