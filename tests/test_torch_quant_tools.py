"""The port's int8 tools (`rt3d_torch.apps.calibrate_quant` and
`rt3d_torch.apps.eval_quant`) against the JAX package's tools
(`tools/calibrate_quant.py`, `tools/eval_quant_chip.py`) and the functions
they call, on the CPU with the committed n weights and one frame.

Both sides run in float32 (the tools' config with its compute dtype set to
float32; JAX's compute dtype likewise), because bf16 convolutions round at
other places in the two frameworks. The JAX side is fed the port's own
calibration batches. Tolerances: activation scales within 1.5e-6 relative
(the two f32 forwards sum in other orders); the sidecar's keys, calibration
record and fingerprint equal; the eval records' keys and every count of
their rows (true and false positives by kind, instances) equal.
"""

import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import pytest
import torch

import rt3d.config as jconfig
from rt3d.io.synthetic import SyntheticSource as JSyntheticSource
from rt3d.models.yolo import core as ycore
from rt3d.models.yolo import quant as jquant
from rt3d.models.yolo.convert import load_params
from rt3d.pipeline.step import build_pipeline as jbuild_pipeline
from rt3d_torch import config
from rt3d_torch.apps import calibrate_quant, eval_quant
from rt3d_torch.models import quant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "yolo11n_synth_seg.npz")
INPUT_HW = (384, 640)  # the n manifest's
SCALE_RTOL = 1.5e-6
COUNTS = ("tp", "fp_dup", "fp_misclass", "fp_ghost")
RECORD_KEYS = {"variant", "weights", "frames", "grouped_excluded", "mask_bf16",
               "preproc_bf16", "fp", "scales", "int8"}

_reference_2cam_config = config.reference_2cam_config


def _f32_config():
    cfg = _reference_2cam_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32", preprocess_dtype="float32",
        mask_resize_dtype="float32"))


@pytest.fixture
def f32(monkeypatch):
    """The port's tools in float32, the JAX package's convs too; records
    the port's calibration batches."""
    batches = []
    orig = quant.synth_calib_batches

    def record(*a, **kw):
        b = orig(*a, **kw)
        batches.extend(b)
        return b

    monkeypatch.setattr(config, "reference_2cam_config", _f32_config)
    monkeypatch.setattr(quant, "synth_calib_batches", record)
    ycore.set_compute_dtype(jnp.float32)
    try:
        yield batches
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)


def _jax_params():
    return {k: jnp.asarray(v, jnp.float32) for k, v in load_params(WEIGHTS).items()}


def _jax_scales(batches, pct=None):
    """JAX's `collect_act_scales` on the port's batches."""
    from rt3d.models.yolo.model import YoloSeg as JYoloSeg

    return jquant.collect_act_scales(JYoloSeg(variant="n", input_hw=INPUT_HW), _jax_params(),
                                     [jnp.asarray(b.numpy()) for b in batches], pct=pct)


def _assert_scales_close(got, exp):
    assert got.keys() == exp.keys() and len(got) == 99  # every conv of the n model
    rel = max(abs(got[k] - exp[k]) / exp[k] for k in exp)
    assert rel < SCALE_RTOL, rel


@pytest.mark.parametrize("pct", [None, 99.9])
def test_calibrate_quant_matches_jax(f32, tmp_path, capsys, pct):
    """One frame of each of the tool's two scenes: the scales equal JAX's
    `collect_act_scales` on the same two batches; the sidecar has the JAX
    sidecar's keys, calibration record and fingerprint, and loads in the
    JAX package's `load_act_scales` against the weights."""
    out = str(tmp_path / "n.act_scales.json")
    flags = ["--pct", str(pct)] if pct else []
    assert calibrate_quant.main([WEIGHTS, "--frames", "1", "--out", out, "--device", "cpu",
                                 *flags]) == 0
    assert f"wrote 99 act scales -> {out}" in capsys.readouterr().out
    assert len(f32) == 2 and all(b.shape == (2, *INPUT_HW, 3) for b in f32)
    got = quant.load_act_scales(out, weights_path=WEIGHTS)
    exp = _jax_scales(f32, pct)
    _assert_scales_close(got, exp)
    jout = str(tmp_path / "jax.act_scales.json")
    calibration = ({"mode": "pct", "pct": pct} if pct else {"mode": "max"}) | {"frames": 2}
    jquant.save_act_scales(jout, exp, weights_path=WEIGHTS, calibration=calibration)
    with open(out) as f, open(jout) as g:
        doc, jdoc = json.load(f), json.load(g)
    assert doc.keys() == jdoc.keys() and doc["scales"].keys() == jdoc["scales"].keys()
    assert doc["calibration"] == jdoc["calibration"]
    assert doc["weights_fingerprint"] == jdoc["weights_fingerprint"]
    assert jquant.load_act_scales(out, weights_path=WEIGHTS) == got


def test_calibrate_quant_default_out_and_keys_equal_jax_tool(tmp_path, monkeypatch):
    """In its own dtypes, as a user runs it, the port's tool writes
    `<weights>.act_scales.json` beside a copy of the weights, with the keys
    and calibration record of the sidecar the JAX tool writes from the same
    flags."""
    import sys

    from tools import calibrate_quant as jtool

    w = tmp_path / "n.npz"
    shutil.copy(WEIGHTS, w)
    shutil.copy(os.path.splitext(WEIGHTS)[0] + ".json", tmp_path / "n.json")
    assert calibrate_quant.main([str(w), "--frames", "1", "--device", "cpu"]) == 0
    with open(quant.sidecar_path(str(w))) as f:
        doc = json.load(f)
    jout = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", ["calibrate_quant.py", str(w), "--frames", "1",
                                      "--out", jout])
    assert jtool.main() == 0
    with open(jout) as f:
        jdoc = json.load(f)
    assert doc.keys() == jdoc.keys() and doc["scales"].keys() == jdoc["scales"].keys()
    assert doc["calibration"] == jdoc["calibration"] == {"mode": "max", "frames": 2}
    assert doc["weights_fingerprint"] == jdoc["weights_fingerprint"]


def _jax_eval_pipe():
    """The JAX tool's pipeline: the reference 2cam config with the n
    manifest's variant and input, conf 0.25, float32 resizes (and float32
    compute here), on the seed-777 scene's cameras."""
    cfg = jconfig.reference_2cam_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, variant="n", input_hw=INPUT_HW, conf_thresh=0.25, compute_dtype="float32",
        mask_resize_dtype="float32", preprocess_dtype="float32"))
    src0 = JSyntheticSource(num_cameras=2, num_frames=None, hw=(720, 1280), num_objects=1,
                            seed=777)
    return jbuild_pipeline(jconfig.with_cameras(cfg, src0.cameras()))


def _assert_rows_equal(got, exp):
    assert got.keys() == exp.keys()
    for k in COUNTS + ("gt_instances", "gt_below_min_visible", "frames"):
        assert got[k] == exp[k], k
    assert got["by_conf"].keys() == exp["by_conf"].keys()
    for t in exp["by_conf"]:
        assert {k: got["by_conf"][t][k] for k in COUNTS} == \
            {k: exp["by_conf"][t][k] for k in COUNTS}, t


def _run_eval(capsys, argv):
    assert eval_quant.main(argv) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_eval_quant_matches_jax(f32, tmp_path, capsys):
    """fp and int8 on one frame, int8 against a sidecar of the port's
    scales: the JAX tool's record keys, and every count of the fp and the
    int8 rows equal to `tools.eval_synth.evaluate_weights` on the JAX
    package's pipeline with the same weights, quantized against the same
    scales."""
    from tools.eval_synth import evaluate_weights as jevaluate

    sp = str(tmp_path / "n.act_scales.json")
    scales = {k: float(v) for k, v in quant.load_act_scales(quant.sidecar_path(WEIGHTS)).items()}
    quant.save_act_scales(sp, scales, weights_path=WEIGHTS)
    rec, _ = _run_eval(capsys, [WEIGHTS, "--frames", "1", "--device", "cpu", "--scales", sp])
    assert rec.keys() == RECORD_KEYS
    assert (rec["variant"], rec["weights"], rec["frames"], rec["scales"]) == (
        "n", "yolo11n_synth_seg.npz", 1, "n.act_scales.json")
    assert not (rec["grouped_excluded"] or rec["mask_bf16"] or rec["preproc_bf16"])
    jpipe = _jax_eval_pipe()
    params = _jax_params()
    ev = dict(variant="n", input_hw=INPUT_HW, num_frames=1, pipe=jpipe)
    _assert_rows_equal(rec["fp"], jevaluate(params, **ev))
    qp = jquant.quantize_params(jpipe.model, params, (), act_scales=scales)
    _assert_rows_equal(rec["int8"], jevaluate(qp, **ev))
    assert rec["fp"]["tp"] > 0 and rec["int8"]["tp"] > 0


def test_eval_quant_calibrates_live_without_grouped(f32, tmp_path, capsys, monkeypatch):
    """Without a sidecar beside the weights the tool calibrates live on the
    seed-4242 scene (its four default frames), and RT3D_QUANT_NO_GROUPED
    keeps the grouped conv in the compute dtype: the record says both, and
    the int8 row's counts equal JAX's `evaluate_weights` with JAX's own
    calibration of the same batches under the same setting."""
    from tools.eval_synth import evaluate_weights as jevaluate

    monkeypatch.setenv("RT3D_QUANT_NO_GROUPED", "1")
    w = tmp_path / "n.npz"
    shutil.copy(WEIGHTS, w)
    shutil.copy(os.path.splitext(WEIGHTS)[0] + ".json", tmp_path / "n.json")
    rec, err = _run_eval(capsys, [str(w), "--frames", "1", "--device", "cpu", "--skip-fp"])
    assert "# no sidecar at" in err
    assert rec.keys() == RECORD_KEYS - {"fp"}
    assert rec["scales"] == "calibrated" and rec["grouped_excluded"] is True
    assert len(f32) == 4
    jpipe = _jax_eval_pipe()
    qp = jquant.quantize_params(jpipe.model, _jax_params(),
                                [jnp.asarray(b.numpy()) for b in f32])
    assert not any(k.startswith("10/m/0/attn/pe/conv/kernel_q8") for k in qp)
    _assert_rows_equal(rec["int8"], jevaluate(qp, variant="n", input_hw=INPUT_HW, num_frames=1,
                                              pipe=jpipe))


def test_tools_refuse_cuda_without_a_card(tmp_path, monkeypatch):
    """``--device cuda`` (the default) without a card is refused, never
    replaced by the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        calibrate_quant.main([WEIGHTS, "--frames", "1", "--out", str(tmp_path / "s.json")])
    with pytest.raises(RuntimeError):
        eval_quant.main([WEIGHTS, "--frames", "1"])
    assert not (tmp_path / "s.json").exists()
