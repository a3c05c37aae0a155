"""Post-training int8 quantization (W8A8) of the YOLO11 conv stack (port of
`rt3d/models/yolo/quant.py`).

A quantized params dict is the switch, as in the JAX package:
`quantize_params` turns each quantized conv's f32 ``kernel`` into

    <path>/kernel_q8      int8 HWIO, per-output-channel symmetric
    <path>/kernel_scale   (cout,) f32 dequant scales (max-|w|/127)
    <path>/act_scale      ()  f32 calibrated max-|input| of the conv

with the JAX package's numpy arithmetic on the f32 weights of the ``.npz``
(not on the model's bf16-cast parameters), so the int8 weights and scales
are the JAX package's bit for bit. `quantize_model` swaps a
`rt3d_torch.models.yolo.QConv` in for each such conv of a port model and
loads the triple with the conv's f32 bias; the same forward and pipeline
then run the int8 path.

Calibration (`collect_act_scales`) records the max |x| (or a percentile of
|x|) of every conv's input in f32 over the model's own forward, through
forward pre-hooks keyed by the JAX package's conv paths (``6.cv1.conv`` is
``6/cv1/conv``).

Exclusions (`default_exclude`): the stem conv (3-channel input) and every
stage from 16 on (neck and head), whose box regression the JAX package
measured to be quantization-sensitive; the backbone (stages 1-15) runs
int8. Whether int8 is faster than bf16 on a given card is measured, not
assumed (PERF.md).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from rt3d_torch.models.yolo import Conv, QConv, YoloSeg, flat_from_model, load_flat


def default_exclude(path: str) -> bool:
    """True for conv paths that stay in the compute dtype: the stem
    (``0/conv``) and stages >= 16 (neck and head)."""
    parts = path.split("/")
    if parts[0] == "0":
        return True
    try:
        if int(parts[0]) >= 16:
            return True
    except ValueError:
        pass
    return False


def _conv_paths(model: YoloSeg) -> Dict[str, torch.nn.Module]:
    """JAX conv path -> the port's `Conv` or `QConv` module."""
    return {name.replace(".", "/"): m for name, m in model.named_modules()
            if isinstance(m, (Conv, QConv))}


def _percentile(ax: torch.Tensor, pct: float) -> torch.Tensor:
    """`jnp.percentile(ax, pct)` (linear interpolation) in its f32
    arithmetic, through `kthvalue`, which takes any size (`torch.quantile`
    refuses inputs above 2^24 elements)."""
    flat = ax.reshape(-1)
    n = flat.numel()
    q = torch.tensor(pct, dtype=torch.float32) / 100.0
    q = q * (torch.tensor(float(n), dtype=torch.float32) - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo = min(max(int(low), 0), n - 1)
    hi = min(max(int(high), 0), n - 1)
    lo_v = torch.kthvalue(flat, lo + 1).values
    hi_v = lo_v if hi == lo else torch.kthvalue(flat, hi + 1).values
    return lo_v * lw.to(flat.device) + hi_v * hw.to(flat.device)


def collect_act_scales(model: YoloSeg, calib_images: Iterable[torch.Tensor],
                       pct: Optional[float] = None) -> Dict[str, float]:
    """Per-conv max |input| over the calibration batches.

    `calib_images`: (B, H, W, 3) float batches in [0, 1], what the model's
    forward takes. Each conv's input goes to f32 and its max |x| (or, with
    `pct`, that percentile of |x|) is taken per batch; the host keeps the
    max over batches."""
    convs = _conv_paths(model)
    stats: Dict[str, List[torch.Tensor]] = {p: [] for p in convs}

    def hook(path):
        def pre(mod, args):
            ax = torch.abs(args[0].float())
            stats[path].append(torch.amax(ax) if pct is None else _percentile(ax, pct))
        return pre

    handles = [m.register_forward_pre_hook(hook(p)) for p, m in convs.items()]
    n = 0
    try:
        with torch.no_grad():
            for images in calib_images:
                model(images)
                n += 1
    finally:
        for h in handles:
            h.remove()
    if n == 0:
        raise ValueError("calibration needs at least one frame batch")
    out: Dict[str, float] = {}
    for path, vals in stats.items():
        for v in torch.stack(vals).cpu().tolist():
            out[path] = max(out.get(path, 0.0), float(v))
    return out


def collect_conv_meta(model: YoloSeg) -> Dict[str, dict]:
    """Static per-conv metadata (the group count) by conv path."""
    return {p: {"groups": m.groups} for p, m in _conv_paths(model).items()}


def quantize_params(model: YoloSeg, params: Dict[str, np.ndarray],
                    calib_images: Iterable[torch.Tensor] = (), exclude=default_exclude,
                    act_scales: Optional[Dict[str, float]] = None,
                    exclude_grouped: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """A new flat params dict (the JAX package's layout, numpy) with int8
    conv weights and scales, from the f32 weights `params` (`load_flat`).

    Convs whose path `exclude` rejects, or whose activation scale is below
    1e-6, keep their f32 kernel. `exclude_grouped` also keeps every conv
    with groups > 1; it defaults to the RT3D_QUANT_NO_GROUPED environment
    variable, as in the JAX package. Without `act_scales` the model is
    calibrated on `calib_images`."""
    if exclude_grouped is None:
        exclude_grouped = bool(os.environ.get("RT3D_QUANT_NO_GROUPED"))
    meta = collect_conv_meta(model)
    if act_scales is None:
        act_scales = collect_act_scales(model, calib_images)
    out: Dict[str, np.ndarray] = {}
    quantized: List[str] = []
    for key, w in params.items():
        if not key.endswith("/kernel"):
            out[key] = w
            continue
        path = key[: -len("/kernel")]
        a = act_scales.get(path)
        if a is None or a < 1e-6 or exclude(path):
            out[key] = w
            continue
        if exclude_grouped and meta.get(path, {}).get("groups", 1) > 1:
            out[key] = w
            continue
        wf = np.asarray(w, np.float32)  # (k, k, cin/g, cout)
        wmax = np.abs(wf).reshape(-1, wf.shape[-1]).max(axis=0)
        wscale = np.maximum(wmax, 1e-12) / 127.0
        wq = np.clip(np.rint(wf / wscale), -127, 127).astype(np.int8)
        out[path + "/kernel_q8"] = wq
        out[path + "/kernel_scale"] = wscale.astype(np.float32)
        out[path + "/act_scale"] = np.float32(a)
        quantized.append(path)
    if not quantized:
        raise ValueError("no conv layer was quantized (bad act_scales?)")
    return out


def is_quantized(params) -> bool:
    """A flat params dict with int8 convs, or a model holding a `QConv`."""
    if isinstance(params, torch.nn.Module):
        return any(isinstance(m, QConv) for m in params.modules())
    return any(k.endswith("/kernel_q8") for k in params)


def quantize_model(model: YoloSeg, flat: Dict[str, np.ndarray],
                   act_scales: Optional[Dict[str, float]] = None) -> Dict[str, np.ndarray]:
    """Swap a `QConv` in for each quantized conv of `model`, in place, on
    the conv's device, and load its int8 weight, scales and f32 bias.

    `flat` is either a quantized params dict (JAX's layout, numpy: what
    `quantize_params` returns on either package), loaded as it is, or the
    f32 weights, quantized here against `act_scales` with the default
    exclusions. Returns the quantized dict."""
    from rt3d_torch.models.yolo import state_dict_from_npz

    if not is_quantized(flat):
        if act_scales is None:
            raise ValueError("quantize_model: f32 weights need act_scales")
        flat = quantize_params(model, flat, (), act_scales=act_scales)
    for path in [k[: -len("/kernel_q8")] for k in flat if k.endswith("/kernel_q8")]:
        name = path.replace("/", ".")
        conv = model.get_submodule(name)
        if not isinstance(conv, QConv):
            cout, cin_g, k, _ = conv.weight.shape
            q = QConv(cin_g * conv.groups, cout, k, conv.stride, conv.groups,
                      device=conv.weight.device)
            parent, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, leaf, q)
            conv = q
        sd = state_dict_from_npz({f"{path}/{leaf}": flat[f"{path}/{leaf}"]
                                  for leaf in ("kernel_q8", "kernel_scale", "act_scale", "bias")})
        conv.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()}, strict=True)
    model.generation += 1
    return flat


def model_act_scales(model: YoloSeg) -> Dict[str, float]:
    """The activation scale of every `QConv` of `model`, by conv path."""
    return {p: float(m.act_scale) for p, m in _conv_paths(model).items()
            if isinstance(m, QConv)}


def weights_fingerprint(weights_path: str) -> str:
    """sha256 of the weights artifact, prefixed for format evolution."""
    h = hashlib.sha256()
    with open(weights_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def save_act_scales(path: str, scales: Dict[str, float],
                    weights_path: Optional[str] = None,
                    calibration: Optional[dict] = None) -> None:
    """Writes `{"scales": {...}, "weights_fingerprint": ...}` (the JAX
    package's sidecar format); `calibration` is recorded verbatim."""
    doc: dict = {"scales": dict(sorted(scales.items()))}
    if weights_path is not None:
        doc["weights_fingerprint"] = weights_fingerprint(weights_path)
    if calibration is not None:
        doc["calibration"] = calibration
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_act_scales(path: str, weights_path: Optional[str] = None
                    ) -> Optional[Dict[str, float]]:
    """The scales, or None when `weights_path` is given and the sidecar's
    fingerprint does not match it (callers then calibrate live). A legacy
    sidecar (a bare {path: scale} dict) loads as it is."""
    with open(path) as f:
        doc = json.load(f)
    if "scales" not in doc:
        return {k: float(v) for k, v in doc.items()}
    fp = doc.get("weights_fingerprint")
    if fp and weights_path is not None:
        actual = weights_fingerprint(weights_path)
        if actual != fp:
            print(f"# {path}: stale sidecar (weights fingerprint "
                  f"{actual[:20]}... != recorded {fp[:20]}...); "
                  "recalibrating", file=sys.stderr)
            return None
    return {k: float(v) for k, v in doc["scales"].items()}


def sidecar_path(weights_path: str) -> str:
    """`<weights>.act_scales.json` beside the weights file."""
    return os.path.splitext(weights_path)[0] + ".act_scales.json"


def synth_calib_batches(pipe, src, frames=(0, 7, 23, 41)) -> List[torch.Tensor]:
    """Calibration batches from a frame source through the pipeline's own
    preprocessing (letterbox and scale), on the pipeline's device: the
    detector's input, also where SAM is the mask model (`SamInput.images`)."""
    batches = [pipe.preprocess(torch.as_tensor(src.get(f).rgb, device=pipe.device))
               for f in frames]
    return [b if isinstance(b, torch.Tensor) else b.images for b in batches]


def quantize_pipeline(pipe, weights_path: Optional[str],
                      calib_images: Iterable[torch.Tensor] = (),
                      act_scales: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Quantize `pipe.model` in place from the f32 weights of
    `weights_path` (without one, the model's own parameters, as the JAX
    apps quantize their random ones): against `act_scales` when given,
    else calibrated live on `calib_images`. Returns the activation scales
    used."""
    flat = load_flat(weights_path, pipe.model) if weights_path else flat_from_model(pipe.model)
    if act_scales is None:
        act_scales = collect_act_scales(pipe.model, calib_images)
    quantize_model(pipe.model, flat, act_scales)
    return act_scales

