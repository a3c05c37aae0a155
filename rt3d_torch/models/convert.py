"""Ultralytics .pt checkpoint -> the flat parameter dict (port of
`rt3d/models/yolo/convert.py`).

The reference loads `yolo11x-seg.pt` through ultralytics
(`2cam/2cams_mask_gpu.py:51`). This converter ingests those checkpoints
WITHOUT ultralytics installed: a stub unpickler materializes unknown classes
as inert shells, the torch module tree is walked for parameters/buffers, and
each conv's BatchNorm is folded into the convolution (eps=1e-3, the
ultralytics BatchNorm2d setting). The result is the JAX package's flat
weight layout (the layout of `weights/*.npz`), which
`rt3d_torch.models.yolo.state_dict_from_npz` turns into the port's
`YoloSeg` state dict; `verify_against_model` checks it against that module
tree, names and shapes.

Key mapping (torch -> flat path):
  model.{i}.{...}.conv.weight (+ sibling .bn.*)  -> {i}/{...}/conv/{kernel,bias}
  model.23.cv2.{l}.2.{weight,bias}               -> 23/cv2/{l}/2/{kernel,bias}
  model.23.proto.upsample.{weight,bias}          -> 23/proto/upsample/{kernel,bias}
  model.23.dfl.conv.weight                       -> dropped (fixed arange; the
                                                   decoder computes it in place)
Weight layout transforms: conv OIHW -> HWIO; ConvTranspose IOHW -> HWIO.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np

from rt3d_torch.models.yolo import state_dict_from_npz

BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# Checkpoint loading without ultralytics
# ---------------------------------------------------------------------------


class _Shell:
    """Inert stand-in for any unpicklable class in the checkpoint."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *a, **k):  # some reduces call the object
        return self


def _load_with_stubs(path: str):
    import torch

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_Shell,), {"__module__": module})

    class _PickleModule:
        Unpickler = StubUnpickler
        load = staticmethod(pickle.load)

    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PickleModule)


def _walk_module(obj, prefix: str, out: Dict[str, np.ndarray]):
    """Recursively extract parameters/buffers from a (possibly stubbed)
    torch nn.Module tree, reproducing state_dict naming."""
    import torch

    d = getattr(obj, "__dict__", {})
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = p.detach().cpu().numpy()
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None and isinstance(b, torch.Tensor):
            out[prefix + name] = b.detach().cpu().numpy()
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            _walk_module(m, prefix + name + ".", out)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load {key: ndarray} from an ultralytics checkpoint or a bare
    state_dict file."""
    import torch

    ckpt = _load_with_stubs(path)
    if isinstance(ckpt, dict) and "model" in ckpt and not isinstance(ckpt["model"], torch.Tensor):
        model = ckpt["model"]
        # ultralytics nests the module list under .model
        sd: Dict[str, np.ndarray] = {}
        _walk_module(model, "", sd)
        if not sd and hasattr(model, "state_dict"):
            sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
        return sd
    if isinstance(ckpt, dict):
        return {
            k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in ckpt.items()
            if isinstance(v, torch.Tensor) or isinstance(v, np.ndarray)
        }
    raise ValueError(f"unrecognized checkpoint structure in {path}")


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


def fuse_conv_bn(
    w: np.ndarray,
    gamma: np.ndarray,
    beta: np.ndarray,
    mean: np.ndarray,
    var: np.ndarray,
    eps: float = BN_EPS,
    conv_bias: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Fold BatchNorm into a conv. w: OIHW. Returns (w', b') with w' OIHW."""
    scale = gamma / np.sqrt(var + eps)
    w_f = w * scale[:, None, None, None]
    b = conv_bias if conv_bias is not None else np.zeros_like(mean)
    b_f = beta + (b - mean) * scale
    return w_f.astype(np.float32), b_f.astype(np.float32)


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _iohw_to_hwio(w: np.ndarray) -> np.ndarray:  # ConvTranspose layout
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def convert_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torch state dict (ultralytics naming, `model.`-prefix optional) ->
    rt3d flat param dict."""
    # normalize: strip a leading "model." only if keys carry it
    keys = list(sd.keys())
    if keys and all(k.startswith("model.") for k in keys):
        sd = {k[len("model."):]: v for k, v in sd.items()}

    out: Dict[str, np.ndarray] = {}
    consumed = set()

    for key in sd:
        if key in consumed:
            continue
        if key.endswith(".conv.weight"):
            base = key[: -len(".conv.weight")]
            bn = f"{base}.bn"
            w = sd[key]
            if f"{bn}.weight" in sd:
                w_f, b_f = fuse_conv_bn(
                    w, sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                    sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                    conv_bias=sd.get(f"{base}.conv.bias"),
                )
                consumed.update({
                    f"{bn}.weight", f"{bn}.bias", f"{bn}.running_mean",
                    f"{bn}.running_var", f"{bn}.num_batches_tracked",
                })
            else:  # conv without BN (e.g. dfl) — keep as-is
                if base.endswith("dfl"):
                    consumed.add(key)
                    continue
                b_f = sd.get(f"{base}.conv.bias", np.zeros(w.shape[0], np.float32))
            consumed.add(key)
            consumed.add(f"{base}.conv.bias")
            p = base.replace(".", "/")
            out[f"{p}/conv/kernel"] = _oihw_to_hwio(w_f)
            out[f"{p}/conv/bias"] = b_f
        elif key.endswith("upsample.weight"):
            base = key[: -len(".weight")]
            p = base.replace(".", "/")
            out[f"{p}/kernel"] = _iohw_to_hwio(sd[key])
            out[f"{p}/bias"] = sd.get(f"{base}.bias", np.zeros(sd[key].shape[1], np.float32))
            consumed.update({key, f"{base}.bias"})

    # bare nn.Conv2d head layers (…cv{2,3,4}.{l}.2.weight) and anything else
    for key in sd:
        if key in consumed or not key.endswith(".weight"):
            continue
        if ".bn." in key or "num_batches_tracked" in key:
            continue
        w = sd[key]
        if w.ndim != 4:
            continue
        base = key[: -len(".weight")]
        if base.endswith("dfl.conv"):
            continue
        p = base.replace(".", "/")
        out[f"{p}/kernel"] = _oihw_to_hwio(w)
        out[f"{p}/bias"] = sd.get(
            f"{base}.bias", np.zeros(w.shape[0], np.float32)
        ).astype(np.float32)
        consumed.update({key, f"{base}.bias"})

    return out


def verify_against_model(params: Dict[str, np.ndarray], model) -> None:
    """Raise unless the converted dict, as a state dict
    (`state_dict_from_npz`), covers the port's `YoloSeg` exactly: the same
    names, the same shapes."""
    got = {k: tuple(v.shape) for k, v in state_dict_from_npz(params).items()}
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = [f"{k}: got {got[k]} want {want[k]}" for k in want
           if k in got and got[k] != want[k]]
    if missing or extra or bad:
        raise ValueError(
            f"conversion mismatch:\n missing={missing[:8]} ({len(missing)})"
            f"\n extra={extra[:8]} ({len(extra)})\n shape={bad[:8]}"
        )


# ---------------------------------------------------------------------------
# npz round-trip
# ---------------------------------------------------------------------------


def save_params(params: Dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def convert_checkpoint(pt_path: str, model, out_path: Optional[str] = None):
    """End-to-end: .pt -> the flat parameter dict, verified against `model`
    (the port's `YoloSeg`), optionally saved to .npz."""
    sd = load_torch_state_dict(pt_path)
    params = convert_state_dict(sd)
    verify_against_model(params, model)
    if out_path:
        save_params(params, out_path)
    return params
