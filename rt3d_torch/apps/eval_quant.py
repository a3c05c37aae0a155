"""fp against int8 detection accuracy of a weights artifact on the card
(port of `tools/eval_quant_chip.py`).

    python -m rt3d_torch.apps.eval_quant weights/yolo11x_synth_seg.npz

Runs `rt3d_torch.train.eval.evaluate_weights` twice on the same pipeline
and scenes (seed 777, one object for the camera rig, conf 0.25): with the
float weights, then with the backbone's convs int8
(`rt3d_torch.models.quant`), because the card's int8 and bf16 numerics can
differ from the CPU's on which the accuracy tests run. The int8 model is
quantized against the sidecar's scales (``--scales``, else
`<weights>.act_scales.json`) when its fingerprint matches the weights, else
calibrated live on four frames of the seed-4242 two-object scene.
``RT3D_QUANT_NO_GROUPED=1`` keeps the grouped convs in the compute dtype.

Prints one JSON line with the JAX tool's keys: ``variant``, ``weights``,
``frames``, ``grouped_excluded``, ``mask_bf16``, ``preproc_bf16``, ``fp``,
``scales`` and ``int8`` (``--skip-fp`` and ``--skip-int8`` leave out
theirs). The flags are the JAX tool's plus ``--device`` (default ``cuda``;
a CUDA device without a card is refused).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence

CONF = 0.25
EVAL_SCENE = dict(num_objects=1, seed=777)    # evaluate_weights' own defaults
CALIB_SCENE = dict(num_objects=2, seed=4242)  # live calibration without a sidecar


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("weights", help="trained .npz artifact")
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--skip-fp", action="store_true")
    p.add_argument("--skip-int8", action="store_true")
    p.add_argument("--scales", default=None,
                   help="act-scales JSON to use instead of the default sidecar "
                        "(e.g. a --pct calibration)")
    p.add_argument("--mask-bf16", action="store_true",
                   help="evaluate with the bf16 retina-mask upsample "
                        "(ModelConfig.mask_resize_dtype)")
    p.add_argument("--preproc-bf16", action="store_true",
                   help="evaluate with the bf16 letterbox preprocess "
                        "(ModelConfig.preprocess_dtype)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the tests pass cpu)")
    return p.parse_args(argv)


def evaluate(args: argparse.Namespace) -> dict:
    """The record that `main` prints."""
    from rt3d_torch.apps.common import check_args
    from rt3d_torch.config import reference_2cam_config, with_cameras
    from rt3d_torch.io.synthetic import SyntheticSource
    from rt3d_torch.models import quant
    from rt3d_torch.models.yolo import load_flat
    from rt3d_torch.pipeline.step import build_pipeline
    from rt3d_torch.train.eval import evaluate_weights

    check_args(args)
    with open(os.path.splitext(args.weights)[0] + ".json") as f:
        manifest = json.load(f)
    variant, input_hw = manifest["variant"], tuple(manifest["input_hw"])
    cfg = reference_2cam_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, variant=variant, input_hw=input_hw, conf_thresh=CONF,
        mask_resize_dtype="bfloat16" if args.mask_bf16 else "float32",
        preprocess_dtype="bfloat16" if args.preproc_bf16 else "float32"))
    src0 = SyntheticSource(num_cameras=2, num_frames=None, hw=(720, 1280), **EVAL_SCENE)
    pipe = build_pipeline(with_cameras(cfg, src0.cameras()), weights=args.weights,
                          device=args.device)
    flat = load_flat(args.weights, pipe.model)
    record = {
        "variant": variant,
        "weights": os.path.basename(args.weights),
        "frames": args.frames,
        "grouped_excluded": bool(os.environ.get("RT3D_QUANT_NO_GROUPED")),
        "mask_bf16": args.mask_bf16,
        "preproc_bf16": args.preproc_bf16,
    }
    ev = dict(variant=variant, input_hw=input_hw, num_frames=args.frames, pipe=pipe)
    if not args.skip_fp:
        record["fp"] = evaluate_weights(flat, **ev)
    if not args.skip_int8:
        sidecar = args.scales or quant.sidecar_path(args.weights)
        scales = (quant.load_act_scales(sidecar, weights_path=args.weights)
                  if os.path.exists(sidecar) else None)
        record["scales"] = os.path.basename(sidecar) if scales else "calibrated"
        if scales is None:
            print(f"# no sidecar at {sidecar}; calibrating", file=sys.stderr)
            src = SyntheticSource(num_cameras=2, num_frames=None, hw=(720, 1280),
                                  **CALIB_SCENE)
            qflat = quant.quantize_params(pipe.model, flat, quant.synth_calib_batches(pipe, src))
        else:
            qflat = quant.quantize_params(pipe.model, flat, (), act_scales=scales)
        quant.quantize_model(pipe.model, qflat)
        record["int8"] = evaluate_weights(qflat, **ev)
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    print(json.dumps(evaluate(parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
