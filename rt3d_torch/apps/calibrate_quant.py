"""Precompute int8 activation scales for a weights artifact (port of
`tools/calibrate_quant.py`).

    python -m rt3d_torch.apps.calibrate_quant weights/yolo11x_synth_seg.npz \\
        --out /tmp/x.act_scales.json

Writes `<weights>.act_scales.json` beside the ``.npz`` unless ``--out``
names another file: the sidecar that ``--quantize`` on the apps loads when
its weights fingerprint matches, so a deployment skips the live
calibration. The file has the JAX tool's format (`scales`,
`weights_fingerprint`, and `calibration` with its `mode`, `pct` and
`frames`), which either package reads.

It calibrates on the synthetic two-camera HD720 scenes of one object (seed
0) and of two (seed 7), on frames 0, 4, 8, ... of each, through the
pipeline's own preprocessing: what the deployed conv stack sees. ``--pct``
records that percentile of |x| per frame instead of the max. The flags are
the JAX tool's plus ``--device`` (default ``cuda``; a CUDA device without a
card is refused).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

# the scenes calibrated on: (objects, seed)
SCENES = ((1, 0), (2, 7))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("weights", help="trained .npz artifact")
    p.add_argument("--frames", type=int, default=6, help="calibration frames per scene")
    p.add_argument("--out", default=None,
                   help="output JSON (default: <weights>.act_scales.json)")
    p.add_argument("--pct", type=float, default=None,
                   help="calibrate to this percentile of |x| per frame instead of the max "
                        "(e.g. 99.9); compare accuracy with rt3d_torch.apps.eval_quant "
                        "before shipping")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the tests pass cpu)")
    return p.parse_args(argv)


def calibrate(args: argparse.Namespace) -> dict:
    """Calibrate and write the sidecar; returns its path, scales and
    calibration record."""
    from rt3d_torch.apps.common import check_args
    from rt3d_torch.config import reference_2cam_config, with_cameras
    from rt3d_torch.io.synthetic import SyntheticSource
    from rt3d_torch.models import quant
    from rt3d_torch.pipeline.step import build_pipeline

    check_args(args)
    with open(os.path.splitext(args.weights)[0] + ".json") as f:
        manifest = json.load(f)
    cfg = reference_2cam_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, variant=manifest["variant"], input_hw=tuple(manifest["input_hw"])))
    srcs = [SyntheticSource(num_cameras=2, num_frames=None, hw=(720, 1280),
                            num_objects=n, seed=s) for n, s in SCENES]
    pipe = build_pipeline(with_cameras(cfg, srcs[0].cameras()), weights=args.weights,
                          device=args.device)
    frames = tuple(range(0, 4 * args.frames, 4))
    batches = [b for s in srcs for b in quant.synth_calib_batches(pipe, s, frames=frames)]
    scales = quant.collect_act_scales(pipe.model, batches, pct=args.pct)
    out = args.out or quant.sidecar_path(args.weights)
    calibration = {"mode": "pct", "pct": args.pct} if args.pct else {"mode": "max"}
    calibration["frames"] = len(batches)
    quant.save_act_scales(out, scales, weights_path=args.weights, calibration=calibration)
    return {"out": out, "scales": scales, "calibration": calibration}


def main(argv: Optional[Sequence[str]] = None) -> int:
    res = calibrate(parse_args(argv))
    print(f"wrote {len(res['scales'])} act scales -> {res['out']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
