"""Weight conversion CLI (port of `rt3d/apps/convert_weights.py`):
ultralytics .pt -> the flat .npz the pipeline loads, checked against the
port's `YoloSeg`.

    python -m rt3d_torch.apps.convert_weights yolo11x-seg.pt --variant x \
        --out yolo11x-seg.npz
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint", help="ultralytics .pt path")
    p.add_argument("--variant", default="x", choices=["n", "s", "m", "l", "x"])
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--out", default=None, help="output .npz (default: <ckpt>.npz)")
    p.add_argument("--input-hw", default="384,640")
    args = p.parse_args(argv)

    h, w = (int(v) for v in args.input_hw.split(","))
    out = args.out or args.checkpoint.rsplit(".", 1)[0] + ".npz"

    from rt3d_torch.models.convert import convert_checkpoint
    from rt3d_torch.models.yolo import YoloSeg

    model = YoloSeg(variant=args.variant, num_classes=args.num_classes, input_hw=(h, w))
    params = convert_checkpoint(args.checkpoint, model, out_path=out)
    n = sum(int(v.size) for v in params.values())
    print(f"converted {len(params)} tensors ({n/1e6:.1f}M params) -> {out}")
    print("verified: exact 1:1 coverage of the port's YoloSeg state dict")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
