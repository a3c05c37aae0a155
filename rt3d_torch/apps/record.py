"""Sequence recorder CLI (port of `rt3d/apps/record.py`): a synthetic scene
-> the .rts file the replay stack consumes. For the same arguments the file
is the JAX recorder's, byte for byte, but for the `generator` string of its
metadata.

    python -m rt3d_torch.apps.record seq.rts --frames 120
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", help="output .rts path")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--cameras", type=int, default=2)
    p.add_argument("--objects", type=int, default=1)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from rt3d_torch.io.format import camera_meta, write_sequence
    from rt3d_torch.io.synthetic import SyntheticSource

    src = SyntheticSource(
        num_cameras=args.cameras, num_frames=args.frames,
        hw=(args.height, args.width), num_objects=args.objects, seed=args.seed)
    rgb = np.zeros((args.frames, args.cameras, args.height, args.width, 3), np.uint8)
    depth = np.zeros((args.frames, args.cameras, args.height, args.width), np.float32)
    for i in range(args.frames):
        pkt = src.get(i)
        rgb[i] = pkt.rgb
        depth[i] = pkt.depth
    meta = {
        "cameras": [
            camera_meta(
                c.intrinsics.fx, c.intrinsics.fy, c.intrinsics.cx, c.intrinsics.cy,
                [list(r) for r in c.extrinsics.rotation],
                list(c.extrinsics.translation), serial=c.serial, fps=c.fps)
            for c in src.cameras()
        ],
        "generator": "rt3d_torch.apps.record synthetic",
        "objects": args.objects,
        "seed": args.seed,
    }
    spec = write_sequence(args.out, rgb, depth, meta)
    size_mb = (spec.data_offset + spec.frame_record_size * spec.n_frames) / 1e6
    print(f"wrote {args.out}: {spec.n_frames} frames x {spec.n_cams} cams "
          f"@ {spec.height}x{spec.width} ({size_mb:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
