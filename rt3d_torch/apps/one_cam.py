"""Single-camera reconstruction CLI (port of `rt3d/apps/one_cam.py`), the
`1cam/rt-tracking.py` analog: one stream, per-object clouds in the robot
frame, a periodic scene export (PLY every 30 frames, like the reference's
Open3D refresh at `1cam/rt-tracking.py:267-285`) of a random subsample
drawn from a seeded generator, and a live spool for the viewer (every 30
frames, its workspace subsampled alike). As in the JAX app,
``--save-frames`` writes nothing here.

    python -m rt3d_torch.apps.one_cam --source seq.rts --save-ply --device cuda
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    from rt3d_torch.apps.common import (
        add_common_args, adopt_source_calibration, check_args, describe_source,
        load_config, maybe_quantize, open_source,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--subsample", type=float, default=0.05,
                   help="preview cloud keep-fraction (reference uses 5%%)")
    args = p.parse_args(argv)
    check_args(args)

    from rt3d_torch.pipeline.step import build_pipeline
    from rt3d_torch.runtime.driver import PipelineDriver
    from rt3d_torch.viz.cloud import save_ply
    from rt3d_torch.viz.live import LiveSpool

    cfg = load_config(args, num_cameras=1)
    cam = cfg.rig.cameras[0].intrinsics
    src = open_source(args, 1, hw=(cam.height, cam.width))
    try:
        print(describe_source(args, src), flush=True)
        cfg = adopt_source_calibration(cfg, src)
        pipe = build_pipeline(cfg, device=args.device)
        maybe_quantize(pipe, src, args)
        os.makedirs(args.log_dir, exist_ok=True)
        driver = PipelineDriver(
            pipe, mode=args.mode, pipeline_depth=args.pipeline_depth,
            frames_per_dispatch=args.scan,
            fps_log_path=os.path.join(args.log_dir, "fps_log.csv"),
            timings_path=os.path.join(args.log_dir, "timings.csv"))
        rng = np.random.default_rng(0)
        # every-30 + 5% subsample mirror the reference's scene refresh
        # cadence (`1cam/rt-tracking.py:189,267-285`)
        spool = (LiveSpool(args.live, every=30, subsample=args.subsample)
                 if args.live else None)

        def on_frame(i, out):
            if spool is not None:
                spool.publish(i, out, rgb_fn=lambda: src.get(i).rgb)
            if i % 30 or not args.save_ply:
                return
            objs = out.per_camera_objects
            val = objs.valid[0] & objs.present[0][:, None]
            cloud = objs.points[0][val].cpu().numpy()
            if len(cloud):
                keep = rng.uniform(size=len(cloud)) < args.subsample
                sub = cloud[keep] if keep.any() else cloud
                save_ply(os.path.join(args.log_dir, f"objects_{i:05d}.ply"), sub)

        res = driver.run(src, num_frames=args.frames, warmup=args.warmup,
                         on_frame=on_frame if args.save_ply or spool is not None else None)
    finally:
        src.close()
    print(f"frames={res.frames} mean_fps={res.mean_fps:.2f} "
          f"median={res.median_fps:.2f} max={res.max_fps:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
