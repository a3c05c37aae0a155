"""Two-camera reconstruction pipeline CLI (port of `rt3d/apps/two_cam.py`),
the `2cam/2cams.py` / `2cams_mask_gpu.py` analog: the full detect -> track
-> clouds -> fuse -> subtract loop with CSV logging, optional PLY and
annotated-frame dumps every 30 frames, and a live spool for the viewer.

    python -m rt3d_torch.apps.two_cam --source seq.rts --frames 100 --device cuda
    python -m rt3d_torch.apps.two_cam --source seq.rts --live spool &
    python -m rt3d_torch.apps.viewer spool
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from rt3d_torch.apps.common import (
        add_common_args, adopt_source_calibration, check_args, describe_source,
        load_config, maybe_quantize, open_source,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    args = p.parse_args(argv)
    check_args(args)

    from rt3d_torch.pipeline.step import build_pipeline
    from rt3d_torch.runtime.driver import PipelineDriver
    from rt3d_torch.viz.cloud import save_ply
    from rt3d_torch.viz.draw import annotate_frame, side_by_side
    from rt3d_torch.viz.live import LiveSpool

    cfg = load_config(args, num_cameras=2)
    cam = cfg.rig.cameras[0].intrinsics
    src = open_source(args, 2, hw=(cam.height, cam.width))
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

        spool = LiveSpool(args.live, every=5, subsample=0.25) if args.live else None

        def on_frame(i, out):
            if spool is not None:
                spool.publish(i, out, rgb_fn=lambda: src.get(i).rgb)
            if i % 30:
                return
            if args.save_ply:
                ws = out.workspace.points[out.workspace.valid].cpu().numpy()
                save_ply(os.path.join(args.log_dir, f"workspace_{i:05d}.ply"), ws)
                ob = out.objects_flat.points[out.objects_flat.valid].cpu().numpy()
                if len(ob):
                    save_ply(os.path.join(args.log_dir, f"objects_{i:05d}.ply"), ob)
            if args.save_frames:
                import cv2

                rgb = src.get(i).rgb
                d = out.detections
                boxes, scores, classes, valid, ids = (
                    t.cpu().numpy() for t in (d.boxes, d.scores, d.classes, d.valid,
                                              out.track_ids))
                frames = [annotate_frame(rgb[c], boxes[c], scores[c], classes[c], valid[c],
                                         ids[c]) for c in range(2)]
                cv2.imwrite(os.path.join(args.log_dir, f"frame_{i:05d}.png"),
                            side_by_side(*frames))

        use_cb = args.save_ply or args.save_frames or spool is not None
        res = driver.run(src, num_frames=args.frames, warmup=args.warmup,
                         on_frame=on_frame if use_cb else None)
    finally:
        src.close()
    print(f"frames={res.frames} mean_fps={res.mean_fps:.2f} "
          f"median={res.median_fps:.2f} max={res.max_fps:.2f}")
    for k, v in res.summary_ms.items():
        print(f"  {k}: {v:.2f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
