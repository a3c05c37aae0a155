"""Detection + tracking demo CLI (port of `rt3d/apps/track_only.py`), the
`1cam/yolo11_tracking.py` analog: no clouds, a per-box centre-depth lookup
(`1cam/yolo11_tracking.py:89-111`). The pipeline's `preprocess`, `detect`
and `track` stages run eagerly on the device; each frame prints one line
per detection, every 30th frame an FPS line.

    python -m rt3d_torch.apps.track_only --source seq.rts --frames 100 --device cuda
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch


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
    from rt3d_torch.viz.draw import annotate_frame
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
        spool = LiveSpool(args.live, every=5) if args.live else None
        state = pipe.init_state()
        for i in range(args.frames):
            t0 = time.perf_counter()
            pkt = src.get(i)
            with torch.no_grad():
                images = pipe.preprocess(torch.from_numpy(pkt.rgb).to(pipe.device))
                det, _, emb = pipe.detect(images)
                state, ids = pipe.track(state, det, det_emb=emb, images=images)
            boxes, scores, classes, valid, tids = (
                t[0].cpu().numpy() for t in (det.boxes, det.scores, det.classes, det.valid, ids))
            dt = time.perf_counter() - t0
            depth = pkt.depth[0]
            h, w = depth.shape
            for k in range(len(boxes)):
                if valid[k]:
                    cx = int((boxes[k, 0] + boxes[k, 2]) / 2)
                    cy = int((boxes[k, 1] + boxes[k, 3]) / 2)
                    z = depth[min(max(cy, 0), h - 1), min(max(cx, 0), w - 1)]
                    print(f"frame {i}: id={int(tids[k])} cls={int(classes[k])} "
                          f"conf={float(scores[k]):.2f} depth@centre={z:.2f} m")
            if i % 30 == 0:
                print(f"frame {i}: {1.0 / max(dt, 1e-9):.1f} FPS")
            img_cache = []

            def make_img():
                if not img_cache:
                    img_cache.append(annotate_frame(pkt.rgb[0], boxes, scores, classes, valid,
                                                    tids, fps=1.0 / max(dt, 1e-9)))
                return img_cache[0]

            if spool is not None:
                spool.publish_frame(i, panel_fn=make_img, detections=int(valid.sum()))
            if args.save_frames and i % 30 == 0:
                import cv2

                cv2.imwrite(os.path.join(args.log_dir, f"track_{i:05d}.png"), make_img())
    finally:
        src.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
