"""Shared CLI plumbing for the port's app entry points (port of
`rt3d/apps/common.py`).

The flags are the JAX apps', plus ``--device`` (default ``cuda``). Flags
whose paths the port does not have yet refuse with `NotImplementedError`
naming their ROADMAP item, rather than being ignored: ``--quantize`` (item
14), ``--live`` and ``--save-frames`` (item 15). A CUDA device without a
card is refused too.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

import torch

from rt3d_torch.config import Config, RigConfig, reference_2cam_config, with_cameras


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--source", default="synthetic",
                   help=".rts sequence path, or 'synthetic'")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--variant", default=None, choices=["n", "s", "m", "l", "x"],
                   help="YOLO11 scale")
    p.add_argument("--weights", default=None, help="converted .npz or raw .pt")
    p.add_argument("--config", default=None, help="JSON config path")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (default cuda; the tests pass cpu)")
    p.add_argument("--mode", default="fused", choices=["fused", "profile"])
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="frames in flight (1 = fully synchronous)")
    p.add_argument("--scan", type=int, default=1,
                   help="frames per dispatch (throughput mode; adds "
                        "scan-1 frames of latency)")
    p.add_argument("--warmup", type=int, default=5,
                   help="frames excluded from the measured FPS window")
    p.add_argument("--log-dir", default="runs")
    p.add_argument("--save-ply", action="store_true",
                   help="dump workspace/object clouds as PLY every 30 frames")
    p.add_argument("--save-frames", action="store_true",
                   help="write annotated frames as PNGs (not ported: ROADMAP item 15)")
    p.add_argument("--live", default=None, metavar="SPOOL_DIR",
                   help="publish latest outputs for a viewer (not ported: ROADMAP item 15)")
    p.add_argument("--accumulate", action="store_true",
                   help="persistent workspace accumulation: publish the voxels whose "
                        "decayed weight clears accum_min_weight")
    p.add_argument("--accum-raw", action="store_true",
                   help="with --accumulate: feed the accumulator the snapped raw rays, "
                        "skipping the per-camera dedupe; voxel weights count rays")
    p.add_argument("--tracker", default=None,
                   choices=["bytetrack", "botsort", "deepsort"],
                   help="ID association: bytetrack (reference default), botsort "
                        "(ReID-fused IoU + GMC), deepsort (appearance-primary under a "
                        "Mahalanobis gate)")
    p.add_argument("--quantize", action="store_true",
                   help="int8 W8A8 conv stack (not ported: ROADMAP item 14)")


# flag -> the ROADMAP item that ports its path
_UNPORTED = (
    ("quantize", "--quantize (int8 W8A8) is ROADMAP item 14"),
    ("live", "--live (the live spool and its viewer) is ROADMAP item 15"),
    ("save_frames", "--save-frames (annotated frames, viz.draw and cv2) is ROADMAP item 15"),
)


def check_args(args) -> None:
    """Refuse what the port cannot run: `NotImplementedError` for the first
    set flag whose path is not ported, naming its ROADMAP item; and
    `RuntimeError` for a CUDA device when none is available (the apps never
    fall back to the CPU)."""
    for name, why in _UNPORTED:
        if getattr(args, name, None):
            raise NotImplementedError(why)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")


def load_config(args, num_cameras: Optional[int] = None) -> Config:
    cfg = Config.from_json(args.config) if args.config else reference_2cam_config()
    if args.variant:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant=args.variant))
    if args.weights:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, weights=args.weights))
    if getattr(args, "tracker", None):
        t = args.tracker
        cfg = dataclasses.replace(
            cfg, tracker=dataclasses.replace(
                cfg.tracker, tracker_type=t,
                # botsort's yaml enables ReID+GMC; deepsort implies ReID
                with_reid=t in ("botsort", "deepsort") or cfg.tracker.with_reid,
                gmc=(t == "botsort") or cfg.tracker.gmc))
    if getattr(args, "accumulate", False):
        cfg = dataclasses.replace(
            cfg, pipeline=dataclasses.replace(
                cfg.pipeline, workspace_accumulate=True,
                accum_skip_prededupe=getattr(args, "accum_raw", False)))
    if num_cameras is not None and num_cameras != cfg.rig.num_cameras:
        cams = tuple(cfg.rig.cameras[i % cfg.rig.num_cameras]
                     for i in range(num_cameras))
        cfg = dataclasses.replace(cfg, rig=RigConfig(cameras=cams))
    return cfg


def open_source(args, num_cameras: int, hw: Tuple[int, int] = (720, 1280)):
    if args.source == "synthetic":
        from rt3d_torch.io.synthetic import SyntheticSource

        return SyntheticSource(num_cameras=num_cameras, num_frames=None, hw=hw,
                               num_objects=1)
    from rt3d_torch.io.source import ReplaySource

    return ReplaySource(args.source, loop=True)


def describe_source(args, src) -> str:
    if args.source == "synthetic":
        return "source: synthetic"
    return f"source: {args.source} (replay, backend {src.backend})"


def adopt_source_calibration(cfg: Config, source) -> Config:
    """Use the source's calibration (replay metadata / synthetic model), the
    analog of reading ZED factory calibration at startup."""
    cams = source.cameras()
    return with_cameras(cfg, cams) if cams else cfg
