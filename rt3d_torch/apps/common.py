"""Shared CLI plumbing for the port's app entry points (port of
`rt3d/apps/common.py`).

The flags are the JAX apps', plus ``--device`` (default ``cuda``). A CUDA
device without a card is refused. ``--quantize`` runs the backbone int8
(`maybe_quantize`); ``--live`` publishes into a spool that
`rt3d_torch.apps.viewer` tails (`rt3d_torch.viz.live`); ``--save-frames``
writes annotated frames with cv2, which it imports where it writes, as the
JAX apps do (so without cv2 it fails there).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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
                   help="write annotated frames as PNGs")
    p.add_argument("--live", default=None, metavar="SPOOL_DIR",
                   help="publish latest outputs for `rt3d_torch.apps.viewer`")
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
                   help="int8 W8A8 backbone convs, calibrated on the source unless the "
                        "weights' act-scales sidecar matches them")


def check_args(args) -> None:
    """Refuse a CUDA device when none is available (`RuntimeError`): the
    apps never fall back to the CPU."""
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


def maybe_quantize(pipe, source, args, calib_frames: int = 4):
    """``--quantize``: the int8 conversion of the pipeline's backbone convs
    (`rt3d_torch.models.quant`), against the scales of the weights'
    sidecar when its fingerprint matches the weights, else calibrated live
    on the first `calib_frames` frames of `source` through the pipeline's
    preprocessing, as the JAX apps do. Returns the activation scales, or
    None without the flag."""
    if not getattr(args, "quantize", False):
        return None
    from rt3d_torch.models import quant

    scales = None
    w = pipe.cfg.model.weights
    if w:
        sp = quant.sidecar_path(w)
        if os.path.exists(sp):
            scales = quant.load_act_scales(sp, weights_path=w)
    batches = () if scales else quant.synth_calib_batches(
        pipe, source, frames=tuple(range(calib_frames)))
    return quant.quantize_pipeline(pipe, w, batches, scales)
