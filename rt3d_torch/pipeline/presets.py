"""The reference presets on the synthetic rig, as the card's scripts drive
them (`chip_smoke.py`, `python3 -m rt3d_torch.stage_times`).

Each preset is its config function, its number of cameras and its
committed weights. The rig's calibration comes from the synthetic source,
as a deployment reads it from its cameras; the preset keeps its own frame
rate and depth floor.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

from rt3d_torch.config import (
    reference_1cam_config, reference_2cam_config, reference_2cam_cpu_config,
    with_cameras,
)
from rt3d_torch.io import SyntheticSource
from rt3d_torch.pipeline.step import Pipeline, build_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (config, cameras, weights under weights/)
PRESETS = {
    "2cam": (reference_2cam_config, 2, "yolo11x_synth_seg.npz"),
    "2cam_cpu": (reference_2cam_cpu_config, 2, "yolo11x_synth_seg.npz"),
    "1cam": (reference_1cam_config, 1, "yolo11l_synth_seg.npz"),
}


def synthetic_preset(name: str, frames: int, device="cuda", plain_kernels: bool = False
                     ) -> Tuple[Pipeline, SyntheticSource]:
    """(pipeline, source) of preset `name` on HD720 synthetic cameras with
    two objects, scene seed 0."""
    make, cameras, weights = PRESETS[name]
    cfg = make()
    src = SyntheticSource(num_cameras=cameras, num_frames=frames, hw=(720, 1280),
                          num_objects=2, seed=0)
    cam = cfg.rig.cameras[0]
    cfg = with_cameras(cfg, [dataclasses.replace(c, fps=cam.fps, depth_min_m=cam.depth_min_m)
                             for c in src.cameras()])
    pipe = build_pipeline(cfg, weights=os.path.join(ROOT, "weights", weights),
                          device=device, plain_kernels=plain_kernels)
    return pipe, src
