"""The reference presets on the synthetic rig, as the card's scripts drive
them (`chip_smoke.py`, `python3 -m rt3d_torch.stage_times`) and as the
JAX golden of `tools/make_torch_golden.py` records them.

Each preset is its config function, its number of cameras and its
committed weights. The rig's calibration comes from the synthetic source,
as a deployment reads it from its cameras; the preset keeps its own frame
rate and depth floor.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from rt3d_torch.config import (
    Config, reference_1cam_config, reference_2cam_config, reference_2cam_cpu_config,
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


def preset_source(name: str, frames: int) -> SyntheticSource:
    """The preset's HD720 synthetic cameras with two objects, scene seed 0."""
    return SyntheticSource(num_cameras=PRESETS[name][1], num_frames=frames,
                           hw=(720, 1280), num_objects=2, seed=0)


def preset_weights(name: str) -> str:
    return os.path.join(ROOT, "weights", PRESETS[name][2])


def preset_config(name: str, src: SyntheticSource, dtype: Optional[str] = None) -> Config:
    """Preset `name` on the cameras of `src`; ``dtype`` (e.g. "float32")
    replaces the model's compute, preprocess and mask-resize dtypes."""
    cfg = PRESETS[name][0]()
    cam = cfg.rig.cameras[0]
    cfg = with_cameras(cfg, [dataclasses.replace(c, fps=cam.fps, depth_min_m=cam.depth_min_m)
                             for c in src.cameras()])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype, preprocess_dtype=dtype, mask_resize_dtype=dtype))
    return cfg


def synthetic_preset(name: str, frames: int, device="cuda", plain_kernels: bool = False,
                     dtype: Optional[str] = None) -> Tuple[Pipeline, SyntheticSource]:
    """(pipeline, source) of preset `name`, its model in `dtype` when given."""
    src = preset_source(name, frames)
    pipe = build_pipeline(preset_config(name, src, dtype), weights=preset_weights(name),
                          device=device, plain_kernels=plain_kernels)
    return pipe, src
