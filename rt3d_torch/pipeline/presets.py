"""The reference presets on the synthetic rig, as the card's scripts drive
them (`chip_smoke.py`, `python3 -m rt3d_torch.stage_times`) and as the
JAX golden of `tools/make_torch_golden.py` records them.

Each preset is a reference config function, overrides of its model,
tracker and pipeline fields, its number of cameras and its committed
weights. The rig's calibration comes from the synthetic source, as a
deployment reads it from its cameras; the preset keeps its own frame rate
and depth floor. The last three are the JAX package's benchmark rows
(`bench.py`): `stretch_4cam_1mm` its `stretch_4cam_1mm_accum_n` (4 cameras,
the n model, 1 mm voxels with the capacities grown to the ray counts,
accumulation fed with the raw rays; conf and dedupe left at the gpu
preset's, as that row leaves them), `2cam_botsort` and `2cam_deepsort` its
`botsort` and `deepsort` rows.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from rt3d_torch.config import (
    Config, reference_1cam_config, reference_2cam_config, reference_2cam_cpu_config,
    with_cameras,
)
from rt3d_torch.io import SyntheticSource
from rt3d_torch.pipeline.step import Pipeline, build_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass(frozen=True)
class Preset:
    base: Callable[[], Config]  # the reference config function
    cameras: int
    weights: str                # file under weights/
    model: Dict = field(default_factory=dict)     # ModelConfig overrides
    tracker: Dict = field(default_factory=dict)   # TrackerConfig overrides
    pipeline: Dict = field(default_factory=dict)  # PipelineConfig overrides

    def config(self) -> Config:
        cfg = self.base()
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **self.model),
            tracker=dataclasses.replace(cfg.tracker, **self.tracker),
            pipeline=dataclasses.replace(cfg.pipeline, **self.pipeline))


STRETCH_PIPELINE = dict(
    voxel_size=0.001, max_points_workspace=262144, max_points_workspace_fused=1048576,
    max_union_voxels=65536, max_points_per_object=8192, max_points_fused_object=16384,
    max_points_fused_flat=32768, workspace_accumulate=True, accum_capacity=1048576,
    accum_skip_prededupe=True)

PRESETS = {
    "2cam": Preset(reference_2cam_config, 2, "yolo11x_synth_seg.npz"),
    "2cam_cpu": Preset(reference_2cam_cpu_config, 2, "yolo11x_synth_seg.npz"),
    "1cam": Preset(reference_1cam_config, 1, "yolo11l_synth_seg.npz"),
    "stretch_4cam_1mm": Preset(reference_2cam_config, 4, "yolo11n_synth_seg.npz",
                               model=dict(variant="n"), pipeline=STRETCH_PIPELINE),
    "2cam_botsort": Preset(reference_2cam_config, 2, "yolo11x_synth_seg.npz",
                           tracker=dict(tracker_type="botsort", with_reid=True, gmc=True)),
    "2cam_deepsort": Preset(reference_2cam_config, 2, "yolo11x_synth_seg.npz",
                            tracker=dict(tracker_type="deepsort", with_reid=True)),
}


def preset_source(name: str, frames: int) -> SyntheticSource:
    """The preset's HD720 synthetic cameras with two objects, scene seed 0."""
    return SyntheticSource(num_cameras=PRESETS[name].cameras, num_frames=frames,
                           hw=(720, 1280), num_objects=2, seed=0)


def preset_weights(name: str) -> str:
    return os.path.join(ROOT, "weights", PRESETS[name].weights)


def preset_config(name: str, src: SyntheticSource, dtype: Optional[str] = None) -> Config:
    """Preset `name` on the cameras of `src`; ``dtype`` (e.g. "float32")
    replaces the model's compute, preprocess and mask-resize dtypes."""
    cfg = PRESETS[name].config()
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
