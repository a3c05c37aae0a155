"""The reference presets on the synthetic rig, as the card's scripts drive
them (`chip_smoke.py`, `python3 -m rt3d_torch.stage_times`) and as the
JAX golden of `tools/make_torch_golden.py` records them.

Each preset is a reference config function, overrides of its model,
tracker and pipeline fields, its number of cameras and its committed
weights. The rig's calibration comes from the synthetic source, as a
deployment reads it from its cameras; the preset keeps its own frame rate
and depth floor. The last four are the JAX package's benchmark rows
(`bench.py`): `stretch_4cam_1mm` its `stretch_4cam_1mm_accum_n` (4 cameras,
the n model, 1 mm voxels with the capacities grown to the ray counts,
accumulation fed with the raw rays; conf and dedupe left at the gpu
preset's, as that row leaves them), `2cam_botsort` and `2cam_deepsort` its
`botsort` and `deepsort` rows, and `2cam_int8` the default row with
``RT3D_BENCH_QUANT=1``: the backbone's convs int8 (`rt3d_torch.models.quant`),
calibrated live on the first `CALIB_FRAMES` frames of the preset's source
(the x model's committed sidecar is stale against its weights), with the
preprocess and mask-resize dtypes pinned to float32 as that row pins them.

The tracker presets watch a scene of six objects (seed 4), on which
BoT-SORT, DeepSORT and ByteTrack give three different sets of track IDs
from the second frame on; the others watch two objects (seed 0).
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
from rt3d_torch.models.quant import quantize_pipeline, synth_calib_batches
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
    scene: Dict = field(default_factory=dict)     # SyntheticSource overrides
    quantize: bool = False      # int8 backbone, calibrated live

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

CALIB_FRAMES = 4
TRACKER_SCENE = dict(num_objects=6, seed=4)

PRESETS = {
    "2cam": Preset(reference_2cam_config, 2, "yolo11x_synth_seg.npz"),
    "2cam_cpu": Preset(reference_2cam_cpu_config, 2, "yolo11x_synth_seg.npz"),
    "1cam": Preset(reference_1cam_config, 1, "yolo11l_synth_seg.npz"),
    "stretch_4cam_1mm": Preset(reference_2cam_config, 4, "yolo11n_synth_seg.npz",
                               model=dict(variant="n"), pipeline=STRETCH_PIPELINE),
    "2cam_botsort": Preset(reference_2cam_config, 2, "yolo11x_synth_seg.npz",
                           tracker=dict(tracker_type="botsort", with_reid=True, gmc=True),
                           scene=TRACKER_SCENE),
    "2cam_deepsort": Preset(reference_2cam_config, 2, "yolo11x_synth_seg.npz",
                            tracker=dict(tracker_type="deepsort", with_reid=True),
                            scene=TRACKER_SCENE),
    "2cam_int8": Preset(reference_2cam_config, 2, "yolo11x_synth_seg.npz",
                        model=dict(preprocess_dtype="float32", mask_resize_dtype="float32"),
                        quantize=True),
}


def preset_source(name: str, frames: int) -> SyntheticSource:
    """The preset's HD720 synthetic cameras, scene seed 0, with two objects
    unless the preset's scene says otherwise."""
    scene = {"num_objects": 2, "seed": 0, **PRESETS[name].scene}
    return SyntheticSource(num_cameras=PRESETS[name].cameras, num_frames=frames,
                           hw=(720, 1280), **scene)


def preset_weights(name: str) -> str:
    return os.path.join(ROOT, "weights", PRESETS[name].weights)


def preset_config(name: str, src: SyntheticSource, dtype: Optional[str] = None,
                  pipeline: Optional[Dict] = None) -> Config:
    """Preset `name` on the cameras of `src`; ``dtype`` (e.g. "float32")
    replaces the model's compute, preprocess and mask-resize dtypes, and
    `pipeline` overrides fields of its `PipelineConfig` (e.g.
    ``{"sor_nb_neighbors": 50}``)."""
    cfg = PRESETS[name].config()
    if pipeline:
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, **pipeline))
    cam = cfg.rig.cameras[0]
    cfg = with_cameras(cfg, [dataclasses.replace(c, fps=cam.fps, depth_min_m=cam.depth_min_m)
                             for c in src.cameras()])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype, preprocess_dtype=dtype, mask_resize_dtype=dtype))
    return cfg


def synthetic_preset(name: str, frames: int, device="cuda", plain_kernels: bool = False,
                     dtype: Optional[str] = None,
                     act_scales: Optional[Dict[str, float]] = None,
                     pipeline: Optional[Dict] = None) -> Tuple[Pipeline, SyntheticSource]:
    """(pipeline, source) of preset `name`, its model in `dtype` and its
    pipeline config overridden by `pipeline` when given. A quantized
    preset's model is quantized against `act_scales` when given, else
    calibrated live on frames 0 to `CALIB_FRAMES` - 1."""
    src = preset_source(name, frames)
    pipe = build_pipeline(preset_config(name, src, dtype, pipeline), weights=preset_weights(name),
                          device=device, plain_kernels=plain_kernels)
    if PRESETS[name].quantize:
        batches = () if act_scales else synth_calib_batches(pipe, src, range(CALIB_FRAMES))
        quantize_pipeline(pipe, preset_weights(name), batches, act_scales)
    return pipe, src
