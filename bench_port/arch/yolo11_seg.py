"""YOLO11-seg (Ultralytics' `yolo11-seg.yaml` at the n, s, m, l and x
scales) with its 32-coefficient proto masks: the architecture of every
configuration file that names none.

The file states the scale (`variant`), `input_hw`, `num_classes` and
`compute_dtype` beside the config overrides that `bench_port.spec.make_config`
applies to `base`. The stated config is built through the frozen copy of
the config functions in `bench_port/reference/config.py`, and the plain
reference is `bench_port/reference/pipeline/step.py`'s pipeline, whose
mask context (the second value of its `detect`) is the prototypes. The
control is the program's own int8 W8A8 path, calibrated live on the first
`control.calib_frames` frames of the cell.
"""

from __future__ import annotations

from bench_port import spec
from bench_port.flops import yolo11_seg_flops

FIELDS = ("variant", "input_hw", "num_classes", "compute_dtype")


def flops_per_image(conf) -> int:
    """One camera image's forward, from the published layer table."""
    return yolo11_seg_flops(conf["variant"], tuple(conf["input_hw"]), conf["num_classes"])


def stated_config(conf, cameras, dtype=None):
    """The configuration the file states, in the reference's frozen config
    classes."""
    from bench_port.reference import config as rconfig

    return spec.make_config(rconfig, conf, cameras, dtype)


def check_program(cfg, conf) -> None:
    """Raise unless the program's model runs the scale, input, classes and
    dtype that the file states."""
    for key in FIELDS:
        got = getattr(cfg.model, key)
        if (list(got) if isinstance(got, tuple) else got) != conf[key]:
            raise ValueError(f"{key} is {got}, the file states {conf[key]}")


def reference_pipeline(conf, cameras, device, weights: str):
    """The plain reference in float32 (`bench_port.check` has turned TF32
    off), with the weights read from the program's file."""
    from bench_port.reference.pipeline.step import build_pipeline

    return build_pipeline(stated_config(conf, cameras, dtype="float32"), weights=weights,
                          device=device)


def control(pipe, weights: str, conf, frames) -> None:
    """Switch on the program's int8 W8A8 path of the YOLO model, calibrated
    on the cell's first `conf["control"]["calib_frames"]` frames."""
    import torch

    from rt3d_torch.models.quant import quantize_pipeline

    batches = [pipe.preprocess(torch.as_tensor(frames[i][0], device=pipe.device))
               for i in range(conf["control"]["calib_frames"])]
    quantize_pipeline(pipe, weights, batches)
