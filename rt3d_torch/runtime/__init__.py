"""Step driver loop, timing capture, CSV logging and checkpoints of the port
(the counterpart of `rt3d/runtime`; `checkpoint` saves and restores the
pipeline state and the model through one ``.npz``), and `trace`, the spans
and counters inside the step.

Mirrors the reference's logging surface exactly (`fps_log.csv` with
`Timestamp,FPS` rows and the per-stage `timings.csv`,
`2cam/vision_pipeline_utils.py:329-355`) so its offline visualizers and the
comparison tooling read either system's output interchangeably.

The names below load on first use: `rt3d_torch.pipeline.step` imports
`trace` from this package, and the driver imports the step.
"""

import importlib

_NAMES = {"STAGES": "timing", "TimingLog": "timing",
          "DriverResult": "driver", "PipelineDriver": "driver",
          "format_op_times": "profiling", "profile_op_times": "profiling"}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
