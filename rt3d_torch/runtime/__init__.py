"""Step driver loop, timing capture, CSV logging and checkpoints of the port
(the counterpart of `rt3d/runtime`; `checkpoint` saves and restores the
pipeline state and the model through one ``.npz``).

Mirrors the reference's logging surface exactly (`fps_log.csv` with
`Timestamp,FPS` rows and the per-stage `timings.csv`,
`2cam/vision_pipeline_utils.py:329-355`) so its offline visualizers and the
comparison tooling read either system's output interchangeably.
"""

from rt3d_torch.runtime.timing import STAGES, TimingLog  # noqa: F401
from rt3d_torch.runtime.driver import DriverResult, PipelineDriver  # noqa: F401
from rt3d_torch.runtime.profiling import format_op_times, profile_op_times  # noqa: F401
