"""Per-stage wall-clock capture + the reference CSV schemas (a copy of
`rt3d/runtime/timing.py`, which the port may not import).

The reference appends per-stage `time.time()` spans to a dict and rewrites
`timings.csv` every frame plus appends to `fps_log.csv`
(`2cam/2cams_mask_gpu.py:31-41,418-428`). Stage names are kept identical so
`visualizer_fps.py` / `visualizer_performance.py` equivalents plot either
system, and the files have the JAX package's layout row for row. The
driver's `profile` mode (stages run one by one, each ended by a device
synchronize) fills every row; in `fused` mode only totals and FPS are
meaningful.
"""

from __future__ import annotations

import csv
import time
from typing import Dict, List, Optional

STAGES = (
    "Frame Retrieval",
    "Depth Retrieval",
    "Point Cloud Processing",
    "YOLO11 Inference",
    "Mask Processing",
    "Point Cloud Fusion",
    "Subtraction",
    "Total Time per Iteration",
)


class TimingLog:
    def __init__(self, fps_log_path: Optional[str] = None,
                 timings_path: Optional[str] = None):
        self.values: Dict[str, List[float]] = {s: [] for s in STAGES}
        self.fps_log_path = fps_log_path
        self.timings_path = timings_path
        if fps_log_path:
            with open(fps_log_path, "w", newline="") as f:
                csv.writer(f).writerow(["Timestamp", "FPS"])

    def add(self, stage: str, seconds: float) -> None:
        self.values.setdefault(stage, []).append(seconds)

    def span(self, stage: str):
        log = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                log.add(stage, time.perf_counter() - self.t0)

        return _Span()

    def end_iteration(self, total_seconds: float) -> None:
        """Record the frame total and append its FPS to `fps_log.csv`."""
        self.add("Total Time per Iteration", total_seconds)
        fps = 1.0 / max(total_seconds, 1e-9)
        if self.fps_log_path:
            with open(self.fps_log_path, "a", newline="") as f:
                csv.writer(f).writerow([time.time(), fps])

    def write_timings(self) -> None:
        """Write the reference's `timings.csv` schema: one row per stage,
        comma-joined per-frame values (`vision_pipeline_utils.py:350-355`)."""
        if not self.timings_path:
            return
        with open(self.timings_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Step", "Timings"])
            for step, vals in self.values.items():
                if vals:
                    w.writerow([step, ",".join(map(str, vals))])

    def summary_ms(self) -> Dict[str, float]:
        out = {}
        for step, vals in self.values.items():
            if vals:
                v = vals[1:] if len(vals) > 1 else vals  # drop warmup frame
                out[step] = 1000.0 * sum(v) / len(v)
        return out
