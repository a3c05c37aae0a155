"""Offline plot CLI (port of `rt3d/apps/plots.py`): the reference's
`visualizer_fps.py` + `visualizer_performance.py` over an app's
`fps_log.csv` and `timings.csv`.

    python -m rt3d_torch.apps.plots --log-dir runs
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log-dir", default="runs")
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)
    out_dir = args.out_dir or os.path.join(args.log_dir, "plots")
    os.makedirs(out_dir, exist_ok=True)

    from rt3d_torch.viz.plots import plot_fps, plot_stage_timings

    fps_csv = os.path.join(args.log_dir, "fps_log.csv")
    tim_csv = os.path.join(args.log_dir, "timings.csv")
    made = []
    if os.path.exists(fps_csv):
        out = plot_fps(fps_csv, os.path.join(out_dir, "fps_over_time_smoothed_30s.png"))
        if out:
            made.append(out)
    if os.path.exists(tim_csv):
        out = plot_stage_timings(tim_csv, os.path.join(out_dir, "average_timing_per_step.png"))
        if out:
            made.append(out)
    print("wrote:", *made if made else ["(nothing — missing CSVs or matplotlib)"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
