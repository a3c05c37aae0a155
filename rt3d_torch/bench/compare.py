"""Side-by-side comparison of rt3d runs against reference CSV logs (port of
`rt3d/bench/compare.py`).

Both systems emit the same CSV schemas (`fps_log.csv`: Timestamp,FPS rows;
`timings.csv`: per-stage comma-joined seconds — reference writers at
`2cam/vision_pipeline_utils.py:345-355`), so one loader serves both. The
reference repo ships its captured RTX-4090 logs (`2cam/fps_log.csv`,
`2cam/timings.csv`), which are the baseline columns here. Pass their
directory with `--reference`; without it, or where it is missing, the
reference columns stay blank.

    python -m rt3d_torch.bench.compare --ours runs --reference path/to/2cam
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

from rt3d_torch.viz.plots import _read_fps_log, read_timings


@dataclass
class RunSummary:
    name: str
    fps_mean: float = float("nan")
    fps_median: float = float("nan")
    fps_max: float = float("nan")
    stage_ms: Dict[str, float] = field(default_factory=dict)


def load_run_summary(log_dir: str, name: str = "run",
                     drop_warmup: int = 1) -> RunSummary:
    out = RunSummary(name=name)
    fps_csv = os.path.join(log_dir, "fps_log.csv")
    tim_csv = os.path.join(log_dir, "timings.csv")
    # drop-warmup applies unconditionally: a run shorter than the warmup
    # window yields honest blank columns, never warm-up numbers
    if os.path.exists(fps_csv):
        _, fps = _read_fps_log(fps_csv)
        fps = fps[drop_warmup:]
        if len(fps):
            out.fps_mean = float(np.mean(fps))
            out.fps_median = float(np.median(fps))
            out.fps_max = float(np.max(fps))
    if os.path.exists(tim_csv):
        for stage, vals in read_timings(tim_csv).items():
            v = vals[drop_warmup:]
            if len(v):
                out.stage_ms[stage] = 1000.0 * float(np.mean(v))
    return out


def compare_runs(
    ours_dir: str,
    reference_dir: Optional[str] = None,
    ours_name: str = "rt3d_torch (H100)",
    ref_name: str = "reference (RTX 4090)",
    drop_warmup: int = 1,
) -> str:
    """Formatted comparison table. Missing files degrade to blank columns.

    ``drop_warmup`` frames are dropped from OUR logs only (the first frames
    pay for kernel builds and allocator growth; the reference loads its
    model before its loop, so its warmup is its frame 1). With no
    ``reference_dir`` the reference columns stay blank."""
    ours = load_run_summary(ours_dir, ours_name, drop_warmup=drop_warmup)
    ref = (load_run_summary(reference_dir, ref_name) if reference_dir
           else RunSummary(name=ref_name))

    rows = [f"{'metric':34s} {ours.name:>18s} {ref.name:>22s}   ratio", "-" * 84]

    def fmt(v):
        return f"{v:18.2f}" if np.isfinite(v) else " " * 17 + "-"

    for label, a, b in [
        ("FPS mean", ours.fps_mean, ref.fps_mean),
        ("FPS median", ours.fps_median, ref.fps_median),
        ("FPS max", ours.fps_max, ref.fps_max),
    ]:
        ratio = a / b if np.isfinite(a) and np.isfinite(b) and b else float("nan")
        rows.append(f"{label:34s} {fmt(a)} {fmt(b):>22s}   "
                    + (f"{ratio:.2f}x" if np.isfinite(ratio) else "-"))
    for s in sorted(set(ours.stage_ms) | set(ref.stage_ms)):
        a = ours.stage_ms.get(s, float("nan"))
        b = ref.stage_ms.get(s, float("nan"))
        ratio = b / a if np.isfinite(a) and np.isfinite(b) and a else float("nan")
        rows.append(f"{s + ' (ms)':34s} {fmt(a)} {fmt(b):>22s}   "
                    + (f"{ratio:.2f}x faster" if np.isfinite(ratio) else "-"))
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ours", default="runs", help="rt3d_torch run log dir")
    p.add_argument("--reference", default=None,
                   help="reference log dir (its columns stay blank without it)")
    p.add_argument("--drop-warmup", type=int, default=1,
                   help="frames dropped from OUR logs (warm-up)")
    args = p.parse_args(argv)
    print(compare_runs(args.ours, args.reference, drop_warmup=args.drop_warmup))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
