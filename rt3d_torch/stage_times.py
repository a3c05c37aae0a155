"""Where the port's step spends its time on the card.

    python3 -m rt3d_torch.stage_times [--frames N]

Builds the main path as `chip_smoke.py` does (default config, two HD720
synthetic cameras, yolo11x-seg with the committed weights), warms up on two
frames, then

* times every stage of `Pipeline.step` on its own, with a synchronize
  before and after it: device ms from CUDA events and host wall ms;
* profiles whole steps with `torch.profiler` and prints the operators with
  the most device time and the device's busy share of the wall time.

The last line of standard output is one JSON object with these numbers.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

from rt3d_torch.config import Config, with_cameras
from rt3d_torch.geometry.ops import PointBuffer
from rt3d_torch.io import SyntheticSource
from rt3d_torch.pipeline.step import build_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _staged_step(pipe, state, rgb, depth, calib, record):
    """`Pipeline.step` split at its stages; `record(name, fn)` runs and
    times each one."""
    images = record("preprocess", lambda: pipe.preprocess(rgb))
    det, protos = record("detect", lambda: pipe.detect(images))
    state, ids = record("track", lambda: pipe.track(state, det))
    masks = record("masks", lambda: pipe.masks(protos, det))
    per_cam, _ = record("object_clouds",
                        lambda: pipe.object_clouds(depth, masks, det, ids, calib))
    ws, _ = record("workspace_clouds", lambda: pipe.workspace_clouds(depth, calib))
    _, flat, _ = record("fuse", lambda: pipe.fuse(per_cam))
    ws_all = PointBuffer(ws.points.reshape(-1, 3), ws.valid.reshape(-1))
    record("subtract", lambda: pipe.subtract(ws_all, flat))
    return state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    src = SyntheticSource(num_cameras=2, num_frames=args.frames, hw=(720, 1280),
                          num_objects=2, seed=0)
    cfg = with_cameras(Config(), src.cameras())
    pipe = build_pipeline(cfg, weights=os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz"))
    frames = [(torch.from_numpy(p.rgb).cuda(), torch.from_numpy(p.depth).cuda())
              for p in (src.get(i) for i in range(args.frames))]
    calib = pipe.calib()
    state = pipe.init_state()
    for rgb, depth in frames[:2]:
        state, _ = pipe.step(state, rgb, depth, calib)
    torch.cuda.synchronize()

    dev, wall = {}, {}

    def record(name, fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        wall.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        dev.setdefault(name, []).append(a.elapsed_time(b))
        return out

    with torch.no_grad():
        for rgb, depth in frames[2:]:
            state = _staged_step(pipe, state, rgb, depth, calib, record)
    stages = {k: {"device_ms": statistics.median(dev[k]),
                  "wall_ms": statistics.median(wall[k])} for k in dev}
    for k, v in stages.items():
        print(f"{k:18s} device {v['device_ms']:8.3f} ms   wall {v['wall_ms']:8.3f} ms",
              flush=True)

    from torch.profiler import ProfilerActivity, profile

    steps = frames[2:4]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for rgb, depth in steps:
            state, _ = pipe.step(state, rgb, depth, calib)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:20]
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20), flush=True)
    result = {
        "card": smi,
        "stages": stages,
        "profiled_steps": len(steps),
        "profiled_wall_ms_per_step": prof_wall_ms / len(steps),
        "device_busy_ms_per_step": busy_ms / len(steps),
        "device_busy_share": busy_ms / prof_wall_ms,
        "top_ops": [{"name": e.key, "device_ms_per_step": e.self_device_time_total / 1e3 / len(steps),
                     "calls_per_step": e.count / len(steps)} for e in ops],
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
