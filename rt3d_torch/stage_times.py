"""Where the port's step spends its time on the card.

    python3 -m rt3d_torch.stage_times [--preset NAME] [--frames N]

Builds a preset as `chip_smoke.py` does (`rt3d_torch.pipeline.presets`:
`2cam`, the default config, two HD720 synthetic cameras, yolo11x-seg with
the committed weights; `2cam_cpu`, the CPU-variant preset with mask erosion
and workspace SOR; `1cam`, one camera with yolo11l-seg; the 4-camera 1 mm
accumulating `stretch_4cam_1mm`; `2cam_botsort` and `2cam_deepsort`;
`2cam_int8`, the backbone int8, calibrated live), warms up on two frames,
then

* times every stage of `Pipeline.step` on its own, with a synchronize
  before and after it: device ms from CUDA events and host wall ms;
* profiles two whole steps with `torch.profiler`
  (`rt3d_torch.runtime.profile_op_times`, after one untraced pair) and
  prints the kernels with the most device time and the device's busy share
  of the traced wall time.

The last line of standard output is one JSON object with these numbers.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from rt3d_torch.geometry.ops import PointBuffer
from rt3d_torch.pipeline.presets import PRESETS, synthetic_preset
from rt3d_torch.runtime.profiling import format_op_times, profile_op_times


def _staged_step(pipe, state, rgb, depth, calib, record):
    """`Pipeline.step` split at its stages; `record(name, fn)` runs and
    times each one."""
    images = record("preprocess", lambda: pipe.preprocess(rgb))
    det, protos, emb = record("detect", lambda: pipe.detect(images))
    state, ids = record("track", lambda: pipe.track(state, det, emb, images))
    masks, _ = record("masks", lambda: pipe.masks(protos, det))
    per_cam, _ = record("object_clouds",
                        lambda: pipe.object_clouds(depth, masks, det, ids, calib))
    ws, _ = record("workspace_clouds", lambda: pipe.workspace_clouds(depth, calib))
    _, flat, _ = record("fuse", lambda: pipe.fuse(per_cam))
    ws_all = PointBuffer(ws.points.reshape(-1, 3), ws.valid.reshape(-1))
    ws_all = record("workspace_sor", lambda: pipe.workspace_sor(ws_all))
    ws_out = record("subtract", lambda: pipe.subtract(ws_all, flat))
    state, _, _ = record("accumulate", lambda: pipe.accumulate(state, ws_out))
    return state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="2cam")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    pipe, src = synthetic_preset(args.preset, args.frames)
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

    steps = frames[2:4]
    walls = []

    def two_steps():
        nonlocal state
        t = time.perf_counter()
        for rgb, depth in steps:
            state, _ = pipe.step(state, rgb, depth, calib)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    busy_ms, per_op = profile_op_times(two_steps, iters=1)
    prof_wall_ms = walls[-1]  # the traced call
    print(format_op_times(busy_ms / len(steps), {k: v / len(steps) for k, v in per_op.items()}),
          flush=True)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:20]
    result = {
        "card": smi,
        "preset": args.preset,
        "stages": stages,
        "profiled_steps": len(steps),
        "profiled_wall_ms_per_step": prof_wall_ms / len(steps),
        "device_busy_ms_per_step": busy_ms / len(steps),
        "device_busy_share": busy_ms / prof_wall_ms,
        "top_ops": [{"name": k, "device_ms_per_step": v / len(steps)} for k, v in ops],
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
