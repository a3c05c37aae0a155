#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`rt3d_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its wall seconds:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel in rt3d_torch/csrc (one nvcc call);
  3. each kernel (K1-K4) against its plain PyTorch version at the main
     path's shapes, with kernel, plain and library-call times (CUDA events
     around a CUDA graph of 5 calls, median of 20 replays after 3 warm-up
     calls) and each kernel's bound;
  4. the main path: `build_pipeline` on the default config (two HD720
     cameras, yolo11x-seg with the committed weights, ByteTrack, 5 mm
     voxels) stepping 8 synthetic frames, every kernel's launch counter
     checked per step;
  5. the same frames with every kernel swapped for its plain version
     (`build_pipeline(plain_kernels=True)`), held against phase 4.

Fails (non-zero exit, no result line) when no CUDA device is present, when
the port is missing beside this file, or when any check fails. The last
line of standard output is the result object.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAMES = 8
WARMUP_FRAMES = 2
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12   # H100 SXM, f32 outside the tensor cores

T0 = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def phase(name: str, t: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - t:.2f} s")


def time_ms(torch, fn, calls: int = 5, replays: int = 20, warmup: int = 3) -> float:
    """Device ms per call of `fn`: `calls` back-to-back calls captured in a
    CUDA graph, replayed `replays` times between CUDA events after `warmup`
    calls; the median replay over `calls`. Replaying the graph keeps host
    launch overhead out of the kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(torch, gen):
    """Main-path-shaped inputs from a fixed seed: voxel-key grids with image
    locality, fused-object slots and a workspace cloud on a 5 mm lattice."""
    from rt3d_torch.geometry.ops import INT_SENTINEL

    dev = "cuda"

    def key_grid(h, w):
        r = torch.arange(h, device=dev)[:, None] // 3
        c = torch.arange(w, device=dev)[None, :] // 5
        kg = (r * 4096 + c).to(torch.int32)
        kg = kg + torch.randint(0, 2, (h, w), device=dev, generator=gen, dtype=torch.int32)
        sent = torch.rand((h, w), device=dev, generator=gen) < 0.3
        return torch.where(sent, INT_SENTINEL, kg).to(torch.int32)

    k1 = key_grid(360, 640)
    k2 = key_grid(720, 1280)
    w2 = torch.randint(1, 2**20, (720, 1280), device=dev, generator=gen, dtype=torch.int32)
    w2 = torch.where(k2 == INT_SENTINEL, 0, w2).to(torch.int32)

    s, cap = 20, 2048
    lat = torch.randint(-20, 20, (s, cap, 3), device=dev, generator=gen).float() * 0.005
    slot_off = torch.rand((s, 1, 3), device=dev, generator=gen) * 0.6
    pts = (lat + slot_off + torch.randn((s, cap, 3), device=dev, generator=gen) * 0.001).contiguous()
    n_valid = torch.tensor([1500, 900, 700, 400, 300, 120, 15] + [0] * (s - 7), device=dev)
    valid = torch.arange(cap, device=dev)[None, :] < n_valid[:, None]

    q = (torch.randint(-100, 150, (131072, 3), device=dev, generator=gen).float() * 0.005).contiguous()
    r = torch.zeros((20480, 3), device=dev)
    nr = 3000
    r[:nr] = torch.randint(0, 40, (nr, 3), device=dev, generator=gen).float() * 0.005
    rv = torch.arange(20480, device=dev) < nr
    return dict(k1=k1, k2=k2, w2=w2, pts=pts, valid=valid, q=q, r=r.contiguous(), rv=rv)


def check_kernels(torch, gen):
    from rt3d_torch import kernels
    from rt3d_torch.geometry import ops, sor, subtract

    x = kernel_inputs(torch, gen)
    k = 20
    rows = []

    def bound(nbytes, nops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # K1
    got = ops.window_dedupe(x["k1"])
    ref = ops.window_dedupe(x["k1"], plain=True)
    err = int((got.long() - ref.long()).abs().max())
    check(torch.equal(got, ref), "K1 window_dedupe differs from its plain version")
    hw = x["k1"].numel()
    rows.append(dict(
        name="window_dedupe", source="rt3d_torch/csrc/window.cu",
        replaces="rt3d/geometry/pallas_ops.py:332", max_abs_err=err,
        ms=time_ms(torch, lambda: ops.window_dedupe(x["k1"])),
        plain_ms=time_ms(torch, lambda: ops.window_dedupe(x["k1"], plain=True)),
        library_ms=None, bound=bound(8 * hw, 58 * hw)))

    # K2
    got = ops.window_prev_or(x["k2"], x["w2"])
    ref = ops.window_prev_or(x["k2"], x["w2"], plain=True)
    err = int((got.long() - ref.long()).abs().max())
    check(torch.equal(got, ref), "K2 window_prev_or differs from its plain version")
    hw = x["k2"].numel()
    rows.append(dict(
        name="window_prev_or", source="rt3d_torch/csrc/window.cu",
        replaces="rt3d/geometry/pallas_ops.py:356", max_abs_err=err,
        ms=time_ms(torch, lambda: ops.window_prev_or(x["k2"], x["w2"])),
        plain_ms=time_ms(torch, lambda: ops.window_prev_or(x["k2"], x["w2"], plain=True)),
        library_ms=None, bound=bound(12 * hw, 3 * 58 * hw)))

    # K3: mean within 1e-5 relative, saturated equal (valid rows)
    pts, valid = x["pts"], x["valid"]
    mean, sat = sor.sor_knn_mean_slots(pts, valid, k)
    pmean, psat = sor.sor_knn_mean_slots(pts, valid, k, plain=True)
    check(torch.equal(sat[valid], psat[valid]), "K3 saturated flags differ")
    ok = valid & ~sat
    rel = ((mean - pmean).abs() / pmean.abs().clamp_min(1e-12))[ok]
    check(bool((rel <= 1e-5).all()), f"K3 mean off by {float(rel.max()):.3g} relative")
    s, cap, _ = pts.shape
    nq = int(valid.sum())

    def k3_library():
        d = torch.cdist(pts, pts)
        return torch.topk(d, k, dim=-1, largest=False).values.sum(-1) / (k - 1)

    rows.append(dict(
        name="sor_knn_slots", source="rt3d_torch/csrc/sor_knn.cu",
        replaces="rt3d/geometry/pallas_ops.py:148",
        max_abs_err=float((mean - pmean).abs()[ok].max()),
        ms=time_ms(torch, lambda: sor.sor_knn_mean_slots(pts, valid, k)),
        plain_ms=time_ms(torch, lambda: sor.sor_knn_mean_slots(pts, valid, k, plain=True)),
        library_ms=time_ms(torch, k3_library),
        bound=bound(s * cap * (12 + 1 + 4 + 1), nq * cap * 10)))

    # K4: keep/drop at 0.06 m equal; d2 within 1e-6 where <= threshold^2
    q, r, rv = x["q"], x["r"], x["rv"]
    d2 = subtract.min_sqdist(q, r, rv)
    pd2 = subtract.min_sqdist(q, r, rv, plain=True)
    t2 = torch.tensor(0.06, device="cuda") ** 2
    check(torch.equal(d2 > t2, pd2 > t2), "K4 keep/drop decisions differ")
    near = pd2 <= t2
    check(bool(((d2 - pd2).abs()[near] <= 1e-6).all()), "K4 d2 differs within the threshold")
    rvalid = r[rv]
    nr = rvalid.shape[0]
    rows.append(dict(
        name="min_sqdist", source="rt3d_torch/csrc/min_d2.cu",
        replaces="rt3d/geometry/pallas_ops.py:25",
        max_abs_err=float((d2 - pd2).abs()[near].max()),
        ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv)),
        plain_ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv, plain=True)),
        library_ms=time_ms(torch, lambda: torch.cdist(q, rvalid).pow(2).amin(1)),
        bound=bound(q.numel() * 4 + q.shape[0] * 4 + r.numel() * 4 + r.shape[0],
                    q.shape[0] * nr * 9)))
    kernels.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path
# ---------------------------------------------------------------------------


def run_path(torch, pipe, frames, per_step):
    """Step all frames in order; returns (per-frame event ms, wall s, host
    copies of the outputs, launches per kernel)."""
    from rt3d_torch import kernels

    state, calib = pipe.init_state(), pipe.calib()
    kernels.reset_launches()
    ms, outs = [], []
    t_wall = None
    for i, (rgb, depth) in enumerate(frames):
        if i == WARMUP_FRAMES:
            torch.cuda.synchronize()
            t_wall = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, out = pipe.step(state, rgb, depth, calib)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        for name, n in per_step.items():
            rose = kernels.LAUNCHES[name] - before[name]
            check(rose == n, f"frame {i}: {name} launched {rose} times, expected {n}")
        outs.append(host_outputs(out))
    wall = time.perf_counter() - t_wall
    return ms, wall, outs, dict(kernels.LAUNCHES)


def host_outputs(out):
    def np_(t):
        return t.detach().cpu().numpy()

    d = out.detections
    return dict(
        boxes=np_(d.boxes), scores=np_(d.scores), classes=np_(d.classes),
        det_valid=np_(d.valid), track_ids=np_(out.track_ids),
        pc_points=np_(out.per_camera_objects.points), pc_valid=np_(out.per_camera_objects.valid),
        obj_points=np_(out.objects.points), obj_valid=np_(out.objects.valid),
        obj_present=np_(out.objects.present),
        flat_points=np_(out.objects_flat.points), flat_valid=np_(out.objects_flat.valid),
        ws_points=np_(out.workspace.points), ws_valid=np_(out.workspace.valid),
        overflow=out.overflow.item())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    import rt3d_torch  # noqa: F401  (fails when the port is not beside this file)
    from rt3d_torch.config import Config, with_cameras
    from rt3d_torch.io import SyntheticSource
    from rt3d_torch.kernels.build import build, load_library
    from rt3d_torch.pipeline.step import build_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True

    # 1. the card
    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    phase("card", t)

    # 2. the build
    t = time.perf_counter()
    lib_path, build_s, nvcc_log = build()
    load_library()
    log(f"built {os.path.relpath(lib_path, ROOT)} in {build_s:.2f} s")
    for line in nvcc_log.splitlines():
        if "Compiling entry" in line or "Used" in line:
            log("  ptxas:", line.strip().replace("ptxas info    : ", ""))
    phase("build", t)

    # 3. kernels against their plain versions
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = check_kernels(torch, gen)
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), "
            f"max_abs_err {r['max_abs_err']}")
    phase("kernels", t)

    # 4. the main path
    t = time.perf_counter()
    src = SyntheticSource(num_cameras=2, num_frames=FRAMES, hw=(720, 1280),
                          num_objects=2, seed=0)
    cfg = with_cameras(Config(), src.cameras())
    weights = os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz")
    pipe = build_pipeline(cfg, weights=weights, device="cuda")
    frames = []
    for i in range(FRAMES):
        pkt = src.get(i)
        frames.append((torch.from_numpy(pkt.rgb).cuda(), torch.from_numpy(pkt.depth).cuda()))
    torch.cuda.synchronize()
    log(f"pipeline built and {FRAMES} frames staged: {time.perf_counter() - t:.2f} s")
    per_step = {"window_dedupe": 2, "window_prev_or": 2, "sor_knn_slots": 1, "min_sqdist": 1}
    torch.cuda.reset_peak_memory_stats()
    ms, wall, outs, launches = run_path(torch, pipe, frames, per_step)
    peak = torch.cuda.max_memory_allocated()
    total_dets = 0
    for i, o in enumerate(outs):
        for key in ("boxes", "scores", "pc_points", "obj_points", "flat_points", "ws_points"):
            check(bool(np.isfinite(o[key]).all()), f"frame {i}: non-finite {key}")
        check(isinstance(o["overflow"], int), "overflow is not an integer")
        n_det = int(o["det_valid"].sum())
        total_dets += n_det
        log(f"  frame {i}: {ms[i]:.2f} ms device clock, detections {n_det} "
            f"(classes {o['classes'][o['det_valid']].tolist()}), track ids "
            f"{o['track_ids'][o['det_valid']].tolist()}, fused objects "
            f"{int(o['obj_present'].sum())}, object points {int(o['flat_valid'].sum())}, "
            f"workspace kept {int(o['ws_valid'].sum())}, overflow {o['overflow']}")
    check(total_dets > 0, "no detection in any frame")
    steady = ms[WARMUP_FRAMES:]
    fps = (FRAMES - WARMUP_FRAMES) / wall
    log(f"  steady frames: device ms mean {statistics.mean(steady):.2f} "
        f"median {statistics.median(steady):.2f}; wall fps {fps:.2f}; "
        f"peak memory {peak / 2**20:.1f} MiB; launches {launches}")
    phase("main path", t)

    # 5. the same frames with every kernel's plain version
    t = time.perf_counter()
    plain = build_pipeline(cfg, weights=weights, device="cuda", plain_kernels=True)
    pms, _, pouts, plaunches = run_path(torch, plain, frames,
                                        {name: 0 for name in per_step})
    exact = ("classes", "det_valid", "track_ids", "pc_points", "pc_valid", "obj_points",
             "obj_valid", "obj_present", "flat_points", "flat_valid", "ws_points", "ws_valid")
    for i, (o, p) in enumerate(zip(outs, pouts)):
        for key in exact:
            check(np.array_equal(o[key], p[key]), f"frame {i}: {key} differs from the plain run")
        for key in ("boxes", "scores"):
            check(np.allclose(o[key], p[key], rtol=0, atol=1e-4),
                  f"frame {i}: {key} differ from the plain run by more than 1e-4")
        check(o["overflow"] == p["overflow"], f"frame {i}: overflow differs")
    log(f"  plain run: steady device ms mean {statistics.mean(pms[WARMUP_FRAMES:]):.2f}; "
        f"identical keys, ids and keep masks over {FRAMES} frames")
    phase("plain path", t)

    out_rows = []
    for r in rows:
        b_ms, b_by = r.pop("bound")
        out_rows.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[r["name"]], max_abs_err=r["max_abs_err"], ms=r["ms"],
            kernel_ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=r["library_ms"], launches_per_step=per_step[r["name"]]))
    log(f"[total] {time.perf_counter() - T0:.2f} s")
    log(json.dumps({"kernels": out_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
