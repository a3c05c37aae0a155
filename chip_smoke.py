#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`rt3d_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its wall seconds:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel in rt3d_torch/csrc (one nvcc per
     source, all started together, then one link);
  3. each kernel (K1-K5) against its plain PyTorch version at the main
     paths' shapes, with kernel, plain and library-call times (CUDA events
     around a CUDA graph of 5 calls, median of 20 replays after 3 warm-up
     calls) and each kernel's bound; K1, K2, K3 and K5 bit for bit on every
     row, K5 over each slot of K3's input equal to K3's rows, K4 bit for bit
     without a threshold and under the step's 0.06 m threshold held to its
     contract (`check_k4_contract`). These inputs are the worst cases: a
     dense key grid, and K4's queries in random order, which no box test
     prunes. Beside them, an empty kernel (`rt3d_noop`) timed the same way:
     the launch floor every kernel's time is read against;
  4. the main path: `build_pipeline` on the default config (two HD720
     cameras, yolo11x-seg with the committed weights, ByteTrack, 5 mm
     voxels) stepping 8 synthetic frames, every kernel's launch counter
     checked per step; then (4b) K3 on the step's own fused slots of the
     last frame (bit for bit, timed beside `cdist` + `topk`), and (4c) K1,
     K2 and K4 on the step's own inputs of the last frame, rebuilt by the
     pipeline's stages (`step_kernel_inputs`: they must give the step's
     object voxels and keep mask), each checked, timed and bounded for
     those inputs, with K1's and K2's sentinel shares, the share of K1's
     tiles that hold a live key and of its live keys that are duplicates,
     and the share of K4's valid pairs its box tests keep;
  5. the same frames with every kernel swapped for its plain version
     (`build_pipeline(plain_kernels=True)`), held against phase 4;
  6. the CPU-variant preset (`reference_2cam_cpu_config`: 12x12 mask
     erosion, Morton-window SOR of the fused workspace cloud, 1 cm voxels,
     conf 0.25 on five classes), 8 HD720 frames of yolo11x, counters checked
     per step, the workspace SOR shown to drop points, then its plain run
     compared as in phase 5;
  7. K5 through its entry points: `sor_inlier_mask` and `sor_filter` on
     each present fused slot of phase 6's last frame equal
     `sor_inlier_mask_slots` (K3) on all of them, and K5's counter rises by
     one per call; then the per-slot fallback above 4096 points (20 slots
     of 16384 rows, 4 present) against one batched windowed pass, timed;
  8. the 1-cam preset (`reference_1cam_config`, yolo11l-seg), 4 frames,
     counters checked per step, then its plain run compared, then K1, K2
     and K4 on its own inputs as in 4c;
  8b. the replay driver: 12 HD720 frames of the 2cam preset's scene
     recorded to an .rts file (camera 1 of frame 5 failed, status 7), then
     `python -m rt3d_torch.apps.two_cam` called in-process on it (x model,
     pipeline depth 2, the C++ replayer built from native/replayer.cpp),
     its CSVs checked; then `PipelineDriver` at depth 1, depth 2 and four
     frames a call, and profile mode over 4 frames, each held bit for bit
     against plain `Pipeline.step` calls on the good frames, with its launch
     counts per step run and no thread left behind;
  10. the presets of the 1 mm and tracker slice, 6 HD720 frames each with
     counters checked per step and a plain run compared, as in phases 4-5:
     `2cam_botsort` (BoT-SORT: ReID and affine GMC; its tracks must hold
     features and its state grey images) and `2cam_deepsort` (K1-K4 as
     2cam), then `stretch_4cam_1mm` (4 cameras, yolo11n-seg, 1 mm voxels,
     raw-ray accumulation: K4 alone, once a frame); K4 on that step's own
     last-frame inputs, 1 048 576 queries against 32 768 references, as
     in 4c (the library call in blocks of 65 536 queries, the whole matrix
     being 128 GiB); and `accumulate_voxels` on an evicting case (65 536
     voxels, two folds of that step's subtracted workspace) against the
     same calls on the CPU, then one fold into the step's accumulator
     timed;
  9. every preset (the six of phases 4-10) in float32 (TF32 off) over the
     frames of its JAX golden (`tests/golden_torch/`, from
     `tools/make_torch_golden.py`), held against it within the bands of
     `rt3d_torch/golden.py`; then its usual bf16 step over the same
     frames, whose differences are printed only.

Fails (non-zero exit, no result line) when no CUDA device is present, when
the port is missing beside this file, or when any check fails. The last
line of standard output is the result object.
"""

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAMES = 8
FRAMES_1CAM = 4
FRAMES_SLICE = 6  # the stretch, BoT-SORT and DeepSORT presets
REPLAY_FRAMES = 12
REPLAY_BAD = 5  # camera 1 of this frame fails in the recording
WARMUP_FRAMES = 2
SLOW_MS = 100.0
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
# H100 SXM at 1.98 GHz: 132 SMs x 128 FP32 lanes issue 33.5e12 unfused f32
# operations a second (the 67 TFLOP/s of the data sheet counts a fused
# multiply-add as two; the kernels' distances are unfused, for their bits),
# and 132 x 64 INT32 lanes 16.7e12 integer operations
PEAK_F32_OPS_PER_S = 33.5e12
PEAK_INT32_OPS_PER_S = 16.7e12

T0 = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def phase(name: str, t: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - t:.2f} s")


def time_ms(torch, fn, calls: int = 5, replays: int = 20, warmup: int = 3,
            graph: bool = True) -> float:
    """Device ms per call of `fn`: `calls` back-to-back calls captured in a
    CUDA graph, replayed `replays` times between CUDA events after `warmup`
    calls; the median replay over `calls`. Replaying the graph keeps host
    launch overhead out of the kernel's time. With ``graph=False`` (for a
    function that reads back to the host) the calls run directly between
    the events. A function whose last warm-up call took over `SLOW_MS` (the
    plain version and the library call at the stretch step's 1 048 576
    queries) is timed over 3 replays of one call."""
    for _ in range(max(warmup, 1)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    if a.elapsed_time(b) > SLOW_MS:
        calls, replays = 1, 3

    def run():
        for _ in range(calls):
            fn()

    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes, f32_ops=0, int_ops=0):
    """The least time of `nbytes` moved once and of the operations at the
    card's rate for their type (`bytes_bound_ms`, `ops_bound_ms`), and the
    larger of the two (`bound_ms`, `bound_by`)."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = (f32_ops / PEAK_F32_OPS_PER_S + int_ops / PEAK_INT32_OPS_PER_S) * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
                bytes_bound_ms=tb, ops_bound_ms=to)


def fmt_bound(b) -> str:
    return (f"{b['bound_ms']:.5f} ms ({b['bound_by']}; bytes {b['bytes_bound_ms']:.5f}, "
            f"operations {b['ops_bound_ms']:.5f})")


def launch_floor_ms(torch):
    """`time_ms` of the library's empty kernel (`rt3d_noop`, one thread)."""
    from rt3d_torch.kernels.build import load_library

    noop = load_library().rt3d_noop

    def call():
        check(noop(torch.cuda.current_stream().cuda_stream) == 0, "rt3d_noop was refused")

    return time_ms(torch, call)


def live_tile_share(torch, live):
    """Share of the window kernels' 128-column x 8-row tiles that hold a
    live key; the others take K1's block skip."""
    h, w = live.shape
    p = torch.nn.functional.pad(live.to(torch.uint8), (0, -w % 128, 0, -h % 8))
    return float(p.reshape(p.shape[0] // 8, 8, -1, 128).amax((1, 3)).float().mean())


def window_ops(torch, kg, wg=None):
    """Integer operations the window's data needs: K1 one compare (its OR
    folds into the compare's predicate) for each of the 58 offsets of each
    live key; K2 the 58 compares of each pixel that has a non-zero word in
    its window (every other output is 0 whatever the keys), plus one OR for
    each same-key neighbour with a non-zero word."""
    from rt3d_torch.geometry import ops

    offsets = list(ops._window_offsets(4, 6))
    if wg is None:
        return len(offsets) * int((kg != ops.INT_SENTINEL).sum())
    need = torch.zeros_like(kg, dtype=torch.bool)
    ors = 0
    for dy, dx in offsets:
        nz = ops._shifted(wg, dy, dx, 0) != 0
        need |= nz
        ors += int((nz & (ops._shifted(kg, dy, dx, ops.INT_SENTINEL) == kg)).sum())
    return len(offsets) * int(need.sum()) + ors


def k4_pairs(torch, q, qv, r, rv, t2, block=256, tile=32):
    """(valid (query, reference) pairs, pairs left by the box tests of
    min_d2.cu at squared threshold `t2`): each `block` of queries against
    each `block` of references, then each `tile` (a warp) of queries against
    each `tile` of references, every box over valid rows only; a pair
    survives when neither its blocks' nor its tiles' boxes are farther apart
    than the threshold."""
    def boxes(p, v, size):
        n = -(-p.shape[0] // block) * block
        pp = torch.zeros((n, 3), device=p.device)
        vv = torch.zeros(n, dtype=torch.bool, device=p.device)
        pp[:p.shape[0]], vv[:p.shape[0]] = p, v
        pp, vv = pp.view(-1, size, 3), vv.view(-1, size)
        inf = torch.full((), float("inf"), device=p.device)
        return (torch.where(vv[..., None], pp, inf).amin(1),
                torch.where(vv[..., None], pp, -inf).amax(1), vv.sum(1))

    def near(a, b):
        (alo, ahi, an), (blo, bhi, bn) = a, b
        gap = torch.clamp_min(torch.maximum(blo[None] - ahi[:, None], alo[:, None] - bhi[None]), 0)
        g2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
        return ~(g2 > t2) & (an[:, None] > 0) & (bn[None, :] > 0)

    qb, rb = boxes(q, qv, block), boxes(r, rv, block)
    qt, rt = boxes(q, qv, tile), boxes(r, rv, tile)
    per = block // tile
    keep = near(qt, rt) & near(qb, rb).repeat_interleave(per, 0).repeat_interleave(per, 1)
    pairs = qt[2][:, None].double() * rt[2][None, :].double()
    return int(qv.sum()) * int(rv.sum()), int((pairs * keep).sum())


def k4_t2(torch, thr):
    """The f32 threshold^2 that `subtract_min_dist` compares against."""
    t = torch.tensor(thr, dtype=torch.float32, device="cuda")
    return t * t


def check_k4_contract(torch, d2, pd2, qv, t2, what):
    """K4's threshold contract against its plain version: bit for bit on
    every valid query whose plain d2 <= t2, > t2 on the other valid
    queries, 3.4e38 on invalid queries in both. Returns the first mask."""
    from rt3d_torch.geometry.subtract import BIG

    near = qv & (pd2 <= t2)
    check(torch.equal(d2[near], pd2[near]), f"K4 on {what}: d2 <= t2 not bit for bit")
    check(bool((d2[qv & ~near] > t2).all()), f"K4 on {what}: a far query got d2 <= t2")
    check(bool((d2[~qv] == BIG).all()) and bool((pd2[~qv] == BIG).all()),
          f"K4 on {what}: an invalid query did not get 3.4e38")
    return near


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

    def cloud(n):  # one fused-object slot, 30 % of its rows invalid
        p = torch.randint(-20, 20, (n, 3), device=dev, generator=gen).float() * 0.005
        p = (p + torch.randn((n, 3), device=dev, generator=gen) * 0.001 + 0.3).contiguous()
        return p, torch.rand(n, device=dev, generator=gen) >= 0.3

    c5, c5v = cloud(2048)
    c5b, c5bv = cloud(3000)
    return dict(k1=k1, k2=k2, w2=w2, pts=pts, valid=valid, q=q, r=r.contiguous(), rv=rv,
                c5=c5, c5v=c5v, c5b=c5b, c5bv=c5bv)


def check_kernels(torch, gen):
    from rt3d_torch import kernels
    from rt3d_torch.geometry import ops, sor, subtract

    x = kernel_inputs(torch, gen)
    k = 20
    rows = []

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
        library_ms=None, bound=bound(8 * hw, int_ops=window_ops(torch, x["k1"]))))

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
        library_ms=None, bound=bound(12 * hw, int_ops=window_ops(torch, x["k2"], x["w2"]))))

    # K3: bit for bit against its plain version on every row (invalid rows
    # included), as K5
    pts, valid = x["pts"], x["valid"]
    mean, sat = sor.sor_knn_mean_slots(pts, valid, k)
    pmean, psat = sor.sor_knn_mean_slots(pts, valid, k, plain=True)
    check(torch.equal(mean, pmean) and torch.equal(sat, psat),
          "K3 sor_knn_slots differs from its plain version")
    s, cap, _ = pts.shape
    pairs = int((valid.sum(-1).long() ** 2).sum())  # valid pairs within each slot

    def k3_library():
        d = torch.cdist(pts, pts)
        return torch.topk(d, k, dim=-1, largest=False).values.sum(-1) / (k - 1)

    rows.append(dict(
        name="sor_knn_slots", source="rt3d_torch/csrc/sor_knn.cu",
        replaces="rt3d/geometry/pallas_ops.py:148",
        max_abs_err=float((mean - pmean).abs().max()),
        ms=time_ms(torch, lambda: sor.sor_knn_mean_slots(pts, valid, k)),
        plain_ms=time_ms(torch, lambda: sor.sor_knn_mean_slots(pts, valid, k, plain=True)),
        library_ms=time_ms(torch, k3_library),
        bound=bound(s * cap * (12 + 1 + 4 + 1), pairs * 10)))

    # K4: bit for bit on every row without a threshold; under the step's
    # threshold, its contract (`check_k4_contract`); timed as the step calls it
    q, r, rv = x["q"], x["r"], x["rv"]
    check(torch.equal(subtract.min_sqdist(q, r, rv), subtract.min_sqdist(q, r, rv, plain=True)),
          "K4 without a threshold differs from its plain version")
    qv = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
    t2 = k4_t2(torch, 0.06)
    d2 = subtract.min_sqdist(q, r, rv, threshold=0.06, query_valid=qv)
    pd2 = subtract.min_sqdist(q, r, rv, threshold=0.06, query_valid=qv, plain=True)
    near = check_k4_contract(torch, d2, pd2, qv, t2, "phase 3's inputs")
    rvalid = r[rv]
    _, kept_pairs = k4_pairs(torch, q, qv, r, rv, t2)
    rows.append(dict(
        name="min_sqdist", source="rt3d_torch/csrc/min_d2.cu",
        replaces="rt3d/geometry/pallas_ops.py:25",
        max_abs_err=float((d2 - pd2).abs()[near].max()),
        ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv, 0.06, qv)),
        plain_ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv, 0.06, qv, plain=True)),
        library_ms=time_ms(torch, lambda: torch.cdist(q, rvalid).pow(2).amin(1)),
        exact_ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv)),
        bound=bound(q.shape[0] * (12 + 1 + 4) + r.shape[0] * (12 + 1), kept_pairs * 9)))

    # K5: bit for bit against its plain version (2048 rows, and 3000, not a
    # multiple of its block), and against K3's row for each slot
    c, cv = x["c5"], x["c5v"]
    mean5, sat5 = sor.sor_knn_mean(c, cv, k)
    pmean5, psat5 = sor.sor_knn_mean(c, cv, k, plain=True)
    check(torch.equal(mean5, pmean5) and torch.equal(sat5, psat5),
          "K5 sor_knn differs from its plain version at 2048 rows")
    b, bv = x["c5b"], x["c5bv"]
    check(all(torch.equal(u, v) for u, v in zip(sor.sor_knn_mean(b, bv, k),
                                                 sor.sor_knn_mean(b, bv, k, plain=True))),
          "K5 sor_knn differs from its plain version at 3000 rows")
    for i in range(s):
        m_i, s_i = sor.sor_knn_mean(pts[i], valid[i], k)
        check(torch.equal(m_i, mean[i]) and torch.equal(s_i, sat[i]),
              f"K5 over slot {i} differs from K3's row")
    n5 = c.shape[0]

    def k5_library():
        d = torch.cdist(c, c)
        return torch.topk(d, k, dim=-1, largest=False).values.sum(-1) / (k - 1)

    rows.append(dict(
        name="sor_knn", source="rt3d_torch/csrc/sor_knn.cu",
        replaces="rt3d/geometry/pallas_ops.py:148",
        max_abs_err=float((mean5 - pmean5).abs().max()),
        ms=time_ms(torch, lambda: sor.sor_knn_mean(c, cv, k)),
        plain_ms=time_ms(torch, lambda: sor.sor_knn_mean(c, cv, k, plain=True)),
        library_ms=time_ms(torch, k5_library),
        bound=bound(n5 * (12 + 1 + 4 + 1), int(cv.sum()) ** 2 * 10)))
    kernels.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# K3 on the step's own slots
# ---------------------------------------------------------------------------


def step_slots(torch, run):
    """K3's input in the 2cam step's last frame: the fusion's first
    `max_detections` slots (camera 1's objects, each with its matched
    camera-2 points behind it: the two-run layout), rebuilt from the frame's
    per-camera objects without the SOR. The step's keep masks of the present
    slots must follow from `sor_inlier_mask_slots` on them."""
    from rt3d_torch.geometry import sor
    from rt3d_torch.geometry.fusion import ObjectSet, fuse_centroid

    pipe, out = run["pipe"], run["last"]
    p, pc = pipe.cfg.pipeline, out.per_camera_objects
    cams = [ObjectSet(pc.points[c], pc.valid[c], pc.class_id[c], pc.present[c],
                      pc.track_id[c]) for c in range(2)]
    fused = fuse_centroid(cams[0], cams[1], p.fusion_distance_threshold, apply_sor=False)
    s1 = cams[0].num_slots
    pts, valid = fused.points[:s1].contiguous(), fused.valid[:s1].contiguous()
    keep = sor.sor_inlier_mask_slots(pts, valid, p.sor_nb_neighbors, p.sor_std_ratio)
    present = out.objects.present[:s1]
    check(torch.equal(keep[present], out.objects.valid[:s1][present]),
          "K3 on the rebuilt slots does not give the step's keep masks")
    return pts, valid


def time_step_slots(torch, run, k=20):
    """K3 on the 2cam step's slots: bit for bit against its plain version,
    then timed beside its bound."""
    from rt3d_torch.geometry import sor

    pts, valid = step_slots(torch, run)
    mean, sat = sor.sor_knn_mean_slots(pts, valid, k)
    pmean, psat = sor.sor_knn_mean_slots(pts, valid, k, plain=True)
    check(torch.equal(mean, pmean) and torch.equal(sat, psat),
          "K3 on the step's slots differs from its plain version")
    n = valid.sum(-1)
    pairs = int((n.long() ** 2).sum())

    def library():
        d = torch.cdist(pts, pts)
        return torch.topk(d, k, dim=-1, largest=False).values.sum(-1) / (k - 1)

    return dict(
        n_valid=[int(v) for v in n if v > 0], cap=pts.shape[1], slots=pts.shape[0],
        ms=time_ms(torch, lambda: sor.sor_knn_mean_slots(pts, valid, k)),
        plain_ms=time_ms(torch, lambda: sor.sor_knn_mean_slots(pts, valid, k, plain=True)),
        library_ms=time_ms(torch, library),
        **bound(pts.shape[0] * pts.shape[1] * (12 + 1 + 4 + 1), pairs * 10))


# ---------------------------------------------------------------------------
# K1, K2 and K4 on the step's own inputs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording(module, name):
    """Record the positional arguments of each call of `module.<name>` made
    inside the block: the stages look their kernel wrapper up in its module
    at each call, so the step's own code hands over its arguments."""
    fn, calls = getattr(module, name), []

    def rec(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def step_kernel_inputs(torch, run):
    """K1's, K2's and K4's arguments in the preset's last frame, rebuilt by
    the pipeline's own stages on that frame: detect and masks again (their
    detections must equal the step's), `object_clouds` (K2's key and word
    grids, one per camera; the object voxels must equal the step's),
    `workspace_clouds` (K1's key grids), `workspace_sor` and
    `flatten_objects` (K4's queries and references; `subtract` on them must
    give the step's keep mask, or with accumulation, folded into the
    accumulator of the state before the frame, the step's published
    workspace)."""
    from rt3d_torch.geometry import ops
    from rt3d_torch.geometry.fusion import flatten_objects
    from rt3d_torch.geometry.ops import PointBuffer

    pipe, out = run["pipe"], run["last"]
    rgb, depth = run["frames"][-1]
    calib = pipe.calib()
    with torch.no_grad():
        det, protos, _ = pipe.detect(pipe.preprocess(rgb))
        check(torch.equal(det.boxes, out.detections.boxes)
              and torch.equal(det.valid, out.detections.valid),
              "detect on the last frame again differs from the step's detections")
        with recording(ops, "window_prev_or") as k2:
            objs, _ = pipe.object_clouds(depth, pipe.masks(protos, det), det,
                                         out.track_ids, calib)
        pc = out.per_camera_objects
        check(torch.equal(objs.points, pc.points) and torch.equal(objs.valid, pc.valid),
              "K2's rebuilt inputs do not give the step's object voxels")
        with recording(ops, "window_dedupe") as k1:
            ws, _ = pipe.workspace_clouds(depth, calib)
        ws = pipe.workspace_sor(PointBuffer(ws.points.reshape(-1, 3), ws.valid.reshape(-1)))
        flat, _ = flatten_objects(out.objects, pipe.cfg.pipeline.max_points_fused_flat)
        check(torch.equal(flat.points, out.objects_flat.points)
              and torch.equal(flat.valid, out.objects_flat.valid),
              "flatten_objects does not give the step's object buffer")
        ws_out = pipe.subtract(ws, flat)
        _, published, _ = pipe.accumulate(run["prev"], ws_out)
        check(torch.equal(published.valid, out.workspace.valid)
              and torch.equal(published.points, out.workspace.points),
              "K4's rebuilt inputs do not give the step's workspace")
    return dict(k1=[a[0] for a in k1], k2=[a[:2] for a in k2], ws=ws, flat=flat,
                ws_out=ws_out, thr=pipe.cfg.pipeline.subtraction_threshold)


def time_step_kernels(torch, run):
    """K1, K2 and K4 on the step's own inputs (`step_kernel_inputs`): each
    against its plain version, timed beside its bound for those inputs. The
    subtracted workspace goes to ``run["ws_out"]``."""
    from rt3d_torch.geometry import ops, subtract

    x = step_kernel_inputs(torch, run)
    run["ws_out"] = x["ws_out"]
    res = {"window_dedupe": [], "window_prev_or": []}
    for kg in x["k1"]:
        ref = ops.window_dedupe(kg, plain=True)
        check(torch.equal(ops.window_dedupe(kg), ref),
              "K1 on the step's key grid differs from its plain version")
        live = kg != ops.INT_SENTINEL
        res["window_dedupe"].append(dict(
            hw=list(kg.shape), sentinel_share=float((~live).float().mean()),
            live_tile_share=live_tile_share(torch, live),
            dup_share=int((live & (ref == ops.INT_SENTINEL)).sum()) / max(int(live.sum()), 1),
            ms=time_ms(torch, lambda: ops.window_dedupe(kg)),
            plain_ms=time_ms(torch, lambda: ops.window_dedupe(kg, plain=True)),
            **bound(8 * kg.numel(), int_ops=window_ops(torch, kg))))
    for kg, wg in x["k2"]:
        check(torch.equal(ops.window_prev_or(kg, wg), ops.window_prev_or(kg, wg, plain=True)),
              "K2 on the step's grids differs from its plain version")
        res["window_prev_or"].append(dict(
            hw=list(kg.shape), sentinel_share=float((kg == ops.INT_SENTINEL).float().mean()),
            ms=time_ms(torch, lambda: ops.window_prev_or(kg, wg)),
            plain_ms=time_ms(torch, lambda: ops.window_prev_or(kg, wg, plain=True)),
            **bound(12 * kg.numel(), int_ops=window_ops(torch, kg, wg))))

    q, qv, r, rv = x["ws"].points, x["ws"].valid, x["flat"].points, x["flat"].valid
    thr = x["thr"]
    t2 = k4_t2(torch, thr)
    d2 = subtract.min_sqdist(q, r, rv, thr, qv)
    pd2 = subtract.min_sqdist(q, r, rv, thr, qv, plain=True)
    check_k4_contract(torch, d2, pd2, qv, t2, "the step's inputs")
    check(torch.equal(subtract.min_sqdist(q, r, rv, query_valid=qv), pd2),
          "K4 on the step's inputs without a threshold differs from its plain version")
    rvalid = r[rv]
    valid_pairs, kept_pairs = k4_pairs(torch, q, qv, r, rv, t2)
    nbytes = q.shape[0] * (12 + 1 + 4) + r.shape[0] * (12 + 1)
    # the library call's (queries, valid refs) matrix, in blocks of queries
    # when it would pass 2 GiB (1 TiB would not fit at the stretch shape)
    block = q.shape[0] if q.shape[0] * rvalid.shape[0] * 4 <= 2**31 else 65536

    def library():
        return torch.cat([torch.cdist(q[i:i + block], rvalid).pow(2).amin(1)
                          for i in range(0, q.shape[0], block)])

    res["min_sqdist"] = dict(
        queries=q.shape[0], valid_queries=int(qv.sum()), refs=r.shape[0],
        valid_refs=int(rv.sum()), valid_pairs=valid_pairs, kept_pairs=kept_pairs,
        kept_share=kept_pairs / max(valid_pairs, 1), library_query_block=block,
        ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv, thr, qv)),
        plain_ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv, thr, qv, plain=True)),
        library_ms=time_ms(torch, library),
        exact_ms=time_ms(torch, lambda: subtract.min_sqdist(q, r, rv, query_valid=qv)),
        **bound(nbytes, kept_pairs * 9),
        valid_pairs_bound_ms=bound(nbytes, valid_pairs * 9)["bound_ms"])
    return res


def log_step_kernels(name, res):
    for kname in ("window_dedupe", "window_prev_or"):
        for c, v in enumerate(res[kname]):
            shares = (f", tiles with a live key {v['live_tile_share']:.4f}, live keys "
                      f"that are duplicates {v['dup_share']:.4f}" if "dup_share" in v else "")
            log(f"  {kname} on {name} camera {c}'s grid ({v['hw'][0]}x{v['hw'][1]}, "
                f"sentinel share {v['sentinel_share']:.4f}{shares}): kernel {v['ms']:.4f} ms, "
                f"plain {v['plain_ms']:.4f} ms, bound {fmt_bound(v)}")
    v = res["min_sqdist"]
    log(f"  min_sqdist on {name}'s workspace ({v['valid_queries']} of {v['queries']} queries "
        f"valid) and objects ({v['valid_refs']} of {v['refs']} valid): kernel {v['ms']:.4f} ms, "
        f"plain {v['plain_ms']:.4f} ms, library {v['library_ms']:.4f} ms "
        f"(blocks of {v['library_query_block']} queries), bound "
        f"{fmt_bound(v)} over the {v['kept_share']:.4f} of "
        f"{v['valid_pairs']} valid pairs the box tests keep "
        f"({v['valid_pairs_bound_ms']:.5f} ms over all of them); without a threshold "
        f"{v['exact_ms']:.4f} ms")


# ---------------------------------------------------------------------------
# Phase 10: the accumulator on the card
# ---------------------------------------------------------------------------


def check_accumulator(torch, run):
    """`accumulate_voxels` on an evicting case, on the card against the
    same calls on a CPU copy: an accumulator of 65536 voxels folds the
    stretch step's last subtracted workspace twice (more voxels than it
    holds): keys and overflow exact, weights within 1e-6 relative. Then one
    fold of that workspace into the step's own accumulator (1 048 576
    voxels) is timed, without a CUDA graph: the branch reads a count back."""
    from rt3d_torch.geometry.voxel_sets import VoxelAccumulator, accumulate_voxels

    p = run["pipe"].cfg.pipeline
    ws = run["ws_out"]
    kw = dict(voxel_size=p.voxel_size, bound_m=p.dedupe_bound_m, decay=p.accum_decay,
              obs_weight=p.accum_obs_weight)
    res = {}
    for dev in ("cuda", "cpu"):
        acc, ovfs = VoxelAccumulator.empty(65536, dev), []
        for _ in range(2):
            acc, ovf = accumulate_voxels(acc, ws.points.to(dev), ws.valid.to(dev), **kw)
            ovfs.append(int(ovf))
        res[dev] = (acc, ovfs)
    (g, govf), (c, covf) = res["cuda"], res["cpu"]
    check(govf == covf and min(govf) > 0,
          f"accumulator: overflow {govf} on the card, {covf} on the CPU")
    check(torch.equal(g.keys_hi.cpu(), c.keys_hi) and torch.equal(g.keys_lo.cpu(), c.keys_lo),
          "accumulator: the card's kept voxels differ from the CPU's")
    rel = float(((g.weight.cpu() - c.weight).abs() / c.weight.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-6, f"accumulator: weights differ by {rel} relative")
    acc = run["prev"].accum
    ms = time_ms(torch, lambda: accumulate_voxels(acc, ws.points, ws.valid, **kw), graph=False)
    out = dict(evicting_overflow=govf, weight_max_rel=rel,
               weights_bit_equal=torch.equal(g.weight.cpu(), c.weight),
               input_rows=ws.points.shape[0], input_valid=int(ws.valid.sum()),
               capacity=acc.capacity, fold_ms=ms)
    log(f"  accumulator, capacity 65536, two folds of {out['input_valid']} points: overflow "
        f"{govf} on both, keys equal, weights max relative difference {rel} (bit equal: "
        f"{out['weights_bit_equal']}); one fold into the step's accumulator "
        f"({acc.capacity} voxels): {ms:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the presets against the JAX golden
# ---------------------------------------------------------------------------


def check_golden(torch):
    """Each preset in float32 over its golden's frames, held against the
    JAX golden (`rt3d_torch.golden`, bands in its docstring); then the
    preset's usual bf16 step over the same frames, whose differences from
    the golden are measured and printed, not checked. Every preset is
    measured before any band is checked."""
    from rt3d_torch import golden
    from rt3d_torch.pipeline.presets import PRESETS, synthetic_preset

    res = {}
    for name in PRESETS:
        g = golden.load_golden(name)
        n = int(g["frames"])
        res[name] = {}
        for dtype in ("float32", None):  # None: the preset's usual bf16
            gc.collect()
            torch.cuda.empty_cache()
            pipe, src = synthetic_preset(name, n, dtype=dtype)
            state, calib = pipe.init_state(), pipe.calib()
            outs = []
            for i in range(n):
                pkt = src.get(i)
                state, o = pipe.step(state, torch.from_numpy(pkt.rgb).cuda(),
                                     torch.from_numpy(pkt.depth).cuda(), calib)
                outs.append(o)
            rec = golden.record(outs, float(g["subtraction_threshold"]),
                                pipe.cfg.pipeline.workspace_accumulate)
            res[name][dtype or "usual"] = golden.measure(rec, g)
            del pipe, outs
        log(f"  {name}: {json.dumps(res[name])}")
    for name, r in res.items():
        try:
            golden.check_bands(r["float32"])
        except AssertionError as e:
            raise AssertionError(f"{name} float32: {e}") from None
    return res


# ---------------------------------------------------------------------------
# Phases 4-8: the presets' paths
# ---------------------------------------------------------------------------


def run_path(torch, pipe, frames, per_step):
    """Step all frames in order; returns (per-frame event ms, wall s, host
    copies of the outputs, launches per kernel, last frame's outputs, the
    state the last frame was stepped from)."""
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
        prev = state
        state, out = pipe.step(state, rgb, depth, calib)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        for name, n in per_step.items():
            rose = kernels.LAUNCHES[name] - before[name]
            check(rose == n, f"frame {i}: {name} launched {rose} times, expected {n}")
        outs.append(host_outputs(out))
    wall = time.perf_counter() - t_wall
    return ms, wall, outs, dict(kernels.LAUNCHES), out, prev


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


def run_preset(torch, np, name, n_frames, per_step):
    """Phases of one preset: step `n_frames` synthetic HD720 frames with
    every launch counter checked per step and the outputs checked, then the
    same frames with every kernel's plain version, compared. Returns the
    run's numbers, its pipeline, frames and last outputs."""
    from rt3d_torch.pipeline.presets import synthetic_preset

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t = time.perf_counter()
    pipe, src = synthetic_preset(name, n_frames)
    frames = []
    for i in range(n_frames):
        pkt = src.get(i)
        frames.append((torch.from_numpy(pkt.rgb).cuda(), torch.from_numpy(pkt.depth).cuda()))
    torch.cuda.synchronize()
    log(f"{name}: pipeline built and {n_frames} frames staged: "
        f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    ms, wall, outs, launches, last, prev = run_path(torch, pipe, frames, per_step)
    peak = torch.cuda.max_memory_allocated()
    total_dets = 0
    for i, o in enumerate(outs):
        for key in ("boxes", "scores", "pc_points", "obj_points", "flat_points", "ws_points"):
            check(bool(np.isfinite(o[key]).all()), f"{name} frame {i}: non-finite {key}")
        check(isinstance(o["overflow"], int), "overflow is not an integer")
        n_det = int(o["det_valid"].sum())
        total_dets += n_det
        log(f"  frame {i}: {ms[i]:.2f} ms device clock, detections {n_det} "
            f"(classes {o['classes'][o['det_valid']].tolist()}), track ids "
            f"{o['track_ids'][o['det_valid']].tolist()}, fused objects "
            f"{int(o['obj_present'].sum())}, object points {int(o['flat_valid'].sum())}, "
            f"workspace kept {int(o['ws_valid'].sum())}, overflow {o['overflow']}")
    check(total_dets > 0, f"{name}: no detection in any frame")
    steady = ms[WARMUP_FRAMES:]
    fps = (n_frames - WARMUP_FRAMES) / wall
    log(f"  steady frames: device ms mean {statistics.mean(steady):.2f} "
        f"median {statistics.median(steady):.2f}; wall fps {fps:.2f}; "
        f"peak memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before the "
        f"preset was built); launches {launches}")
    phase(f"{name} path", t)

    t = time.perf_counter()
    plain, _ = synthetic_preset(name, n_frames, plain_kernels=True)
    pms, _, pouts, _, _, _ = run_path(torch, plain, frames, {n: 0 for n in per_step})
    exact = ("classes", "det_valid", "track_ids", "pc_points", "pc_valid", "obj_points",
             "obj_valid", "obj_present", "flat_points", "flat_valid", "ws_points", "ws_valid")
    for i, (o, p) in enumerate(zip(outs, pouts)):
        for key in exact:
            check(np.array_equal(o[key], p[key]),
                  f"{name} frame {i}: {key} differs from the plain run")
        for key in ("boxes", "scores"):
            check(np.allclose(o[key], p[key], rtol=0, atol=1e-4),
                  f"{name} frame {i}: {key} differ from the plain run by more than 1e-4")
        check(o["overflow"] == p["overflow"], f"{name} frame {i}: overflow differs")
    log(f"  plain run: steady device ms mean {statistics.mean(pms[WARMUP_FRAMES:]):.2f}; "
        f"identical keys, ids and keep masks over {n_frames} frames")
    phase(f"{name} plain path", t)
    return dict(launches=launches, steady_ms=statistics.mean(steady), fps=fps,
                peak_mib=peak / 2**20, plain_ms=statistics.mean(pms[WARMUP_FRAMES:]),
                pipe=pipe, frames=frames, outs=outs, last=last, prev=prev)


def check_workspace_sor(torch, run):
    """The CPU-variant preset's workspace SOR drops points: per frame, the
    fused workspace cloud through `Pipeline.workspace_sor` keeps fewer
    points than it receives, and the step's workspace lies within them."""
    from rt3d_torch.geometry.ops import PointBuffer

    pipe, calib = run["pipe"], run["pipe"].calib()
    with torch.no_grad():
        for i, ((_, depth), o) in enumerate(zip(run["frames"], run["outs"])):
            ws, _ = pipe.workspace_clouds(depth, calib)
            ws = PointBuffer(ws.points.reshape(-1, 3), ws.valid.reshape(-1))
            keep = pipe.workspace_sor(ws).valid
            got, kept = int(ws.valid.sum()), int(keep.sum())
            log(f"  frame {i}: workspace SOR receives {got} points, keeps {kept}")
            check(0 < kept < got, f"frame {i}: workspace SOR kept {kept} of {got}")
            check(not (o["ws_valid"] & ~keep.cpu().numpy()).any(),
                  f"frame {i}: the step kept a point its workspace SOR dropped")


def check_sor_entry(torch, objs):
    """K5 through `sor_inlier_mask` and `sor_filter` on every present fused
    slot, against `sor_inlier_mask_slots` (K3) over all slots; returns K5's
    launches, which must be one per call."""
    from rt3d_torch import kernels
    from rt3d_torch.geometry import sor
    from rt3d_torch.geometry.ops import PointBuffer

    present = objs.present.nonzero().flatten().tolist()
    check(len(present) > 0, "no fused object in the preset's last frame")
    kernels.reset_launches()
    slots = sor.sor_inlier_mask_slots(objs.points, objs.valid)
    for s in present:
        keep = sor.sor_inlier_mask(objs.points[s], objs.valid[s])
        kept = sor.sor_filter(PointBuffer(objs.points[s], objs.valid[s])).valid
        check(torch.equal(keep, slots[s]) and torch.equal(kept, keep),
              f"slot {s}: sor_inlier_mask / sor_filter differ from sor_inlier_mask_slots")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(launches["sor_knn"] == 2 * len(present),
          f"K5 launched {launches['sor_knn']} times for {2 * len(present)} calls")
    check(launches["sor_knn_slots"] == 1, "K3 not launched once")
    mean3, sat3 = sor.sor_knn_mean_slots(objs.points, objs.valid, 20)
    for s in present:
        m, st = sor.sor_knn_mean(objs.points[s], objs.valid[s], 20)
        check(torch.equal(m, mean3[s]) and torch.equal(st, sat3[s]),
              f"slot {s}: K5 differs from K3's row")
    log(f"  {len(present)} present slots of {objs.present.shape[0]}: keep masks equal "
        f"K3's, K5 equals K3's rows; launches {launches}")
    return launches


def check_slot_fallback(torch, gen):
    """The per-slot fallback of `sor_inlier_mask_slots` above 4096 points at
    the 1 mm stretch shape (20 slots of 16384 rows, 4 present): it runs the
    Morton-window SOR on the present slots only. Its keep mask must equal one
    batched windowed pass over every slot; both are timed (without a CUDA
    graph: the fallback reads the present slots back) with their peak
    memory."""
    from rt3d_torch.geometry import sor

    dev, s, cap = "cuda", 20, 16384
    n_valid = torch.tensor([16384, 9000, 5000, 2500] + [0] * (s - 4), device=dev)
    pts = torch.randint(-60, 60, (s, cap, 3), device=dev, generator=gen).float() * 0.001
    pts = (pts + torch.rand((s, 1, 3), device=dev, generator=gen) * 0.6
           + torch.randn((s, cap, 3), device=dev, generator=gen) * 0.0002).contiguous()
    valid = torch.arange(cap, device=dev)[None, :] < n_valid[:, None]
    forms = {"present slots": lambda: sor.sor_inlier_mask_slots(pts, valid),
             "batched": lambda: sor.sor_inlier_mask_windowed(pts, valid)}
    keeps, out = {}, {}
    for name, fn in forms.items():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        keeps[name] = fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        out[name] = (time_ms(torch, fn, graph=False), peak)
    keep = keeps["present slots"]
    check(torch.equal(keep, keeps["batched"]),
          "slot fallback: present-slot keep mask differs from the batched pass")
    kept, got = int(keep.sum()), int(valid.sum())
    check(0 < kept < got, f"slot fallback kept {kept} of {got}")
    log(f"  slot fallback, {s} slots of {cap}, 4 present, keeps {kept} of {got}: "
        + "; ".join(f"{name} {ms:.4f} ms, peak {peak:.1f} MiB above the inputs"
                    for name, (ms, peak) in out.items()))


# ---------------------------------------------------------------------------
# Phase 8b: the replay driver and the two_cam app
# ---------------------------------------------------------------------------


def same_outputs(torch, a, b):
    """True when two `FrameOutputs` hold equal tensors everywhere."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(same_outputs(torch, getattr(a, f), getattr(b, f))
               for f in a.__dataclass_fields__)


def record_replay(np, path):
    """`REPLAY_FRAMES` frames of the 2cam preset's synthetic scene written
    with the port's recorder; camera 1 of frame `REPLAY_BAD` has status 7."""
    from rt3d_torch.io import write_sequence
    from rt3d_torch.io.format import camera_meta
    from rt3d_torch.pipeline.presets import preset_source

    src = preset_source("2cam", REPLAY_FRAMES)
    pkts = [src.get(i) for i in range(REPLAY_FRAMES)]
    status = np.zeros((REPLAY_FRAMES, 2), np.uint32)
    status[REPLAY_BAD, 1] = 7
    meta = {"cameras": [
        camera_meta(c.intrinsics.fx, c.intrinsics.fy, c.intrinsics.cx, c.intrinsics.cy,
                    [list(r) for r in c.extrinsics.rotation], list(c.extrinsics.translation),
                    serial=c.serial, fps=c.fps) for c in src.cameras()],
        "generator": "chip_smoke.py"}
    return write_sequence(path, np.stack([p.rgb for p in pkts]),
                          np.stack([p.depth for p in pkts]), meta, status)


def run_app(torch, tmp, path, per_step, steps):
    """`rt3d_torch.apps.two_cam.main` in-process on the recording, as a user
    runs it; checks its exit code, replay backend, CSVs and launches.
    Returns its printed numbers and launches."""
    import contextlib
    import csv
    import io

    from rt3d_torch import kernels
    from rt3d_torch.apps import two_cam

    log_dir = os.path.join(tmp, "runs")
    argv = ["--source", path, "--variant", "x",
            "--weights", os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz"),
            "--frames", str(REPLAY_FRAMES), "--warmup", "2", "--pipeline-depth", "2",
            "--device", "cuda", "--log-dir", log_dir]
    out = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(out):
        rc = two_cam.main(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    text = out.getvalue()
    for line in text.splitlines():
        log(f"  two_cam: {line}")
    check(rc == 0, f"two_cam exited {rc}")
    check("(replay, backend native)" in text, "two_cam did not replay through the native replayer")
    with open(os.path.join(log_dir, "fps_log.csv")) as f:
        fps_rows = list(csv.reader(f))
    with open(os.path.join(log_dir, "timings.csv")) as f:
        timing_rows = list(csv.reader(f))
    check(fps_rows[0] == ["Timestamp", "FPS"] and len(fps_rows) == 1 + steps,
          f"fps_log.csv: {len(fps_rows) - 1} rows for {steps} good frames")
    rows = {r[0]: r[1].split(",") for r in timing_rows[1:]}
    # as in the JAX driver: a total per good frame, a retrieval per frame read
    check(timing_rows[0] == ["Step", "Timings"]
          and len(rows.get("Total Time per Iteration", ())) == steps
          and len(rows.get("Frame Retrieval", ())) == REPLAY_FRAMES,
          "timings.csv is not the reference schema with a total per good frame")
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"two_cam: {name} launched {launches[name]} times over {steps} steps")
    fps = dict(kv.split("=") for kv in text.split("frames=", 1)[1].splitlines()[0].split()[1:])
    return {"mean_fps": float(fps["mean_fps"]), "median_fps": float(fps["median"]),
            "max_fps": float(fps["max"])}, launches


def check_replay(torch, np, per_step):
    """Phase 8b: record, run the two_cam app, then hold `PipelineDriver` in
    every mode against plain steps of the good frames. Returns the numbers
    per mode and the app's launches."""
    import shutil
    import tempfile
    import threading

    from rt3d_torch import kernels
    from rt3d_torch.apps.common import adopt_source_calibration
    from rt3d_torch.config import reference_2cam_config
    from rt3d_torch.io import ReplaySource
    from rt3d_torch.pipeline.presets import preset_weights
    from rt3d_torch.pipeline.step import build_pipeline
    from rt3d_torch.runtime import PipelineDriver

    threads = threading.active_count()
    good = [i for i in range(REPLAY_FRAMES) if i != REPLAY_BAD]
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="rt3d_replay_")
    try:
        t = time.perf_counter()
        path = os.path.join(tmp, "seq.rts")
        spec = record_replay(np, path)
        log(f"  recorded {spec.n_frames} frames x {spec.n_cams} cams @ {spec.height}x"
            f"{spec.width}, {os.path.getsize(path) / 1e6:.1f} MB, in "
            f"{time.perf_counter() - t:.2f} s")
        res = {}
        torch.cuda.reset_peak_memory_stats()
        res["two_cam app"], app_launches = run_app(torch, tmp, path, per_step, len(good))
        res["two_cam app"]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        gc.collect()
        torch.cuda.empty_cache()

        src = ReplaySource(path)
        try:
            check(src.backend == "native", f"replay backend is {src.backend}")
            pipe = build_pipeline(adopt_source_calibration(reference_2cam_config(), src),
                                  weights=preset_weights("2cam"))
            state, calib = pipe.init_state(), pipe.calib()
            plain = {}
            for i in good:
                pkt = src.get(i)
                state, plain[i] = pipe.step(state, torch.from_numpy(pkt.rgb).cuda(),
                                            torch.from_numpy(pkt.depth).cuda(), calib)
            check(sum(int(o.detections.valid.sum()) for o in plain.values()) > 0,
                  "replay: no detection in any frame")
            modes = (("fused, depth 1", dict(pipeline_depth=1), REPLAY_FRAMES, good),
                     ("fused, depth 2", dict(pipeline_depth=2), REPLAY_FRAMES, good),
                     ("scan, 4 frames a call", dict(frames_per_dispatch=4), REPLAY_FRAMES,
                      list(range(REPLAY_FRAMES))),
                     ("profile", dict(mode="profile"), 4, list(range(4))))
            for name, kw, n, stepped in modes:
                seen = []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()
                drv = PipelineDriver(pipe, **kw)
                r = drv.run(src, n, warmup=2 if n > 4 else 1,
                            on_frame=lambda i, o: seen.append((i, o)))
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                expect = [i for i in range(n) if i != REPLAY_BAD]
                check([i for i, _ in seen] == expect, f"{name}: on_frame saw {[i for i, _ in seen]}")
                check(r.skipped_frames == (1 if n > REPLAY_BAD else 0),
                      f"{name}: skipped {r.skipped_frames} frames")
                for i, o in seen:
                    check(same_outputs(torch, o, plain[i]),
                          f"{name}: frame {i} differs from plain Pipeline.step calls")
                for k, per in per_step.items():
                    check(launches[k] == per * len(stepped),
                          f"{name}: {k} launched {launches[k]} times over {len(stepped)} steps")
                if kw.get("mode") == "profile":
                    for stage in ("Frame Retrieval", "YOLO11 Inference", "Mask Processing",
                                  "Point Cloud Processing", "Point Cloud Fusion",
                                  "Subtraction", "Total Time per Iteration"):
                        check(r.summary_ms.get(stage, 0.0) > 0, f"profile: stage {stage} not timed")
                res[name] = dict(mean_fps=r.mean_fps, median_fps=r.median_fps,
                                 max_fps=r.max_fps, summary_ms=r.summary_ms,
                                 peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                                 steps=len(stepped))
                del seen, drv
            del plain, pipe, state
        finally:
            src.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    check(threading.active_count() == threads,
          f"{threading.active_count() - threads} threads left behind by the replay phase")
    for name, r in res.items():
        log(f"  {name}: mean fps {r['mean_fps']:.2f}, median {r['median_fps']:.2f}, max "
            f"{r['max_fps']:.2f}, peak memory {r['peak_mib']:.1f} MiB"
            + (f", summary ms {json.dumps({k: round(v, 3) for k, v in r['summary_ms'].items()})}"
               if "summary_ms" in r else ""))
    return res, app_launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    import rt3d_torch  # noqa: F401  (fails when the port is not beside this file)
    from rt3d_torch.kernels.build import build, load_library

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
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("  ptxas:", line.strip().replace("ptxas info    : ", ""))
    phase("build", t)

    # 3. kernels against their plain versions
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = check_kernels(torch, gen)
    floor_ms = launch_floor_ms(torch)
    log(f"  launch floor (empty kernel rt3d_noop): {floor_ms:.4f} ms")
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {fmt_bound(r['bound'])}, "
            f"max_abs_err {r['max_abs_err']}"
            + (f"; without a threshold {r['exact_ms']:.4f} ms" if "exact_ms" in r else ""))
    phase("kernels", t)

    # 4-5. the default main path, then its plain run
    none = {"window_dedupe": 0, "window_prev_or": 0, "sor_knn_slots": 0,
            "min_sqdist": 0, "sor_knn": 0}
    runs = {"2cam": run_preset(torch, np, "2cam", FRAMES, {
        **none, "window_dedupe": 2, "window_prev_or": 2, "sor_knn_slots": 1,
        "min_sqdist": 1})}

    # 4b. K3 on the step's own slots
    t = time.perf_counter()
    slot_row = time_step_slots(torch, runs["2cam"])
    log(f"  K3 on the 2cam step's slots (valid rows {slot_row['n_valid']} of "
        f"{slot_row['cap']}, {slot_row['slots']} slots): kernel {slot_row['ms']:.4f} ms, "
        f"plain {slot_row['plain_ms']:.4f} ms, library {slot_row['library_ms']:.4f} ms, "
        f"bound {fmt_bound(slot_row)}")
    phase("sor_knn step slots", t)

    # 4c. K1, K2 and K4 on the step's own inputs
    t = time.perf_counter()
    step_rows = {"2cam": time_step_kernels(torch, runs["2cam"])}
    log_step_kernels("2cam", step_rows["2cam"])
    phase("2cam step inputs", t)

    drop = ("pipe", "frames", "outs", "last", "prev", "ws_out")
    for key in drop:
        runs["2cam"].pop(key, None)

    # 6. the CPU-variant preset
    runs["2cam_cpu"] = run_preset(torch, np, "2cam_cpu", FRAMES, {
        **none, "window_dedupe": 2, "window_prev_or": 2, "sor_knn_slots": 1,
        "min_sqdist": 1})
    t = time.perf_counter()
    check_workspace_sor(torch, runs["2cam_cpu"])
    phase("2cam_cpu workspace SOR", t)

    # 7. K5 through its entry points
    t = time.perf_counter()
    sor_entry = check_sor_entry(torch, runs["2cam_cpu"]["last"].objects)
    check_slot_fallback(torch, gen)
    phase("sor entry points", t)
    for key in drop:
        runs["2cam_cpu"].pop(key, None)

    # 8. the 1-cam preset
    runs["1cam"] = run_preset(torch, np, "1cam", FRAMES_1CAM, {
        **none, "window_dedupe": 1, "window_prev_or": 1, "min_sqdist": 1})
    t = time.perf_counter()
    step_rows["1cam"] = time_step_kernels(torch, runs["1cam"])
    log_step_kernels("1cam", step_rows["1cam"])
    phase("1cam step inputs", t)
    for key in drop:
        runs["1cam"].pop(key, None)

    # 8b. the replay driver and the two_cam app
    t = time.perf_counter()
    replay, launches_replay = check_replay(torch, np, {
        **none, "window_dedupe": 2, "window_prev_or": 2, "sor_knn_slots": 1,
        "min_sqdist": 1})
    phase("replay driver", t)

    # 10. the 1 mm stretch and the other trackers
    slice_k = {**none, "window_dedupe": 2, "window_prev_or": 2, "sor_knn_slots": 1,
               "min_sqdist": 1}
    for name in ("2cam_botsort", "2cam_deepsort"):
        runs[name] = run_preset(torch, np, name, FRAMES_SLICE, slice_k)
        st = runs[name]["prev"]
        check(all(bool((t.emb != 0).any()) for t in st.trackers),
              f"{name}: no track holds an appearance feature")
        check((name == "2cam_botsort") == bool((st.prev_gray != 0).any()),
              f"{name}: GMC's grey images are not what the tracker asks for")
        for key in drop:
            runs[name].pop(key, None)
    runs["stretch_4cam_1mm"] = run_preset(torch, np, "stretch_4cam_1mm", FRAMES_SLICE,
                                          {**none, "min_sqdist": 1})
    t = time.perf_counter()
    step_rows["stretch_4cam_1mm"] = time_step_kernels(torch, runs["stretch_4cam_1mm"])
    log_step_kernels("stretch_4cam_1mm", step_rows["stretch_4cam_1mm"])
    v = step_rows["stretch_4cam_1mm"]["min_sqdist"]
    check((v["queries"], v["refs"]) == (1048576, 32768),
          f"stretch: K4 at {v['queries']} x {v['refs']}, expected 1048576 x 32768")
    phase("stretch_4cam_1mm step inputs", t)
    t = time.perf_counter()
    accum = check_accumulator(torch, runs["stretch_4cam_1mm"])
    phase("accumulator", t)
    for key in drop:
        runs["stretch_4cam_1mm"].pop(key, None)

    # 9. every preset against the JAX golden
    t = time.perf_counter()
    gold = check_golden(torch)
    phase("golden", t)

    launches = {name: dict(r["launches"]) for name, r in runs.items()}
    launches["sor_entry"] = sor_entry
    launches["replay"] = launches_replay
    step_rows["2cam"]["sor_knn_slots"] = slot_row
    out_rows = []
    for r in rows:
        path = "sor_entry" if r["name"] == "sor_knn" else "2cam"
        steps = {p: v[r["name"]] for p, v in step_rows.items() if v.get(r["name"])}
        out_rows.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[path][r["name"]], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], **r["bound"], library_ms=r["library_ms"],
            launch_floor_ms=floor_ms,
            launches_by_path={p: n[r["name"]] for p, n in launches.items()},
            **({"exact_ms": r["exact_ms"]} if "exact_ms" in r else {}),
            **({"step_inputs": steps} if steps else {})))
    log(json.dumps({"presets": {name: {k: r[k] for k in ("steady_ms", "fps", "peak_mib",
                                                          "plain_ms")}
                                for name, r in runs.items()},
                    "replay": replay, "accumulator": accum}))
    log(json.dumps({"golden": gold}))
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
